"""JAX side of the port's injected draws (a helper, not a test module).

`window_draws` reproduces `repro.core.protocol.draco_window`'s key ladder
exactly, so the port, fed the result through
`repro_torch.convert.draws_from_numpy`, consumes the same random
outcomes as the reference window:

  - ``split(state.key, 8)`` -> k_next, k_grad, k_gsel, k_tx, k_chan,
    k_psi, ... (`protocol.py:420-421`);
  - grad mask: ``uniform(k_grad) < p`` (`events.py:31`);
  - batch rows: ``split(k_gsel, N)``, then per client ``split(key_i, B)``
    and ``randint`` per local batch (`protocol.py:198-206`);
  - tx mask: ``uniform(k_tx) < p``;
  - fading: ``exponential(k_chan, (N, N))`` (`channel.py:81`), channel on;
  - priority: ``permutation(k_psi, N)`` (`protocol.py:305`), psi > 0.
"""
import jax
import numpy as np

from repro.core.events import sample_event_masks


def window_draws(key, cfg, num_samples):
    """One window's draws from the reference state's `key`; returns
    ``(draws dict of numpy arrays, next key)``."""
    n = cfg.num_clients
    k_next, k_grad, k_gsel, k_tx, k_chan, k_psi, _, _ = jax.random.split(key, 8)
    grad_mask = sample_event_masks(k_grad, cfg.lambda_grad, cfg.window, n)

    def client_rows(key_i):
        return jax.vmap(lambda k: jax.random.randint(
            k, (cfg.batch_size,), 0, num_samples))(
                jax.random.split(key_i, cfg.local_batches))

    batch_idx = jax.vmap(client_rows)(jax.random.split(k_gsel, n))
    tx_mask = sample_event_masks(k_tx, cfg.lambda_tx, cfg.window, n)
    draws = {"grad_mask": np.asarray(grad_mask),
             "batch_idx": np.asarray(batch_idx),
             "tx_mask": np.asarray(tx_mask)}
    if cfg.channel is not None and cfg.channel.enabled:
        draws["fading"] = np.asarray(jax.random.exponential(k_chan, (n, n)))
    if cfg.psi > 0:
        draws["perm"] = np.asarray(jax.random.permutation(k_psi, n))
    return draws, k_next


def draws_chain(key, cfg, num_samples, num_windows):
    """Draws of `num_windows` consecutive windows from the state key."""
    out = []
    for _ in range(num_windows):
        draws, key = window_draws(key, cfg, num_samples)
        out.append(draws)
    return out
