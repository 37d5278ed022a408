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

`round_draws` does the same for a baseline round
(`repro.core.baselines`), for `repro_torch.convert.round_draws_from_numpy`.
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
    batch_idx = _batch_rows(k_gsel, cfg, num_samples)
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


def _batch_rows(key, cfg, num_samples):
    """Per-client batch rows of `protocol.local_updates`: ``split(key, N)``,
    then per client ``split(key_i, B)`` and ``randint`` per batch."""
    def client_rows(key_i):
        return jax.vmap(lambda k: jax.random.randint(
            k, (cfg.batch_size,), 0, num_samples))(
                jax.random.split(key_i, cfg.local_batches))

    return jax.vmap(client_rows)(jax.random.split(key, cfg.num_clients))


def round_draws(key, cfg, method, num_samples, p_active=0.5):
    """One baseline round's draws from the reference state's `key`, as
    `repro.core.baselines` splits it on the frozen path; returns ``(draws
    dict of numpy arrays, next key)``:

      - sync: ``split(key, 3)`` -> k_next, k_g, k_c (`baselines.py:96`),
        every client active;
      - async: ``split(key, 4)`` -> k_next, k_a, k_g, k_c (`:180`, `:200`),
        participation ``uniform(k_a, (N,)) < p_active``;
      - batch rows from k_g, as `protocol.local_updates` draws them;
      - fading ``exponential(k_c, (N, N))`` (`channel.py:81`), channel on.
    """
    n = cfg.num_clients
    if method.startswith("sync"):
        k_next, k_g, k_c = jax.random.split(key, 3)
        active = np.ones((n,), bool)
    else:
        k_next, k_a, k_g, k_c = jax.random.split(key, 4)
        active = np.asarray(jax.random.uniform(k_a, (n,)) < p_active)
    draws = {"active": active,
             "batch_idx": np.asarray(_batch_rows(k_g, cfg, num_samples))}
    if cfg.channel is not None and cfg.channel.enabled:
        draws["fading"] = np.asarray(jax.random.exponential(k_c, (n, n)))
    return draws, k_next


def round_draws_chain(key, cfg, method, num_samples, num_rounds):
    """Draws of `num_rounds` consecutive rounds of `method` from the state key."""
    out = []
    for _ in range(num_rounds):
        draws, key = round_draws(key, cfg, method, num_samples)
        out.append(draws)
    return out
