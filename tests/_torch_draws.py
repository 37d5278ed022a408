"""JAX side of the port's injected draws (a helper, not a test module).

`window_draws` reproduces `repro.core.protocol.draco_window`'s key ladder
exactly, so the port, fed the result through
`repro_torch.convert.draws_from_numpy`, consumes the same random
outcomes as the reference window:

  - ``split(state.key, 8)`` -> k_next, k_grad, k_gsel, k_tx, k_chan,
    k_psi, ... (`protocol.py:420-421`);
  - grad mask: ``uniform(k_grad) < p`` (`events.py:31`), at
    ``lambda_grad * compute_rate`` per client under a scenario
    (`protocol.py:445`);
  - batch rows: ``split(k_gsel, N)``, then per client ``split(key_i, B)``
    and ``randint`` per local batch (`protocol.py:198-206`);
  - tx mask: ``uniform(k_tx) < p``, at ``lambda_tx * tx_rate`` under a
    scenario (`protocol.py:345`);
  - fading: ``exponential(k_chan, (N, N))`` (`channel.py:81`), channel on;
  - priority: ``permutation(k_psi, N)`` (`protocol.py:305`), psi > 0.

`round_draws` does the same for a baseline round
(`repro.core.baselines`), for `repro_torch.convert.round_draws_from_numpy`;
`seed_draws_chains` gives a sweep's per-seed window chains; `event_draws`
one event of `repro.events.engine.event_step` (its 4-way key split), for
`repro_torch.convert.event_draws_from_numpy`.
"""
import jax
import numpy as np

from repro.core.baselines import _participation
from repro.core.events import sample_event_masks


def _scaled(lam, rate):
    return lam if rate is None else lam * rate


def window_draws(key, cfg, num_samples, compute_rate=None, tx_rate=None):
    """One window's draws from the reference state's `key`, with a
    scenario snapshot's (N,) rates when given; returns ``(draws dict of
    numpy arrays, next key)``."""
    n = cfg.num_clients
    k_next, k_grad, k_gsel, k_tx, k_chan, k_psi, _, _ = jax.random.split(key, 8)
    grad_mask = sample_event_masks(k_grad, _scaled(cfg.lambda_grad, compute_rate),
                                   cfg.window, n)
    batch_idx = _batch_rows(k_gsel, cfg, num_samples)
    tx_mask = sample_event_masks(k_tx, _scaled(cfg.lambda_tx, tx_rate), cfg.window, n)
    draws = {"grad_mask": np.asarray(grad_mask),
             "batch_idx": np.asarray(batch_idx),
             "tx_mask": np.asarray(tx_mask)}
    if cfg.channel is not None and cfg.channel.enabled:
        draws["fading"] = np.asarray(jax.random.exponential(k_chan, (n, n)))
    if cfg.psi > 0:
        draws["perm"] = np.asarray(jax.random.permutation(k_psi, n))
    return draws, k_next


def draws_chain(key, cfg, num_samples, num_windows, schedule=None):
    """Draws of `num_windows` consecutive windows from the state key (of
    a state at window 0), each at the rates of its step of the
    reference `schedule` when one is given."""
    out = []
    for w in range(num_windows):
        snap = None if schedule is None else schedule.at(w)
        draws, key = window_draws(key, cfg, num_samples,
                                  None if snap is None else snap.compute_rate,
                                  None if snap is None else snap.tx_rate)
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


def round_draws(key, cfg, method, num_samples, p_active=0.5, compute_rate=None):
    """One baseline round's draws from the reference state's `key`, as
    `repro.core.baselines` splits it; returns ``(draws dict of numpy
    arrays, next key)``:

      - sync, frozen path: ``split(key, 3)`` -> k_next, k_g, k_c
        (`baselines.py:90-93`), every client active;
      - sync with a scenario's `compute_rate`: ``split(key, 4)`` -> k_next,
        k_g, k_c, k_s (`:97-98`), participation at ``clip(rate, 0, 1)``
        from k_s;
      - async: ``split(key, 4)`` -> k_next, k_a, k_g, k_c, participation
        at `p_active` (scaled by `compute_rate` and clipped, when given)
        from k_a;
      - batch rows from k_g, as `protocol.local_updates` draws them;
      - fading ``exponential(k_c, (N, N))`` (`channel.py:81`), channel on.
    """
    n = cfg.num_clients
    if method.startswith("sync") and compute_rate is None:
        k_next, k_g, k_c = jax.random.split(key, 3)
        active = np.ones((n,), bool)
    elif method.startswith("sync"):
        k_next, k_g, k_c, k_s = jax.random.split(key, 4)
        active = np.asarray(_participation(k_s, n, 1.0, compute_rate))
    else:
        k_next, k_a, k_g, k_c = jax.random.split(key, 4)
        active = np.asarray(_participation(k_a, n, p_active, compute_rate))
    draws = {"active": active,
             "batch_idx": np.asarray(_batch_rows(k_g, cfg, num_samples))}
    if cfg.channel is not None and cfg.channel.enabled:
        draws["fading"] = np.asarray(jax.random.exponential(k_c, (n, n)))
    return draws, k_next


def round_draws_chain(key, cfg, method, num_samples, num_rounds, schedule=None):
    """Draws of `num_rounds` consecutive rounds of `method` from the state
    key (of a state at round 0), at each round's compute rates of the
    reference `schedule` when one is given."""
    out = []
    for r in range(num_rounds):
        rate = None if schedule is None else schedule.at(r).compute_rate
        draws, key = round_draws(key, cfg, method, num_samples, compute_rate=rate)
        out.append(draws)
    return out


def seed_draws_chains(keys, cfg, num_samples, num_windows, schedule=None):
    """Per-seed draws chains of a sweep row: ``[draws_chain(k_r, ...)]``
    from each seed's reference state key (of a state at window 0)."""
    return [draws_chain(k, cfg, num_samples, num_windows, schedule) for k in keys]


def event_draws(key, cfg, num_samples):
    """One valid event's draws from the reference state's `key`, as
    `event_step` splits it (`engine.py:145-146`): ``split(key, 4)`` ->
    k_next, k_gsel, k_chan, _; the batch rows of all N clients from
    k_gsel (`local_step`'s ladder), the fading ``exponential(k_chan, (N,
    N))`` with the channel on. Returns ``(draws dict, next key)``; both
    fields are given whatever the kind (the port reads the one it needs)."""
    k_next, k_gsel, k_chan, _ = jax.random.split(key, 4)
    draws = {"batch_idx": np.asarray(_batch_rows(k_gsel, cfg, num_samples))}
    if cfg.channel is not None and cfg.channel.enabled:
        draws["fading"] = np.asarray(jax.random.exponential(k_chan, (cfg.num_clients,) * 2))
    return draws, k_next


def event_draws_chain(key, cfg, num_samples, tape):
    """Draws of every row of the reference's `tape` from the state key
    (None for padding rows, which split no key)."""
    valid = np.asarray(tape.valid)
    out = []
    for e in range(valid.shape[0]):
        if not valid[e]:
            out.append(None)
            continue
        draws, key = event_draws(key, cfg, num_samples)
        out.append(draws)
    return out
