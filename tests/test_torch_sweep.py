"""repro_torch's sweep engine: `simulate_sweep`, `stack_configs`, the
per-row `Overrides` and the seed axis of the windowed path.

  - Against the JAX package: a Psi x lr grid over two seeds, the port fed
    each seed's reference initial state and its reference draws
    (tests/_torch_draws.py::seed_draws_chains), equals the reference's
    `simulate_sweep` within f32 rtol = atol = 1e-5, counters exact.
  - Row (g, r) equals the port's own solo `simulate` with config g and
    seed r exactly on the CPU: the seed axis (one seed-stacked state, the
    drain's seed axis, the local step over R * N rows), the config axis
    (psi = 0 included), the scenario axis, a baseline and the windowed
    staleness hybrid. The batched local step's GEMMs run per client on
    the CPU as the solo ones do, so no tolerance is needed here (on the
    card `chip_smoke.py` prints the gap instead).
  - Every rejection of the reference's `stack_configs` / `simulate_sweep`.
"""
import jax
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: E402,F401  (autouse: one CPU thread)

from _torch_draws import seed_draws_chains
from repro.api import simulate_sweep as jsimulate_sweep
from repro.core import protocol as jp
from repro.core.channel import ChannelConfig as JChannel
from repro.data.synthetic import federated_classification, make_mlp
from repro_torch import convert
from repro_torch.api import make_context, simulate, simulate_sweep, stack_configs
from repro_torch.api.sweep import SWEEPABLE, seed_keys
from repro_torch.core import protocol as tp
from repro_torch.core.channel import ChannelConfig
from repro_torch.data.synthetic import mlp_fns
from repro_torch.events import EventConfig
from repro_torch.scenarios import make_schedule
from repro_torch.tasks import get_task

N, PER_CLIENT = 5, 64
KEYS = [3, 4]


def _kw(**over):
    kw = dict(num_clients=N, lr=0.1, local_batches=1, batch_size=8, window=0.03,
              lambda_grad=20.0, lambda_tx=20.0, unify_period=4, psi=2,
              topology="complete", max_delay_windows=3)
    kw.update(over)
    return kw


def _cfg(channel=True, **over):
    return tp.DracoConfig(**_kw(**over), channel=ChannelConfig() if channel else None)


TASK = get_task("mlp", input_dim=6, hidden=(8,), num_classes=3, per_client=PER_CLIENT)
_G = torch.Generator().manual_seed(0)
PARAMS0 = TASK.init_params(_G)
DATA, EVAL = TASK.make_data(_G, N)


def _cell_equal(solo, finals, g, r):
    for k in solo.params:
        assert torch.equal(solo.params[k], finals.params[k][g, r]), (g, r, k)
    assert torch.equal(solo.total_accept, finals.total_accept[g, r])


# --- against the JAX package --------------------------------------------------


def test_sweep_matches_reference_with_injected_draws():
    k_data, k_model = jax.random.split(jax.random.PRNGKey(0))
    train, test = federated_classification(k_data, N, 6, 3, per_client=PER_CLIENT)
    params0, _, loss, acc = make_mlp(k_model, 6, (8,), 3)
    jkeys = jax.random.split(jax.random.PRNGKey(42), 2)
    over = [dict(psi=0), dict(psi=2), dict(psi=3, lr=0.05)]
    jgrid = [jp.DracoConfig(**_kw(**o), channel=JChannel()) for o in over]
    tgrid = [_cfg(**o) for o in over]
    steps = 6
    jfinals, jtrace = jsimulate_sweep("draco", jgrid, params0, loss, train, steps,
                                      keys=jkeys, eval_every=4, eval_fn=acc, eval_data=test)
    inits = [jp.init_state(k, jgrid[0], params0) for k in jkeys]
    chains = [seed_draws_chains([s.key for s in inits], c, PER_CLIENT, steps) for c in jgrid]
    _, tloss, tacc = mlp_fns(2)
    finals, trace = simulate_sweep(
        "draco", tgrid, convert.params_from_numpy(params0, "cpu"), tloss,
        convert.data_from_numpy(train, "cpu"), steps,
        states=[convert.state_from_numpy(s, device="cpu") for s in inits], eval_every=4,
        eval_fn=tacc, eval_data=convert.data_from_numpy(test, "cpu"), device="cpu",
        draws_fn=lambda g, r, i: convert.draws_from_numpy(chains[g][r][i], "cpu"))
    np.testing.assert_array_equal(trace.step, np.asarray(jtrace.step))
    assert trace.metrics["accuracy"].shape == (3, 2, 2)
    for k in trace.metrics:
        np.testing.assert_allclose(trace.metrics[k], np.asarray(jtrace.metrics[k]),
                                   rtol=1e-5, atol=1e-5)
    for k in finals.params:
        np.testing.assert_allclose(finals.params[k].numpy(), np.asarray(jfinals.params[k]),
                                   rtol=1e-5, atol=1e-5)
    for field in ("total_accept", "accept_count", "w_ring", "delay_ring"):
        np.testing.assert_array_equal(getattr(finals, field).numpy(),
                                      np.asarray(getattr(jfinals, field)))
    # a seed-stacked row shares one host window index
    np.testing.assert_array_equal(finals.window_idx, np.full((3,), steps))


# --- rows against the port's solo runs ----------------------------------------


@pytest.mark.parametrize("optimizer", ["sgd", "adamw"])
def test_seed_axis_rows_equal_solo_runs(optimizer):
    """One seed-stacked state per row, the drain's seed axis on the CPU
    reference, the local step over R * N rows: row r is the solo run."""
    task = TASK.with_optimizer(optimizer)
    cfg = _cfg()
    finals, trace = simulate_sweep("draco", cfg, task=task, data=DATA, params0=PARAMS0,
                                   num_steps=9, keys=KEYS + [5], eval_every=4,
                                   eval_data=EVAL, device="cpu")
    assert trace.metrics["accuracy"].shape == (1, 3, 3) and list(trace.step) == [4, 8, 9]
    for r, key in enumerate(KEYS + [5]):
        solo, solo_tr = simulate("draco", cfg, task=task, data=DATA, params0=PARAMS0,
                                 num_steps=9, key=key, eval_every=4, eval_data=EVAL,
                                 device="cpu")
        _cell_equal(solo, finals, 0, r)
        assert torch.equal(solo.opt_state, finals.opt_state[0, r])
        for k in solo_tr.metrics:
            np.testing.assert_array_equal(solo_tr.metrics[k], trace.metrics[k][0, r])


@pytest.mark.parametrize("over", [
    [dict(psi=0), dict(psi=2), dict(psi=3, lr=0.05)],
    [dict(lambda_grad=5.0), dict(lambda_grad=20.0, lambda_tx=8.0)],
], ids=["psi-lr", "lambda"])
def test_config_axis_rows_equal_cfg_replace(over):
    """Per-row overrides (psi = 0, unbounded, included) equal the solo
    runs with ``cfg.replace(...)``."""
    grid = [_cfg(**o) for o in over]
    finals, _ = simulate_sweep("draco", grid, task=TASK, data=DATA, params0=PARAMS0,
                               num_steps=8, keys=KEYS, device="cpu")
    for g, cfg in enumerate(grid):
        solo, _ = simulate("draco", cfg, task=TASK, data=DATA, params0=PARAMS0,
                           num_steps=8, key=KEYS[1], device="cpu")
        _cell_equal(solo, finals, g, 1)


def test_override_window_equals_replaced_config():
    """`draco_window(..., overrides=)` is the window of the replaced config."""
    cfg = _cfg()
    ov = tp.Overrides(lr=0.02, lambda_grad=9.0, lambda_tx=7.0, psi=0)
    q, adj = tp.build_graph(cfg, device="cpu")
    a = tp.init_state(2, cfg, PARAMS0, task=TASK, device="cpu")
    b = tp.init_state(2, cfg, PARAMS0, task=TASK, device="cpu")
    for _ in range(5):
        a = tp.draco_window(a, cfg, q, adj, TASK, DATA, overrides=ov)
        b = tp.draco_window(b, cfg.replace(lr=0.02, lambda_grad=9.0, lambda_tx=7.0, psi=0),
                            q, adj, TASK, DATA)
    for k in a.params:
        assert torch.equal(a.params[k], b.params[k])
    assert torch.equal(a.total_accept, b.total_accept)


@pytest.mark.parametrize("algo", ["sync-push", "async-symm"])
def test_baseline_rows_equal_solo_runs(algo):
    grid = [_cfg(topology="cycle", lr=0.1), _cfg(topology="cycle", lr=0.02)]
    finals, _ = simulate_sweep(algo, grid, task=TASK, data=DATA, params0=PARAMS0,
                               num_steps=6, keys=KEYS, device="cpu")
    for g, cfg in enumerate(grid):
        for r, key in enumerate(KEYS):
            solo, _ = simulate(algo, cfg, task=TASK, data=DATA, params0=PARAMS0,
                               num_steps=6, key=key, device="cpu")
            for k in solo.params:
                assert torch.equal(solo.params[k], finals.params[k][g, r])
            assert torch.equal(solo.push_weight, finals.push_weight[g, r])


def test_fedasync_window_seed_axis_rows_equal_solo_runs():
    cfg = EventConfig(**_kw(), channel=ChannelConfig(), staleness="poly", staleness_a=0.7)
    grid = [cfg, cfg.replace(psi=0)]
    finals, _ = simulate_sweep("fedasync-window", grid, task=TASK, data=DATA,
                               params0=PARAMS0, num_steps=7, keys=KEYS, device="cpu")
    for g, c in enumerate(grid):
        solo, _ = simulate("fedasync-window", c, task=TASK, data=DATA, params0=PARAMS0,
                           num_steps=7, key=KEYS[0], device="cpu")
        _cell_equal(solo, finals, g, 0)


def test_scenario_axis_rows_equal_solo_runs():
    cfg = _cfg()
    scheds = [make_schedule("markov-edge-flip", cfg, key=10 + i, steps=6, churn=c,
                            device="cpu") for i, c in enumerate((0.1, 0.4))]
    finals, _ = simulate_sweep("draco", cfg, task=TASK, data=DATA, params0=PARAMS0,
                               num_steps=8, keys=KEYS, schedules=scheds, device="cpu")
    for g, sched in enumerate(scheds):
        ctx = make_context(cfg, task=TASK, data=DATA, params0=PARAMS0, scenario=sched,
                           device="cpu")
        solo, _ = simulate("draco", cfg, task=TASK, num_steps=8, key=KEYS[0], ctx=ctx,
                           device="cpu")
        _cell_equal(solo, finals, g, 0)


def _take_accept(state):
    return state.total_accept


def test_final_fn_slims_output_and_key_splits():
    grid = [_cfg(psi=1), _cfg(psi=2)]
    finals, trace = simulate_sweep("draco", grid, task=TASK, data=DATA, params0=PARAMS0,
                                   num_steps=4, key=7, num_seeds=3, final_fn=_take_accept,
                                   device="cpu")
    assert finals.shape == (2, 3, N) and finals.dtype == torch.int32
    assert trace.step.shape == (0,) and trace.metrics == {}
    keys = seed_keys(7, 3)
    assert keys == seed_keys(7, 3) and len(set(keys)) == 3
    solo, _ = simulate("draco", grid[1], task=TASK, data=DATA, params0=PARAMS0,
                       num_steps=4, key=keys[2], device="cpu")
    assert torch.equal(solo.total_accept, finals[1, 2])


def test_stack_configs_detects_swept_fields():
    grid = [_cfg(psi=1, lr=0.1), _cfg(psi=4, lr=0.1)]
    base, ov = stack_configs(grid)
    assert base == grid[0]
    assert ov.lr is None and ov.lambda_grad is None and ov.lambda_tx is None
    assert ov.psi == (1, 4) and all(isinstance(p, int) for p in ov.psi)
    assert set(SWEEPABLE) == {"lr", "lambda_grad", "lambda_tx", "psi"}
    with pytest.raises(ValueError, match="empty"):
        stack_configs([])


def _rejects(match, *args, **kw):
    kw = dict(dict(task=TASK, data=DATA, params0=PARAMS0, num_steps=2, keys=KEYS,
                   device="cpu"), **kw)
    with pytest.raises(ValueError, match=match):
        simulate_sweep(*args, **kw)


def test_rejects_what_the_reference_rejects():
    cfg = _cfg()
    _rejects("non-sweepable", "draco", [cfg, cfg.replace(topology="cycle")])
    _rejects("no field varies", "draco", [cfg.replace(psi=1), cfg.replace(psi=1)])
    _rejects("does not consume", "sync-push", [cfg.replace(psi=1), cfg.replace(psi=2)])
    scheds = [make_schedule("markov-edge-flip", cfg, key=i, steps=4, churn=0.2,
                            device="cpu") for i in range(3)]
    _rejects("grid axes disagree", "draco", [cfg.replace(psi=1), cfg.replace(psi=2)],
             schedules=scheds)
    _rejects("keys", "draco", cfg, keys=None)
    ctx = make_context(cfg, task=TASK, data=DATA, params0=PARAMS0, device="cpu")
    _rejects("differs from the grid's base", "draco", cfg.replace(psi=5), ctx=ctx)
    _rejects("already carries overrides", "draco", cfg,
             ctx=ctx._replace(overrides=tp.Overrides(psi=1)))
    _rejects("either schedules= or a ctx", "draco", cfg, schedules=scheds[:1],
             ctx=make_context(cfg, task=TASK, data=DATA, params0=PARAMS0,
                              scenario=scheds[0], device="cpu"))
    _rejects("eval_fn requires eval_data", "draco", cfg, eval_fn=TASK.eval_fn)
    from dataclasses import replace

    fixed = replace(TASK, sweepable=())
    _rejects("does not declare 'lr' sweepable", "draco", [cfg, cfg.replace(lr=0.2)],
             task=fixed)
    with pytest.raises(ValueError, match="schedules must share"):
        simulate_sweep("draco", cfg, task=TASK, data=DATA, params0=PARAMS0, num_steps=2,
                       keys=KEYS, device="cpu",
                       schedules=[scheds[0], make_schedule("markov-edge-flip", cfg, key=9,
                                                           steps=5, churn=0.2, device="cpu")])
