"""The port's paper benches and bench harness (`benchmarks/torch_*.py`)
against the JAX package's (`benchmarks/fig3_convergence.py`,
`benchmarks/run.py`), on the CPU at the quick sizes.

  - `torch_fig3_convergence.setup` builds the reference's `DracoConfig`
    (every field, the channel's message size included) for the paper
    presets and a registry task, and `steps_for_budget` prices the same
    baseline rounds per segment;
  - every `torch_run` bench at ``--quick --device cpu`` emits the
    reference bench's row names at the same arguments (the f-strings of
    `benchmarks/run.py`), apart from `gossip` and `ssd`, whose rows are
    named by what ran (the kernel on the card, the plain version here);
    the values are finite (fig3, fig4 and sweep, the longest, are in
    tests/test_torch_entry_figures.py, so that two workers share them);
  - the fig benches' JSON files have the reference's keys;
  - without a card, every entry point raises unless given ``--device
    cpu``.
"""
import dataclasses
import json
import os

import pytest

torch = pytest.importorskip("torch")

from _torch_entry import DYNAMIC_ROW, fig_json, run_quick_bench  # noqa: E402
from _torch_entry import single_thread  # noqa: E402,F401  (autouse)
from benchmarks import torch_fig3_convergence, torch_run  # noqa: E402
from benchmarks import torch_fig4_psi_sweep, torch_fig_dynamic  # noqa: E402

FIGURES = ("fig3", "fig4", "sweep")  # tests/test_torch_entry_figures.py


@pytest.fixture(scope="module")
def bench_dir(tmp_path_factory):
    return tmp_path_factory.mktemp("bench")


@pytest.mark.parametrize("bench", [b for b in torch_run.BENCHES if b not in FIGURES])
def test_quick_bench_emits_the_reference_rows(bench, bench_dir, capsys):
    run_quick_bench(bench, bench_dir, capsys)


def test_ssd_bench_holds_the_kernel_against_the_recurrence(bench_dir, monkeypatch):
    """`bench_ssd` fails when `ssd_forward` strays from `ssd_reference`
    past its tolerance (here a forward scaled by 1.01)."""
    from repro_torch.kernels.ssd import ops

    forward = ops.ssd_forward
    monkeypatch.setattr(ops, "ssd_forward", lambda *a, **k: forward(*a, **k) * 1.01)
    with pytest.raises(AssertionError, match="ssd_forward disagrees"):
        torch_run.bench_ssd(quick=True, device="cpu", out_dir=str(bench_dir))


def test_fig_dynamic_json_has_the_reference_keys(bench_dir):
    doc = fig_json("fig_dynamic", bench_dir)
    assert set(doc["results"]) == {"churn", "straggler"}
    assert list(doc["results"]["churn"]) == ["0.0", "0.2"]
    assert all(set(r) == DYNAMIC_ROW for rows in doc["results"].values()
               for r in rows.values())
    with open(os.path.join(bench_dir, "BENCH_torch_scenarios.json")) as f:
        assert len(json.load(f)) == 8


def _field_dict(cfg):
    out = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        out[f.name] = None if v is None else (
            dataclasses.asdict(v) if dataclasses.is_dataclass(v) else v)
    return out


_SETUPS = {}


def _setups(task):
    """The reference's and the port's `setup(task, 0, num_clients=6)`,
    built once per task for both tests below."""
    if task not in _SETUPS:
        from benchmarks.fig3_convergence import setup as jsetup

        _SETUPS[task] = (jsetup(task, 0, num_clients=6),
                         torch_fig3_convergence.setup(task, 0, num_clients=6, device="cpu"))
    return _SETUPS[task]


@pytest.mark.parametrize("task", ["emnist", "poker", "mlp"])
def test_setup_config_matches_reference(task):
    """`setup`'s `DracoConfig` equals the reference's field for field,
    the channel (its message size) included; the data shapes too."""
    (jcfg, jtrain, jtest, jparams0, jwork, _, _), (
        tcfg, ttrain, ttest, tparams0, twork, _, key) = _setups(task)
    assert _field_dict(tcfg) == _field_dict(jcfg)
    assert tcfg.channel.message_bytes == jcfg.channel.message_bytes
    assert tuple(ttrain[0].shape) == tuple(jtrain[0].shape)
    assert tuple(ttest[0].shape) == tuple(jtest[0].shape)
    assert sorted(tparams0) == sorted(jparams0)
    for name, leaf in tparams0.items():
        assert tuple(leaf.shape) == tuple(jparams0[name].shape)
    assert isinstance(key, int)
    assert hasattr(twork, "loss_fn") == hasattr(jwork, "loss_fn")


@pytest.mark.parametrize("task", ["emnist", "poker", "mlp"])
def test_rounds_per_segment_match_reference(task):
    """The compute-matched baseline rounds of one 100-window segment."""
    from repro.api import get_algorithm as jget_algorithm
    from repro.api import steps_for_budget as jsteps

    from repro_torch.api import get_algorithm, steps_for_budget
    from repro_torch.core.baselines import BASELINES

    (jcfg, *_, jwork, _, _), (tcfg, *_, twork, _, _) = _setups(task)
    jtask = jwork if hasattr(jwork, "loss_fn") else None
    ttask = twork if hasattr(twork, "loss_fn") else None
    jcost = jtask.grad_cost if jtask is not None else 1.0
    tcost = ttask.grad_cost if ttask is not None else 1.0
    assert tcost == pytest.approx(jcost, rel=1e-12)
    jbudget = 100 * jget_algorithm("draco").grads_per_step(jcfg) * jcost
    tbudget = 100 * get_algorithm("draco").grads_per_step(tcfg) * tcost
    assert tbudget == pytest.approx(jbudget, rel=1e-12)
    for name in BASELINES:
        assert steps_for_budget(name, tcfg, tbudget, task=ttask) == jsteps(
            name, jcfg, jbudget, task=jtask), name


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without CUDA")


@pytest.mark.parametrize("entry", [
    *(f"torch_run:{name}" for name in torch_run.BENCHES),
    "fig3", "fig4", "fig_dynamic"])
def test_bench_entry_points_raise_without_cuda(no_cuda, entry, tmp_path):
    mains = {"fig3": torch_fig3_convergence.main, "fig4": torch_fig4_psi_sweep.main,
             "fig_dynamic": torch_fig_dynamic.main}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if entry.startswith("torch_run:"):
            torch_run.main(["--quick", "--only", entry.split(":")[1], "--json", "",
                            "--out-dir", str(tmp_path)])
        else:
            mains[entry](["--out-dir", str(tmp_path)])
    assert not os.listdir(tmp_path)
