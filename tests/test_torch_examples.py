"""The port's examples (`examples/torch_*.py`) on the CPU at reduced sizes,
each holding its own assertions, and each refusing to run without a card
unless given ``--device cpu``.

`torch_wireless_sim.py` runs at its full size (10 clients, 400 s): its
assertions (mean client accuracy above 0.3 on the exact timeline and on
the windowed engine) are about that horizon. The trainer example runs
the reduced qwen2 config for a few steps (its loss must fall).
"""
import importlib.util
import math
import os

import pytest

torch = pytest.importorskip("torch")

from _torch_entry import single_thread  # noqa: E402,F401  (autouse: one CPU thread)

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
CPU = ["--device", "cpu"]
REDUCED = {
    "quickstart": ["--clients", "8", "--windows", "60"],
    "dynamic_topology": ["--clients", "8", "--windows", "45"],
    "event_timeline": ["--clients", "8", "--horizon", "12"],
    "seed_sweep": ["--clients", "6", "--windows", "20"],
    "task_zoo": ["--clients", "6", "--windows", "20"],
    "train_lm_federated": ["--reduced", "--steps", "4", "--seq", "32"],
    "wireless_sim": [],
}


def _example(name):
    path = os.path.join(ROOT, "examples", f"torch_{name}.py")
    spec = importlib.util.spec_from_file_location(f"torch_example_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_every_torch_example_is_covered():
    names = sorted(os.path.basename(p)[len("torch_"):-3]
                   for p in os.listdir(os.path.join(ROOT, "examples"))
                   if p.startswith("torch_") and p.endswith(".py"))
    assert names == sorted(REDUCED)


def test_quickstart(capsys):
    trace = _example("quickstart").main(REDUCED["quickstart"] + CPU)
    assert list(trace.step) == [10, 20, 30, 40, 50, 60]
    assert all(math.isfinite(a) for a in trace.metrics["accuracy"])
    assert "virtual-global acc" in capsys.readouterr().out


def test_dynamic_topology():
    rows = _example("dynamic_topology").main(REDUCED["dynamic_topology"] + CPU)
    assert list(rows) == ["static", "markov-edge-flip", "random-waypoint",
                          "straggler-profile"]
    assert all(0.0 <= a <= 1.0 for a in rows.values())


def test_event_timeline():
    rows = _example("event_timeline").main(REDUCED["event_timeline"] + CPU)
    assert list(rows) == ["draco-event", "fedasync-gossip", "event-triggered",
                          "draco (windowed)"]
    # the same tape: the staleness damping changes no broadcast, the
    # trigger suppresses some
    assert rows["draco-event"][1] == rows["fedasync-gossip"][1]
    assert rows["event-triggered"][1] <= rows["draco-event"][1]


def test_seed_sweep():
    trace = _example("seed_sweep").main(REDUCED["seed_sweep"] + CPU)
    assert trace.metrics["accuracy"].shape == (3, 4, 1)


def test_task_zoo():
    rows = _example("task_zoo").main(REDUCED["task_zoo"] + CPU)
    assert set(rows) == {"linear-softmax", "mlp", "small-cnn", "tiny-lm", "sgd",
                         "momentum", "adamw"}


def test_train_lm_federated(capsys):
    losses = _example("train_lm_federated").main(REDUCED["train_lm_federated"] + CPU)
    assert len(losses) == 4 and losses[-1] < losses[0]
    assert capsys.readouterr().out.strip().splitlines()[-1].startswith("OK: loss")


def test_wireless_sim():
    exact, windowed = _example("wireless_sim").main(REDUCED["wireless_sim"] + CPU)
    assert exact > 0.3 and windowed > 0.3


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without CUDA")


@pytest.mark.parametrize("name", sorted(REDUCED))
def test_example_raises_without_cuda(no_cuda, name):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _example(name).main(REDUCED[name])
