"""The port stands alone: importing every `repro_torch` module, and every
torch bench and example, loads neither JAX nor the JAX package; each
subpackage exports the reference's names; the entry points refuse to run
on the CPU unless asked to."""
import ast
import glob
import os
import pkgutil
import importlib
import subprocess
import sys

import pytest
import torch

import repro_torch

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
# subpackages of the reference that the port has not ported yet
NOT_PORTED = ("analysis", "sharding")


def _modules():
    names = ["repro_torch"]
    for info in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
        names.append(info.name)
    return names


def test_every_module_imports_without_jax_or_repro():
    code = (
        "import importlib, sys\n"
        f"names = {_modules()!r}\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print(len(names))\n")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=240)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 30


def _reference_all(package: str):
    """``__all__`` of ``src/repro/<package>/__init__.py``, read with `ast`
    (importing it would import JAX); None when it defines none."""
    with open(os.path.join(SRC, "repro", package, "__init__.py")) as f:
        tree = ast.parse(f.read())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == "__all__" for t in node.targets):
            return ast.literal_eval(node.value)
    return None


def _reference_packages():
    return sorted(p for p in os.listdir(os.path.join(SRC, "repro"))
                  if os.path.isfile(os.path.join(SRC, "repro", p, "__init__.py")))


def test_reference_packages_are_known():
    """Every reference subpackage is either ported or named as not yet."""
    ported = {name.split(".")[1] for name in _modules() if name.count(".") >= 1}
    for package in _reference_packages():
        assert package in ported or package in NOT_PORTED, package


@pytest.mark.parametrize("package", [
    "analysis", "api", "checkpoint", "configs", "core", "data", "events", "kernels",
    "models", "optim", "scenarios", "sharding", "tasks"])
def test_package_exports_the_reference_names(package):
    if package in NOT_PORTED:
        pytest.skip(f"repro.{package} is not ported yet")
    assert package in _reference_packages()
    names = _reference_all(package)
    port = importlib.import_module(f"repro_torch.{package}")
    if names is None:  # the reference exports nothing by name
        return
    missing = sorted(set(names) - set(getattr(port, "__all__", ())))
    assert not missing, f"repro_torch.{package}.__all__ lacks {missing}"
    for name in names:
        assert getattr(port, name) is not None


def test_f1_imports_work():
    from repro_torch.configs import get_config
    from repro_torch.core import DracoStateLegacy, draco_window, draco_window_legacy
    from repro_torch.data import make_mlp
    from repro_torch.tasks import opt_width

    assert callable(draco_window) and callable(draco_window_legacy)
    assert DracoStateLegacy._fields[0] == "params"
    assert callable(get_config) and callable(make_mlp) and callable(opt_width)


def _entry_scripts():
    """The torch benches (as modules) and the torch examples (as files)."""
    benches = sorted(f"benchmarks.{os.path.basename(p)[:-3]}"
                     for p in glob.glob(os.path.join(ROOT, "benchmarks", "torch_*.py")))
    examples = sorted(glob.glob(os.path.join(ROOT, "examples", "torch_*.py")))
    return benches, examples


def test_benches_and_examples_import_without_jax_or_repro():
    benches, examples = _entry_scripts()
    assert len(benches) >= 5 and len(examples) >= 7
    code = (
        "import importlib, importlib.util, sys\n"
        f"for name in {benches!r}:\n"
        "    importlib.import_module(name)\n"
        f"for i, path in enumerate({examples!r}):\n"
        "    spec = importlib.util.spec_from_file_location(f'example_{i}', path)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro')\n"
        "             or m == 'benchmarks.common' or m == 'benchmarks.fig3_convergence')\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([os.path.abspath(SRC), ROOT]))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=240, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_module_list_covers_the_slice():
    names = set(_modules())
    for mod in ("core.flat", "core.topology", "core.events", "core.channel",
                "core.protocol", "kernels.gossip.ops", "kernels.gossip.ref",
                "kernels.build", "models.layers", "data.synthetic",
                "tasks.base", "tasks.zoo", "api.algorithm", "api.context",
                "api.simulate", "api.algorithms", "convert",
                "configs.base", "configs.qwen2_1p5b", "models.attention",
                "models.model", "models.registry", "core.mixing",
                "launch.steps", "launch.train", "checkpoint.ckpt",
                "configs.mamba2_2p7b", "models.ssm", "kernels.ssd.ops",
                "kernels.ssd.ref", "optim.optimizers", "scenarios.base",
                "scenarios.generators", "api.sweep", "events", "events.config",
                "events.tape", "events.staleness", "events.engine", "events.replay",
                "events.algorithms", "events.driver", "models.moe",
                "configs.olmoe_1b_7b", "configs.qwen3_moe_30b_a3b",
                "configs.zamba2_2p7b", "configs.llama3p2_vision_11b",
                "configs.musicgen_large", "configs.stablelm_3b",
                "configs.qwen2p5_32b", "configs.yi_34b", "models.flash",
                "launch.serve"):
        assert f"repro_torch.{mod}" in names


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without CUDA")


def _entry_points():
    from repro_torch.api import simulate, simulate_sweep
    from repro_torch.core import protocol
    from repro_torch.events import init_event_state, simulate_events
    from repro_torch.configs.base import get_reduced
    from repro_torch.data import synthetic
    from repro_torch.launch import train
    from repro_torch.models import model
    from repro_torch.tasks import get_task

    cfg = protocol.DracoConfig(num_clients=3)
    task = get_task("linear-softmax")
    return {
        "simulate": lambda: simulate("draco", cfg, task="linear-softmax",
                                     num_steps=1, key=0),
        "simulate_sweep": lambda: simulate_sweep("draco", [cfg, cfg.replace(psi=2)],
                                                 task="linear-softmax", num_steps=1,
                                                 keys=[0, 1]),
        "simulate_events": lambda: simulate_events("draco-event", cfg, task="linear-softmax",
                                                   horizon=5.0, key=0),
        "init_event_state": lambda: init_event_state(0, cfg, {"w": torch.zeros(2)}),
        "init_state": lambda: protocol.init_state(0, cfg, {"w": torch.zeros(2)}),
        "build_graph": lambda: protocol.build_graph(cfg),
        "federated_classification": lambda: synthetic.federated_classification(
            0, 3, 4, 2, per_client=5),
        "make_mlp": lambda: synthetic.make_mlp(0, 4, (), 2),
        "task.init_params": lambda: task.init_params(0),
        "task.make_data": lambda: task.make_data(0, 3),
        "init_params": lambda: model.init_params(0, get_reduced("qwen2-1.5b")),
        "make_batches": lambda: train.make_batches(0, get_reduced("qwen2-1.5b"), 2, 2, 4),
        "train.main": lambda: train.main(["--reduced", "--steps", "1"]),
        "init_params[mamba2]": lambda: model.init_params(0, get_reduced("mamba2-2.7b")),
        "train.main[mamba2]": lambda: train.main(["--arch", "mamba2-2.7b", "--reduced",
                                                  "--steps", "1", "--seq", "32"]),
        **{f"init_params[{a}]": lambda a=a: model.init_params(0, get_reduced(a))
           for a in NEW_FAMILIES},
        **{f"make_batches[{a}]": lambda a=a: train.make_batches(0, get_reduced(a), 2, 2, 4)
           for a in NEW_FAMILIES},
        **{f"train.main[{a}]": lambda a=a: train.main(["--arch", a, "--reduced",
                                                       "--steps", "1", "--seq", "32"])
           for a in NEW_FAMILIES},
    }


NEW_FAMILIES = ("olmoe-1b-7b", "zamba2-2.7b", "llama-3.2-vision-11b", "musicgen-large")


@pytest.mark.parametrize("entry", [
    "build_graph", "federated_classification", "init_params", "init_state",
    "make_batches", "make_mlp", "simulate", "simulate_sweep", "simulate_events",
    "init_event_state", "task.init_params", "task.make_data",
    "train.main", "init_params[mamba2]", "train.main[mamba2]",
    *(f"{e}[{a}]" for e in ("init_params", "make_batches", "train.main")
      for a in NEW_FAMILIES)])
def test_entry_points_raise_without_cuda(no_cuda, entry):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _entry_points()[entry]()


def test_default_device_raises_without_cuda(no_cuda):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        repro_torch.default_device()
    assert repro_torch.resolve_device("cpu").type == "cpu"


def test_tf32_is_off():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
