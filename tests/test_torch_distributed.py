"""The port's client mesh on `torch.distributed`, in gloo worlds of 2 and
4 ranks on the CPU, against the JAX package.

Each world runs once (`_torch_dist.world`, spawned by
`repro_torch.launch.mesh.spawn_ranks`) and does every check of its size:
`gossip_drain_sharded`, the mesh `make_train_step` in the dense (f32 and
bf16), ring and none modes, unification, `mix_ring_shardmap`, the serve
step and `simulate_sweep(mesh=)`. The JAX side runs once, in one
subprocess with four host devices and an ``Auto`` (4, 1) mesh (jax
0.9's `jax.make_mesh` default, ``Explicit`` axes, makes the reference's
``constrain`` raise), started before the worlds so that both run at
once: the reference's own `make_train_step` on the same params, tokens
and ``q_eff``, its unsharded `gossip_drain` on `tests/test_sweep_mesh.py`'s
case, and its `mix_dense` with the cycle's Q.

Tolerances: the drain within 1e-5 (f32 sums re-associated across
ranks), the train steps within 1e-4 (the bound `tests/test_torch_train.py`
holds the single-device step to; bf16 mix 1e-2), the sweep's params
within 2e-5 and accuracies within 1e-5 of the port's unsharded sweep;
unification and the none mode exact against the port on one device.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import _torch_dist as D
from repro_torch.configs.base import get_reduced
from repro_torch.core import flat as flat_lib
from repro_torch.kernels.gossip import ops
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import steps
from repro_torch.launch import train as ttrain
from repro_torch.models import model as M

SRC = os.path.join(os.path.dirname(__file__), "..", "src")

REFERENCE = r'''
import sys
import jax, jax.numpy as jnp
import numpy as np
from repro.configs.base import ShapeConfig, get_reduced
from repro.core import mixing
from repro.kernels.gossip.ops import gossip_drain
from repro.launch import steps

src, dst, lr = sys.argv[1], sys.argv[2], float(sys.argv[3])
inp = dict(np.load(src))
assert len(jax.devices()) == 4
mesh = jax.make_mesh((4, 1), ("data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 2)
out = {}
for key in ("w", "w0"):
    out["drain_" + key] = np.asarray(gossip_drain(
        jnp.asarray(inp["drain_" + key]), jnp.asarray(inp["drain_ring"]),
        jnp.asarray(inp["drain_slots"])))
deltas = {k[5:]: jnp.asarray(v) for k, v in inp.items() if k.startswith("ring/")}
for k, v in mixing.mix_dense(jnp.asarray(inp["cycle"]), deltas).items():
    out["ring/" + k] = np.asarray(v)

def nest(prefix):
    tree = {}
    for key, v in inp.items():
        if key.startswith(prefix):
            node, path = tree, key[len(prefix):].split("/")
            for p in path[:-1]:
                node = node.setdefault(p, {})
            node[path[-1]] = jnp.asarray(v)
    return tree

cfg = get_reduced("qwen2-1.5b")
params, tokens = nest("param/"), jnp.asarray(inp["tokens"], jnp.int32)
n, b, s = tokens.shape
param_sh, batch_sh, q_sh = steps.make_shardings(mesh, cfg, ShapeConfig("t", s, n * b, "train"))
modes = {"dense": ("dense", None), "dense-bf16": ("dense", jnp.bfloat16),
         "ring": ("ring", None), "none": ("none", None)}
for name, (mode, md) in modes.items():
    step = jax.jit(steps.make_train_step(cfg, mesh, lr=lr, mix_mode=mode, mix_dtype=md),
                   in_shardings=(param_sh, batch_sh, q_sh), out_shardings=(param_sh, None))
    new, loss = step(jax.device_put(params, param_sh),
                     {"tokens": jax.device_put(tokens, batch_sh["tokens"])},
                     jax.device_put(jnp.asarray(inp["q_eff"]), q_sh))
    out["loss/" + name] = np.asarray(loss)
    for path, leaf in jax.tree_util.tree_leaves_with_path(new):
        out[f"train/{name}/" + "/".join(p.key for p in path)] = np.asarray(leaf)
np.savez(dst, **out)
print("REFERENCE_OK")
'''


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The ranks run torch on one thread each; the one-device results they
    are held to exactly are computed on one thread too (the same sums in
    the same order)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def inputs():
    return D.train_inputs(), D.drain_inputs()


@pytest.fixture(scope="module")
def reference(inputs, tmp_path_factory):
    """Starts the JAX subprocess; returns a function that waits for it and
    loads its outputs."""
    train, drain = inputs
    root = tmp_path_factory.mktemp("reference")
    arrays = {"tokens": train["tokens"], "q_eff": train["q_eff"], "cycle": train["cycle"],
              "drain_w": drain["w"], "drain_w0": drain["w0"], "drain_ring": drain["ring"],
              "drain_slots": np.asarray(drain["slots"])}
    arrays.update({"param/" + "/".join(p): leaf.numpy()
                   for p, leaf in flat_lib.tree_items(train["params"])})
    arrays.update({"ring/" + k: v for k, v in train["ring_deltas"].items()})
    np.savez(root / "in.npz", **arrays)
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([os.path.abspath(SRC), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.Popen([sys.executable, "-c", REFERENCE, str(root / "in.npz"),
                             str(root / "out.npz"), str(D.LR)], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    loaded = {}

    def wait():
        if not loaded:
            out, err = proc.communicate(timeout=300)
            assert proc.returncode == 0 and "REFERENCE_OK" in out, err[-4000:]
            loaded.update(np.load(root / "out.npz"))
        return loaded

    yield wait
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def worlds(inputs, reference):
    train, drain = inputs
    return {size: mesh_lib.spawn_ranks(D.world, size, train, drain, backend="gloo",
                                       timeout=60, deadline=240)
            for size in (2, 4)}


def _cat(outs, key):
    return torch.cat([o[key] for o in outs])


def _cat_tree(outs, key, index=None):
    trees = [o[key] if index is None else o[key][index] for o in outs]
    return flat_lib.tree_map(lambda *xs: torch.cat(xs), *trees)


@pytest.mark.parametrize("size", [2, 4])
def test_drain_sharded_matches_reference(worlds, reference, size):
    outs, ref = worlds[size], reference()
    assert [o["rank"] for o in outs] == list(range(size))
    for key in ("w", "w0"):
        got = _cat(outs, f"drain_{key}").numpy()
        np.testing.assert_allclose(got, ref[f"drain_{key}"], rtol=1e-5, atol=1e-5)
    # the empty bucket adds nothing: w0 is w without bucket 1's term
    assert "divisible" in outs[0]["indivisible"]


# the ring holds one client per rank: N == 4 ranks only
@pytest.mark.parametrize("size,mode", [(2, "dense"), (2, "dense-bf16"), (2, "none"),
                                       (4, "dense"), (4, "dense-bf16"), (4, "ring"),
                                       (4, "none")])
def test_train_step_matches_reference(worlds, reference, size, mode):
    outs, ref = worlds[size], reference()
    tol = 1e-2 if mode == "dense-bf16" else 1e-4
    for o in outs:
        np.testing.assert_allclose(float(o[f"train_{mode}"][1]), ref[f"loss/{mode}"],
                                   rtol=1e-4, atol=1e-4)
    got = _cat_tree(outs, f"train_{mode}", 0)
    for path, leaf in flat_lib.tree_items(got):
        np.testing.assert_allclose(leaf.numpy(), ref[f"train/{mode}/" + "/".join(path)],
                                   rtol=tol, atol=tol, err_msg="/".join(path))


@pytest.mark.parametrize("size", [2, 4])
def test_unify_and_none_mode_equal_one_device(worlds, inputs, size):
    train, _ = inputs
    outs = worlds[size]
    cfg = get_reduced(D.ARCH)
    dense = _cat_tree(outs, "train_dense", 0)
    want = steps.make_unify_step(cfg, None)(flat_lib.tree_map(torch.clone, dense), 1)
    for a, b in zip(flat_lib.tree_leaves(_cat_tree(outs, "unify")), flat_lib.tree_leaves(want)):
        assert torch.equal(a, b)
    params = flat_lib.tree_map(torch.clone, train["params"])
    params, loss = ttrain.train_step(params, {"tokens": torch.as_tensor(train["tokens"])},
                                     torch.as_tensor(train["q_eff"]), cfg, D.LR,
                                     mix=lambda q, plane: plane)
    for a, b in zip(flat_lib.tree_leaves(_cat_tree(outs, "train_none", 0)),
                    flat_lib.tree_leaves(params)):
        assert torch.equal(a, b)
    assert all(float(o["train_none"][1]) == float(loss) for o in outs)


def test_ring_matches_dense_cycle(worlds, reference):
    outs, ref = worlds[4], reference()
    got = _cat_tree(outs, "ring_mix")
    for k, v in got.items():
        np.testing.assert_allclose(v.numpy(), ref["ring/" + k], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("size", [2, 4])
def test_serve_step_matches_one_device(worlds, inputs, size):
    train, _ = inputs
    cfg = get_reduced(D.ARCH)
    params0 = flat_lib.tree_map(lambda p: p[0].clone(), train["params"])
    gen = torch.Generator().manual_seed(5)
    prompt = torch.randint(0, cfg.vocab_size, (D.SERVE_BATCH, D.SERVE_PROMPT), generator=gen)
    state = M.init_decode_state(cfg, D.SERVE_BATCH, D.SERVE_PROMPT + 2, device="cpu")
    want = []
    for t in range(D.SERVE_PROMPT):
        lg, state = M.decode_step(params0, cfg, prompt[:, t], state)
        want.append(lg)
    got = _cat(worlds[size], "serve")
    torch.testing.assert_close(got, torch.stack(want, dim=1), rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def sweep_plain():
    return D.run_sweep()


@pytest.mark.parametrize("size", [2, 4])
def test_sweep_on_mesh_matches_unsharded(worlds, sweep_plain, size):
    for o in worlds[size]:
        got = o["sweep"]
        for a, b in zip(flat_lib.tree_leaves(got["params"]),
                        flat_lib.tree_leaves(sweep_plain["params"])):
            torch.testing.assert_close(a, b, rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(got["accuracy"], sweep_plain["accuracy"], atol=1e-5)
        np.testing.assert_allclose(got["consensus"], sweep_plain["consensus"], rtol=1e-5,
                                   atol=1e-6)
        assert torch.equal(got["total_accept"], sweep_plain["total_accept"])
        assert o["collective_s"] > 0


def test_drain_sharded_checks_its_shapes():
    """No process group needed: the checks run before the collective."""
    class Mesh:
        axis_names, shape, size = ("data", "model"), {"data": 2, "model": 1}, 2

    with pytest.raises(ValueError, match="divisible"):
        ops.gossip_drain_sharded(torch.zeros(2, 4, 9), torch.zeros(3, 4, 4), [0, 1], Mesh())
    with pytest.raises(ValueError, match="client axes"):
        ops.gossip_drain_sharded(torch.zeros(2, 4, 8), torch.zeros(3, 4, 4), [0, 1], Mesh(),
                                 ("model",))
    with pytest.raises(ValueError, match="senders"):
        ops.gossip_drain_sharded(torch.zeros(2, 3, 8), torch.zeros(3, 3, 4), [0, 1], Mesh())
