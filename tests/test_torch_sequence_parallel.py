"""Sequence parallelism over "model" (``seq_parallel=True``) for every
family, in gloo worlds on the CPU, against the JAX package and against
the port's own step without the flag.

Three worlds run once each (`_torch_sp.world`, spawned by
`repro_torch.launch.mesh.spawn_ranks`), each for reduced qwen2 (dense),
qwen3-moe-30b-a3b (moe), mamba2-2.7b (ssm), zamba2-2.7b (hybrid),
llama-3.2-vision-11b (vlm, its cross gate at 0.5: at its init of 0 the
layer adds nothing) and musicgen-large (audio): (2, 2) and (1, 2), where
the model axis divides the 16 positions, run the train step in the
dense and none mix modes with the flag and without; (1, 3) runs
`lm_loss` and its gradients in f64 under the flag at 24 positions and
at 16, which 3 does not divide: there the residual stays whole, and the
tally says so. The JAX side runs in three subprocesses (the dense and
audio archs; the moe and vlm; the ssm and hybrid) with four host devices
and ``Auto`` meshes of the same layouts (jax 0.9's default ``Explicit``
axes make the reference's ``constrain`` raise), started before the
worlds so that all of them run at once: the reference's own
`make_train_step(..., seq_parallel=True)` in both mix modes, on the same
params, batches and ``q_eff``.

Tolerances: the f32 steps within rtol/atol 1e-5 of the reference, and
within 1e-5 of each leaf's largest |value| of the port's step without
the flag (the same numbers summed in another order: reduce-scatters and
all-gathers in place of all-reduces; ~3e-7 read); the replicated leaves
bit for bit equal across the model ranks; the f64 loss and gradients
within 1e-10 of one process (f64 is an exact witness: RoPE, the norms,
the attention scores, the cross gate, the SSM code and the moe router
compute in f64 for an f64 model; ~1e-15 read). A missing sum shows
there: a norm's scale read on the rank's positions without `TP.copy`
would keep its positions' part of the gradient alone, a moe router fed
the rank's positions alone would route other tokens, an MLP's output
reduced and not scattered would add the whole sequence to each rank's
part of the residual.
"""
import math
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_sp as SP  # noqa: E402
import _torch_tp as T  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402,F401  (autouse: one CPU thread)
from repro_torch.configs.base import get_reduced  # noqa: E402
from repro_torch.core import flat as flat_lib  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.sharding.specs import tree_param_specs  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
STEP_LAYOUTS = ((2, 2), (1, 2))  # the train steps, held against the reference
F64_LAYOUTS = ((1, 3),)
# layout: (with the train steps, with the f64 checks)
WORLDS = {layout: (layout in STEP_LAYOUTS, layout in F64_LAYOUTS)
          for layout in STEP_LAYOUTS + F64_LAYOUTS}

REFERENCE = r'''
import sys
import jax, jax.numpy as jnp
import numpy as np
from repro.configs.base import ShapeConfig, get_reduced
from repro.launch import steps
from repro.models import model as M

src, dst, lr = sys.argv[1], sys.argv[2], float(sys.argv[3])
inp = dict(np.load(src))
auto = (jax.sharding.AxisType.Auto,) * 2


def nest(prefix):
    tree = {}
    for key, v in inp.items():
        if key.startswith(prefix):
            node, path = tree, key[len(prefix):].split("/")
            for p in path[:-1]:
                node = node.setdefault(p, {})
            node[path[-1]] = jnp.asarray(v)
    return tree


def fill(tree, like):
    """`tree` with the empty sub-blocks of `like` (zamba2's "2:shared")
    put back."""
    for key, v in like.items():
        if isinstance(v, dict):
            fill(tree.setdefault(key, {}), v)
    return tree


def put(tree, sh):
    return jax.tree_util.tree_map(jax.device_put, tree, sh)


out = {}
for arch in sys.argv[4].split(","):
    cfg = get_reduced(arch)
    like = jax.eval_shape(lambda k: M.init_params(k, cfg), jax.random.PRNGKey(0))
    params = fill(nest(f"param/{arch}/"), like)
    batch = {key.split("/")[-1]: jnp.asarray(v, jnp.int32 if v.dtype.kind == "i" else None)
             for key, v in inp.items() if key.startswith(f"batch/{arch}/")}
    n, b, s = inp["tokens"].shape
    for layout in ((2, 2), (1, 2)):
        mesh = jax.make_mesh(layout, ("data", "model"), axis_types=auto,
                             devices=jax.devices()[:layout[0] * layout[1]])
        param_sh, batch_sh, q_sh = steps.make_shardings(
            mesh, cfg, ShapeConfig("t", s, n * b, "train"))
        for mode in ("dense", "none"):
            step = jax.jit(steps.make_train_step(cfg, mesh, lr=lr, mix_mode=mode,
                                                 seq_parallel=True),
                           in_shardings=(param_sh, batch_sh, q_sh),
                           out_shardings=(param_sh, None))
            new, loss = step(put(params, param_sh), put(batch, batch_sh),
                             jax.device_put(jnp.asarray(inp["q_eff"]), q_sh))
            tag = arch + "/" + "x".join(map(str, layout)) + "/" + mode
            out[f"{tag}/loss"] = np.asarray(loss)
            for path, leaf in jax.tree_util.tree_leaves_with_path(new):
                out[f"{tag}/train/" + "/".join(p.key for p in path)] = np.asarray(leaf)
np.savez(dst, **out)
print("REFERENCE_OK")
'''

# the reference's archs, each set in a subprocess of its own, all at once
REFERENCE_SETS = ((T.ARCH, T.AUDIO), (T.MOE, T.VLM), T.SSM_ARCHS)


@pytest.fixture(scope="module")
def inputs():
    return T.train_inputs()


@pytest.fixture(scope="module")
def reference(inputs, tmp_path_factory):
    """Starts the JAX subprocesses; returns a function that waits for them
    and loads their outputs."""
    root = tmp_path_factory.mktemp("reference")
    arrays = {"tokens": inputs["tokens"], "q_eff": inputs["q_eff"]}
    for arch in T.ARCHS:
        arrays.update({f"param/{arch}/" + "/".join(p): leaf.numpy()
                       for p, leaf in flat_lib.tree_items(inputs["params"][arch])})
        arrays.update({f"batch/{arch}/{k}": v for k, v in inputs["batches"][arch].items()})
    np.savez(root / "in.npz", **arrays)
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([os.path.abspath(SRC),
                                           os.environ.get("PYTHONPATH", "")]))
    procs = []
    for i, archs in enumerate(REFERENCE_SETS):  # output to files: no pipe fills and stalls
        with open(root / f"log{i}.txt", "w") as log:
            procs.append((subprocess.Popen(
                [sys.executable, "-c", REFERENCE, str(root / "in.npz"), str(root / f"out{i}.npz"),
                 str(T.LR), ",".join(archs)], env=env, stdout=log, stderr=subprocess.STDOUT),
                i))
    loaded = {}

    def wait():
        if not loaded:
            for proc, i in procs:
                proc.wait(timeout=300)
                log = (root / f"log{i}.txt").read_text()
                assert proc.returncode == 0 and "REFERENCE_OK" in log, log[-4000:]
                loaded.update(np.load(root / f"out{i}.npz"))
        return loaded

    yield wait
    for proc, _ in procs:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


@pytest.fixture(scope="module")
def worlds(inputs, reference):
    """Every world's results by layout, the worlds spawned at once (each
    rank on one thread) while the reference runs."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(len(WORLDS)) as pool:
        futures = {layout: pool.submit(mesh_lib.spawn_ranks, SP.world, math.prod(layout),
                                       layout, inputs, *what, backend="gloo", timeout=60,
                                       deadline=240)
                   for layout, what in WORLDS.items()}
        return {layout: f.result() for layout, f in futures.items()}


def _tag(layout):
    return "x".join(map(str, layout))


@pytest.mark.parametrize("arch", T.ARCHS)
@pytest.mark.parametrize("layout", STEP_LAYOUTS, ids=_tag)
@pytest.mark.parametrize("mode", SP.MODES)
def test_train_step_matches_reference(worlds, reference, arch, layout, mode):
    """Step 1 with the flag against the reference's
    `make_train_step(..., seq_parallel=True)`: the loss and every leaf,
    gathered whole on every rank."""
    ref = reference()
    tag = f"{arch}/{_tag(layout)}/{mode}"
    for o in worlds[layout]:
        got = o[arch][f"{mode}_True"]
        np.testing.assert_allclose(got["loss"], ref[f"{tag}/loss"], rtol=1e-5, atol=1e-5)
        for path, leaf in flat_lib.tree_items(got["whole"]):
            np.testing.assert_allclose(leaf.numpy(), ref[f"{tag}/train/" + "/".join(path)],
                                       rtol=1e-5, atol=1e-5, err_msg="/".join(path))


@pytest.mark.parametrize("arch", T.ARCHS)
@pytest.mark.parametrize("layout", STEP_LAYOUTS, ids=_tag)
@pytest.mark.parametrize("mode", SP.MODES)
def test_train_step_equals_the_step_without_the_flag(worlds, arch, layout, mode):
    """The flag changes where the data sits, not the numbers: every leaf
    within 1e-5 of its largest |value| of the same world's step without
    it, the losses within 1e-6; the tally shows the path each took."""
    for o in worlds[layout]:
        flat, split = o[arch][f"{mode}_False"], o[arch][f"{mode}_True"]
        assert math.isclose(split["loss"], flat["loss"], rel_tol=1e-6)
        for (path, a), b in zip(flat_lib.tree_items(split["whole"]),
                                flat_lib.tree_leaves(flat["whole"])):
            gap = float((a - b).abs().max())
            assert gap <= 1e-5 * max(float(b.abs().max()), 1e-30), (path, gap)
        assert split["routes"]["seq"] > 0 and split["routes"]["seq_whole"] == 0
        assert flat["routes"]["seq"] == flat["routes"]["seq_whole"] == 0
        assert {k: v for k, v in split["routes"].items() if not k.startswith("seq")} == \
            {k: v for k, v in flat["routes"].items() if not k.startswith("seq")}


@pytest.mark.parametrize("arch", T.ARCHS)
@pytest.mark.parametrize("layout", STEP_LAYOUTS, ids=_tag)
def test_replicated_leaves_equal_across_model_ranks(worlds, inputs, arch, layout):
    """A leaf no layout splits (the norms, the router, the gate) is bit for
    bit the same on every model rank after the flag's step, though each
    rank computed its gradient on its own positions: `TP.copy` summed
    the partials."""
    mesh = mesh_lib.Mesh.dry(layout, ("data", "model"))
    kept = {path for path, spec in flat_lib.tree_items(tree_param_specs(
        inputs["params"][arch], prefix=("data",), mesh=mesh)) if "model" not in spec}
    assert kept
    for mode in SP.MODES:
        by_data = {}
        for o in worlds[layout]:
            by_data.setdefault(o["coords"][0], []).append(o[arch][f"{mode}_True"]["local"])
        for trees in by_data.values():
            first = flat_lib.tree_items(trees[0])
            for other in trees[1:]:
                for (path, a), b in zip(first, flat_lib.tree_leaves(other)):
                    assert torch.equal(a, b) == (path in kept), (mode, path)


@pytest.mark.parametrize("layout", STEP_LAYOUTS, ids=_tag)
def test_joins_are_sequence_collectives(worlds, layout):
    """Under the flag the model axis's joins are reduce-scatters and
    all-gathers along the sequence: more of each, fewer all-reduces (the
    norms' and gate's gradients, the vocab-parallel loss's sums stay
    all-reduces)."""
    for arch in T.ARCHS:
        o = worlds[layout][0][arch]
        flat, split = o["dense_False"]["counts"], o["dense_True"]["counts"]
        assert split["model_reduce_scatter"] > flat["model_reduce_scatter"], arch
        assert split["model_all_gather"] > flat["model_all_gather"], arch
        assert split["model_all_reduce"] < flat["model_all_reduce"], arch
        assert split["reduce_scatter"] == flat["reduce_scatter"] == 1, arch


@pytest.mark.parametrize("arch", T.ARCHS)
@pytest.mark.parametrize("layout", F64_LAYOUTS, ids=_tag)
def test_loss_and_gradients_in_f64(worlds, inputs, arch, layout):
    """`lm_loss` in both loss forms and on the flash path, and every
    gradient, under the flag's context against one process within 1e-10,
    at 16 and 24 positions: split along the sequence where the model
    axis divides them, whole (tallied ``seq_whole``) where it does not."""
    cfg = get_reduced(arch).with_(dtype="float64")
    whole = flat_lib.tree_map(lambda p: p[0].double(), inputs["params"][arch])
    for seq in SP.F64_SEQS:
        batch = {k: torch.as_tensor(v) for k, v in SP.f64_batch(get_reduced(arch), seq).items()}
        for name, kw in SP.f64_forms():
            params = flat_lib.tree_map(lambda p: p.clone().requires_grad_(), whole)
            loss = M.lm_loss(params, cfg, batch, **kw)
            grads = torch.autograd.grad(loss, flat_lib.tree_leaves(params),
                                        materialize_grads=True)
            split = seq % layout[1] == 0
            for o in worlds[layout]:
                got = o[arch][f"{name}_{seq}"]
                assert (got["routes"]["seq"] > 0) == split
                assert (got["routes"]["seq_whole"] > 0) == (not split)
                assert math.isclose(got["loss"], float(loss.detach()), rel_tol=1e-12)
                for (path, g), want in zip(flat_lib.tree_items(got["grads"]), grads):
                    torch.testing.assert_close(g, want, rtol=1e-10, atol=1e-10,
                                               msg=f"{name} S={seq} {path}")
