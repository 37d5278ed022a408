"""Tensor parallelism over "model" for the dense family, in gloo worlds of
4 ranks on the CPU, against the JAX package.

Three worlds run once each (`_torch_tp.world`, spawned by
`repro_torch.launch.mesh.spawn_ranks`), each doing every check of its
layout: (2, 2), where reduced qwen2's 6 query and 2 kv heads split at
whole heads (the heads route); (1, 4), where every attention shard cuts
a head (the gathered route); and (1, 3), held against one process,
where the query heads split whole but the 2 kv heads and the vocabulary
of 512 do not divide, so each rank picks its query heads' kv heads out
of all of them and the embedding, head and loss stay whole. The JAX
side runs once, in one
subprocess with four host devices and ``Auto`` meshes of the same
layouts (jax 0.9's default ``Explicit`` axes make the reference's
``constrain`` raise), started before the worlds so that both run at
once: the reference's own `make_train_step` in each mix mode, and its
prefill and serve steps at (2, 2), on the same params, tokens and
``q_eff``.

Tolerances: the f32 train steps within rtol/atol 1e-5 of the reference
(f32 sums re-associated across ranks; 3e-8 read), the bf16 mix within
1e-4 (a mixed delta that rounds to the other side of a bf16 step moves
by one step of its value: here |delta| < 0.02, a step under 8e-5; 1.5e-5
read), prefill and serve logits within 1e-5 (3.3e-6 read); the round trip of
`shard_params` and `gather_params` and the replicated leaves across the
model ranks exact; the f64 loss and gradients within 1e-10 of one
process, 1e-6 at (1, 3), where the rank's query heads read their kv
heads through a pick: the attention scores are f32 for every dtype (as
the reference's), and the picked layout sums them in another order, so
a score rounds to the other side of an f32 step now and then (3.5e-8 of
the largest gradient read).
"""
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import _torch_dist as D
import _torch_tp as T
from _torch_threads import one_torch_thread  # noqa: F401  (autouse: torch on one thread)
from repro_torch.configs.base import ARCH_IDS, SHAPES, get_config, get_reduced
from repro_torch.core import flat as flat_lib
from repro_torch.launch import dryrun, steps
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import train as ttrain
from repro_torch.models import layers
from repro_torch.models import model as M
from repro_torch.sharding import axes
from repro_torch.sharding import tp as tp_lib
from repro_torch.sharding.specs import tree_param_specs

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
LAYOUTS = ((2, 2), (1, 4))  # held against the reference
WORLDS = LAYOUTS + ((1, 3),)

REFERENCE = r'''
import sys
import jax, jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs.base import ShapeConfig, get_reduced
from repro.launch import steps
from repro.models import model as M

src, dst, lr = sys.argv[1], sys.argv[2], float(sys.argv[3])
inp = dict(np.load(src))
assert len(jax.devices()) == 4
auto = (jax.sharding.AxisType.Auto,) * 2


def nest(prefix, rows=None):
    tree = {}
    for key, v in inp.items():
        if key.startswith(prefix):
            node, path = tree, key[len(prefix):].split("/")
            for p in path[:-1]:
                node = node.setdefault(p, {})
            node[path[-1]] = jnp.asarray(v if rows is None else v[rows])
    return tree


def put(tree, sh):
    return jax.tree_util.tree_map(jax.device_put, tree, sh)


cfg = get_reduced("qwen2-1.5b")
out = {}
modes = {"dense": ("dense", None), "dense-bf16": ("dense", jnp.bfloat16),
         "none": ("none", None), "ring": ("ring", None)}
for layout in ((2, 2), (1, 4)):
    mesh = jax.make_mesh(layout, ("data", "model"), axis_types=auto)
    tag = "x".join(map(str, layout))
    for name, (mode, md) in modes.items():
        n = layout[0] if mode == "ring" else len(inp["tokens"])
        params = nest("param/", slice(0, n))
        tokens = jnp.asarray(inp["tokens"][:n], jnp.int32)
        _, b, s = tokens.shape
        param_sh, batch_sh, q_sh = steps.make_shardings(
            mesh, cfg, ShapeConfig("t", s, n * b, "train"))
        step = jax.jit(steps.make_train_step(cfg, mesh, lr=lr, mix_mode=mode, mix_dtype=md),
                       in_shardings=(param_sh, batch_sh, q_sh),
                       out_shardings=(param_sh, None))
        new, loss = step(put(params, param_sh),
                         {"tokens": jax.device_put(tokens, batch_sh["tokens"])},
                         jax.device_put(jnp.asarray(inp["q_eff"][:n, :n]), q_sh))
        out[f"{tag}/loss/{name}"] = np.asarray(loss)
        for path, leaf in jax.tree_util.tree_leaves_with_path(new):
            out[f"{tag}/train/{name}/" + "/".join(p.key for p in path)] = np.asarray(leaf)
    if layout != (2, 2):
        continue
    params0 = nest("param/", 0)
    prompt = jnp.asarray(inp["prompt"], jnp.int32)
    B, L = prompt.shape
    pshape = ShapeConfig("prefill", L, B, "prefill")
    psh = steps.serve_shardings(mesh, cfg, pshape)[0]
    prefill = jax.jit(steps.make_prefill_step(cfg, pshape, mesh),
                      in_shardings=(psh, {"tokens": NamedSharding(mesh, P("data", None))}))
    out["prefill"] = np.asarray(prefill(put(params0, psh), {"tokens": prompt}))
    shape = ShapeConfig("serve", L + 2, B, "decode")
    param_sh, tok_sh, state_sh, _, scfg = steps.serve_shardings(mesh, cfg, shape)
    serve = jax.jit(steps.make_serve_step(cfg, shape, mesh),
                    in_shardings=(param_sh, tok_sh, state_sh))
    state = put(M.init_decode_state(scfg, B, shape.seq_len), state_sh)
    p0 = put(params0, param_sh)
    logits = []
    for t in range(L):
        lg, state = serve(p0, jax.device_put(prompt[:, t], tok_sh), state)
        logits.append(np.asarray(lg))
    out["serve"] = np.stack(logits, axis=1)
np.savez(dst, **out)
print("REFERENCE_OK")
'''


@pytest.fixture(scope="module")
def inputs():
    return D.train_inputs()


@pytest.fixture(scope="module")
def reference(inputs, tmp_path_factory):
    """Starts the JAX subprocess; returns a function that waits for it and
    loads its outputs."""
    root = tmp_path_factory.mktemp("reference")
    arrays = {"tokens": inputs["tokens"], "q_eff": inputs["q_eff"],
              "prompt": T.serve_inputs()[0].numpy()}
    arrays.update({"param/" + "/".join(p): leaf.numpy()
                   for p, leaf in flat_lib.tree_items(inputs["params"])})
    np.savez(root / "in.npz", **arrays)
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([os.path.abspath(SRC),
                                           os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.Popen([sys.executable, "-c", REFERENCE, str(root / "in.npz"),
                             str(root / "out.npz"), str(T.LR)], env=env,
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
    return {layout: mesh_lib.spawn_ranks(T.world, math.prod(layout), layout, inputs,
                                         backend="gloo", timeout=60, deadline=240)
            for layout in WORLDS}


def _tag(layout):
    return "x".join(map(str, layout))


def _close(got, want, tol, what):
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol, err_msg=what)


@pytest.mark.parametrize("layout", LAYOUTS, ids=_tag)
@pytest.mark.parametrize("mode", [m for m, _, _ in T.MODES])
def test_train_step_matches_reference(worlds, reference, layout, mode):
    outs, ref = worlds[layout], reference()
    tol = 1e-4 if mode == "dense-bf16" else 1e-5
    for o in outs:
        _close(o[f"train_{mode}"]["loss"], ref[f"{_tag(layout)}/loss/{mode}"], 1e-5,
               "loss")
    for o in outs:  # every rank gathers the same whole tree
        for path, leaf in flat_lib.tree_items(o[f"train_{mode}"]["whole"]):
            _close(leaf.numpy(), ref[f"{_tag(layout)}/train/{mode}/" + "/".join(path)], tol,
                   "/".join(path))


@pytest.mark.parametrize("layout", WORLDS, ids=_tag)
def test_replicated_leaves_equal_across_model_ranks(worlds, inputs, layout):
    """A leaf the layout keeps whole (no "model" in its spec: the norms and
    biases, and at (1, 3) wk, wv and the embedding) is bit for bit the same
    on every model rank after the step; a sharded one differs between
    them."""
    mesh = mesh_lib.Mesh.dry(layout, ("data", "model"))
    kept = {path for path, spec in flat_lib.tree_items(
        tree_param_specs(inputs["params"], prefix=("data",), mesh=mesh)) if "model" not in spec}
    outs = worlds[layout]
    for mode, _, _ in T.MODES:
        by_data = {}
        for o in outs:
            by_data.setdefault(o["coords"][0], []).append(o[f"train_{mode}"]["local"])
        for trees in by_data.values():
            first = flat_lib.tree_items(trees[0])
            for other in trees[1:]:
                for (path, a), b in zip(first, flat_lib.tree_leaves(other)):
                    assert torch.equal(a, b) == (path in kept), (mode, path)


def test_routes_and_tally(worlds):
    """(2, 2) and (1, 3) take the heads route in every attention layer,
    (1, 4) the gathered one with all four projections gathered; the
    step's model collectives are tallied apart from the client ones."""
    for layout, route in (((2, 2), "heads"), ((1, 4), "gathered"), ((1, 3), "heads")):
        o = worlds[layout][0]["train_dense"]
        layers_run = 2 * (T.N // layout[0])  # 2 layers of each of the rank's clients
        gathered = 4 * layers_run if route == "gathered" else 0
        assert o["routes"] == {"heads": layers_run if route == "heads" else 0,
                               "gathered": layers_run if route == "gathered" else 0,
                               "gathered_leaves": gathered}
        counts = o["tally"]["_counts"]
        assert counts["model_all_reduce"] > 0 and counts["reduce_scatter"] == 1
        assert (counts["model_all_gather"] > 0) == (route == "gathered")


@pytest.mark.parametrize("layout", WORLDS, ids=_tag)
def test_shard_and_gather_round_trip(worlds, inputs, layout):
    f32 = inputs["params"]
    wants = [f32, flat_lib.tree_map(lambda p: p.to(torch.bfloat16), f32),
             flat_lib.tree_map(lambda p: p[0], f32)]
    for o in worlds[layout]:
        for got, want in zip(o["round_trip"], wants):
            for (path, a), b in zip(flat_lib.tree_items(got), flat_lib.tree_leaves(want)):
                assert a.dtype == b.dtype and torch.equal(a, b), path


def test_prefill_and_serve_match_reference(worlds, reference):
    outs, ref = worlds[(2, 2)], reference()
    by_rows = {o["coords"][0]: o for o in outs}  # model ranks return the same rows
    for key in ("prefill", "serve"):
        got = torch.cat([by_rows[r][key] for r in sorted(by_rows)])
        _close(got.numpy(), ref[key], 1e-5, key)
    assert all(o["cache_heads"] == 1 for o in outs)  # 2 kv heads over 2 model ranks


@pytest.mark.parametrize("layout", ((1, 4), (1, 3)), ids=_tag)
def test_serve_on_one_client_rank_matches_one_device(worlds, inputs, layout):
    cfg = get_reduced(T.ARCH)
    params0 = flat_lib.tree_map(lambda p: p[0], inputs["params"])
    prompt, shape = T.serve_inputs()
    state = M.init_decode_state(cfg, T.SERVE_BATCH, shape.seq_len, device="cpu")
    want = []
    for t in range(T.SERVE_PROMPT):
        lg, state = M.decode_step(params0, cfg, prompt[:, t], state)
        want.append(lg)
    for o in worlds[layout]:
        torch.testing.assert_close(o["serve"], torch.stack(want, dim=1), rtol=1e-5, atol=1e-5)
        assert o["cache_heads"] == cfg.num_kv_heads  # 2 kv heads do not divide by 4 or 3


@pytest.mark.parametrize("mode", ["dense", "none"])
def test_picked_kv_heads_and_whole_vocab_match_one_device(worlds, inputs, mode):
    """(1, 3): the train step against the port's single-device step."""
    cfg = get_reduced(T.ARCH)
    params = flat_lib.tree_map(torch.clone, inputs["params"])
    mix = (lambda q, plane: plane) if mode == "none" else None
    params, loss = ttrain.train_step(params, {"tokens": torch.as_tensor(inputs["tokens"])},
                                     torch.as_tensor(inputs["q_eff"]), cfg, T.LR, mix=mix)
    for o in worlds[(1, 3)]:
        got = o[f"train_{mode}"]
        assert math.isclose(got["loss"], float(loss), rel_tol=1e-6)
        for (path, a), b in zip(flat_lib.tree_items(got["whole"]), flat_lib.tree_leaves(params)):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5, msg=str(path))


@pytest.mark.parametrize("layout", WORLDS, ids=_tag)
def test_loss_forms_and_gradients_in_f64(worlds, inputs, layout):
    """The vocab-parallel cross-entropy in both loss forms, the flash and
    blocked attention, and the operators' gradients against one process,
    in f64 (see the module docstring for (1, 3)'s bound)."""
    from repro_torch.models import attention

    tol = 1e-6 if layout == (1, 3) else 1e-10
    cfg = get_reduced(T.ARCH).with_(dtype="float64")
    whole = flat_lib.tree_map(lambda p: p[0].double(), inputs["params"])
    batch = {"tokens": torch.as_tensor(inputs["tokens"][0])}
    for name, kw in (("f64_0", {}), (f"f64_{T.CHUNK}", {"vocab_chunk": T.CHUNK}),
                     ("f64_flash", {"blocked_attn_threshold": T.FLASH_FROM})):
        params = flat_lib.tree_map(lambda p: p.clone().requires_grad_(), whole)
        loss = M.lm_loss(params, cfg, batch, **kw)
        grads = torch.autograd.grad(loss, flat_lib.tree_leaves(params))
        for o in worlds[layout]:
            got = o[name]
            assert math.isclose(got["loss"], float(loss.detach()), rel_tol=1e-12)
            for (path, g), want in zip(flat_lib.tree_items(got["grads"]), grads):
                torch.testing.assert_close(g, want, rtol=tol, atol=tol, msg=str(path))
    ap = M._unbind_groups(whole["groups"], cfg.num_layers)[0]["0:attn"]["attn"]
    want = attention.blocked_attention(ap, T.attention_input(cfg), cfg, block_q=T.BLOCK,
                                       block_kv=T.BLOCK)
    for o in worlds[layout]:
        torch.testing.assert_close(o["blocked"], want, rtol=tol, atol=tol)
    logits, labels = T.loss_inputs()
    mask = torch.ones(labels.shape, dtype=torch.float64)
    mask[:, -1] = 0.0
    logits = logits.clone().requires_grad_()
    ce = layers.cross_entropy(logits, labels, mask).detach()
    (g,) = torch.autograd.grad(layers.cross_entropy(logits, labels, mask), [logits])
    for o in worlds[layout]:
        if layout == (1, 3):  # 512 does not divide by 3: no vocab-parallel loss
            assert "ce" not in o
            continue
        assert math.isclose(o["ce"]["loss"], float(ce), rel_tol=1e-12)
        torch.testing.assert_close(o["ce"]["grad"], g, rtol=1e-12, atol=1e-14)


def _jax_local_shapes(cfg, mesh):
    """The reference's blocks at (16, 16): its `tree_param_specs` over the
    client-stacked abstract params, each dim divided by its axes' size."""
    import jax

    from repro.launch import steps as jsteps
    from repro.sharding.specs import tree_param_specs

    params = jsteps.stack_clients_abstract(jsteps.param_specs_abstract(cfg), 16)
    specs = tree_param_specs(params, prefix=("data",), mesh=mesh)
    leaves = jax.tree_util.tree_leaves_with_path(params)
    spec_leaves = jax.tree_util.tree_leaves(specs, is_leaf=lambda s: isinstance(
        s, jax.sharding.PartitionSpec))
    out = {}
    for (path, leaf), spec in zip(leaves, spec_leaves):
        shape = tuple(d // (1 if ax is None else 16) for d, ax in
                      zip(leaf.shape, tuple(spec) + (None,) * len(leaf.shape)))
        out[tuple(p.key for p in path)] = shape
    return out


DENSE = [a for a in ARCH_IDS if get_config(a).family == "dense"]


@pytest.mark.parametrize("arch", DENSE)
def test_production_blocks_equal_the_reference(arch):
    """At (16, 16) on ``meta``: the port's blocks of every dense config,
    cut at init (`tp.shard_leaf`) and by the dry run (`local_abstract`),
    have the shapes of the reference's `tree_param_specs` shards."""
    from repro.configs.base import get_config as jget_config

    class FakeMesh:  # the reference reads only the axis sizes
        axis_names, shape = ("data", "model"), {"data": 16, "model": 16}

    cfg = get_config(arch)
    mesh = mesh_lib.Mesh.dry((16, 16), ("data", "model"))
    want = _jax_local_shapes(jget_config(arch), FakeMesh())
    pspecs, _, _ = steps.make_shardings(mesh, cfg, SHAPES["train_4k"])
    dry = steps.local_abstract(steps.stack_clients_abstract(steps.param_specs_abstract(cfg),
                                                            16), pspecs, mesh)
    init = M.init_params(steps._MetaGenerator(), cfg, shard=tp_lib.sharder(mesh))
    for (path, a), b in zip(flat_lib.tree_items(dry), flat_lib.tree_leaves(init)):
        assert tuple(a.shape) == want[path] == (1,) + tuple(b.shape), (arch, path)
    assert set(want) == {p for p, _ in flat_lib.tree_items(dry)}


NON_DENSE = [a for a in ARCH_IDS if get_config(a).family != "dense"]


@pytest.mark.parametrize("arch", NON_DENSE)
def test_other_families_raise_naming_their_item(arch):
    cfg = get_reduced(arch)
    mesh = mesh_lib.Mesh.dry((2, 2), ("data", "model"))
    shape = SHAPES["decode_32k"]
    for make in (lambda: steps.make_train_step(cfg, mesh),
                 lambda: steps.make_prefill_step(cfg, shape, mesh),
                 lambda: steps.make_serve_step(cfg, shape, mesh)):
        with pytest.raises(NotImplementedError, match=r"ROADMAP item 20\([bcd]\)"):
            make()
    with pytest.raises(NotImplementedError, match=r"ROADMAP item 20\([bcd]\)"):
        dryrun.lower_pair(arch, "decode_32k", cfg=cfg, verbose=False)
    steps.make_train_step(cfg, mesh_lib.Mesh.dry((2, 1), ("data", "model")))  # clients only


def test_seq_parallel_and_cache_layouts_raise_naming_their_item():
    cfg = get_reduced(T.ARCH)
    mesh = mesh_lib.Mesh.dry((2, 2), ("data", "model"))
    with pytest.raises(NotImplementedError, match=r"ROADMAP item 20\(e\)"):
        axes.train_rules(mesh, seq_parallel=True)
    with pytest.raises(NotImplementedError, match=r"ROADMAP item 20\(e\)"):
        dryrun.lower_pair(T.ARCH, "train_4k", cfg=cfg, seq_parallel=True, verbose=False)
    for cache_shard in ("head_dim", "seq"):
        with pytest.raises(NotImplementedError, match=r"ROADMAP item 20\(f\)"):
            dryrun.lower_pair(T.ARCH, "decode_32k", cfg=cfg, cache_shard=cache_shard,
                              verbose=False)
    assert axes.train_rules(mesh).rules["heads"] == "model"
