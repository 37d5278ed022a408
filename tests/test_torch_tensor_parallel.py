"""Tensor parallelism over "model" for every family, in gloo worlds of 4
ranks on the CPU, against the JAX package.

Three worlds run once each (`_torch_tp.world`, spawned by
`repro_torch.launch.mesh.spawn_ranks`), each doing every check of its
layout for reduced qwen2 (dense: 6 query and 2 kv heads), reduced
qwen3-moe-30b-a3b (moe: 4 experts, top-2, 4 query over 2 kv heads) and
reduced mamba2-2.7b and zamba2-2.7b (ssm and hybrid: 16 ssm heads, one
group; zamba2's shared block 4 heads): (2, 2), where qwen2's heads split
at whole heads (the heads route), each rank runs 2 experts and computes
8 ssm heads; (1, 4), where every qwen2 attention shard cuts a head (the
padded route: ranks take 2, 2, 2 and 0 of the 6 heads), each rank runs
1 expert and computes 4 ssm heads; and (1, 3), held against one process,
where qwen2's query heads split whole but the 2 kv heads and the
vocabulary of 512 do not divide, so each rank slices its query heads'
kv heads out of all of them and the embedding, head and loss stay
whole, where the 4 experts do not divide either, so every rank runs
them all, and where the 16 ssm heads split 6, 6 and 4 (the padded
split) out of replicated head leaves (mamba2's in_proj and conv still
blocks, zamba2's whole). Reduced llama-3.2-vision-11b (vlm: a
self-attention and a cross layer of 4 query heads over 2 kv heads of 64,
16 patch tokens, the cross layer's gate set to 0.5, since at its init of
0 the layer adds nothing and its projections' gradients are exactly 0 on
any layout) splits at whole heads at (2, 2), cuts its kv heads inside a
head at (1, 4) (gathered, each rank slicing the kv head its query head
reads) and keeps ``wq`` whole at (1, 3); reduced musicgen-large (audio:
4 heads over 4 kv heads, a vocabulary of 128, frame embeddings in)
splits at whole heads and vocab-parallel at (2, 2) and (1, 4) and stays
whole at (1, 3), and its serving feeds back tokens' embeddings looked up
vocab-parallel. The JAX side runs once, in two subprocesses
(the dense, moe and audio archs; the ssm, hybrid and vlm ones) with four host
devices each and ``Auto`` meshes of the same layouts (jax 0.9's default
``Explicit`` axes make the reference's ``constrain`` raise), started
before the worlds so that all run at once: the reference's own
`make_train_step` in each mix mode, and its prefill and serve steps at
(2, 2), on the same params, tokens and ``q_eff``; and its serve step of
reduced qwen2 with a ring of 4 slots under each decode cache layout of
`_torch_tp.CACHE_CASES` (its `serve_shardings` of that layout) at (2, 2)
and (1, 4), which the ranks serve under `steps.cache_layout`.

Tolerances: the f32 train steps within rtol/atol 1e-5 of the reference
(f32 sums re-associated across ranks; 3e-8 read), the bf16 mix within
1e-4 (a mixed delta that rounds to the other side of a bf16 step moves
by one step of its value: here |delta| < 0.02, a step under 8e-5; 1.5e-5
read), prefill and serve logits within 1e-5 (3.3e-6 read); the round trip of
`shard_params` and `gather_params` and the replicated leaves across the
model ranks exact; the f64 loss and gradients within 1e-10 of one
process at every layout (RoPE, the norms and the attention scores
compute in f64 for an f64 model, so a kv head's gradient summed over
the ranks that read it is not rounded to f32 part by part, and a
softmax's rounding does not hang on how many heads one call holds;
7e-16 read). A wrong operator shows there: a router
gradient summed over the ranks (a `TP.copy` on the moe layer's input)
would double it at (2, 2); a Mamba2 block's gated-norm sum of squares
reduced forward only (`TP.reduce` without its `TP.copy`) would leave
each rank's gradient through the norm partial, its channels' share of
the cross term alone; a `TP.copy` on B or C (computed whole on every
rank) would sum their gradient over the ranks on top of the
reduce-scatter that already does, counting it T times.
"""
import json
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
import json
import sys
import jax, jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs.base import ShapeConfig, get_reduced
from repro.launch import steps
from repro.models import model as M

src, dst, lr = sys.argv[1], sys.argv[2], float(sys.argv[3])
cache = json.loads(sys.argv[5])  # the decode cache's layouts: window, cases by layout
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


def fill(tree, like):
    """`tree` with the empty sub-blocks of `like` (zamba2's "2:shared",
    which the npz cannot hold) put back."""
    for key, v in like.items():
        if isinstance(v, dict):
            fill(tree.setdefault(key, {}), v)
    return tree


def put(tree, sh):
    return jax.tree_util.tree_map(jax.device_put, tree, sh)


out = {}
modes = {"dense": ("dense", None), "dense-bf16": ("dense", jnp.bfloat16),
         "none": ("none", None), "ring": ("ring", None)}
def arrays(prefix, rows=slice(None)):
    """The npz's arrays under `prefix` by their last key, integers as int32."""
    return {key[len(prefix):]: jnp.asarray(v[rows], jnp.int32 if v.dtype.kind == "i" else None)
            for key, v in inp.items() if key.startswith(prefix)}


for arch, layout in [(a, l) for a in sys.argv[4].split(",") for l in ((2, 2), (1, 4))]:
    cfg = get_reduced(arch)
    like = jax.eval_shape(lambda k: M.init_params(k, cfg), jax.random.PRNGKey(0))
    mesh = jax.make_mesh(layout, ("data", "model"), axis_types=auto)
    tag = arch + "/" + "x".join(map(str, layout))
    for name, (mode, md) in modes.items():
        n = layout[0] if mode == "ring" else len(inp["tokens"])
        params = fill(nest(f"param/{arch}/", slice(0, n)), like)
        batch = arrays(f"batch/{arch}/", slice(0, n))
        _, b, s = inp["tokens"].shape
        param_sh, batch_sh, q_sh = steps.make_shardings(
            mesh, cfg, ShapeConfig("t", s, n * b, "train"))
        step = jax.jit(steps.make_train_step(cfg, mesh, lr=lr, mix_mode=mode, mix_dtype=md),
                       in_shardings=(param_sh, batch_sh, q_sh),
                       out_shardings=(param_sh, None))
        new, loss = step(put(params, param_sh), put(batch, batch_sh),
                         jax.device_put(jnp.asarray(inp["q_eff"][:n, :n]), q_sh))
        out[f"{tag}/loss/{name}"] = np.asarray(loss)
        for path, leaf in jax.tree_util.tree_leaves_with_path(new):
            out[f"{tag}/train/{name}/" + "/".join(p.key for p in path)] = np.asarray(leaf)
    if arch == "qwen2-1.5b":  # the serve step under each cache layout (serve_shardings)
        ccfg = cfg.with_(sliding_window=cache["window"])
        ctoks = inp["cache_tokens"]
        p0 = fill(nest(f"param/{arch}/", 0), like)
        for name, B, cache_shard in cache["cases"].get("x".join(map(str, layout)), []):
            cshape = ShapeConfig("serve", ctoks.shape[1], B, "decode")
            param_sh, tok_sh, state_sh, _, scfg = steps.serve_shardings(mesh, ccfg, cshape,
                                                                        cache_shard)
            state = put(M.init_decode_state(scfg, B, cshape.seq_len), state_sh)
            serve = jax.jit(steps.make_serve_step(ccfg, cshape, mesh),
                            in_shardings=(param_sh, tok_sh, state_sh))
            pc, logits = put(p0, param_sh), []
            for t in range(cshape.seq_len):
                tok = jax.device_put(jnp.asarray(ctoks[:B, t], jnp.int32), tok_sh)
                lg, state = serve(pc, tok, state)
                logits.append(np.asarray(lg))
            out[f"cache/{tag}/{name}"] = np.stack(logits, axis=1)
    if layout != (2, 2):
        continue
    params0 = fill(nest(f"param/{arch}/", 0), like)
    prompt = arrays(f"prompt/{arch}/")
    feed = prompt.pop("feed", None)  # an audio model's fed-back tokens
    B, L = next(iter(prompt.values())).shape[:2]
    pshape = ShapeConfig("prefill", L, B, "prefill")
    psh = steps.serve_shardings(mesh, cfg, pshape)[0]
    prefill = jax.jit(steps.make_prefill_step(cfg, pshape, mesh), in_shardings=(
        psh, {k: NamedSharding(mesh, P("data", *[None] * (v.ndim - 1)))
              for k, v in prompt.items()}))
    out[f"{arch}/prefill"] = np.asarray(prefill(put(params0, psh), prompt))
    shape = ShapeConfig("serve", L + 2, B, "decode")
    param_sh, tok_sh, state_sh, cross_sh, scfg = steps.serve_shardings(mesh, cfg, shape)
    state = put(M.init_decode_state(scfg, B, shape.seq_len), state_sh)
    p0 = put(params0, param_sh)
    if cross_sh is None:
        serve = jax.jit(steps.make_serve_step(cfg, shape, mesh),
                        in_shardings=(param_sh, tok_sh, state_sh))
    else:
        cross = put(M.init_cross_kv(params0, scfg, prompt["cross_embeds"]), cross_sh)
        serve = jax.jit(lambda p, t, s: steps.make_serve_step(cfg, shape, mesh)(p, t, s, cross),
                        in_shardings=(param_sh, tok_sh, state_sh))
    if cfg.embeds_in:
        inputs = [prompt["embeds"][:, t:t + 1] for t in range(L)] + [
            params0["embed"][feed[:, j]][:, None, :] for j in range(feed.shape[1])]
    else:
        inputs = [prompt["tokens"][:, t] for t in range(L)]
    logits = []
    for x in inputs:
        lg, state = serve(p0, jax.device_put(x, tok_sh), state)
        logits.append(np.asarray(lg))
    out[f"{arch}/serve"] = np.stack(logits, axis=1)
np.savez(dst, **out)
print("REFERENCE_OK")
'''


@pytest.fixture(scope="module")
def inputs():
    return T.train_inputs()


# the reference's archs, each set in a subprocess of its own, both at once
REFERENCE_SETS = ((T.ARCH, T.MOE, T.AUDIO), T.SSM_ARCHS + (T.VLM,))
CACHE_ARG = json.dumps({"window": T.CACHE_WINDOW, "cases": {
    "x".join(map(str, lay)): [list(c) for c in cases] for lay, cases in T.CACHE_CASES.items()}})


@pytest.fixture(scope="module")
def reference(inputs, tmp_path_factory):
    """Starts the JAX subprocesses (one for each of `REFERENCE_SETS`);
    returns a function that waits for them and loads their outputs."""
    root = tmp_path_factory.mktemp("reference")
    arrays = {"tokens": inputs["tokens"], "q_eff": inputs["q_eff"],
              "cache_tokens": T.cache_tokens().numpy()}
    for arch in T.ARCHS:
        arrays.update({f"param/{arch}/" + "/".join(p): leaf.numpy()
                       for p, leaf in flat_lib.tree_items(inputs["params"][arch])})
        arrays.update({f"batch/{arch}/{k}": v for k, v in inputs["batches"][arch].items()})
        arrays.update({f"prompt/{arch}/{k}": v.numpy()
                       for k, v in T.serve_prompt(get_reduced(arch)).items()})
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
                 str(T.LR), ",".join(archs), CACHE_ARG], env=env, stdout=log,
                stderr=subprocess.STDOUT),
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
    return {layout: mesh_lib.spawn_ranks(T.world, math.prod(layout), layout, inputs,
                                         backend="gloo", timeout=60, deadline=240)
            for layout in WORLDS}


def _tag(layout):
    return "x".join(map(str, layout))


def _close(got, want, tol, what):
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol, err_msg=what)


# the heads each model rank caches, in rank order: a KV cache's kv heads
# (`attention.rank_heads`: qwen2's 6 query heads read kv head h // 3, moe's
# 4 read h // 2, zamba2's shared block's 4 their own, all of them at (1, 3)
# where its wq does not split) and an SSM state's ssm heads
# (`ssm.rank_ssm_heads`: ceil(16 / T) a rank, 6, 6 and 4 at (1, 3))
_SSM_HEADS = {(2, 2): [8, 8], (1, 4): [4, 4, 4, 4], (1, 3): [6, 6, 4]}
CACHE_HEADS = {(T.ARCH, (2, 2)): {"0:attn": [1, 1]},
               (T.ARCH, (1, 4)): {"0:attn": [1, 2, 1, 0]},
               (T.ARCH, (1, 3)): {"0:attn": [1, 2, 1]},
               (T.MOE, (2, 2)): {"0:attn": [1, 1]},
               (T.MOE, (1, 4)): {"0:attn": [1, 1, 1, 1]},
               (T.MOE, (1, 3)): {"0:attn": [2, 2, 2]},
               **{(T.MAMBA, lay): {"0:ssm": h} for lay, h in _SSM_HEADS.items()},
               **{(T.ZAMBA, lay): {"0:ssm": h, "2:shared": kv} for (lay, h), kv in
                  zip(_SSM_HEADS.items(), ([2, 2], [1, 1, 1, 1], [4, 4, 4]))},
               # the vlm's 4 query heads read kv head h // 2, in its
               # self-attention cache and its cross K/V alike; musicgen's 4
               # read their own
               **{(T.VLM, lay): {"0:attn": kv, "cross": kv} for lay, kv in
                  (((2, 2), [1, 1]), ((1, 4), [1, 1, 1, 1]), ((1, 3), [2, 2, 2]))},
               **{(T.AUDIO, lay): {"0:attn": kv} for lay, kv in
                  (((2, 2), [2, 2]), ((1, 4), [1, 1, 1, 1]), ((1, 3), [4, 4, 4]))}}


def _cache_heads(outs, arch, want):
    """Each cache's heads on the ranks `outs` against `want` ({cache:
    heads per rank}); an SSM state's conv channels are its heads' x and
    the B and C of its one group."""
    cfg = get_reduced(arch)
    for name, heads in want.items():
        got = [o[arch]["cache_heads"][name] for o in outs]
        assert [g[0] for g in got] == heads, (arch, name, got)
        if name.endswith(":ssm"):
            assert [g[1] for g in got] == [h * cfg.ssm_head_dim + 2 * cfg.ssm_state
                                           for h in heads], (arch, name, got)


def _train_matches(worlds, reference, arch, layout, mode):
    outs, ref = worlds[layout], reference()
    tag = f"{arch}/{_tag(layout)}"
    tol = 1e-4 if mode == "dense-bf16" else 1e-5
    for o in outs:
        _close(o[arch][f"train_{mode}"]["loss"], ref[f"{tag}/loss/{mode}"], 1e-5, "loss")
    for o in outs:  # every rank gathers the same whole tree
        for path, leaf in flat_lib.tree_items(o[arch][f"train_{mode}"]["whole"]):
            _close(leaf.numpy(), ref[f"{tag}/train/{mode}/" + "/".join(path)], tol,
                   "/".join(path))


def _replicated_equal(worlds, inputs, arch, layout):
    mesh = mesh_lib.Mesh.dry(layout, ("data", "model"))
    kept = {path for path, spec in flat_lib.tree_items(tree_param_specs(
        inputs["params"][arch], prefix=("data",), mesh=mesh)) if "model" not in spec}
    for mode, _, _ in T.MODES:
        by_data = {}
        for o in worlds[layout]:
            by_data.setdefault(o["coords"][0], []).append(o[arch][f"train_{mode}"]["local"])
        for trees in by_data.values():
            first = flat_lib.tree_items(trees[0])
            for other in trees[1:]:
                for (path, a), b in zip(first, flat_lib.tree_leaves(other)):
                    assert torch.equal(a, b) == (path in kept), (mode, path)
    return kept


def _round_trip(worlds, inputs, arch, layout):
    f32 = inputs["params"][arch]
    wants = [f32, flat_lib.tree_map(lambda p: p.to(torch.bfloat16), f32),
             flat_lib.tree_map(lambda p: p[0], f32)]
    for o in worlds[layout]:
        for got, want in zip(o[arch]["round_trip"], wants):
            for (path, a), b in zip(flat_lib.tree_items(got), flat_lib.tree_leaves(want)):
                assert a.dtype == b.dtype and torch.equal(a, b), path


def _serving_matches_reference(worlds, reference, arch):
    outs, ref = worlds[(2, 2)], reference()
    by_rows = {o["coords"][0]: o[arch] for o in outs}  # model ranks return the same rows
    for key in ("prefill", "serve"):
        got = torch.cat([by_rows[r][key] for r in sorted(by_rows)])
        _close(got.numpy(), ref[f"{arch}/{key}"], 1e-5, key)
    _cache_heads(outs, arch, {k: v * 2 for k, v in CACHE_HEADS[arch, (2, 2)].items()})


def _serving_matches_one_device(worlds, inputs, arch, layout):
    cfg = get_reduced(arch)
    params0 = flat_lib.tree_map(lambda p: p[0], inputs["params"][arch])
    _, shape = T.serve_inputs()
    state = M.init_decode_state(cfg, T.SERVE_BATCH, shape.seq_len, device="cpu")
    want, _ = T.decode(lambda *a: M.decode_step(a[0], cfg, *a[1:]), cfg, T.serve_prompt(cfg),
                       params0, state)
    outs = sorted(worlds[layout], key=lambda o: o["coords"][1])
    for o in outs:
        torch.testing.assert_close(o[arch]["serve"], want, rtol=1e-5, atol=1e-5)
    _cache_heads(outs, arch, CACHE_HEADS[arch, layout])


def _train_matches_one_device(worlds, inputs, arch, mode):
    """(1, 3): the train step against the port's single-device step."""
    cfg = get_reduced(arch)
    params = flat_lib.tree_map(torch.clone, inputs["params"][arch])
    mix = (lambda q, plane: plane) if mode == "none" else None
    params, loss = ttrain.train_step(params, T.torch_batch(inputs["batches"][arch]),
                                     torch.as_tensor(inputs["q_eff"]), cfg, T.LR, mix=mix)
    for o in worlds[(1, 3)]:
        got = o[arch][f"train_{mode}"]
        assert math.isclose(got["loss"], float(loss), rel_tol=1e-6)
        for (path, a), b in zip(flat_lib.tree_items(got["whole"]), flat_lib.tree_leaves(params)):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5, msg=str(path))


def _f64_matches_one_device(worlds, inputs, arch, layout):
    """lm_loss in both loss forms and on the flash path, its gradients, and
    the blocked attention, in f64 against one process within 1e-10."""
    from repro_torch.models import attention

    cfg = get_reduced(arch).with_(dtype="float64")
    whole = flat_lib.tree_map(lambda p: p[0].double(), inputs["params"][arch])
    batch = T.torch_batch(inputs["batches"][arch], 0)
    for name, kw in (("f64_0", {}), (f"f64_{T.CHUNK}", {"vocab_chunk": T.CHUNK}),
                     ("f64_flash", {"blocked_attn_threshold": T.FLASH_FROM})):
        params = flat_lib.tree_map(lambda p: p.clone().requires_grad_(), whole)
        loss = M.lm_loss(params, cfg, batch, **kw)
        grads = torch.autograd.grad(loss, flat_lib.tree_leaves(params), materialize_grads=True)
        for o in worlds[layout]:
            got = o[arch][name]
            assert math.isclose(got["loss"], float(loss.detach()), rel_tol=1e-12)
            for (path, g), want in zip(flat_lib.tree_items(got["grads"]), grads):
                torch.testing.assert_close(g, want, rtol=1e-10, atol=1e-10, msg=str(path))
    if "0:attn" not in whole["groups"]:
        return
    ap = M._unbind_groups(whole["groups"], M.block_pattern(cfg)[1])[0]["0:attn"]["attn"]
    want = attention.blocked_attention(ap, T.attention_input(cfg), cfg, block_q=T.BLOCK,
                                       block_kv=T.BLOCK)
    for o in worlds[layout]:
        torch.testing.assert_close(o[arch]["blocked"], want, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("layout", LAYOUTS, ids=_tag)
@pytest.mark.parametrize("mode", [m for m, _, _ in T.MODES])
def test_train_step_matches_reference(worlds, reference, layout, mode):
    _train_matches(worlds, reference, T.ARCH, layout, mode)


@pytest.mark.parametrize("layout", WORLDS, ids=_tag)
def test_replicated_leaves_equal_across_model_ranks(worlds, inputs, layout):
    """A leaf the layout keeps whole (no "model" in its spec: the norms and
    biases, and at (1, 3) wk, wv and the embedding) is bit for bit the same
    on every model rank after the step; a sharded one differs between
    them."""
    _replicated_equal(worlds, inputs, T.ARCH, layout)


def test_routes_and_tally(worlds):
    """(2, 2) and (1, 3) take the heads route in every attention layer,
    (1, 4) the padded one with all four projections gathered, their
    gradients reduce-scattered back; the step's model collectives are
    tallied apart from the client ones."""
    for layout, route in (((2, 2), "heads"), ((1, 4), "padded"), ((1, 3), "heads")):
        o = worlds[layout][0][T.ARCH]["train_dense"]
        layers_run = 2 * (T.N // layout[0])  # 2 layers of each of the rank's clients
        padded = route == "padded"
        assert o["routes"] == {"heads": 0 if padded else layers_run,
                               "padded": layers_run if padded else 0,
                               "gathered_leaves": 4 * layers_run if padded else 0,
                               "moe": 0, "experts": 0, "ssm": 0, "ssm_heads": 0, "seq": 0,
                               "seq_whole": 0}
        counts = o["tally"]["_counts"]
        assert counts["model_all_reduce"] > 0 and counts["reduce_scatter"] == 1
        assert (counts["model_all_gather"] > 0) == padded
        assert (counts["model_reduce_scatter"] > 0) == padded


@pytest.mark.parametrize("layout", WORLDS, ids=_tag)
def test_shard_and_gather_round_trip(worlds, inputs, layout):
    _round_trip(worlds, inputs, T.ARCH, layout)


def test_prefill_and_serve_match_reference(worlds, reference):
    _serving_matches_reference(worlds, reference, T.ARCH)  # 2 kv heads over 2 model ranks


@pytest.mark.parametrize("layout", ((1, 4), (1, 3)), ids=_tag)
def test_serve_on_one_client_rank_matches_one_device(worlds, inputs, layout):
    """Each rank caches only the kv heads its query heads read (2 kv heads
    do not divide by 4 or 3); at (1, 4) the last rank has no head."""
    _serving_matches_one_device(worlds, inputs, T.ARCH, layout)


@pytest.mark.parametrize("mode", ["dense", "none"])
def test_picked_kv_heads_and_whole_vocab_match_one_device(worlds, inputs, mode):
    _train_matches_one_device(worlds, inputs, T.ARCH, mode)


@pytest.mark.parametrize("layout", WORLDS, ids=_tag)
def test_loss_forms_and_gradients_in_f64(worlds, inputs, layout):
    """The vocab-parallel cross-entropy in both loss forms, the flash and
    blocked attention, and the operators' gradients against one process,
    in f64 (see the module docstring)."""
    _f64_matches_one_device(worlds, inputs, T.ARCH, layout)
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


# -- the decode cache's other layouts (reduced qwen2, a ring of 4 slots) -----

# (layout, case) -> (the layout that took effect, a rank's KV cache (groups,
# rows, slots, kv heads, head_dim)): the rows whole and the ring's 4 slots 2
# a data rank; every kv head at 32 / T of head_dim or 4 / T slots a model rank
_WHOLE, _EVERY = "the rank's", "every"
CACHE_EXPECT = {
    ((2, 2), "rows whole"): ({"slots": "data", "head_dim": None, "kv_heads": _WHOLE},
                             (2, 1, 2, 1, 32)),
    ((2, 2), "head_dim"): ({"slots": None, "head_dim": "model", "kv_heads": _EVERY},
                           (2, 2, 4, 2, 16)),
    ((2, 2), "seq"): ({"slots": "model", "head_dim": None, "kv_heads": _EVERY}, (2, 2, 2, 2, 32)),
    ((2, 2), "rows whole head_dim"): ({"slots": "data", "head_dim": "model",
                                       "kv_heads": _EVERY}, (2, 1, 2, 2, 16)),
    ((2, 2), "rows whole seq"): ({"slots": "model", "head_dim": None, "kv_heads": _EVERY},
                                 (2, 1, 2, 2, 32)),
    ((1, 4), "head_dim"): ({"slots": None, "head_dim": "model", "kv_heads": _EVERY},
                           (2, 4, 4, 2, 8)),
    ((1, 4), "seq"): ({"slots": "model", "head_dim": None, "kv_heads": _EVERY}, (2, 4, 1, 2, 32))}
CACHE_IDS = [f"{_tag(lay)}-{name.replace(' ', '_')}" for lay, name in CACHE_EXPECT]


def _cache_rows(o, got, batch):
    """The rows of the batch that rank `o` served as `got`: all of them, or
    its client rank's block."""
    n = got.shape[0]
    return slice(None) if n == batch else slice(o["coords"][0] * n, (o["coords"][0] + 1) * n)


def _cache_case(layout, name):
    (batch, cache_shard), = [c[1:] for c in T.CACHE_CASES[layout] if c[0] == name]
    return batch, cache_shard


def _cache_one_device(inputs, dtype, batch):
    cfg = T.cache_config(dtype)
    params = flat_lib.tree_map(lambda p: p[0].to(cfg.torch_dtype), inputs["params"][T.ARCH])
    return T.cache_decode(params, cfg, T.cache_tokens()[:batch])[0]


@pytest.mark.parametrize("layout, name", list(CACHE_EXPECT), ids=CACHE_IDS)
def test_cache_layout_matches_reference(worlds, reference, layout, name):
    """The serve step under each layout against the reference's on the
    same params and tokens (its `serve_shardings` of that layout), f32
    logits within 1e-5, through a ring that wraps twice; the layout that
    took effect and a rank's KV cache as `CACHE_EXPECT` says; the merge of
    the slots over "data" tallied as client-axis all-reduces, none
    elsewhere."""
    batch, _ = _cache_case(layout, name)
    want = reference()[f"cache/{T.ARCH}/{_tag(layout)}/{name}"]
    for o in worlds[layout]:
        got = o["cache"][name]
        _close(got["float32"].numpy(), want[_cache_rows(o, got["float32"], batch)], 1e-5, name)
        assert (got["layout"], got["kv"]) == CACHE_EXPECT[layout, name]
        assert (got["counts"]["client_all_reduce"] > 0) == (got["layout"]["slots"] == "data")
        assert got["counts"]["model_all_reduce"] > 0


@pytest.mark.parametrize("layout, name", list(CACHE_EXPECT), ids=CACHE_IDS)
def test_cache_layout_in_f64_matches_one_device(worlds, inputs, layout, name):
    """The exact witness: f64 decode under each layout within 1e-10 of one
    process (the merged partial softmaxes, the summed head_dim scores)."""
    batch, _ = _cache_case(layout, name)
    want = _cache_one_device(inputs, "float64", batch)
    for o in worlds[layout]:
        got = o["cache"][name]["float64"]
        torch.testing.assert_close(got, want[_cache_rows(o, got, batch)], rtol=1e-10,
                                   atol=1e-10)


@pytest.mark.parametrize("fault", [f[0] for f in T.CACHE_FAULTS])
def test_planted_cache_faults_fail(worlds, inputs, fault):
    """A merge that skips the rescale to the row max over every slot (an
    empty rank's count of masked slots and a full rank's unscaled sums
    enter it), and head_dim blocks' scores left unsummed, each move the f64
    logits far past the witness's 1e-10: O(1) of them."""
    (case,) = [c for f, c, _, _ in T.CACHE_FAULTS if f == fault]
    layout = next(lay for lay, cases in T.CACHE_CASES.items() if any(c[0] == case for c in cases))
    batch, _ = _cache_case(layout, case)
    want = _cache_one_device(inputs, "float64", batch)
    for o in worlds[layout]:
        got = o["cache"][fault]
        gap = float((got - want[_cache_rows(o, got, batch)]).abs().max())
        assert gap > 0.1 * float(want.abs().max()), (fault, gap)


# -- the moe expert axis over "model" (reduced qwen3-moe-30b-a3b) ----------


@pytest.mark.parametrize("layout", LAYOUTS, ids=_tag)
@pytest.mark.parametrize("mode", [m for m, _, _ in T.MODES])
def test_moe_train_step_matches_reference(worlds, reference, layout, mode):
    _train_matches(worlds, reference, T.MOE, layout, mode)


@pytest.mark.parametrize("layout", WORLDS, ids=_tag)
def test_moe_replicated_leaves_equal_across_model_ranks(worlds, inputs, layout):
    """The router and the norms (and at (1, 3), where neither the experts
    nor the heads nor the vocabulary divide, every leaf) bit for bit the
    same on every model rank after the step; the experts differ."""
    kept = _replicated_equal(worlds, inputs, T.MOE, layout)
    assert ("groups", "1:moe", "moe", "router") in kept
    assert (("groups", "1:moe", "moe", "experts_up") in kept) == (layout == (1, 3))


def test_moe_experts_and_routes_tally(worlds):
    """Each rank runs E / T experts where T divides E = 4, all 4 at (1, 3);
    the moe layers and the attention routes are tallied (moe's 4 query
    heads split whole at 2 and 4 ways, its 2 kv heads gathered at 4)."""
    for layout, experts in (((2, 2), 2), ((1, 4), 1), ((1, 3), 4)):
        for o in worlds[layout]:
            layers_run = T.N // layout[0]  # 1 moe layer of each of 2, for each client
            routes = o[T.MOE]["train_dense"]["routes"]
            heads = 0 if layout == (1, 3) else 2 * layers_run  # (1, 3): wq stays whole
            assert routes == {"heads": heads, "padded": 0,
                              "gathered_leaves": 2 * heads if layout == (1, 4) else 0,
                              "moe": 2 * layers_run, "experts": experts, "ssm": 0,
                              "ssm_heads": 0, "seq": 0, "seq_whole": 0}
            assert o[T.MOE]["serve_routes"]["experts"] == experts
            counts = o[T.MOE]["train_dense"]["tally"]["_counts"]
            assert (counts["model_all_reduce"] > 0) == (layout != (1, 3))


@pytest.mark.parametrize("layout", WORLDS, ids=_tag)
def test_moe_shard_and_gather_round_trip(worlds, inputs, layout):
    _round_trip(worlds, inputs, T.MOE, layout)


def test_moe_prefill_and_serve_match_reference(worlds, reference):
    _serving_matches_reference(worlds, reference, T.MOE)


@pytest.mark.parametrize("layout", ((1, 4), (1, 3)), ids=_tag)
def test_moe_serve_on_one_client_rank_matches_one_device(worlds, inputs, layout):
    _serving_matches_one_device(worlds, inputs, T.MOE, layout)


@pytest.mark.parametrize("mode", ["dense", "none"])
def test_moe_replicated_experts_match_one_device(worlds, inputs, mode):
    _train_matches_one_device(worlds, inputs, T.MOE, mode)


@pytest.mark.parametrize("layout", WORLDS, ids=_tag)
def test_moe_loss_and_gradients_in_f64(worlds, inputs, layout):
    """The router's gradient among them: a `TP.copy` on the layer's input
    or the router would sum its whole-on-every-rank gradient T times."""
    _f64_matches_one_device(worlds, inputs, T.MOE, layout)


# -- the ssm and hybrid families over "model" (reduced mamba2-2.7b, zamba2-2.7b)


@pytest.mark.parametrize("arch", T.SSM_ARCHS)
@pytest.mark.parametrize("layout", LAYOUTS, ids=_tag)
@pytest.mark.parametrize("mode", [m for m, _, _ in T.MODES])
def test_ssm_train_step_matches_reference(worlds, reference, arch, layout, mode):
    _train_matches(worlds, reference, arch, layout, mode)


@pytest.mark.parametrize("arch", T.SSM_ARCHS)
@pytest.mark.parametrize("layout", WORLDS, ids=_tag)
def test_ssm_replicated_leaves_equal_across_model_ranks(worlds, inputs, arch, layout):
    """The norms (and at (1, 3), where neither the 16 heads nor d_inner nor
    the vocabulary divide, every leaf but mamba2's in_proj and conv)
    bit for bit the same on every model rank after the step; a block
    differs between them."""
    kept = _replicated_equal(worlds, inputs, arch, layout)
    ssm = ("groups", "0:ssm", "ssm")
    assert (ssm + ("a_log",) in kept) == (layout == (1, 3))
    assert (ssm + ("in_proj",) in kept) == (layout == (1, 3) and arch == T.ZAMBA)


def test_ssm_heads_and_routes_tally(worlds):
    """Each rank computes ceil(16 / T) ssm heads in each Mamba2 block: their
    in_proj, conv_w and conv_b gathered wherever those are blocks (every
    layout but zamba2's (1, 3), where they stay whole); zamba2's shared
    block takes the heads route where its 4 heads split."""
    for layout in WORLDS:
        o = worlds[layout][0]
        clients = T.N // layout[0]
        for arch, blocks in ((T.MAMBA, 2), (T.ZAMBA, 2)):
            routes = o[arch]["train_dense"]["routes"]
            cut = not (arch == T.ZAMBA and layout == (1, 3))
            shared = clients if arch == T.ZAMBA and layout != (1, 3) else 0
            assert routes == {"heads": shared, "padded": 0,
                              "gathered_leaves": 3 * blocks * clients if cut else 0,
                              "moe": 0, "experts": 0, "ssm": blocks * clients,
                              "ssm_heads": -(-16 // layout[1]), "seq": 0,
                              "seq_whole": 0}, (arch, layout, routes)
            counts = o[arch]["train_dense"]["tally"]["_counts"]
            assert counts["model_all_reduce"] > 0
            assert (counts["model_reduce_scatter"] > 0) == cut


@pytest.mark.parametrize("arch", T.SSM_ARCHS)
@pytest.mark.parametrize("layout", WORLDS, ids=_tag)
def test_ssm_shard_and_gather_round_trip(worlds, inputs, arch, layout):
    _round_trip(worlds, inputs, arch, layout)


@pytest.mark.parametrize("arch", T.SSM_ARCHS)
def test_ssm_prefill_and_serve_match_reference(worlds, reference, arch):
    """The reference's conv state holds a uniform block of conv_ch a rank,
    the port's the rank's own heads' channels: the same values for the
    heads each computes, and the same logits."""
    _serving_matches_reference(worlds, reference, arch)


@pytest.mark.parametrize("arch", T.SSM_ARCHS)
@pytest.mark.parametrize("layout", ((1, 4), (1, 3)), ids=_tag)
def test_ssm_serve_on_one_client_rank_matches_one_device(worlds, inputs, arch, layout):
    _serving_matches_one_device(worlds, inputs, arch, layout)


@pytest.mark.parametrize("arch", T.SSM_ARCHS)
@pytest.mark.parametrize("mode", ["dense", "none"])
def test_ssm_padded_heads_match_one_device(worlds, inputs, arch, mode):
    """(1, 3): 6, 6 and 4 heads a rank from replicated head leaves (and
    zamba2's whole in_proj and conv) against one process."""
    _train_matches_one_device(worlds, inputs, arch, mode)


@pytest.mark.parametrize("arch", T.SSM_ARCHS)
@pytest.mark.parametrize("layout", WORLDS, ids=_tag)
def test_ssm_loss_and_gradients_in_f64(worlds, inputs, arch, layout):
    """Under remat, so that each rank recomputes its blocks' gathers and
    norm sums in the backward. The gated norm's sum reduced forward only
    would leave each rank's norm gradient partial; a `TP.copy` on B or C
    would count their gradient T times."""
    _f64_matches_one_device(worlds, inputs, arch, layout)


def test_ssm_rank_without_heads_matches_one_device(inputs):
    """(1, 5): ranks of 4, 4, 4, 4 and 0 ssm heads (ceil(16 / 5) = 4), the
    last joining every collective on empty slices (and reading the last
    group); f64 loss and gradients under remat, and f64 decode, within
    1e-10 of one process."""
    outs = mesh_lib.spawn_ranks(T.zero_heads, 5, (1, 5), inputs, backend="gloo", timeout=60,
                                deadline=240)
    assert [o["heads"] for o in outs] == [4, 4, 4, 4, 0]
    cfg = get_reduced(T.MAMBA).with_(dtype="float64")
    whole = flat_lib.tree_map(lambda p: p[0].double().requires_grad_(),
                              inputs["params"][T.MAMBA])
    loss = M.lm_loss(whole, cfg, {"tokens": torch.as_tensor(inputs["tokens"][0])})
    grads = torch.autograd.grad(loss, flat_lib.tree_leaves(whole))
    prompt, shape = T.serve_inputs()
    state = M.init_decode_state(cfg, T.SERVE_BATCH, shape.seq_len, device="cpu")
    whole = flat_lib.tree_map(torch.Tensor.detach, whole)
    want = torch.stack([M.decode_step(whole, cfg, prompt[:, t], state)[0]
                        for t in range(T.SERVE_PROMPT)], dim=1)
    for o in outs:
        assert math.isclose(o["loss"], float(loss.detach()), rel_tol=1e-12)
        for (path, g), w in zip(flat_lib.tree_items(o["grads"]), grads):
            torch.testing.assert_close(g, w, rtol=1e-10, atol=1e-10, msg=str(path))
        torch.testing.assert_close(o["serve"], want, rtol=1e-10, atol=1e-10)


# -- the vlm's cross attention and the audio family over "model" (reduced
# llama-3.2-vision-11b, musicgen-large)


@pytest.mark.parametrize("arch", T.CROSS_ARCHS)
@pytest.mark.parametrize("layout", LAYOUTS, ids=_tag)
@pytest.mark.parametrize("mode", [m for m, _, _ in T.MODES])
def test_cross_train_step_matches_reference(worlds, reference, arch, layout, mode):
    """The vlm's cross layer on whole heads at (2, 2) and on its kv heads
    cut inside a head (gathered) at (1, 4), its gate at `T.GATE`; the audio
    model's frame embeddings whole over "model" and its head
    vocab-parallel, its token embedding's update zero on every rank."""
    _train_matches(worlds, reference, arch, layout, mode)


def test_cross_layer_is_live(inputs, reference):
    """The gate is not zero, so the cross layer adds to the stream and the
    reference's step moves its projections (at a zero gate they would keep
    their init on any layout, a trap for every check above); the audio
    model's unused token embedding keeps its init."""
    ref = reference()
    for layout in LAYOUTS:
        tag = _tag(layout)
        for name in ("wq", "wk", "wv", "wo"):
            init = inputs["params"][T.VLM]["groups"]["2:cross"]["attn"][name].numpy()
            moved = ref[f"{T.VLM}/{tag}/train/dense/groups/2:cross/attn/{name}"] - init
            assert np.abs(moved).max() > 1e-6, (layout, name)
        np.testing.assert_array_equal(ref[f"{T.AUDIO}/{tag}/train/dense/embed"],
                                      inputs["params"][T.AUDIO]["embed"].numpy())
    assert (inputs["params"][T.VLM]["groups"]["2:cross"]["gate"] == T.GATE).all()


@pytest.mark.parametrize("arch", T.CROSS_ARCHS)
@pytest.mark.parametrize("layout", WORLDS, ids=_tag)
def test_cross_replicated_leaves_equal_across_model_ranks(worlds, inputs, arch, layout):
    """The vlm's 0-d gate (its gradient whole on every rank: it multiplies
    the reduced output) and the norms bit for bit the same on every model
    rank after the step (at (1, 3), where neither the heads nor d_ff nor
    the vocabulary divide, every leaf); a block differs between them."""
    kept = _replicated_equal(worlds, inputs, arch, layout)
    if arch == T.VLM:
        assert ("groups", "2:cross", "gate") in kept
        assert (("groups", "2:cross", "attn", "wq") in kept) == (layout == (1, 3))
    assert (("embed",) in kept) == (layout == (1, 3))


def test_cross_routes_and_tally(worlds):
    """The vlm's self-attention and cross layers take the heads route
    where its 4 query heads split (their 2 kv heads gathered at (1, 4),
    where a shard cuts a head); musicgen's two layers take it at 2 and 4
    ways, their 4 kv heads their own; at (1, 3) every leaf is whole and the
    step runs no model collective."""
    for layout in WORLDS:
        for o in worlds[layout]:
            clients = T.N // layout[0]
            split = layout != (1, 3)
            for arch, layers, gathered in ((T.VLM, 2, 4 if layout == (1, 4) else 0),
                                           (T.AUDIO, 2, 0)):
                routes = o[arch]["train_dense"]["routes"]
                assert routes == {"heads": layers * clients if split else 0, "padded": 0,
                                  "gathered_leaves": gathered * clients, "moe": 0,
                                  "experts": 0, "ssm": 0, "ssm_heads": 0, "seq": 0,
                                  "seq_whole": 0}, (arch, layout)
                counts = o[arch]["train_dense"]["tally"]["_counts"]
                assert (counts["model_all_reduce"] > 0) == split
                assert (counts["model_reduce_scatter"] > 0) == bool(gathered)


@pytest.mark.parametrize("arch", T.CROSS_ARCHS)
@pytest.mark.parametrize("layout", WORLDS, ids=_tag)
def test_cross_shard_and_gather_round_trip(worlds, inputs, arch, layout):
    _round_trip(worlds, inputs, arch, layout)


@pytest.mark.parametrize("arch", T.CROSS_ARCHS)
def test_cross_prefill_and_serve_match_reference(worlds, reference, arch):
    """The vlm against the reference's cross K/V (whole heads at (2, 2));
    the audio model fed frame embeddings, then `T.SERVE_FEED` tokens'
    embeddings looked up vocab-parallel (the reference indexes its whole
    table)."""
    _serving_matches_reference(worlds, reference, arch)


@pytest.mark.parametrize("arch", T.CROSS_ARCHS)
@pytest.mark.parametrize("layout", ((1, 4), (1, 3)), ids=_tag)
def test_cross_serve_on_one_client_rank_matches_one_device(worlds, inputs, arch, layout):
    """The vlm's cross K/V on the kv head each rank's query head reads at
    (1, 4) (one of 2), all of them at (1, 3); the audio model's fed-back
    tokens looked up in 4 blocks of 32 rows at (1, 4), whole at (1, 3)."""
    _serving_matches_one_device(worlds, inputs, arch, layout)


@pytest.mark.parametrize("arch", T.CROSS_ARCHS)
@pytest.mark.parametrize("mode", ["dense", "none"])
def test_cross_replicated_layers_match_one_device(worlds, inputs, arch, mode):
    """(1, 3): every rank computes the whole model from replicated leaves."""
    _train_matches_one_device(worlds, inputs, arch, mode)


@pytest.mark.parametrize("arch", T.CROSS_ARCHS)
@pytest.mark.parametrize("layout", WORLDS, ids=_tag)
def test_cross_loss_and_gradients_in_f64(worlds, inputs, arch, layout):
    """The gate's gradient among them: a `TP.copy` on it would sum its
    whole-on-every-rank gradient T times; a cross layer left unreduced
    would leave its output, and so the gate's and the stream's
    gradients, partial."""
    _f64_matches_one_device(worlds, inputs, arch, layout)


def test_ssm_heads_and_groups_of_each_rank():
    """`rank_ssm_heads`: the padded split, a rank without heads reading the
    last group, and groups a rank's heads read out of step raising
    (ROADMAP item 20(g))."""
    from repro_torch.models import ssm

    cfg = get_reduced(T.MAMBA)  # 16 heads, one group
    assert [ssm.rank_ssm_heads(cfg, r, 3) for r in range(3)] == [
        (0, 6, 0, 1), (6, 6, 0, 1), (12, 4, 0, 1)]
    assert ssm.rank_ssm_heads(cfg, 4, 5) == (16, 0, 0, 1)
    grouped = cfg.with_(ssm_groups=4)  # 4 heads a group
    assert ssm.rank_ssm_heads(grouped, 1, 2) == (8, 8, 2, 2)
    assert ssm.rank_ssm_heads(grouped, 1, 4) == (4, 4, 1, 1)
    with pytest.raises(NotImplementedError, match=r"ROADMAP item 20\(g\)"):
        ssm.rank_ssm_heads(grouped, 0, 3)  # heads 0..5 read groups 0 and 1 out of step


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


SPLIT = list(ARCH_IDS)  # every family splits over "model"


@pytest.mark.parametrize("arch", SPLIT)
def test_production_blocks_equal_the_reference(arch):
    """At (16, 16) on ``meta``: the port's blocks of every config split over
    "model" (zamba2's shared block among them),
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


@pytest.mark.parametrize("arch", [a for a in SPLIT if get_config(a).num_heads])
def test_every_attention_layer_at_16_ways_computes_its_own_heads(arch):
    """At (16, 16) model rank 0 of every config computes ceil(H / 16)
    query heads in each attention layer (zamba2's in its shared block, the
    vlm's in its cross layer too), on the heads route where 16 divides H
    and the padded one where it cuts a head; a moe rank runs E / 16
    experts; the vlm's cross K/V holds the one kv head its 2 query heads
    read (the reference replicates all 8)."""
    from repro_torch.models import attention, moe

    cfg = get_config(arch)
    mesh = mesh_lib.Mesh.dry((16, 16), ("data", "model"))
    tp = tp_lib.context(mesh)
    one = {"hybrid": cfg.shared_attn_every, "vlm": cfg.cross_attn_every}.get(cfg.family, 1)
    params = M.init_params(steps._MetaGenerator(), cfg.with_(num_layers=one),
                           shard=tp_lib.sharder(mesh))
    kind = "1:moe" if cfg.family == "moe" else "1:mlp"
    layers = [params["shared"] if cfg.family == "hybrid" else params["groups"]["0:attn"]]
    layers += [b for name, b in params["groups"].items() if name.endswith(":cross")]
    assert len(layers) == (2 if cfg.family == "vlm" else 1)
    for ap in layers:
        lay = attention._layout(ap["attn"], cfg, tp)
        assert lay.hq == -(-cfg.num_heads // 16) and lay.params["wq"].shape[-1] == \
            lay.hq * cfg.resolved_head_dim
    route = "heads" if cfg.num_heads % 16 == 0 else "padded"
    assert mesh.tp_routes[route] == len(layers) and sum(mesh.tp_routes[r] for r in
                                                        ("heads", "padded")) == len(layers)
    if cfg.family == "vlm":
        x = torch.empty((2, cfg.num_patch_tokens, cfg.d_model), dtype=cfg.torch_dtype,
                        device="meta")
        cross = M.init_cross_kv(params, cfg.with_(num_layers=one), x, mesh)
        assert tuple(cross["k"].shape) == (1, 2, cfg.num_patch_tokens, 1,
                                           cfg.resolved_head_dim)
    if cfg.family == "moe":
        x = torch.empty((1, 8, cfg.d_model), dtype=cfg.torch_dtype, device="meta")
        moe.moe_block(flat_lib.tree_map(lambda t: t[0], params["groups"][kind]["moe"]), x,
                      cfg, tp)
        assert mesh.tp_routes["experts"] == cfg.num_experts // 16


@pytest.mark.parametrize("arch", [a for a in SPLIT if get_config(a).family in ("ssm", "hybrid")])
def test_every_ssm_layer_at_16_ways_computes_its_own_heads(arch):
    """At (16, 16) model rank 0 of mamba2-2.7b and zamba2-2.7b computes 5 of
    the 80 ssm heads in a Mamba2 block: 901 (mamba2) or 773 (zamba2)
    in_proj columns out of its gathered block, `ssd_chunk` on ``meta`` at
    H_loc 5, and a partial output of the whole width."""
    from repro_torch.kernels import work
    from repro_torch.models import ssm

    cfg = get_config(arch)
    mesh = mesh_lib.Mesh.dry((16, 16), ("data", "model"))
    tp = tp_lib.context(mesh)
    params = M.init_params(steps._MetaGenerator(), steps.depth_config(cfg, 1),
                           shard=tp_lib.sharder(mesh))
    bp = flat_lib.tree_map(lambda t: t[0], params["groups"]["0:ssm"]["ssm"])
    heads, P, N = 5, cfg.ssm_head_dim, cfg.ssm_state
    assert ssm.rank_ssm_heads(cfg, 0, 16) == (0, heads, 0, 1)
    lay, h, g = ssm._layout(bp, cfg, tp)
    assert (h, g) == (heads, 1)
    assert lay["in_proj"].shape[-1] == 2 * heads * P + 2 * N + heads == \
        {"ssm": 901, "hybrid": 773}[cfg.family]
    assert lay["conv_w"].shape[0] == heads * P + 2 * N
    assert bp["in_proj"].shape[-1] == (2 * cfg.d_inner + 2 * N + cfg.ssm_heads) // 16
    calls = []
    x = torch.empty((2, 256, cfg.d_model), dtype=cfg.torch_dtype, device="meta")
    with work.sink(lambda kernel, w: calls.append((kernel, w))):
        out = ssm.ssm_block(bp, x, cfg, tp=tp)
    # (Bb 2, H_loc 5, one group, 2 chunks of 128)
    assert calls == [("ssd_chunk", work.ssd_chunk(2, heads, 1, 2, cfg.ssm_chunk, N, P,
                                                  x.element_size()))]
    assert out.shape == x.shape
    assert mesh.tp_routes["ssm"] == 2 and mesh.tp_routes["ssm_heads"] == heads


def test_seq_parallel_and_cache_layouts_raise_naming_their_item():
    """Sequence parallelism (ROADMAP item 20(e), ported) lays 'seq' on
    "model" and runs the dry run's train pair at (16, 16): every
    sub-block on the rank's positions, the model axis's joins now
    reduce-scatters and all-gathers along the sequence. The cache's other
    layouts (item 20(f), ported) reckon decode_32k at (2, 2): head_dim adds
    one model-axis all-reduce a layer (the partial scores' sum) and two
    all-gathers (q, k and v relaid to every head; the output's head_dim
    blocks), seq two all-reduces a layer (the merge's row max and sums) and
    the relay's all-gather; 64 rows a client rank, no client-axis
    collective."""
    cfg = get_reduced(T.ARCH)
    mesh = mesh_lib.Mesh.dry((2, 2), ("data", "model"))
    assert axes.train_rules(mesh, seq_parallel=True).rules["seq"] == "model"
    assert axes.train_rules(mesh).rules["seq"] is None
    rows = {sp: dryrun.lower_pair(T.ARCH, "train_4k", cfg=cfg, seq_parallel=sp, verbose=False)
            for sp in (False, True)}
    assert rows[True]["seq_parallel"] and not rows[False]["seq_parallel"]
    # one tally a sub-block run: 2 a layer (the reduced config has no remat)
    assert not cfg.remat and rows[True]["tp_routes"]["seq"] == 2 * cfg.num_layers
    assert rows[True]["tp_routes"]["seq_whole"] == rows[False]["tp_routes"]["seq"] == 0
    counts = {sp: r["coll_breakdown"]["counts"] for sp, r in rows.items()}
    assert counts[True]["model_reduce_scatter"] > counts[False]["model_reduce_scatter"]
    assert counts[True]["model_all_gather"] > counts[False]["model_all_gather"]
    assert counts[True]["model_all_reduce"] < counts[False]["model_all_reduce"]
    assert rows[True]["reckoned_peak_bytes"] < rows[False]["reckoned_peak_bytes"]
    counts = {cs: dryrun.reckon(cfg, SHAPES["decode_32k"],
                                mesh_lib.Mesh.dry((2, 2), ("data", "model")),
                                cache_shard=cs)["coll_counts"] for cs in steps.CACHE_SHARDS}
    layers = cfg.num_layers
    added = {cs: {kind: counts[cs][kind] - counts["kv_heads"][kind]
                  for kind in ("model_all_reduce", "model_all_gather", "client_all_reduce")}
             for cs in ("head_dim", "seq")}
    assert added == {"head_dim": {"model_all_reduce": layers, "model_all_gather": 2 * layers,
                                  "client_all_reduce": 0},
                     "seq": {"model_all_reduce": 2 * layers, "model_all_gather": layers,
                             "client_all_reduce": 0}}
    assert all(c["client_all_reduce"] == 0 for c in counts.values())
    assert axes.train_rules(mesh).rules["heads"] == "model"
