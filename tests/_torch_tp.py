"""Rank functions of `tests/test_torch_tensor_parallel.py` (a helper, not
a test module). Each runs in one process of a gloo world spawned by
`repro_torch.launch.mesh.spawn_ranks`, on the CPU, laid over ("data",
"model"), and returns what the test compares; this module imports no
JAX, so a rank starts quickly.

A world does every check of its layout in one run, for each of `ARCHS`
(reduced qwen2, dense; reduced qwen3-moe-30b-a3b, moe; reduced
mamba2-2.7b, ssm; reduced zamba2-2.7b, hybrid; reduced
llama-3.2-vision-11b, vlm, its cross layer's tanh gate set to
`GATE`; reduced musicgen-large, audio): the train step in each
mix mode from the reference's whole parameters (`convert.shard_params`)
back to whole ones (`convert.gather_params`), the round trip of those
two, the prefill and serve steps, and the model's gradients in f64
against one process (the ssm and hybrid models under remat, so that a
recomputed block runs its collectives again); and the vocab-parallel
cross-entropy once. Then the decode cache's other layouts
(`CACHE_CASES`, reduced qwen2 with a ring of `CACHE_WINDOW` slots): each
served in f32 and f64, and f64 again with a planted merge fault.
"""
from unittest import mock

import numpy as np
import torch

import _torch_dist as D
from repro_torch import convert
from repro_torch.configs.base import ShapeConfig, get_reduced
from repro_torch.core import flat as flat_lib
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import steps
from repro_torch.models import layers
from repro_torch.models import model as M
from repro_torch.models.attention import KVCache
from repro_torch.sharding import tp as tp_lib

ARCH, N, LR = D.ARCH, D.N, D.LR
MOE = "qwen3-moe-30b-a3b"  # reduced: 4 experts, top-2, 4 query heads over 2 kv heads
# reduced: 16 ssm heads of 32 channels, one group, state 32 (mamba2) and 16
# (zamba2, whose one group of 2 Mamba2 blocks ends in the shared block of 4
# heads)
MAMBA, ZAMBA = "mamba2-2.7b", "zamba2-2.7b"
SSM_ARCHS = (MAMBA, ZAMBA)
# reduced: one group of a self-attention layer and a cross layer, 4 query
# heads over 2 kv heads of 64, 16 patch tokens, vocabulary 512 (the vlm);
# 4 heads over 4 kv heads, vocabulary 128, frame embeddings in (musicgen)
VLM, AUDIO = "llama-3.2-vision-11b", "musicgen-large"
CROSS_ARCHS = (VLM, AUDIO)
ARCHS = (ARCH, MOE) + SSM_ARCHS + CROSS_ARCHS
# the cross layer's tanh gate: zeros at init, where the layer adds nothing
# and its projections' gradients are exactly 0 on any layout
GATE = 0.5
SERVE_BATCH, SERVE_PROMPT = 4, 8
SERVE_FEED = 2  # an audio model's decode steps past its prompt, fed tokens' embeddings
CHUNK = 8  # lm_loss's vocab_chunk form over D.SEQ positions
FLASH_FROM = 8  # apply_model's blocked_attn_threshold: the flash path at D.SEQ
BLOCK = 8  # blocked_attention's q and kv blocks
# (name, mix_mode, mix_dtype); the ring holds one client a data rank
MODES = (("dense", "dense", None), ("dense-bf16", "dense", torch.bfloat16),
         ("none", "none", None), ("ring", "ring", None))


def set_gate(params, value=GATE):
    """`params` (one model's, or client-stacked) with each cross layer's
    tanh gate set to `value`, in place; returns them."""
    for name, block in params["groups"].items():
        if name.endswith(":cross"):
            block["gate"].fill_(value)
    return params


def model_batch(cfg, tokens, rng):
    """An (N, B, S) batch for `cfg` in numpy: `tokens` (a text model's
    input), frame embeddings and labels (audio), patch embeddings (vlm)."""
    n, b, s = tokens.shape
    if cfg.embeds_in:
        batch = {"embeds": rng.standard_normal((n, b, s, cfg.d_model)).astype(np.float32),
                 "labels": rng.integers(0, cfg.vocab_size, (n, b, s))}
    else:
        batch = {"tokens": tokens}
    if cfg.family == "vlm":
        batch["cross_embeds"] = rng.standard_normal(
            (n, b, cfg.num_patch_tokens, cfg.d_model)).astype(np.float32)
    return batch


def train_inputs(seed=0):
    """`_torch_dist.train_inputs`' tokens and ``q_eff``, and ``params``
    for each of `ARCHS`: one init copied to the N clients (the cross
    layer's gate at `GATE`); ``batches``: each arch's numpy batch, the
    text models' the tokens."""
    out = D.train_inputs(seed)
    out["params"] = {ARCH: out["params"]}
    for arch in ARCHS[1:]:
        one = set_gate(M.init_params(seed, get_reduced(arch), "cpu"))
        out["params"][arch] = flat_lib.tree_map(
            lambda p: p[None].expand(N, *p.shape).clone(), one)
    rng = np.random.default_rng(seed + 1)
    out["batches"] = {arch: model_batch(get_reduced(arch), out["tokens"], rng)
                      for arch in ARCHS}
    return out


def torch_batch(batch, rows=slice(None)):
    """A numpy batch's `rows` as tensors."""
    return {k: torch.as_tensor(v[rows]) for k, v in batch.items()}


def numpy_tree(tree):
    return flat_lib.tree_map(lambda t: t.numpy(), tree)


def serve_inputs(seed=5):
    """(prompt (SERVE_BATCH, SERVE_PROMPT) int64, its serving shape); the
    text configs of `ARCHS` have a vocabulary of 512."""
    cfg = get_reduced(ARCH)
    gen = torch.Generator().manual_seed(seed)
    prompt = torch.randint(0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT), generator=gen)
    return prompt, ShapeConfig("serve", SERVE_PROMPT + 2, SERVE_BATCH, "decode")


def serve_prompt(cfg, seed=6):
    """`cfg`'s served inputs, (SERVE_BATCH, ...) tensors: `serve_inputs`'
    tokens, or for an audio model frame embeddings (``embeds``) and the
    tokens fed back after them (``feed``, SERVE_FEED of them); for a vlm
    also patch embeddings (``cross_embeds``)."""
    out = {}
    if cfg.embeds_in:
        rng = np.random.default_rng(seed)
        out["embeds"] = torch.as_tensor(rng.standard_normal(
            (SERVE_BATCH, SERVE_PROMPT, cfg.d_model)).astype(np.float32))
        out["feed"] = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                                   (SERVE_BATCH, SERVE_FEED)))
    else:
        out["tokens"] = serve_inputs()[0]
    if cfg.family == "vlm":
        rng = np.random.default_rng(seed + 1)
        out["cross_embeds"] = torch.as_tensor(rng.standard_normal(
            (SERVE_BATCH, cfg.num_patch_tokens, cfg.d_model)).astype(np.float32))
    return out


def decode_inputs(cfg, prompt, params, mesh=None):
    """Each decode step's input of `serve_prompt`'s `prompt` (a rank's
    rows of it): a token, or an audio model's frame embedding, then the
    embeddings of its fed-back tokens (`M.token_embeds`: vocab-parallel on
    `mesh`)."""
    if not cfg.embeds_in:
        return [prompt["tokens"][:, t] for t in range(SERVE_PROMPT)]
    return ([prompt["embeds"][:, t:t + 1] for t in range(SERVE_PROMPT)]
            + [M.token_embeds(params, cfg, prompt["feed"][:, j], mesh)
               for j in range(SERVE_FEED)])


def decode(step, cfg, prompt, params, state, mesh=None):
    """`step(params, input, state, cross_kv)` over `decode_inputs`, the
    vlm's cross K/V from its patch embeddings (the rank's heads on
    `mesh`): the logits (B, steps, V)."""
    cross = None
    if cfg.family == "vlm":
        cross = M.init_cross_kv(params, cfg, prompt["cross_embeds"], mesh)
    logits = []
    for x in decode_inputs(cfg, prompt, params, mesh):
        lg, state = step(params, x, state, cross)
        logits.append(lg)
    return torch.stack(logits, dim=1), cross


# the decode cache's other layouts (`steps.cache_layout`), reduced qwen2
# with a sliding window of CACHE_WINDOW slots (a ring: the steps wrap it
# twice, and at (2, 2) the rank holding slots 2 and 3 holds no token for
# the first two steps), decoding CACHE_STEPS prompt tokens: (name, batch,
# cache_shard) by layout. A batch of 1 does not divide by 2 client ranks:
# the whole batch on each, the ring's slots over "data"; head_dim and seq
# split the cache's head_dim (32 / T) or slots (4 / T) over "model", every
# kv head on each rank (at (1, 4) the 6 query heads on the padded route)
CACHE_WINDOW, CACHE_STEPS = 4, 10
CACHE_CASES = {(2, 2): (("rows whole", 1, "kv_heads"), ("head_dim", SERVE_BATCH, "head_dim"),
                        ("seq", SERVE_BATCH, "seq"), ("rows whole head_dim", 1, "head_dim"),
                        ("rows whole seq", 1, "seq")),
               (1, 4): (("head_dim", SERVE_BATCH, "head_dim"), ("seq", SERVE_BATCH, "seq"))}
# planted in the f64 decode of a case each: the merge's rescale to the row
# max over every slot left out, the head_dim blocks' partial scores left
# unsummed over the model ranks
CACHE_FAULTS = (("unscaled merge", "rows whole", "_rescale", lambda m_loc, m: m_loc * 0 + 1),
                ("unsummed scores", "head_dim", "_sum_scores", lambda scores, mesh: scores))


def cache_config(dtype="float32"):
    return get_reduced(ARCH).with_(sliding_window=CACHE_WINDOW, dtype=dtype)


def cache_tokens(seed=7):
    """(SERVE_BATCH, CACHE_STEPS) int64 prompt tokens of `CACHE_CASES`."""
    gen = torch.Generator().manual_seed(seed)
    return torch.randint(0, cache_config().vocab_size, (SERVE_BATCH, CACHE_STEPS), generator=gen)


def cache_decode(params, cfg, tokens, mesh=None, cache_shard="kv_heads"):
    """`tokens` (B, CACHE_STEPS) decoded by the serve step of `cfg` under
    `cache_shard` on `mesh` (one process without), each rank its
    `steps.serving_rows`: (logits (rows, CACHE_STEPS, V), the state)."""
    shape = ShapeConfig("serve", CACHE_STEPS, tokens.shape[0], "decode")
    serve = steps.make_serve_step(cfg, shape, mesh, cache_shard)
    rows = steps.serving_rows(shape, mesh)
    if rows != tokens.shape[0]:
        tokens = tokens[mesh.client_slice(tokens.shape[0])]
    state = M.init_decode_state(cfg, rows, CACHE_STEPS, device="cpu", mesh=mesh,
                                layout=serve.layout)
    logits = []
    for t in range(CACHE_STEPS):
        lg, state = serve(params, tokens[:, t], state)
        logits.append(lg)
    return torch.stack(logits, dim=1), state


def _cache_layouts(mesh, train, out):
    """Each of this layout's `CACHE_CASES` in f32 and f64 (logits, the
    layout and the KV cache's shape), and the `CACHE_FAULTS` planted."""
    from repro_torch.models import attention

    whole = flat_lib.tree_map(lambda p: p[0], train["params"][ARCH])
    tokens = cache_tokens()
    for name, batch, cache_shard in CACHE_CASES.get(mesh_shape(mesh), ()):
        got = {}
        for dtype in ("float32", "float64"):
            cfg = cache_config(dtype)
            params = convert.shard_params(flat_lib.tree_map(lambda p: p.to(cfg.torch_dtype),
                                                            whole), mesh, clients=False)
            mesh.reset_tally()
            got[dtype], state = cache_decode(params, cfg, tokens[:batch], mesh, cache_shard)
        layout = steps.cache_layout(cfg, ShapeConfig("serve", CACHE_STEPS, batch, "decode"),
                                    mesh, cache_shard)
        out[name] = dict(got, layout=layout.describe(), counts=dict(
            mesh.collective_tally()["_counts"]), kv=tuple(state.caches["0:attn"].k.shape))
        for fault, case, fn, planted in CACHE_FAULTS:
            if case == name:  # in f64
                with mock.patch.object(attention, fn, planted):
                    out[fault] = cache_decode(params, cfg, tokens[:batch], mesh, cache_shard)[0]


def mesh_shape(mesh):
    return (mesh.shape["data"], mesh.shape["model"])


def loss_inputs(seed=9):
    """f64 logits (2, D.SEQ, V) and labels for the cross-entropy check."""
    cfg = get_reduced(ARCH)
    rng = np.random.default_rng(seed)
    logits = torch.as_tensor(rng.standard_normal((2, D.SEQ, cfg.vocab_size)) * 3.0)
    labels = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, D.SEQ)))
    return logits, labels


def _train(mesh, cfg, train, out):
    for name, mode, md in MODES:
        n = mesh.size if mode == "ring" else N
        params = convert.shard_params(flat_lib.tree_map(lambda p: p[:n], train["params"][cfg.name]),
                                      mesh)
        sl = mesh.client_slice(n)
        batch = {k: torch.as_tensor(v[:n])[sl] for k, v in train["batches"][cfg.name].items()}
        step = steps.make_train_step(cfg, mesh, lr=LR, mix_mode=mode, mix_dtype=md)
        mesh.reset_tally()
        params, loss = step(params, batch, torch.as_tensor(train["q_eff"][:n, :n]))
        out[f"train_{name}"] = dict(
            loss=float(loss), local=params, tally=mesh.collective_tally(),
            routes=dict(mesh.tp_routes), whole=convert.gather_params(params, mesh, cfg))


def _serve(mesh, cfg, train, out):
    _, shape = serve_inputs()
    params0 = convert.shard_params(flat_lib.tree_map(lambda p: p[0], train["params"][cfg.name]),
                                   mesh, clients=False)
    rows = mesh.client_slice(SERVE_BATCH)
    prompt = {k: v[rows] for k, v in serve_prompt(cfg).items()}
    mesh.reset_tally()
    pshape = ShapeConfig("prefill", SERVE_PROMPT, SERVE_BATCH, "prefill")
    out["prefill"] = steps.make_prefill_step(cfg, pshape, mesh)(
        params0, {k: v for k, v in prompt.items() if k != "feed"})
    serve = steps.make_serve_step(cfg, shape, mesh)
    state = M.init_decode_state(cfg, rows.stop - rows.start, shape.seq_len, device="cpu",
                                mesh=mesh)
    out["serve"], cross = decode(serve, cfg, prompt, params0, state, mesh)
    out["serve_routes"] = dict(mesh.tp_routes)
    # each cache's heads: a KV cache's kv heads, an SSM state's ssm heads
    # (and its conv channels), the vlm's cross K/V's kv heads
    out["cache_heads"] = {name: (c.k.shape[-2],) if isinstance(c, KVCache) else
                          (c.h.shape[-3], c.conv.shape[-1])
                          for name, c in state.caches.items()}
    if cross is not None:
        out["cache_heads"]["cross"] = (cross["k"].shape[-2],)


def arch_remat(cfg) -> bool:
    """The f64 checks' remat: on for the ssm and hybrid models."""
    return cfg.family in ("ssm", "hybrid")


def attention_input(cfg, seed=3):
    """An f64 (2, D.SEQ, d) input for the attention paths."""
    gen = torch.Generator().manual_seed(seed)
    return torch.randn((2, D.SEQ, cfg.d_model), generator=gen, dtype=torch.float64)


def _f64(mesh, cfg, train, out):
    """lm_loss and its gradients in both loss forms and on the flash path,
    in f64, and the blocked attention's output, on the rank's blocks."""
    from repro_torch.models import attention

    tp = tp_lib.context(mesh)
    cfg64 = cfg.with_(dtype="float64", remat=arch_remat(cfg))
    whole = flat_lib.tree_map(lambda p: p[0].double(), train["params"][cfg.name])
    batch = torch_batch(train["batches"][cfg.name], 0)
    for name, kw in (("f64_0", {}), (f"f64_{CHUNK}", {"vocab_chunk": CHUNK}),
                     ("f64_flash", {"blocked_attn_threshold": FLASH_FROM})):
        params = flat_lib.tree_map(lambda p: p.requires_grad_(),
                                   convert.shard_params(whole, mesh, clients=False))
        with tp_lib.use(tp):
            loss = M.lm_loss(params, cfg64, batch, **kw)
        leaves = flat_lib.tree_leaves(params)
        grads = flat_lib.tree_from_items(zip(
            [p for p, _ in flat_lib.tree_items(params)],
            # an audio model's token embedding is unused: its gradient zeros
            torch.autograd.grad(loss, leaves, materialize_grads=True)))
        out[name] = dict(loss=float(loss.detach()),
                         grads=convert.gather_params(grads, mesh, cfg64, clients=False))
    if "0:attn" not in params["groups"]:
        return
    ap = M._unbind_groups(params["groups"], M.block_pattern(cfg)[1])[0]["0:attn"]["attn"]
    out["blocked"] = attention.blocked_attention(
        flat_lib.tree_map(torch.Tensor.detach, ap), attention_input(cfg), cfg64,
        block_q=BLOCK, block_kv=BLOCK, tp=tp)


def _cross_entropy(mesh, out):
    """The vocab-parallel cross-entropy alone on random f64 logits."""
    tp = tp_lib.context(mesh)
    logits, labels = loss_inputs()
    if logits.shape[-1] % mesh.model_size:  # the vocabulary stays whole
        return
    mask = torch.ones(labels.shape, dtype=torch.float64)
    mask[:, -1] = 0.0
    v_loc = logits.shape[-1] // mesh.model_size
    local = logits[..., mesh.model_rank * v_loc:(mesh.model_rank + 1) * v_loc]
    local = local.clone().requires_grad_()
    ce = layers.cross_entropy(local, labels, mask, tp)
    (g,) = torch.autograd.grad(ce, [local])
    out["ce"] = dict(loss=float(ce.detach()), grad=mesh.model_all_gather(g, -1))


def _round_trip(mesh, cfg, train, out):
    """shard_params then gather_params, client-stacked in f32 and bf16 and
    the one serving copy: the whole trees back on every rank."""
    f32 = train["params"][cfg.name]
    bf16 = flat_lib.tree_map(lambda p: p.to(torch.bfloat16), f32)
    one = flat_lib.tree_map(lambda p: p[0], f32)
    out["round_trip"] = [
        convert.gather_params(convert.shard_params(numpy_tree(f32), mesh), mesh, cfg),
        convert.gather_params(convert.shard_params(bf16, mesh), mesh, cfg),
        convert.gather_params(convert.shard_params(one, mesh, clients=False), mesh, cfg,
                              clients=False)]


def world(rank, world_size, shape, train):
    """Every check of one ("data", "model") layout `shape`; returns this
    rank's results."""
    mesh = mesh_lib.make_test_mesh(shape)
    out = {"coords": (mesh.rank, mesh.model_rank), "model_size": mesh.model_size}
    for arch in ARCHS:
        cfg = get_reduced(arch)
        out[arch] = {}
        _train(mesh, cfg, train, out[arch])
        _round_trip(mesh, cfg, train, out[arch])
        _serve(mesh, cfg, train, out[arch])
        _f64(mesh, cfg, train, out[arch])
    _cross_entropy(mesh, out)
    out["cache"] = {}
    _cache_layouts(mesh, train, out["cache"])
    return out



def zero_heads(rank, world, shape, train):
    """A (1, 5) world of reduced mamba2 under remat, in f64: 16 ssm heads
    split 4, 4, 4, 4 and 0, so the last rank computes none; lm_loss and
    its gradients, then `SERVE_PROMPT` decode steps, on each rank."""
    mesh = mesh_lib.make_test_mesh(shape)
    tp = tp_lib.context(mesh)
    cfg = get_reduced(MAMBA).with_(dtype="float64", remat=True)
    whole = flat_lib.tree_map(lambda p: p[0].double(), train["params"][MAMBA])
    params = flat_lib.tree_map(lambda p: p.requires_grad_(),
                               convert.shard_params(whole, mesh, clients=False))
    with tp_lib.use(tp):
        loss = M.lm_loss(params, cfg, {"tokens": torch.as_tensor(train["tokens"][0])})
    grads = torch.autograd.grad(loss, flat_lib.tree_leaves(params))
    grads = flat_lib.tree_from_items(zip([p for p, _ in flat_lib.tree_items(params)], grads))
    prompt, sshape = serve_inputs()
    state = M.init_decode_state(cfg, SERVE_BATCH, sshape.seq_len, device="cpu", mesh=mesh)
    serve = steps.make_serve_step(cfg, sshape, mesh)
    params = flat_lib.tree_map(torch.Tensor.detach, params)
    logits = [serve(params, prompt[:, t], state)[0] for t in range(SERVE_PROMPT)]
    return dict(loss=float(loss.detach()), heads=state.caches["0:ssm"].h.shape[-3],
                grads=convert.gather_params(grads, mesh, cfg, clients=False),
                serve=torch.stack(logits, dim=1))
