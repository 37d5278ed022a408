"""repro_torch's moe, hybrid, vlm and audio families and every remaining
model config, against the JAX package.

All reduced configs in f32 (2 layers; olmoe and qwen3-moe 4 experts top-2,
zamba2 a shared block every 2 layers with 8 SSD heads of 32 and chunk 32,
llama-3.2-vision a cross layer every 2 with 16 patch tokens, musicgen
frame embeddings in). The parameters are the reference's own init,
carried over with `convert.params_from_numpy`, their norm gains, biases
and the vlm's tanh gate moved off zero so those paths count; inputs come
from numpy seeds. Tolerance rtol = atol = 1e-5 for a forward and a
gradient (f32 sums in another order); the trainer's steps are in
tests/test_torch_families_train.py. zamba2's SSD blocks are
held as tests/test_torch_model.py holds mamba2's: the logits at 1e-5 and
the gradients at 1e-4 of the largest |value|, for the f32 cumsum reason
tests/test_torch_ssm.py's docstring gives.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401  (autouse: one CPU thread)

from repro.configs import base as jbase  # noqa: E402
from repro.core import flat as jflat  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import registry as jregistry  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.core import flat as tflat  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import registry as tregistry  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
MOE = ["olmoe-1b-7b", "qwen3-moe-30b-a3b"]
FAMILIES = MOE + ["zamba2-2.7b", "llama-3.2-vision-11b", "musicgen-large"]
DENSE = ["stablelm-3b", "qwen2.5-32b", "yi-34b"]
NEW_MODULES = ["olmoe_1b_7b", "qwen3_moe_30b_a3b", "zamba2_2p7b", "llama3p2_vision_11b",
               "musicgen_large", "stablelm_3b", "qwen2p5_32b", "yi_34b"]
# gains, biases and the tanh gate, zero at init: moved so that they count
MOVED = ("norm", "gnorm", "conv_b", "norm_attn", "norm_mlp", "final_norm", "gate",
         "bq", "bk", "bv")


def _cfgs(arch, **over):
    return jbase.get_reduced(arch).with_(**over), tbase.get_reduced(arch).with_(**over)


def _seq(cfg):
    """Two SSD chunks for zamba2, 16 tokens for the others."""
    return 2 * cfg.ssm_chunk if cfg.family == "hybrid" else 16


def _params(jcfg, seed=0):
    jp = jmodel.init_params(jax.random.PRNGKey(seed), jcfg)
    jp = jax.tree_util.tree_map_with_path(
        lambda path, v: v + 0.1 if path[-1].key in MOVED else v, jp)
    return jp, convert.params_from_numpy(jax.device_get(jp), "cpu")


def _batch(cfg, lead=(2,), s=16, seed=0):
    """Numpy inputs with `make_batches`' keys, leading axes `lead`."""
    rng = np.random.default_rng(seed)
    out = {}
    if cfg.embeds_in:
        out["embeds"] = rng.standard_normal(lead + (s, cfg.d_model)).astype(np.float32)
        out["labels"] = rng.integers(0, cfg.vocab_size, lead + (s,))
    else:
        out["tokens"] = rng.integers(0, cfg.vocab_size, lead + (s,))
    if cfg.family == "vlm":
        out["cross_embeds"] = rng.standard_normal(
            lead + (cfg.num_patch_tokens, cfg.d_model)).astype(np.float32)
    return out


def _both(batch):
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.as_tensor(v) for k, v in batch.items()})


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **(tol or TOL))


def _close_scaled(got, want, tol=1e-5):
    want = np.asarray(want)
    _close(got, want, rtol=tol, atol=tol * float(np.abs(want).max()))


def _grads(loss, tree):
    """d loss / d leaf for every leaf of `tree` in flatten order; a leaf
    the loss does not reach gets zeros, as JAX gives."""
    leaves = tflat.tree_leaves(tree)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g for g, p in zip(grads, leaves)]


# ---- configs -------------------------------------------------------------


@pytest.mark.parametrize("which", ["CONFIG", "reduced"])
@pytest.mark.parametrize("mod", NEW_MODULES)
def test_config_equals_reference(mod, which):
    jmod = __import__(f"repro.configs.{mod}", fromlist=["x"])
    tmod = __import__(f"repro_torch.configs.{mod}", fromlist=["x"])
    jc = jmod.CONFIG if which == "CONFIG" else jmod.reduced()
    tc = tmod.CONFIG if which == "CONFIG" else tmod.reduced()
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert tc.param_count() == jc.param_count()
    assert tc.active_param_count() == jc.active_param_count()
    assert (tc.resolved_head_dim, tc.d_inner, tc.ssm_heads) == (
        jc.resolved_head_dim, jc.d_inner, jc.ssm_heads)


def test_arch_ids_shapes_and_all_configs_equal_reference():
    assert tbase.ARCH_IDS == jbase.ARCH_IDS
    assert {k: dataclasses.asdict(v) for k, v in tbase.SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in jbase.SHAPES.items()}
    tall, jall = tbase.all_configs(), jbase.all_configs()
    assert list(tall) == list(jall) == list(jbase.ARCH_IDS)
    for a in jbase.ARCH_IDS:
        assert dataclasses.asdict(tall[a]) == dataclasses.asdict(jall[a])
    for alias, mod in tbase.ARCH_ALIASES.items():
        assert tbase.get_config(alias) == tbase.get_config(mod) == tall[mod]
        assert dataclasses.asdict(tbase.get_reduced(alias)) == dataclasses.asdict(
            jbase.get_reduced(alias))


@pytest.mark.parametrize("arch", ["gpt-9", "qwen2_1p5", "base"])
def test_unknown_architecture_raises(arch):
    with pytest.raises(ValueError, match="unknown architecture"):
        tbase.get_config(arch)


# ---- init layout ---------------------------------------------------------


@pytest.mark.parametrize("arch", FAMILIES + DENSE)
def test_init_layout_and_flat_spec_equal_reference(arch):
    """Paths, shapes, offsets and dtypes of the client-stacked plane as
    the JAX ravel's: the router in f32, zamba2's shared block beside the
    groups (its empty sub-block has no leaf), the vlm's 0-d gate one
    column per group."""
    jcfg, tcfg = _cfgs(arch)
    jp = jmodel.init_params(jax.random.PRNGKey(0), jcfg)
    tp = tmodel.init_params(0, tcfg, device="cpu")
    assert tp.keys() == jp.keys() and tp["groups"].keys() == jp["groups"].keys()
    n = 3
    jstack = jax.tree_util.tree_map(lambda p: jnp.broadcast_to(p[None], (n,) + p.shape), jp)
    tstack = tflat.tree_map(lambda p: p[None].expand(n, *p.shape), tp)
    jspec, tspec = jflat.spec_of(jstack), tflat.spec_of(tstack)
    jpaths = [tuple(k.key for k in path)
              for path, _ in jax.tree_util.tree_flatten_with_path(jstack)[0]]
    assert list(tspec.paths) == jpaths
    assert tspec.shapes == jspec.shapes
    assert tspec.offsets == jspec.offsets and tspec.sizes == jspec.sizes
    assert tspec.dim == jspec.dim
    assert [str(d).split(".")[-1] for d in tspec.dtypes] == [str(d) for d in jspec.dtypes]
    tconv = convert.params_from_numpy(jax.device_get(jstack), "cpu")
    assert tflat.spec_of(tconv) == tspec
    np.testing.assert_array_equal(tflat.ravel_clients(tconv).numpy(),
                                  np.asarray(jflat.ravel_clients(jstack)))
    n_groups = tmodel.block_pattern(tcfg)[1]
    if tcfg.family == "vlm":
        assert tp["groups"]["2:cross"]["gate"].shape == (n_groups,)
        assert "bq" not in tp["groups"]["2:cross"]["attn"]
    if tcfg.family == "hybrid":
        assert tp["groups"]["2:shared"] == {} and "shared" in tp
        assert tspec.paths[-1][0] == "shared"
    if tcfg.family == "moe":
        assert tp["groups"]["1:moe"]["moe"]["router"].dtype == torch.float32
        assert tp["groups"]["1:moe"]["moe"]["experts_gate"].shape == (
            n_groups, tcfg.num_experts, tcfg.d_model, tcfg.d_ff)


@pytest.mark.parametrize("arch", FAMILIES + DENSE)
def test_init_scales_and_counts_follow_reference(arch):
    """Draws differ (Philox against threefry); layout, scales and counts
    do not, also in bf16."""
    _, tcfg = _cfgs(arch)
    tp = tmodel.init_params(1, tcfg, device="cpu")
    jp = jmodel.init_params(jax.random.PRNGKey(1), jbase.get_reduced(arch))
    n_params = sum(p.numel() for p in tflat.tree_leaves(tp))
    assert n_params == sum(int(np.prod(p.shape)) for p in jax.tree_util.tree_leaves(jp))
    assert abs(float(tp["embed"].std()) - 1 / math.sqrt(tcfg.d_model)) < 0.01
    for path, leaf in tflat.tree_items(tp):
        if path[-1] in MOVED:
            assert float(leaf.abs().max()) == 0.0, path
    bf = tmodel.init_params(1, tcfg.with_(dtype="bfloat16"), device="cpu")
    dtypes = {p[-1]: leaf.dtype for p, leaf in tflat.tree_items(bf)}
    assert dtypes["embed"] == torch.bfloat16
    if tcfg.family == "moe":
        assert dtypes["router"] == torch.float32


# ---- forward and gradients -----------------------------------------------


def _close_logits(tcfg, got, want):
    (_close_scaled if tcfg.family == "hybrid" else _close)(got, want)


@pytest.mark.parametrize("arch", FAMILIES + DENSE)
def test_apply_model_logits_and_aux_match_reference(arch):
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _params(jcfg)
    s = _seq(tcfg)
    jb, tb = _both(_batch(tcfg, s=s, seed=1))
    want, jaux = jmodel.apply_model(jp, jcfg, jb)
    got, taux = tmodel.apply_model(tp, tcfg, tb)
    assert got.shape == (2, s, tcfg.vocab_size)
    _close_logits(tcfg, got, want)
    _close(taux, jaux)
    assert (float(taux) > 0) == (tcfg.family == "moe")


@pytest.mark.parametrize("arch", FAMILIES)
def test_lm_loss_and_gradients_match_reference(arch):
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _params(jcfg, seed=2)
    jb, tb = _both(_batch(tcfg, s=_seq(tcfg), seed=3))
    jloss, jgrads = jax.value_and_grad(lambda p: jmodel.lm_loss(p, jcfg, jb))(jp)
    tp = tflat.tree_map(lambda p: p.requires_grad_(), tp)
    tloss = tmodel.lm_loss(tp, tcfg, tb)
    _close(tloss, jloss)
    jleaves = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    tgrads = _grads(tloss, tp)
    assert len(tgrads) == len(jleaves)
    for g, (path, jg) in zip(tgrads, jleaves):
        if tcfg.family == "hybrid":
            _close_scaled(g, jg, tol=1e-4)
        else:
            _close(g, jg)
    if tcfg.embeds_in:  # the token embedding is not read: zero gradient
        assert float(np.abs(np.asarray(jgrads["embed"])).max()) == 0.0


@pytest.mark.parametrize("arch", FAMILIES)
def test_remat_changes_nothing(arch):
    """Each group under `torch.utils.checkpoint` gives the same loss and
    gradients, the shared block's (summed over its applications) too."""
    _, tcfg = _cfgs(arch)
    _, tp = _params(jbase.get_reduced(arch), seed=4)
    tb = _both(_batch(tcfg, s=_seq(tcfg), seed=4))[1]
    out = []
    for remat in (False, True):
        leaves = tflat.tree_map(lambda p: p.detach().clone().requires_grad_(), tp)
        loss = tmodel.lm_loss(leaves, tcfg.with_(remat=remat), tb)
        out.append((loss, _grads(loss, leaves)))
    assert float(out[0][0].detach()) == float(out[1][0].detach())
    for a, b in zip(out[0][1], out[1][1]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    if tcfg.family == "hybrid":
        assert float(out[1][1][-1].abs().max()) > 0  # a shared leaf learns


def test_labels_and_mask_take_the_batch_labels():
    cfg = jbase.get_reduced("musicgen-large")
    b = _batch(cfg, lead=(3,), s=7, seed=5)
    jl, jm = jmodel._labels_and_mask({k: jnp.asarray(v) for k, v in b.items()})
    tl, tm = tmodel._labels_and_mask({k: torch.as_tensor(v) for k, v in b.items()})
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(tl.numpy(), b["labels"])
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    assert tm[:, -1].sum() == 0 and tm[:, :-1].min() == 1


@pytest.mark.parametrize("arch", FAMILIES)
def test_registry_builds_the_same_surface(arch):
    jm, tm = jregistry.build_reduced(arch), tregistry.build_reduced(arch)
    assert dataclasses.asdict(tm.cfg) == dataclasses.asdict(jm.cfg)
    jp = jm.init(jax.random.PRNGKey(7))
    tp = convert.params_from_numpy(jax.device_get(jp), "cpu")
    jb, tb = _both(_batch(jm.cfg, s=_seq(jm.cfg), seed=7))
    _close(tm.loss(tp, tb), jm.loss(jp, jb))
    logits, _ = tm.apply(tp, tb)
    assert logits.shape == (2, _seq(jm.cfg), jm.cfg.vocab_size)
    assert tm.init(0, device="cpu").keys() == jp.keys()
    full = tregistry.build_model(arch)
    assert full.cfg.param_count() == jregistry.build_model(arch).cfg.param_count()
    assert tmodel.block_pattern(full.cfg) == jmodel.block_pattern(full.cfg)


# ---- the moe block -------------------------------------------------------

# (capacity factor, tokens): ample capacity (nothing dropped); the
# config's 1.25; capacity ~0, the floor of 8 slots (most tokens dropped);
# a T whose capacity rounds up to the next multiple of 8
MOE_CASES = {"ample": (8.0, 32), "default": (1.25, 32), "drop": (1e-6, 32),
             "rounding": (1.25, 52)}


def _moe_setup(arch, cf, t, seed=0):
    jcfg, tcfg = _cfgs(arch, capacity_factor=cf)
    jp = jmoe.init_moe(jax.random.PRNGKey(seed), jcfg)
    tp = convert.params_from_numpy(jax.device_get(jp), "cpu")
    x = np.random.default_rng(seed).standard_normal((2, t // 2, jcfg.d_model)).astype(np.float32)
    return jcfg, tcfg, jp, tp, x


@pytest.mark.parametrize("case", list(MOE_CASES))
@pytest.mark.parametrize("arch", MOE)
def test_moe_block_matches_reference(arch, case):
    cf, t = MOE_CASES[case]
    jcfg, tcfg, jp, tp, x = _moe_setup(arch, cf, t)
    assert tmoe._capacity(t, tcfg) == jmoe._capacity(t, jcfg)
    want, jaux = jmoe.moe_block(jp, jnp.asarray(x), jcfg)
    got, taux = tmoe.moe_block(tp, torch.as_tensor(x), tcfg)
    _close(got, want)
    _close(taux, jaux)
    # the same tokens dropped: the drop case leaves rows of zeros
    np.testing.assert_array_equal(got.detach().abs().sum(-1).numpy() == 0,
                                  np.abs(np.asarray(want)).sum(-1) == 0)
    if case == "drop":
        assert int((got.abs().sum(-1) == 0).sum()) > 0

    def jloss(p, xx):
        out, aux = jmoe.moe_block(p, xx, jcfg)
        return (out ** 2).mean() + aux

    jg, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    tp = tflat.tree_map(lambda p: p.requires_grad_(), tp)
    tx = torch.as_tensor(x).requires_grad_()
    out, aux = tmoe.moe_block(tp, tx, tcfg)
    grads = torch.autograd.grad((out ** 2).mean() + aux, tflat.tree_leaves(tp) + [tx])
    for g, want_g in zip(grads, jax.tree_util.tree_leaves(jg) + [jgx]):
        _close(g, want_g)


@pytest.mark.parametrize("t", [1, 7, 16, 100, 1024, 4096])
@pytest.mark.parametrize("arch", MOE)
def test_capacity_rounds_like_the_reference(arch, t):
    for cf in (1e-6, 1.0, 1.25, 2.0):
        jcfg, tcfg = _cfgs(arch, capacity_factor=cf)
        c = tmoe._capacity(t, tcfg)
        assert c == jmoe._capacity(t, jcfg)
        assert c % 8 == 0 and c >= 8


def test_moe_aux_under_a_uniform_router_is_the_weight():
    """Every expert equally likely: aux = E * sum(1/E * density) * w = w,
    whatever the top-k picks among the ties."""
    _, tcfg, _, tp, x = _moe_setup("olmoe-1b-7b", 8.0, 32)
    tp["router"] = torch.zeros_like(tp["router"])
    _, aux = tmoe.moe_block(tp, torch.as_tensor(x), tcfg)
    np.testing.assert_allclose(float(aux), tcfg.router_aux_weight, rtol=1e-6)


# ---- cross attention -----------------------------------------------------


@pytest.mark.parametrize("patches", [16, 5])
def test_cross_attention_matches_reference(patches):
    """`full_attention(..., kv_x=, cross=True)`: no RoPE, every patch
    visible from every position, GQA (4 heads over 2 KV heads)."""
    jcfg, tcfg = _cfgs("llama-3.2-vision-11b")
    jp = jattn.init_attention(jax.random.PRNGKey(5), jcfg, cross=True)
    tp = convert.params_from_numpy(jax.device_get(jp), "cpu")
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 12, jcfg.d_model)).astype(np.float32)
    kv = rng.standard_normal((2, patches, jcfg.d_model)).astype(np.float32)
    want = jattn.full_attention(jp, jnp.asarray(x), jcfg, kv_x=jnp.asarray(kv), cross=True)
    got = tattn.full_attention(tp, torch.as_tensor(x), tcfg, kv_x=torch.as_tensor(kv),
                               cross=True)
    _close(got, want)
    # position-free: a permutation of the queries permutes the output
    perm = torch.randperm(12, generator=torch.Generator().manual_seed(0))
    again = tattn.full_attention(tp, torch.as_tensor(x)[:, perm], tcfg,
                                 kv_x=torch.as_tensor(kv), cross=True)
    torch.testing.assert_close(again, got[:, perm], **TOL)


def test_cross_layers_have_no_qkv_bias():
    jcfg, tcfg = _cfgs("qwen2.5-32b")
    assert tcfg.qkv_bias
    gen = torch.Generator().manual_seed(0)
    assert set(tattn.init_attention(gen, tcfg, cross=True)) == set(
        jattn.init_attention(jax.random.PRNGKey(0), jcfg, cross=True))
    assert "bq" in tattn.init_attention(gen, tcfg) and "bq" not in tattn.init_attention(
        gen, tcfg, cross=True)
