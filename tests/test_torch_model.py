"""repro_torch decoder (configs, layers, attention, model, registry)
against the JAX package.

The inputs come from numpy seeds and the parameters are the reference's
own init, carried over with `convert.params_from_numpy`; everything runs
at the reduced qwen2 config (f32, 2 layers, d_model 192) and the reduced
mamba2 config (f32, 2 layers, d_model 256, 16 SSD heads of 32, state 32,
chunk 32). Tolerance rtol = atol = 1e-5: f32 sums in another order; the
mamba2 logits at 1e-5 of the largest |logit|, for the f32 cumsum reason
that tests/test_torch_ssm.py's docstring gives.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: E402,F401  (autouse: one CPU thread)

from repro.configs import base as jbase
from repro.core import flat as jflat
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import model as jmodel
from repro.models import registry as jregistry
from repro_torch import convert
from repro_torch.configs import base as tbase
from repro_torch.core import flat as tflat
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import model as tmodel
from repro_torch.models import registry as tregistry

TOL = dict(rtol=1e-5, atol=1e-5)
ARCH = "qwen2-1.5b"


def _cfgs(**over):
    return (jbase.get_reduced(ARCH).with_(**over),
            tbase.get_reduced(ARCH).with_(**over))


def _params(jcfg, seed=0):
    jp = jmodel.init_params(jax.random.PRNGKey(seed), jcfg)
    return jp, convert.params_from_numpy(jax.device_get(jp), "cpu")


def _tokens(cfg, b=2, s=16, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s))


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **(tol or TOL))


@pytest.mark.parametrize("which", ["CONFIG", "reduced"])
def test_config_equals_reference(which):
    jmod = __import__("repro.configs.qwen2_1p5b", fromlist=["x"])
    tmod = __import__("repro_torch.configs.qwen2_1p5b", fromlist=["x"])
    jc = jmod.CONFIG if which == "CONFIG" else jmod.reduced()
    tc = tmod.CONFIG if which == "CONFIG" else tmod.reduced()
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert tc.param_count() == jc.param_count()
    assert tc.resolved_head_dim == jc.resolved_head_dim


def test_model_config_fields_and_aliases_match_reference():
    jf = [(f.name, f.default) for f in dataclasses.fields(jbase.ModelConfig)]
    tf = [(f.name, f.default) for f in dataclasses.fields(tbase.ModelConfig)]
    assert tf == jf
    assert tbase.ARCH_ALIASES == jbase.ARCH_ALIASES
    assert tbase.get_config("qwen2_1p5b") == tbase.get_config(ARCH)
    assert tbase.get_config(ARCH).param_count() == 1_543_712_768
    with pytest.raises(ValueError, match="unknown architecture"):
        tbase.get_config("zamba3-2.7b")


def test_rms_norm_matches_reference():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 192)).astype(np.float32) * 3
    scale = rng.standard_normal(192).astype(np.float32) * 0.1
    got = tlayers.rms_norm(torch.as_tensor(x), torch.as_tensor(scale), 1e-6)
    _close(got, jlayers.rms_norm(jnp.asarray(x), jnp.asarray(scale), 1e-6))


def test_rms_norm_keeps_bf16_and_computes_in_f32():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 64)).astype(np.float32)
    scale = rng.standard_normal(64).astype(np.float32) * 0.1
    got = tlayers.rms_norm(torch.as_tensor(x).to(torch.bfloat16),
                           torch.as_tensor(scale).to(torch.bfloat16), 1e-5)
    want = jlayers.rms_norm(jnp.asarray(x, jnp.bfloat16),
                            jnp.asarray(scale, jnp.bfloat16), 1e-5)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_rope_matches_reference(theta):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 9, 3, 32)).astype(np.float32)
    pos = np.stack([np.arange(9), np.arange(9) + 100])
    got = tlayers.apply_rope(torch.as_tensor(x), torch.as_tensor(pos), theta)
    _close(got, jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta))
    _close(tlayers.rope_freqs(32, theta), jlayers.rope_freqs(32, theta))


def test_mlp_matches_reference():
    jcfg, _ = _cfgs()
    jp = jlayers.init_mlp(jax.random.PRNGKey(4), 192, 384, jnp.float32)
    tp = convert.params_from_numpy(jax.device_get(jp), "cpu")
    x = np.random.default_rng(4).standard_normal((2, 7, 192)).astype(np.float32)
    _close(tlayers.mlp(tp, torch.as_tensor(x)), jlayers.mlp(jp, jnp.asarray(x)))


@pytest.mark.parametrize("window", [0, 5])
def test_full_attention_matches_reference(window):
    jcfg, tcfg = _cfgs()
    jp = jattn.init_attention(jax.random.PRNGKey(5), jcfg)
    # non-zero biases, so the QKV bias path is exercised
    jp = {k: (v + 0.1 if k.startswith("b") else v) for k, v in jp.items()}
    tp = convert.params_from_numpy(jax.device_get(jp), "cpu")
    x = np.random.default_rng(5).standard_normal((2, 12, 192)).astype(np.float32)
    got = tattn.full_attention(tp, torch.as_tensor(x), tcfg, sliding_window=window)
    want = jattn.full_attention(jp, jnp.asarray(x), jcfg, sliding_window=window)
    _close(got, want)


def test_grouped_sdpa_reads_kv_head_h_div_nrep():
    """Query head h attends with KV head h // n_rep (attention.py:83)."""
    rng = np.random.default_rng(6)
    b, s, hkv, n_rep, hd = 1, 4, 2, 3, 8
    q = torch.as_tensor(rng.standard_normal((b, s, hkv * n_rep, hd)).astype(np.float32))
    k = torch.as_tensor(rng.standard_normal((b, s, hkv, hd)).astype(np.float32))
    v = torch.as_tensor(rng.standard_normal((b, s, hkv, hd)).astype(np.float32))
    mask = tattn.causal_mask(s, s)
    got = tattn._sdpa_grouped(q, k, v, mask, n_rep)
    want = jattn._sdpa_grouped(jnp.asarray(q.numpy()), jnp.asarray(k.numpy()),
                               jnp.asarray(v.numpy()), jnp.asarray(mask.numpy()), n_rep)
    _close(got, want)
    for h in range(hkv * n_rep):
        one = tattn._sdpa_grouped(q[:, :, h:h + 1], k[:, :, h // n_rep:h // n_rep + 1],
                                  v[:, :, h // n_rep:h // n_rep + 1], mask, 1)
        torch.testing.assert_close(got[:, :, h:h + 1], one, **TOL)


def test_init_layout_and_flat_spec_equal_reference():
    jcfg, tcfg = _cfgs()
    jp = jmodel.init_params(jax.random.PRNGKey(0), jcfg)
    tp = tmodel.init_params(0, tcfg, device="cpu")
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
    assert tp["groups"]["0:attn"]["attn"]["wq"].shape == (2, 192, 192)
    # ravel of the same params is the same plane, column for column
    tconv = convert.params_from_numpy(jax.device_get(jstack), "cpu")
    np.testing.assert_array_equal(tflat.ravel_clients(tconv).numpy(),
                                  np.asarray(jflat.ravel_clients(jstack)))


def test_init_scales_follow_reference():
    """Draws differ (Philox against threefry); layout and scales do not."""
    _, tcfg = _cfgs()
    tp = tmodel.init_params(1, tcfg, device="cpu")
    wq = tp["groups"]["0:attn"]["attn"]["wq"]
    assert abs(float(wq.std()) - 1 / np.sqrt(192)) < 0.01
    assert float(tp["groups"]["0:attn"]["attn"]["bq"].abs().max()) == 0.0
    assert float(tp["final_norm"].abs().max()) == 0.0
    n_params = sum(p.numel() for p in tflat.tree_leaves(tp))
    # the analytic count leaves out the final norm, as the reference's does
    assert n_params == tcfg.param_count() + tcfg.d_model
    bf = tmodel.init_params(1, tcfg.with_(dtype="bfloat16"), device="cpu")
    assert all(p.dtype == torch.bfloat16 for p in tflat.tree_leaves(bf))


@pytest.mark.parametrize("window", [0, 6])
def test_apply_model_logits_match_reference(window):
    jcfg, tcfg = _cfgs(sliding_window=window)
    jp, tp = _params(jcfg)
    tok = _tokens(jcfg)
    want, jaux = jmodel.apply_model(jp, jcfg, {"tokens": jnp.asarray(tok)})
    got, taux = tmodel.apply_model(tp, tcfg, {"tokens": torch.as_tensor(tok)})
    assert got.shape == (2, 16, jcfg.vocab_size)
    _close(got, want)
    assert float(taux) == float(jaux) == 0.0


def test_remat_changes_nothing():
    jcfg, tcfg = _cfgs()
    _, tp = _params(jcfg)
    tok = torch.as_tensor(_tokens(jcfg, seed=3))
    base = tmodel.lm_loss(tp, tcfg, {"tokens": tok})
    remat = tmodel.lm_loss(tp, tcfg.with_(remat=True), {"tokens": tok})
    assert float(base) == float(remat)


def test_labels_and_mask_match_reference():
    tok = _tokens(jbase.get_reduced(ARCH), b=3, s=7, seed=4)
    jl, jm = jmodel._labels_and_mask({"tokens": jnp.asarray(tok)})
    tl, tm = tmodel._labels_and_mask({"tokens": torch.as_tensor(tok)})
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))


def test_lm_loss_and_gradients_match_reference():
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg, seed=2)
    tok = _tokens(jcfg, seed=5)
    jloss, jgrads = jax.value_and_grad(
        lambda p: jmodel.lm_loss(p, jcfg, {"tokens": jnp.asarray(tok)}))(jp)
    tp = tflat.tree_map(lambda p: p.requires_grad_(), tp)
    tloss = tmodel.lm_loss(tp, tcfg, {"tokens": torch.as_tensor(tok)})
    tgrads = torch.autograd.grad(tloss, tflat.tree_leaves(tp))
    _close(tloss, jloss)
    jleaves = jax.tree_util.tree_leaves(jgrads)
    assert len(tgrads) == len(jleaves)
    for g, jg in zip(tgrads, jleaves):
        _close(g, jg)


def test_registry_builds_the_same_surface():
    jm = jregistry.build_reduced(ARCH)
    tm = tregistry.build_reduced(ARCH)
    assert dataclasses.asdict(tm.cfg) == dataclasses.asdict(jm.cfg)
    jp = jm.init(jax.random.PRNGKey(7))
    tp = convert.params_from_numpy(jax.device_get(jp), "cpu")
    tok = _tokens(jm.cfg, seed=7)
    _close(tm.loss(tp, {"tokens": torch.as_tensor(tok)}),
           jm.loss(jp, {"tokens": jnp.asarray(tok)}))
    logits, _ = tm.apply(tp, {"tokens": torch.as_tensor(tok)})
    assert logits.shape == (2, 16, jm.cfg.vocab_size)
    assert tm.init(0, device="cpu").keys() == jp.keys()


def test_other_families_raise(monkeypatch):
    """A family the reference does not know raises. At S >= 8192, where
    the reference switches to the flash path, the port takes it too: its
    logits over the first 1024 positions equal the full-attention path's
    over that prefix (causal attention sees no later position)."""
    cfg = tbase.get_reduced(ARCH)
    with pytest.raises(ValueError, match="unknown model family"):
        tmodel.block_pattern(cfg.with_(family="rnn"))
    cfg1 = cfg.with_(num_layers=1)
    params = tmodel.init_params(0, cfg1, device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (1, 8192),
                           generator=torch.Generator().manual_seed(0))
    calls = []
    flash = tattn.flash_self_attention

    def spy(*args, **kw):
        calls.append(args[1].shape[1])
        return flash(*args, **kw)

    monkeypatch.setattr(tattn, "flash_self_attention", spy)
    with torch.no_grad():
        long, _ = tmodel.apply_model(params, cfg1, {"tokens": tokens})
        prefix, _ = tmodel.apply_model(params, cfg1, {"tokens": tokens[:, :1024]})
    assert calls == [8192]
    assert bool(torch.isfinite(long).all())
    torch.testing.assert_close(long[:, :1024], prefix, **TOL)


def test_bf16_params_carry_over_bit_for_bit():
    jcfg, _ = _cfgs(dtype="bfloat16")
    jp = jmodel.init_params(jax.random.PRNGKey(8), jcfg)
    tp = convert.params_from_numpy(jax.device_get(jp), "cpu")
    for (path, jl), tl in zip(jax.tree_util.tree_flatten_with_path(jp)[0],
                              tflat.tree_leaves(tp)):
        assert tl.dtype == torch.bfloat16, path
        np.testing.assert_array_equal(tl.view(torch.int16).numpy(),
                                      np.asarray(jl).view(np.int16))


# ---- the ssm family: mamba2-2.7b ----------------------------------------
SSM_ARCH = "mamba2-2.7b"


def _ssm_cfgs(**over):
    return (jbase.get_reduced(SSM_ARCH).with_(**over),
            tbase.get_reduced(SSM_ARCH).with_(**over))


@pytest.mark.parametrize("which", ["CONFIG", "reduced"])
def test_mamba2_config_equals_reference(which):
    jmod = __import__("repro.configs.mamba2_2p7b", fromlist=["x"])
    tmod = __import__("repro_torch.configs.mamba2_2p7b", fromlist=["x"])
    jc = jmod.CONFIG if which == "CONFIG" else jmod.reduced()
    tc = tmod.CONFIG if which == "CONFIG" else tmod.reduced()
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert tc.param_count() == jc.param_count()
    assert (tc.d_inner, tc.ssm_heads) == (jc.d_inner, jc.ssm_heads)
    assert tbase.get_config(SSM_ARCH) == tmod.CONFIG


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba2_init_layout_flat_spec_and_dtypes_equal_reference(dtype):
    jcfg, tcfg = _ssm_cfgs(dtype=dtype)
    jp = jmodel.init_params(jax.random.PRNGKey(0), jcfg)
    tp = tmodel.init_params(0, tcfg, device="cpu")
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
    ssm = tp["groups"]["0:ssm"]["ssm"]
    assert ssm["in_proj"].shape == (2, 256, 2 * 512 + 2 * 32 + 16)
    # f32 leaves inside a model of another dtype, as in the reference
    for k in ("a_log", "dt_bias", "ssm_d"):
        assert ssm[k].dtype == torch.float32 and ssm[k].shape == (2, 16)
    assert ssm["out_proj"].dtype == tcfg.torch_dtype
    n_params = sum(p.numel() for p in tflat.tree_leaves(tp))
    assert n_params == sum(int(np.prod(p.shape)) for p in jax.tree_util.tree_leaves(jp))
    # the analytic count leaves out the final norm, conv_b and dt_bias
    conv_ch = tcfg.d_inner + 2 * tcfg.ssm_groups * tcfg.ssm_state
    assert n_params == (tcfg.param_count() + tcfg.d_model
                        + tcfg.num_layers * (conv_ch + tcfg.ssm_heads))
    tconv = convert.params_from_numpy(jax.device_get(jstack), "cpu")
    np.testing.assert_array_equal(tflat.ravel_clients(tconv).numpy(),
                                  np.asarray(jflat.ravel_clients(jstack)))


def _ssm_params(jcfg, seed=0):
    jp = jmodel.init_params(jax.random.PRNGKey(seed), jcfg)
    # non-zero norm gains and biases, so those paths are exercised
    jp = jax.tree_util.tree_map_with_path(
        lambda path, v: v + 0.1 if path[-1].key in ("norm", "gnorm", "conv_b") else v, jp)
    return jp, convert.params_from_numpy(jax.device_get(jp), "cpu")


def _close_scaled(got, want, tol=1e-5):
    want = np.asarray(want)
    _close(got, want, rtol=tol, atol=tol * float(np.abs(want).max()))


@pytest.mark.parametrize("seq", [16, 64], ids=["one-short-chunk", "two-chunks"])
def test_mamba2_apply_model_logits_match_reference(seq):
    jcfg, tcfg = _ssm_cfgs()
    jp, tp = _ssm_params(jcfg)
    tok = _tokens(jcfg, s=seq, seed=seq)
    want, jaux = jmodel.apply_model(jp, jcfg, {"tokens": jnp.asarray(tok)})
    got, taux = tmodel.apply_model(tp, tcfg, {"tokens": torch.as_tensor(tok)})
    assert got.shape == (2, seq, jcfg.vocab_size)
    _close_scaled(got, want)
    assert float(taux) == float(jaux) == 0.0


def test_mamba2_lm_loss_and_gradients_match_reference():
    jcfg, tcfg = _ssm_cfgs()
    jp, tp = _ssm_params(jcfg, seed=2)
    tok = _tokens(jcfg, s=64, seed=5)
    jloss, jgrads = jax.value_and_grad(
        lambda p: jmodel.lm_loss(p, jcfg, {"tokens": jnp.asarray(tok)}))(jp)
    tp = tflat.tree_map(lambda p: p.requires_grad_(), tp)
    tloss = tmodel.lm_loss(tp, tcfg, {"tokens": torch.as_tensor(tok)})
    tgrads = torch.autograd.grad(tloss, tflat.tree_leaves(tp))
    _close(tloss, jloss)
    jleaves = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    assert len(tgrads) == len(jleaves)
    for g, (path, jg) in zip(tgrads, jleaves):
        _close_scaled(g, jg, tol=1e-4)


def test_mamba2_plain_chunk_path_equals_kernel_path_on_cpu():
    """On the CPU the kernel wrapper takes `ssd_chunk_ref`, so the two
    paths `chunk_fn` selects give the same loss and gradients."""
    from repro_torch.kernels.ssd.ref import ssd_chunk_ref

    jcfg, tcfg = _ssm_cfgs()
    _, tp = _ssm_params(jcfg, seed=3)
    batch = {"tokens": torch.as_tensor(_tokens(jcfg, s=64, seed=6))}
    out = []
    for chunk_fn in (None, ssd_chunk_ref):
        leaves = tflat.tree_map(lambda p: p.detach().clone().requires_grad_(), tp)
        loss = tmodel.lm_loss(leaves, tcfg, batch, chunk_fn=chunk_fn)
        out.append((loss, torch.autograd.grad(loss, tflat.tree_leaves(leaves))))
    torch.testing.assert_close(out[0][0], out[1][0], rtol=0, atol=0)
    for a, b in zip(out[0][1], out[1][1]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def test_mamba2_remat_changes_nothing():
    jcfg, tcfg = _ssm_cfgs()
    _, tp = _ssm_params(jcfg)
    tok = torch.as_tensor(_tokens(jcfg, s=64, seed=3))
    base = tmodel.lm_loss(tp, tcfg, {"tokens": tok})
    remat = tmodel.lm_loss(tp, tcfg.with_(remat=True), {"tokens": tok})
    assert float(base) == float(remat)


def test_mamba2_registry_builds_the_same_surface():
    full = tregistry.build_model(SSM_ARCH)
    assert full.cfg.num_heads == 0 and full.cfg.family == "ssm"
    assert full.cfg.param_count() == jregistry.build_model(SSM_ARCH).cfg.param_count()
    assert tmodel.block_pattern(full.cfg) == (("ssm",), 64)
    jm, tm = jregistry.build_reduced(SSM_ARCH), tregistry.build_reduced(SSM_ARCH)
    assert dataclasses.asdict(tm.cfg) == dataclasses.asdict(jm.cfg)
    jp = jm.init(jax.random.PRNGKey(7))
    tp = convert.params_from_numpy(jax.device_get(jp), "cpu")
    tok = _tokens(jm.cfg, s=32, seed=7)
    _close(tm.loss(tp, {"tokens": torch.as_tensor(tok)}),
           jm.loss(jp, {"tokens": jnp.asarray(tok)}))
    assert tm.init(0, device="cpu").keys() == jp.keys()


def test_mamba2_mixed_dtype_params_carry_over_bit_for_bit():
    """A bf16 model keeps a_log, dt_bias and ssm_d in f32: each leaf
    crosses with its own dtype, bit for bit."""
    jcfg, _ = _ssm_cfgs(dtype="bfloat16")
    jp = jmodel.init_params(jax.random.PRNGKey(8), jcfg)
    tp = convert.params_from_numpy(jax.device_get(jp), "cpu")
    dtypes = set()
    for (path, jl), tl in zip(jax.tree_util.tree_flatten_with_path(jp)[0],
                              tflat.tree_leaves(tp)):
        jl = np.asarray(jl)
        dtypes.add(str(tl.dtype))
        if jl.dtype.name == "bfloat16":
            assert tl.dtype == torch.bfloat16, path
            np.testing.assert_array_equal(tl.view(torch.int16).numpy(), jl.view(np.int16))
        else:
            assert tl.dtype == torch.float32, path
            np.testing.assert_array_equal(tl.numpy(), jl)
    assert dtypes == {"torch.bfloat16", "torch.float32"}
