"""repro_torch Mamba2 SSD (the intra-chunk step, the SSD forward, the
sequential oracle, the block) against the JAX package.

Inputs come from numpy seeds and go through both packages in f32. On the
CPU the port's `ssd_chunk` takes its plain version `ssd_chunk_ref`; both
are held against the reference's Pallas kernel in interpret mode, and
the SSD forms against their JAX counterparts. Tolerance rtol = atol =
1e-5 (f32 sums in another order), with one exception: the forms that
compute ``cums = cumsum(dt * A)`` themselves are held at 1e-5 of the
largest |y| (`_close_scaled`). XLA's CPU cumsum is an associative scan
and torch's a sequential sum; where |cums| reaches 30 their f32 roundings
differ by a few units in the last place, and exp(cums_i - cums_j)
carries that into terms of |y| ~ 30 that cancel to small outputs.
`test_ssd_forward_meets_1e5_with_the_reference_cumsum` shows that the
cumsum is the whole difference: with XLA's cumsum substituted, the
port's SSD forward meets rtol = atol = 1e-5 element by element. Against
the sequential oracle the bound is 5e-4, the JAX package's own. The
kernel itself runs only on the card (tests/test_torch_cuda.py,
chip_smoke.py); `test_three_bf16_terms_meet_f32_accuracy` holds its bf16
arithmetic, emulated in plain torch, to 1e-5 of the largest |Y|, |S|.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: E402,F401  (autouse: one CPU thread)

from repro.configs.base import get_reduced as jget_reduced
from repro.kernels.ssd.ops import ssd_forward_kernel
from repro.kernels.ssd.ssd import ssd_chunk_pallas
from repro.models import ssm as jssm
from repro_torch import convert
from repro_torch.configs.base import get_reduced
from repro_torch.kernels import build
from repro_torch.kernels.ssd import ops as tops
from repro_torch.kernels.ssd import variants
from repro_torch.kernels.ssd.ref import ssd_chunk_ref
from repro_torch.models import ssm as tssm

TOL = dict(rtol=1e-5, atol=1e-5)
ORACLE_TOL = dict(rtol=5e-4, atol=5e-4)
ARCH = "mamba2-2.7b"

# (B, T, H, P, G, N, chunk): tests/test_kernels_ssd.py's cases
CASES = [
    (2, 64, 4, 8, 2, 16, 16),
    (1, 128, 8, 16, 1, 32, 32),
    (2, 96, 6, 8, 3, 8, 32),
    (1, 32, 2, 4, 1, 4, 8),
]
IDS = ["g2", "g1-q32", "g3", "tiny"]


def _softplus(v):
    return np.log1p(np.exp(v))


def _inputs(case, seed=0, decay=1.0):
    """x, dt, A, B_, C_, D as f32 numpy (`decay` scales A)."""
    B, T, H, P, G, N, _ = case
    rng = np.random.default_rng(seed)
    f = np.float32
    return (rng.standard_normal((B, T, H, P)).astype(f),
            _softplus(rng.standard_normal((B, T, H))).astype(f),
            (-decay * np.exp(rng.standard_normal(H))).astype(f),
            rng.standard_normal((B, T, G, N)).astype(f),
            rng.standard_normal((B, T, G, N)).astype(f),
            np.ones(H, f))


def _chunk_inputs(case, seed=0):
    """The reference wrapper's head-major (BH, nc, Q, .) intra-chunk
    inputs, with B_ and C_ repeated over the heads of their group."""
    B, T, H, P, G, N, Q = case
    x, dt, A, B_, C_, _ = _inputs(case, seed)
    rep, nc = H // G, T // Q
    xh = np.moveaxis(x, 2, 1).reshape(B * H, nc, Q, P)
    dth = np.moveaxis(dt, 2, 1).reshape(B * H, nc, Q)
    Bh = np.moveaxis(np.repeat(B_, rep, axis=2), 2, 1).reshape(B * H, nc, Q, N)
    Ch = np.moveaxis(np.repeat(C_, rep, axis=2), 2, 1).reshape(B * H, nc, Q, N)
    cums = np.cumsum(dth * np.tile(A, B)[:, None, None], axis=2).astype(np.float32)
    return Ch, Bh, xh, cums, dth


def _t(*arrays):
    return [torch.as_tensor(a) for a in arrays]


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **(tol or TOL))


def _close_scaled(got, want, tol=1e-5):
    """|got - want| <= tol * (|want| + max |want|): f32 agreement at the
    scale of the terms that were summed (see the module docstring)."""
    want = np.asarray(want)
    _close(got, want, rtol=tol, atol=tol * float(np.abs(want).max()))


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_chunk_ref_matches_pallas_interpret(case):
    args = _chunk_inputs(case, seed=3)
    want_y, want_s = ssd_chunk_pallas(*map(jnp.asarray, args), interpret=True)
    got_y, got_s = ssd_chunk_ref(*_t(*args))
    assert got_y.dtype == got_s.dtype == torch.float32
    _close(got_y, want_y)
    _close(got_s, want_s)
    # the wrapper takes the plain version for CPU tensors; the reference
    # layout is its grouped one with a single batch row and a group per head
    wrap_y, wrap_s = tops.ssd_chunk(*(t.unsqueeze(0) for t in _t(*args)))
    torch.testing.assert_close(wrap_y[0], got_y, rtol=0, atol=0)
    torch.testing.assert_close(wrap_s[0], got_s, rtol=0, atol=0)


def test_chunk_wrapper_takes_only_the_grouped_layout():
    args = _t(*_chunk_inputs(CASES[0]))
    with pytest.raises(ValueError, match="grouped layout"):
        tops.ssd_chunk(*args)
    C, B, x, cums, dt = (t.unsqueeze(0) for t in args)
    with pytest.raises(ValueError, match="multiple of G"):
        tops.ssd_chunk(C, B, x[:, :-1], cums[:, :-1], dt[:, :-1])
    with pytest.raises(ValueError, match="must be"):
        tops.ssd_chunk(C, B, x, cums[..., :-1], dt)


def _grouped(case, seed=0):
    """The port's grouped layout: C, B (Bb, G, nc, Q, N) views, x (Bb, H,
    nc, Q, P), cums, dt (Bb, H, nc, Q)."""
    B, T, H, P, G, N, Q = case
    x, dt, A, B_, C_, _ = _inputs(case, seed)
    nc = T // Q
    xg = torch.as_tensor(x).reshape(B, nc, Q, H, P).permute(0, 3, 1, 2, 4)
    Bg = torch.as_tensor(B_).reshape(B, nc, Q, G, N).permute(0, 3, 1, 2, 4)
    Cg = torch.as_tensor(C_).reshape(B, nc, Q, G, N).permute(0, 3, 1, 2, 4)
    dtg = torch.as_tensor(dt).reshape(B, nc, Q, H).permute(0, 3, 1, 2).contiguous()
    cums = torch.cumsum(dtg * torch.as_tensor(A)[None, :, None, None], dim=-1)
    return Cg, Bg, xg, cums, dtg


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_grouped_layout_equals_heads_repeated(case):
    """Head h reads group h // (H // G): the grouped call equals the
    reference layout with B and C repeated over the heads."""
    B, T, H, P, G, N, Q = case
    Cg, Bg, xg, cums, dtg = _grouped(case, seed=4)
    y, s = tops.ssd_chunk(Cg, Bg, xg, cums, dtg)
    assert y.shape == (B, H, T // Q, Q, P) and s.shape == (B, H, T // Q, N, P)
    rep = H // G
    flat = [Cg.repeat_interleave(rep, 1), Bg.repeat_interleave(rep, 1), xg, cums, dtg]
    want_y, want_s = ssd_chunk_ref(*[t.reshape(B * H, *t.shape[2:]) for t in flat])
    torch.testing.assert_close(y.reshape(want_y.shape), want_y, **TOL)
    torch.testing.assert_close(s.reshape(want_s.shape), want_s, **TOL)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_ssd_forward_matches_kernel_wrapper_interpret(case):
    *args, chunk = *_inputs(case, seed=1), case[-1]
    want = ssd_forward_kernel(*map(jnp.asarray, args), chunk=chunk, interpret=True)
    got = tops.ssd_forward(*_t(*args), chunk)
    assert got.shape == case[:4] and got.dtype == torch.float32
    _close_scaled(got, want)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_ssd_forward_meets_1e5_with_the_reference_cumsum(case, monkeypatch):
    """The port's SSD forward with its one cumsum computed by XLA, as the
    reference computes it: element by element within 1e-5."""
    def xla_cumsum(t, dim):
        return torch.as_tensor(np.array(jnp.cumsum(jnp.asarray(t.numpy()), axis=dim)))

    *args, chunk = *_inputs(case, seed=1), case[-1]
    want = ssd_forward_kernel(*map(jnp.asarray, args), chunk=chunk, interpret=True)
    monkeypatch.setattr(torch, "cumsum", xla_cumsum)
    _close(tops.ssd_forward(*_t(*args), chunk), want)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_ssd_forward_plain_step_matches_reference_chunked(case):
    """`ssd_forward` with its plain intra-chunk step against the
    reference's plain-jnp `ssd_chunked`, which `ssm_block` calls."""
    *args, chunk = *_inputs(case, seed=2), case[-1]
    want = jssm.ssd_chunked(*map(jnp.asarray, args), chunk=chunk)
    _close_scaled(tops.ssd_forward(*_t(*args), chunk, chunk_fn=ssd_chunk_ref), want)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_chunked_forms_match_the_sequential_oracle(case):
    *args, chunk = *_inputs(case, seed=5), case[-1]
    oracle = tssm.ssd_reference(*_t(*args))
    _close(oracle, jssm.ssd_reference(*map(jnp.asarray, args)))
    for got in (tops.ssd_forward(*_t(*args), chunk),
                tops.ssd_forward(*_t(*args), chunk, chunk_fn=ssd_chunk_ref)):
        torch.testing.assert_close(got, oracle, **ORACLE_TOL)


def test_ssd_forward_rejects_a_ragged_sequence():
    args = _inputs((1, 48, 2, 4, 1, 4, 32))
    with pytest.raises(ValueError, match="multiple of ssm_chunk"):
        tops.ssd_forward(*_t(*args), 32)


@pytest.mark.parametrize("layout", ["group-per-head", "grouped"])
def test_function_gradient_equals_autograd_through_ref(layout):
    """SSDChunk's backward is the plain version's gradient (on the CPU its
    forward, `ssd_chunk`, takes the plain version too)."""
    case = CASES[0]
    if layout == "group-per-head":
        inputs = [t.unsqueeze(0) for t in _t(*_chunk_inputs(case, seed=6))]
    else:
        inputs = [t.detach().clone() for t in _grouped(case, seed=6)]
    rng = np.random.default_rng(7)
    y0, s0 = ssd_chunk_ref(*inputs)
    gy = torch.as_tensor(rng.standard_normal(y0.shape).astype(np.float32))
    gs = torch.as_tensor(rng.standard_normal(s0.shape).astype(np.float32))
    leaves = [t.clone().requires_grad_() for t in inputs]
    y, s = tops.ssd_chunk_autograd(*leaves)
    got = torch.autograd.grad((y, s), leaves, (gy, gs))
    leaves = [t.clone().requires_grad_() for t in inputs]
    want = torch.autograd.grad(ssd_chunk_ref(*leaves), leaves, (gy, gs))
    for g, w in zip(got, want):
        assert g.shape == w.shape
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_gradients_finite_with_strongly_negative_decay():
    """exp(cums_i - cums_j) overflows above the diagonal when dt * A is
    strongly negative (mamba2's init reaches A = -H); the mask comes
    before the exp, so the forward and every gradient stay finite."""
    case = (1, 64, 4, 8, 1, 16, 32)
    x, dt, A, B_, C_, D = _t(*_inputs(case, seed=8, decay=80.0))
    dt = dt * 20
    leaves = [t.clone().requires_grad_() for t in (x, dt, A, B_, C_, D)]
    y = tops.ssd_forward(*leaves, 32)
    assert bool(torch.isfinite(y).all())
    grads = torch.autograd.grad(y.square().sum(), leaves)
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    assert float(grads[0].abs().sum()) > 0


def _bf16_terms(v, terms):
    """f32 `v` as `terms` bf16 values, each the nearest bf16 of what the
    earlier ones left: the split of ``csrc/ssd_chunk.cu``'s bf16 kernel."""
    out = []
    for _ in range(terms):
        t = v.to(torch.bfloat16).float()
        out.append(t)
        v = v - t
    return out


def _split_chunk(C, B, x, cums, dt, terms):
    """Y, S as the bf16 kernel forms them, in plain torch: the f32 scores
    and decayed B split into bf16 terms, each multiplied by the bf16 X
    (exact products, f32 sums) and the products summed."""
    q = C.shape[-2]
    diff = cums[..., :, None] - cums[..., None, :]
    mask = torch.ones((q, q), dtype=torch.bool).tril()
    L = torch.exp(torch.where(mask, diff, torch.full_like(diff, -1e30)))
    scores = (C @ B.transpose(-1, -2)) * L * dt[..., None, :]
    Bw = B * (torch.exp(cums[..., -1:] - cums) * dt)[..., None]
    return (sum(t @ x for t in _bf16_terms(scores, terms)),
            sum(t.transpose(-1, -2) @ x for t in _bf16_terms(Bw, terms)))


@pytest.mark.parametrize("decay", [1.0, 80.0], ids=["mamba2-init", "a-80h"])
def test_three_bf16_terms_meet_f32_accuracy(decay):
    """The card's bf16 kernel splits each f32 operand (the masked scores,
    the decayed B) into three bf16 terms. On bf16 C, B, X at mamba2's
    chunk widths (Q = N = 128, P = 64), with A = -h for heads h up to 80
    (the init) or A = -80h with dt + 1, the split gives Y and S within
    1e-5 of the largest |Y|, |S| of `ssd_chunk_ref`; one unsplit bf16
    pass misses the card's 1e-4."""
    rng = np.random.default_rng(12)
    heads = np.array([1, 2, 5, 10, 20, 40, 60, 80], np.float32)
    bh, nc, q, n, p = len(heads), 2, 128, 128, 64

    def bf16(*shape):
        t = torch.as_tensor(rng.standard_normal(shape).astype(np.float32))
        return t.to(torch.bfloat16).float()

    C, B, x = bf16(bh, nc, q, n), bf16(bh, nc, q, n), bf16(bh, nc, q, p)
    dt = torch.as_tensor(_softplus(rng.standard_normal((bh, nc, q))).astype(np.float32))
    if decay > 1:
        dt = dt + 1.0
    cums = torch.cumsum(dt * torch.as_tensor(-decay * heads)[:, None, None], dim=-1)
    want = ssd_chunk_ref(C, B, x, cums, dt)
    errs = {}
    for terms in (1, 2, 3):
        got = _split_chunk(C, B, x, cums, dt, terms)
        assert all(bool(torch.isfinite(g).all()) for g in got)
        errs[terms] = max(float((g - w).abs().max()) / float(w.abs().max())
                          for g, w in zip(got, want))
    print(f"split error of the largest |Y|, |S| at A scale {decay}: " + ", ".join(
        f"{t} term(s) {e:.2e}" for t, e in errs.items()))
    assert errs[3] <= 1e-5 and errs[1] > 1e-4, errs


@pytest.mark.parametrize("edit", sorted(variants.EDITS))
def test_every_variant_edit_finds_its_text(edit):
    """Each edit of the kernel's variants (timing parts of it, planted
    faults) still finds the text it replaces in ``csrc/ssd_chunk.cu``."""
    got = variants.variant_source(edit)
    assert got != variants.variant_source("kernel")
    assert all(new in got for _, new in variants.EDITS[edit])


def test_default_variants_apply():
    assert variants.variant_source("kernel") == build.source_path("ssd_chunk").read_text()
    for name in variants.DEFAULT:
        variants.variant_source(name)
    with pytest.raises(KeyError):
        variants.variant_source("no-such-edit")


def _block_params(cfg, seed=0):
    jp = jssm.init_ssm(jax.random.PRNGKey(seed), cfg)
    # non-zero biases and norm gains, so those paths are exercised
    jp = dict(jp, conv_b=jp["conv_b"] + 0.1, gnorm=jp["gnorm"] + 0.2,
              dt_bias=jp["dt_bias"] - 0.3)
    return jp, convert.params_from_numpy(jax.device_get(jp), "cpu")


def test_causal_conv_matches_reference():
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 11, 6)).astype(np.float32)
    w = rng.standard_normal((6, 4)).astype(np.float32)
    b = rng.standard_normal(6).astype(np.float32)
    _close(tssm._causal_conv(*_t(x, w, b)),
           jssm._causal_conv(*map(jnp.asarray, (x, w, b))))


@pytest.mark.parametrize("seq", [16, 64], ids=["one-short-chunk", "two-chunks"])
def test_ssm_block_matches_reference(seq):
    jcfg, tcfg = jget_reduced(ARCH), get_reduced(ARCH)
    jp, tp = _block_params(jcfg)
    x = np.random.default_rng(10).standard_normal((2, seq, jcfg.d_model)).astype(np.float32)
    want = jssm.ssm_block(jp, jnp.asarray(x), jcfg)
    got = tssm.ssm_block(tp, torch.as_tensor(x), tcfg)
    assert got.shape == (2, seq, jcfg.d_model)
    _close_scaled(got, want)


def test_ssm_block_gradients_match_reference():
    jcfg, tcfg = jget_reduced(ARCH), get_reduced(ARCH)
    jp, tp = _block_params(jcfg, seed=1)
    x = np.random.default_rng(11).standard_normal((2, 64, jcfg.d_model)).astype(np.float32)
    jgrads = jax.grad(lambda p: jnp.sum(jnp.square(jssm.ssm_block(p, jnp.asarray(x), jcfg))))(jp)
    tp = {k: v.requires_grad_() for k, v in tp.items()}
    loss = tssm.ssm_block(tp, torch.as_tensor(x), tcfg).square().sum()
    tgrads = torch.autograd.grad(loss, [tp[k] for k in sorted(tp)])
    for k, g in zip(sorted(tp), tgrads):
        scale = float(np.abs(np.asarray(jgrads[k])).max())
        np.testing.assert_allclose(g.numpy(), np.asarray(jgrads[k]), rtol=1e-4,
                                   atol=1e-5 * max(scale, 1.0), err_msg=k)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_ssm_layout_and_dtypes_equal_reference(dtype):
    jcfg = jget_reduced(ARCH).with_(dtype=dtype)
    tcfg = get_reduced(ARCH).with_(dtype=dtype)
    jp = jssm.init_ssm(jax.random.PRNGKey(0), jcfg)
    tp = tssm.init_ssm(torch.Generator().manual_seed(0), tcfg)
    assert sorted(tp) == sorted(jp)
    for k in jp:
        assert tuple(tp[k].shape) == jp[k].shape, k
        assert str(tp[k].dtype).split(".")[-1] == str(jp[k].dtype), k
    for k in ("ssm_d", "dt_bias", "conv_b", "gnorm"):
        np.testing.assert_array_equal(tp[k].float().numpy(),
                                      np.asarray(jp[k], np.float32), err_msg=k)
    # log(1..H): torch's and XLA's log may differ in the last place
    np.testing.assert_allclose(tp["a_log"].numpy(), np.asarray(jp["a_log"]),
                               rtol=1e-6, atol=0)
    assert tp["a_log"].dtype == tp["ssm_d"].dtype == tp["dt_bias"].dtype == torch.float32
    d = tcfg.d_model
    assert abs(float(tp["in_proj"].float().std()) - 1 / np.sqrt(d)) < 0.01
