"""repro_torch's long-context path against the JAX package: the flash
attention and its backward (`models/flash.py`), `blocked_attention` and
`flash_self_attention`, `apply_model` on the flash path (a lowered
`blocked_attn_threshold`) with `return_hidden`, and the chunked-vocab
loss (`lm_loss(vocab_chunk > 0)`).

Inputs come from numpy seeds; the model parameters are the reference's
own init carried over with `convert.params_from_numpy`, their zero gains
and biases moved so those paths count. f32 throughout. Tolerance rtol =
atol = 1e-5: f32 sums in another order (the flash backward's dk and dv
add their q blocks in one contraction where the reference adds them one
after another, and stay within it). zamba2's SSD blocks are held at 1e-5
of the largest |value|, as tests/test_torch_families.py holds them.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401  (autouse: one CPU thread)

from repro.configs import base as jbase  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import flash as jflash  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.core import flat as tflat  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import flash as tflash  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
MOVED = ("norm", "gnorm", "conv_b", "norm_attn", "norm_mlp", "final_norm", "gate",
         "bq", "bk", "bv")
FAMILIES = ["qwen2-1.5b", "olmoe-1b-7b", "zamba2-2.7b", "llama-3.2-vision-11b",
            "musicgen-large"]


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **(tol or TOL))


def _close_scaled(got, want, tol=1e-5):
    want = np.asarray(want)
    _close(got, want, rtol=tol, atol=tol * float(np.abs(want).max()))


def _qkv(b=2, h=3, s=64, hd=16, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, h, s, hd)).astype(np.float32) for _ in range(4)]


def _flash_both(q, k, v, dout, bq, bk, window):
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    jout, vjp = jax.vjp(lambda a, b, c: jflash.flash_attention(a, b, c, bq, bk, window),
                        jq, jk, jv)
    jgrads = vjp(jnp.asarray(dout))
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    tout = tflash.flash_attention(tq, tk, tv, bq, bk, window)
    tgrads = torch.autograd.grad(tout, (tq, tk, tv), torch.as_tensor(dout))
    return (tout, tgrads), (jout, jgrads)


@pytest.mark.parametrize("blocks", [(16, 16), (32, 16), (64, 64)])
@pytest.mark.parametrize("window", [0, 24])
def test_flash_attention_and_gradients_match_reference(blocks, window):
    q, k, v, dout = _qkv(seed=sum(blocks) + window)
    (tout, tgrads), (jout, jgrads) = _flash_both(q, k, v, dout, *blocks, window)
    _close(tout, jout)
    for g, jg in zip(tgrads, jgrads):
        _close(g, jg)


def test_flash_skips_a_block_the_window_hides_and_matches():
    """Window 8 at blocks of 16: q block 3 sees kv blocks 2 and 3 only, so
    kv blocks 0 and 1 are skipped for it (the reference runs them with m
    at -1e30 and wipes them afterwards), and blocks past the diagonal are
    skipped as well."""
    ranges = tflash._active_blocks(4, 4, 16, 16, 8)
    assert ranges == [(0, 2), (1, 3), (2, 4), (3, 4)]
    q, k, v, dout = _qkv(seed=7)
    (tout, tgrads), (jout, jgrads) = _flash_both(q, k, v, dout, 16, 16, 8)
    _close(tout, jout)
    for g, jg in zip(tgrads, jgrads):
        _close(g, jg)


@pytest.mark.parametrize("case", [(4, 4, 16, 16, 0), (2, 4, 32, 16, 0), (4, 2, 16, 32, 24),
                                  (8, 8, 8, 8, 5), (4, 4, 16, 16, 40), (2, 8, 32, 8, 9)])
def test_active_blocks_are_exactly_the_unmasked_ones(case):
    nq, nk, bq, bk, window = case
    iq = np.arange(nq * bq)[:, None]
    jk = np.arange(nk * bk)[None, :]
    mask = jk <= iq
    if window:
        mask &= jk > iq - window
    seen = mask.reshape(nq, bq, nk, bk).any(axis=(1, 3))  # (nq, nk)
    for j, (lo, hi) in enumerate(tflash._active_blocks(nq, nk, bq, bk, window)):
        assert [i for i in range(nq) if seen[i, j]] == list(range(lo, hi)), j


def test_flash_rejects_ragged_blocks():
    q = torch.zeros((1, 1, 48, 8))
    with pytest.raises(ValueError, match="multiples"):
        tflash.flash_attention(q, q, q, 32, 32)


def _attn(arch="qwen2-1.5b", seed=5):
    jcfg, tcfg = jbase.get_reduced(arch), tbase.get_reduced(arch)
    jp = jattn.init_attention(jax.random.PRNGKey(seed), jcfg)
    jp = {k: (v + 0.1 if k.startswith("b") else v) for k, v in jp.items()}
    x = np.random.default_rng(seed).standard_normal((2, 64, jcfg.d_model)).astype(np.float32)
    return jcfg, tcfg, jp, convert.params_from_numpy(jax.device_get(jp), "cpu"), x


def _x_grad(fn, tp, x):
    tx = torch.tensor(x, requires_grad=True)
    out = fn(tp, tx)
    (g,) = torch.autograd.grad(out.square().sum(), tx)
    return out, g


@pytest.mark.parametrize("window", [0, 24])
def test_blocked_attention_matches_reference(window):
    jcfg, tcfg, jp, tp, x = _attn()
    jfn = lambda p, a: jattn.blocked_attention(p, a, jcfg, block_q=16, block_kv=32,  # noqa: E731
                                               sliding_window=window)
    want, jvjp = jax.vjp(lambda a: jfn(jp, a), jnp.asarray(x))
    (jgx,) = jvjp(2 * want)
    got, gx = _x_grad(lambda p, a: tattn.blocked_attention(
        p, a, tcfg, block_q=16, block_kv=32, sliding_window=window), tp, x)
    _close(got, want)
    _close(gx, jgx)
    plain, _ = _x_grad(lambda p, a: tattn.blocked_attention(
        p, a, tcfg, block_q=16, block_kv=32, sliding_window=window, remat_steps=False), tp, x)
    torch.testing.assert_close(plain, got, rtol=0, atol=0)


@pytest.mark.parametrize("window", [0, 24])
def test_flash_self_attention_matches_reference_and_full(window):
    jcfg, tcfg, jp, tp, x = _attn(seed=6)
    want, jvjp = jax.vjp(lambda a: jattn.flash_self_attention(
        jp, a, jcfg, sliding_window=window, block_q=16, block_kv=16), jnp.asarray(x))
    (jgx,) = jvjp(2 * want)
    got, gx = _x_grad(lambda p, a: tattn.flash_self_attention(
        p, a, tcfg, sliding_window=window, block_q=16, block_kv=16), tp, x)
    _close(got, want)
    _close(gx, jgx)
    full = tattn.full_attention(tp, torch.as_tensor(x), tcfg, sliding_window=window)
    torch.testing.assert_close(got, full, rtol=1e-5, atol=1e-5)


def _model(arch, seed=0, **over):
    jcfg = jbase.get_reduced(arch).with_(**over)
    tcfg = tbase.get_reduced(arch).with_(**over)
    jp = jmodel.init_params(jax.random.PRNGKey(seed), jcfg)
    jp = jax.tree_util.tree_map_with_path(
        lambda path, v: v + 0.1 if path[-1].key in MOVED else v, jp)
    return jcfg, tcfg, jp, convert.params_from_numpy(jax.device_get(jp), "cpu")


def _batch(cfg, s, b=2, seed=0):
    rng = np.random.default_rng(seed)
    out = {}
    if cfg.embeds_in:
        out["embeds"] = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
        out["labels"] = rng.integers(0, cfg.vocab_size, (b, s))
    else:
        out["tokens"] = rng.integers(0, cfg.vocab_size, (b, s))
    if cfg.family == "vlm":
        out["cross_embeds"] = rng.standard_normal(
            (b, cfg.num_patch_tokens, cfg.d_model)).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in out.items()},
            {k: torch.as_tensor(v) for k, v in out.items()})


def _seq(cfg):
    return 2 * cfg.ssm_chunk if cfg.family == "hybrid" else 32


@pytest.mark.parametrize("return_hidden", [False, True])
@pytest.mark.parametrize("arch", FAMILIES)
def test_apply_model_on_the_flash_path_matches_reference(arch, return_hidden):
    """A threshold of 16 sends every self-attention (and zamba2's shared
    block) through the flash path; cross-attention stays full."""
    jcfg, tcfg, jp, tp = _model(arch)
    jb, tb = _batch(jcfg, _seq(jcfg))
    want, jaux = jmodel.apply_model(jp, jcfg, jb, blocked_attn_threshold=16,
                                    return_hidden=return_hidden)
    got, taux = tmodel.apply_model(tp, tcfg, tb, blocked_attn_threshold=16,
                                   return_hidden=return_hidden)
    assert got.shape == want.shape
    if tcfg.family == "hybrid":
        _close_scaled(got, want)
    else:
        _close(got, want)
    _close(taux, jaux)
    # the flash path computes the full path's function
    full, _ = tmodel.apply_model(tp, tcfg, tb, return_hidden=return_hidden)
    torch.testing.assert_close(got, full, rtol=1e-4, atol=1e-4)


def test_return_hidden_feeds_the_head():
    _, tcfg, _, tp = _model("qwen2-1.5b")
    _, tb = _batch(tcfg, 16)
    h, _ = tmodel.apply_model(tp, tcfg, tb, return_hidden=True)
    logits, _ = tmodel.apply_model(tp, tcfg, tb)
    torch.testing.assert_close(h @ tp["embed"].T, logits, rtol=0, atol=0)


def _loss_and_grads(tcfg, tp, tb, **kw):
    tp = tflat.tree_map(lambda p: p.detach().clone().requires_grad_(), tp)
    loss = tmodel.lm_loss(tp, tcfg, tb, **kw)
    leaves = tflat.tree_leaves(tp)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss, [torch.zeros_like(p) if g is None else g for g, p in zip(grads, leaves)]


@pytest.mark.parametrize("chunk", [8, 16, 32])
@pytest.mark.parametrize("arch", ["qwen2-1.5b", "musicgen-large", "olmoe-1b-7b"])
def test_chunked_vocab_loss_and_gradients_match_reference(arch, chunk):
    jcfg, tcfg, jp, tp = _model(arch)
    jb, tb = _batch(jcfg, 32, seed=1)
    jloss, jgrads = jax.value_and_grad(
        lambda p: jmodel.lm_loss(p, jcfg, jb, vocab_chunk=chunk))(jp)
    loss, grads = _loss_and_grads(tcfg, tp, tb, vocab_chunk=chunk)
    _close(loss, jloss)
    jleaves = jax.tree_util.tree_leaves(jgrads)
    assert len(grads) == len(jleaves)
    for g, jg in zip(grads, jleaves):
        _close(g, jg)
    full, full_grads = _loss_and_grads(tcfg, tp, tb)
    torch.testing.assert_close(loss, full, rtol=1e-5, atol=1e-5)
    for g, fg in zip(grads, full_grads):
        torch.testing.assert_close(g, fg, rtol=1e-5, atol=1e-5)


def test_chunked_vocab_loss_on_the_flash_path_and_ragged_chunks():
    jcfg, tcfg, jp, tp = _model("qwen2-1.5b", remat=True)
    jb, tb = _batch(jcfg, 32, seed=2)
    want = jmodel.lm_loss(jp, jcfg, jb, vocab_chunk=16, blocked_attn_threshold=32)
    got = tmodel.lm_loss(tp, tcfg, tb, vocab_chunk=16, blocked_attn_threshold=32)
    _close(got, want)
    with torch.no_grad():  # no checkpoints without gradients: the same sum
        torch.testing.assert_close(tmodel.lm_loss(tp, tcfg, tb, vocab_chunk=16,
                                                  blocked_attn_threshold=32), got.detach(),
                                   rtol=0, atol=0)
    with pytest.raises(ValueError, match="multiple of vocab_chunk"):
        tmodel.lm_loss(tp, tcfg, tb, vocab_chunk=12)
