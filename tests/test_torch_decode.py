"""repro_torch's decode path against the JAX package: `decode_attention`
(a full cache, a ring, and positions past the last slot), the cross
decode, the recurrent `ssm_decode_step`, `init_decode_state`,
`init_cross_kv`, `decode_step` for the six families, and
`convert.decode_state_from_numpy`.

The reduced configs in f32; parameters are the reference's own init
(gains, biases and the vlm's gate moved off zero) carried over with
`convert.params_from_numpy`, and both packages start from one cache, the
reference's, carried over with `decode_state_from_numpy`. Inputs come
from numpy seeds. A decode step is held at rtol = atol = 1e-5 against
the reference's (f32 sums in another order); the decode over a prompt is
held against the port's own `apply_model` over the same prompt at the
JAX tests' atol 2e-4, rtol 2e-3 (tests/test_attention.py; per-token
products against whole-sequence ones, the SSD's chunked scan against the
recurrence). For that comparison the moe config's capacity factor is
E / k, so that no expert drops a token of the prompt (decode's one token
a step never fills a queue).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401  (autouse: one CPU thread)

from repro.configs import base as jbase  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
PREFILL_TOL = dict(rtol=2e-3, atol=2e-4)
MOVED = ("norm", "gnorm", "conv_b", "norm_attn", "norm_mlp", "final_norm", "gate",
         "bq", "bk", "bv")
SIX = ["qwen2-1.5b", "mamba2-2.7b", "olmoe-1b-7b", "zamba2-2.7b", "llama-3.2-vision-11b",
       "musicgen-large"]


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **(tol or TOL))


def _attn(seed=3):
    jcfg, tcfg = jbase.get_reduced("qwen2-1.5b"), tbase.get_reduced("qwen2-1.5b")
    jp = jattn.init_attention(jax.random.PRNGKey(seed), jcfg)
    jp = {k: (v + 0.1 if k.startswith("b") else v) for k, v in jp.items()}
    return jcfg, tcfg, jp, convert.params_from_numpy(jax.device_get(jp), "cpu")


def _run_decode_attention(cache_len, steps, ring, seed=3):
    jcfg, tcfg, jp, tp = _attn(seed)
    hd, nkv = jcfg.resolved_head_dim, jcfg.num_kv_heads
    x = np.random.default_rng(seed).standard_normal((2, steps, jcfg.d_model)).astype(np.float32)
    jcache = jattn.KVCache.init(2, cache_len, nkv, hd, jnp.float32)
    tcache = tattn.KVCache.init(2, cache_len, nkv, hd, torch.float32)
    for t in range(steps):
        want, jcache = jattn.decode_attention(jp, jnp.asarray(x[:, t:t + 1]), jcache,
                                              jnp.int32(t), jcfg, ring=ring)
        got, tcache = tattn.decode_attention(tp, torch.as_tensor(x[:, t:t + 1]), tcache,
                                             torch.tensor(t, dtype=torch.int32), tcfg,
                                             ring=ring)
        _close(got, want)
    _close(tcache.k, jcache.k)
    _close(tcache.v, jcache.v)
    return tcfg, tp, x


def test_decode_attention_full_cache_matches_reference_and_full_attention():
    tcfg, tp, x = _run_decode_attention(cache_len=20, steps=20, ring=False)
    # the decode over the sequence is full causal attention over it
    tcache = tattn.KVCache.init(2, 20, tcfg.num_kv_heads, tcfg.resolved_head_dim,
                                torch.float32)
    outs = [tattn.decode_attention(tp, torch.as_tensor(x[:, t:t + 1]), tcache,
                                   torch.tensor(t), tcfg)[0] for t in range(20)]
    full = tattn.full_attention(tp, torch.as_tensor(x), tcfg)
    torch.testing.assert_close(torch.cat(outs, 1), full, **PREFILL_TOL)


def test_decode_attention_on_a_ring_matches_reference():
    _run_decode_attention(cache_len=8, steps=21, ring=True)


def test_decode_attention_clamps_past_the_last_slot_as_the_reference():
    """Positions >= C overwrite slot C - 1 (``min(pos, C - 1)``)."""
    _run_decode_attention(cache_len=6, steps=11, ring=False)


def test_decode_attention_writes_the_cache_in_place():
    _, tcfg, _, tp = _attn()
    tcache = tattn.KVCache.init(1, 4, tcfg.num_kv_heads, tcfg.resolved_head_dim,
                                torch.float32)
    k0 = tcache.k
    x = torch.randn((1, 1, tcfg.d_model), generator=torch.Generator().manual_seed(0))
    _, out_cache = tattn.decode_attention(tp, x, tcache, torch.tensor(2), tcfg)
    assert out_cache.k is k0
    assert bool(k0[:, 2].abs().sum() > 0) and float(k0[:, [0, 1, 3]].abs().sum()) == 0.0


def test_cross_decode_attention_matches_reference():
    jcfg = jbase.get_reduced("llama-3.2-vision-11b")
    tcfg = tbase.get_reduced("llama-3.2-vision-11b")
    jp = jattn.init_attention(jax.random.PRNGKey(4), jcfg, cross=True)
    tp = convert.params_from_numpy(jax.device_get(jp), "cpu")
    rng = np.random.default_rng(4)
    hd, nkv = jcfg.resolved_head_dim, jcfg.num_kv_heads
    x = rng.standard_normal((2, 1, jcfg.d_model)).astype(np.float32)
    k = rng.standard_normal((2, 16, nkv, hd)).astype(np.float32)
    v = rng.standard_normal((2, 16, nkv, hd)).astype(np.float32)
    want = jattn.cross_decode_attention(jp, jnp.asarray(x), jnp.asarray(k), jnp.asarray(v),
                                        jcfg)
    got = tattn.cross_decode_attention(tp, torch.as_tensor(x), torch.as_tensor(k),
                                       torch.as_tensor(v), tcfg)
    _close(got, want)


def test_repeat_kv_is_jnp_repeat():
    x = np.random.default_rng(5).standard_normal((2, 3, 2, 4)).astype(np.float32)
    np.testing.assert_array_equal(tattn._repeat_kv(torch.as_tensor(x), 3).numpy(),
                                  np.asarray(jattn._repeat_kv(jnp.asarray(x), 3)))


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-2.7b"])
def test_ssm_decode_step_matches_reference_over_20_steps(arch):
    jcfg, tcfg = jbase.get_reduced(arch), tbase.get_reduced(arch)
    jp = jssm.init_ssm(jax.random.PRNGKey(6), jcfg)
    jp = {k: (v + 0.1 if k in MOVED else v) for k, v in jp.items()}
    tp = convert.params_from_numpy(jax.device_get(jp), "cpu")
    x = np.random.default_rng(6).standard_normal((2, 20, jcfg.d_model)).astype(np.float32)
    jst = jssm.SSMState.init(2, jcfg, jnp.float32)
    tst = tssm.SSMState.init(2, tcfg, torch.float32)
    outs = []
    for t in range(20):
        want, jst = jssm.ssm_decode_step(jp, jnp.asarray(x[:, t:t + 1]), jst, jcfg)
        got, tst = tssm.ssm_decode_step(tp, torch.as_tensor(x[:, t:t + 1]), tst, tcfg)
        _close(got, want)
        outs.append(got)
    _close(tst.conv, jst.conv)
    _close(tst.h, jst.h)
    # the recurrence is the block's SSD over the sequence (chunk 20 <= 32)
    full = tssm.ssm_block(tp, torch.as_tensor(x), tcfg)
    torch.testing.assert_close(torch.cat(outs, 1), full, **PREFILL_TOL)


def _leaves(state):
    """[(name, field, shape, dtype)] of a decode state of either package."""
    out = []
    for name in sorted(state.caches):
        cache = state.caches[name]
        for field in cache._fields:
            leaf = getattr(cache, field)
            out.append((name, field, tuple(leaf.shape), str(leaf.dtype).split(".")[-1]))
    return out


@pytest.mark.parametrize("window", [0, 8, 16])
@pytest.mark.parametrize("arch", SIX)
def test_init_decode_state_equals_reference(arch, window):
    """Shapes and dtypes, a ring of `window` slots when 16 positions do not
    fit the window (8) and a full cache when they do (16)."""
    jcfg = jbase.get_reduced(arch).with_(sliding_window=window)
    tcfg = tbase.get_reduced(arch).with_(sliding_window=window, dtype="bfloat16")
    jst = jmodel.init_decode_state(jcfg.with_(dtype="bfloat16"), 3, 16)
    tst = tmodel.init_decode_state(tcfg, 3, 16, device="cpu")
    assert _leaves(tst) == _leaves(jst)
    assert tst.pos.dtype == torch.int32 and int(tst.pos) == 0 and tst.pos.dim() == 0
    kv = [c for c in tst.caches.values() if isinstance(c, tattn.KVCache)]
    assert all(c.k.shape[2] == (8 if window == 8 else 16) for c in kv)
    assert all(c.k.data_ptr() != c.v.data_ptr() for c in kv)


def _model(arch, seed=0, **over):
    jcfg = jbase.get_reduced(arch).with_(**over)
    tcfg = tbase.get_reduced(arch).with_(**over)
    jp = jmodel.init_params(jax.random.PRNGKey(seed), jcfg)
    jp = jax.tree_util.tree_map_with_path(
        lambda path, v: v + 0.1 if path[-1].key in MOVED else v, jp)
    return jcfg, tcfg, jp, convert.params_from_numpy(jax.device_get(jp), "cpu")


def _prompt(cfg, b=2, s=16, seed=1):
    rng = np.random.default_rng(seed)
    if cfg.embeds_in:
        return rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    return rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


def _step_input(cfg, prompt, t):
    return prompt[:, t:t + 1] if cfg.embeds_in else prompt[:, t]


def _decode_both(arch, s=16, **over):
    """Both packages' decode over one prompt from the reference's cache:
    per-step logits held at 1e-5; returns the port's (B, S, V) logits,
    config, params, prompt and cross embeddings."""
    if arch.startswith("olmoe"):
        cfg = jbase.get_reduced(arch)
        over.setdefault("capacity_factor", cfg.num_experts / cfg.experts_per_token)
    jcfg, tcfg, jp, tp = _model(arch, **over)
    prompt = _prompt(jcfg, s=s)
    patches = None
    jcross = None
    if jcfg.family == "vlm":
        patches = np.random.default_rng(2).standard_normal(
            (2, jcfg.num_patch_tokens, jcfg.d_model)).astype(np.float32)
        jcross = jmodel.init_cross_kv(jp, jcfg, jnp.asarray(patches))
    jst = jmodel.init_decode_state(jcfg, 2, s)
    tst, tcross = convert.decode_state_from_numpy(jax.device_get(jst),
                                                  None if jcross is None
                                                  else jax.device_get(jcross), "cpu")
    if patches is not None:
        own = tmodel.init_cross_kv(tp, tcfg, torch.as_tensor(patches))
        for key in ("k", "v"):
            _close(own[key], jcross[key])
    jstep = jax.jit(lambda p, x, st, c: jmodel.decode_step(p, jcfg, x, st, c))
    outs = []
    for t in range(s):
        x = _step_input(jcfg, prompt, t)
        want, jst = jstep(jp, jnp.asarray(x), jst, jcross)
        got, tst = tmodel.decode_step(tp, tcfg, torch.as_tensor(x), tst, tcross)
        _close(got, want)
        outs.append(got)
    assert int(tst.pos) == int(jst.pos) == s
    for name, cache in tst.caches.items():
        for field in cache._fields:
            _close(getattr(cache, field), getattr(jst.caches[name], field))
    return torch.stack(outs, 1), tcfg, tp, prompt, patches


@pytest.mark.parametrize("arch", SIX)
def test_decode_step_matches_reference_and_is_cache_exact(arch):
    logits, tcfg, tp, prompt, patches = _decode_both(arch)
    batch = {"embeds" if tcfg.embeds_in else "tokens": torch.as_tensor(prompt)}
    if patches is not None:
        batch["cross_embeds"] = torch.as_tensor(patches)
    full, _ = tmodel.apply_model(tp, tcfg, batch)
    torch.testing.assert_close(logits, full, **PREFILL_TOL)


def test_decode_on_a_ring_matches_windowed_prefill():
    """24 tokens through an 8-slot ring equal windowed attention."""
    logits, tcfg, tp, prompt, _ = _decode_both("qwen2-1.5b", s=24, sliding_window=8)
    full, _ = tmodel.apply_model(tp, tcfg, {"tokens": torch.as_tensor(prompt)})
    torch.testing.assert_close(logits, full, **PREFILL_TOL)


@pytest.mark.parametrize("chunk", [8, 32])
def test_ssm_decode_in_f64_equals_prefill(chunk):
    """In f64 the recurrent decode equals the chunked prefill (through the
    plain intra-chunk step) to rounding, ~1e-14 of the largest |logit|:
    the f32 gap held above is f32 rounding, not a decode fault."""
    from repro_torch.core import flat
    from repro_torch.kernels.ssd.ref import ssd_chunk_ref

    cfg = tbase.get_reduced("mamba2-2.7b").with_(dtype="float64", ssm_chunk=chunk)
    params = flat.tree_map(lambda t: t.double() if t.is_floating_point() else t,
                           tmodel.init_params(0, cfg, "cpu"))
    prompt = torch.as_tensor(_prompt(cfg, s=32))
    with torch.no_grad():
        full, _ = tmodel.apply_model(params, cfg, {"tokens": prompt}, chunk_fn=ssd_chunk_ref)
        st = tmodel.init_decode_state(cfg, 2, 32, device="cpu")
        outs = []
        for t in range(32):
            logits, st = tmodel.decode_step(params, cfg, prompt[:, t], st)
            outs.append(logits)
    assert all(c.h.dtype == torch.float64 for c in st.caches.values())
    dec = torch.stack(outs, 1)
    assert dec.dtype == full.dtype == torch.float64
    assert float((dec - full).abs().max() / full.abs().max()) < 1e-12


def test_vlm_decode_without_cross_kv_raises():
    _, tcfg, _, tp = _model("llama-3.2-vision-11b")
    st = tmodel.init_decode_state(tcfg, 1, 4, device="cpu")
    with pytest.raises(ValueError, match="cross_kv"):
        tmodel.decode_step(tp, tcfg, torch.zeros(1, dtype=torch.long), st)
    assert tmodel.init_cross_kv(tp, tbase.get_reduced("qwen2-1.5b"), None) is None


def test_decode_state_from_numpy_keeps_bf16_and_layout():
    jcfg = jbase.get_reduced("zamba2-2.7b").with_(dtype="bfloat16")
    jst = jmodel.init_decode_state(jcfg, 2, 8)
    jst = jst._replace(pos=jnp.int32(5), caches=jax.tree_util.tree_map(
        lambda x: x + jnp.asarray(0.5, x.dtype), jst.caches))
    tst, cross = convert.decode_state_from_numpy(jax.device_get(jst), device="cpu")
    assert cross is None and int(tst.pos) == 5 and tst.pos.dtype == torch.int32
    assert _leaves(tst) == _leaves(jst)
    for name, cache in tst.caches.items():
        assert type(cache).__name__ == type(jst.caches[name]).__name__
        for field in cache._fields:
            np.testing.assert_array_equal(getattr(cache, field).float().numpy(),
                                          np.asarray(getattr(jst.caches[name], field),
                                                     np.float32))
