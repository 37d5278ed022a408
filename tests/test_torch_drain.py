"""repro_torch gossip drain against the JAX reference.

On the CPU the port's wrapper takes its plain version; both are held
against the reference's Pallas kernel in interpret mode and its XLA
fallback, on the edge cases the Hopper kernel must also meet (clients
off any tile grid, K with a ragged last tile, D in {2, 4, 8}, empty
buckets, rectangular (J, N, M) weights, a bf16 ring). Tolerance
rtol = atol = 1e-5: f32 sums in another order. The kernel itself runs
only on the card (tests/test_torch_cuda.py, and chip_smoke.py).
"""
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: E402,F401  (autouse: one CPU thread)

from repro.kernels.gossip import ops as jops
from repro.kernels.gossip import ref as jref
from repro_torch.kernels import build
from repro_torch.kernels.gossip import ops as tops
from repro_torch.kernels.gossip import ref as tref


def _case(j, n, m, k, s, empty=(), seed=0):
    """(w_stack (J, N, M) f32, ring (S, N, K) f32, slots) from numpy:
    each edge in one bucket, buckets in `empty` all zero."""
    rng = np.random.default_rng(seed)
    q = rng.random((n, m)).astype(np.float32)
    q /= q.sum(axis=1, keepdims=True)
    bucket = rng.integers(0, j, (n, m))
    w = np.stack([q * (bucket == b) for b in range(j)]).astype(np.float32)
    for b in empty:
        w[b] = 0.0
    ring = rng.standard_normal((s, n, k)).astype(np.float32)
    slots = [int(x) for x in rng.permutation(s)[:j]]
    return w, ring, slots


CASES = {
    "D2": dict(j=1, n=8, m=8, k=256, s=2),
    "D4": dict(j=3, n=8, m=8, k=256, s=4),
    "D8": dict(j=7, n=8, m=8, k=256, s=8),
    "n7-ragged-k": dict(j=3, n=7, m=7, k=513, s=4),
    "n25-main-path-width": dict(j=3, n=25, m=25, k=300, s=4),
    "empty-buckets": dict(j=3, n=8, m=8, k=200, s=4, empty=(0, 2)),
    "all-empty": dict(j=3, n=8, m=8, k=200, s=4, empty=(0, 1, 2)),
    "rectangular": dict(j=3, n=8, m=16, k=256, s=4),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_drain_matches_pallas_interpret_and_xla_fallback(name):
    w, ring, slots = _case(**CASES[name])
    got = tops.gossip_drain(torch.as_tensor(w), torch.as_tensor(ring), slots)
    assert got.dtype == torch.float32 and got.shape == (w.shape[2], ring.shape[2])
    jw, jring, jslots = jnp.asarray(w), jnp.asarray(ring), jnp.asarray(slots)
    pallas = jops.gossip_drain(jw, jring, jslots, use_kernel=True,
                               interpret=True, block_d=128)
    xla = jops.gossip_drain(jw, jring, jslots, use_kernel=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(xla), rtol=1e-5, atol=1e-5)


def test_drain_bf16_ring_accumulates_in_f32():
    w, ring, slots = _case(j=3, n=8, m=8, k=384, s=4, seed=3)
    ring_bf16 = torch.as_tensor(ring).to(torch.bfloat16)
    got = tops.gossip_drain(torch.as_tensor(w), ring_bf16, slots)
    jring = jnp.asarray(ring).astype(jnp.bfloat16)
    pallas = jops.gossip_drain(jnp.asarray(w), jring, jnp.asarray(slots),
                               use_kernel=True, interpret=True, block_d=128)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), rtol=1e-5, atol=1e-5)


def test_drain_ref_matches_reference_oracle():
    w, ring, slots = _case(j=3, n=6, m=9, k=70, s=5, seed=1)
    payloads = ring[slots]
    got = tref.gossip_drain_ref(torch.as_tensor(w), torch.as_tensor(payloads))
    ref = jref.gossip_drain_ref(jnp.asarray(w), jnp.asarray(payloads))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_reference_skips_empty_buckets_exactly():
    """An all-zero bucket is skipped; the result equals the sum of the
    live buckets alone, bit for bit."""
    w, ring, slots = _case(j=3, n=8, m=8, k=64, s=4, empty=(1,), seed=2)
    ring[slots[1]] = np.nan  # would poison the sum if it were read
    got = tops.gossip_drain_reference(torch.as_tensor(w), torch.as_tensor(ring), slots)
    live = tops.gossip_drain_reference(torch.as_tensor(w[[0, 2]]),
                                       torch.as_tensor(ring),
                                       [slots[0], slots[2]])
    assert torch.equal(got, live)


def test_cpu_path_does_not_count_launches():
    w, ring, slots = _case(j=3, n=8, m=8, k=64, s=4)
    before = tops.gossip_drain.launches
    tops.gossip_drain(torch.as_tensor(w), torch.as_tensor(ring), slots)
    assert tops.gossip_drain.launches == before


def test_slots_accept_host_tensor():
    w, ring, slots = _case(j=3, n=8, m=8, k=64, s=4)
    a = tops.gossip_drain(torch.as_tensor(w), torch.as_tensor(ring), slots)
    b = tops.gossip_drain(torch.as_tensor(w), torch.as_tensor(ring),
                          torch.tensor(slots))
    assert torch.equal(a, b)


@pytest.mark.parametrize("bad", ["dtype", "senders", "slots-count",
                                 "slot-range", "rank"])
def test_drain_rejects_bad_input(bad):
    w, ring, slots = _case(j=3, n=8, m=8, k=64, s=4)
    w, ring = torch.as_tensor(w), torch.as_tensor(ring)
    err = ValueError
    if bad == "dtype":
        ring, err = ring.to(torch.float16), TypeError
    elif bad == "senders":
        ring = ring[:, :7]
    elif bad == "slots-count":
        slots = slots[:2]
    elif bad == "slot-range":
        slots, err = [0, 1, 4], IndexError
    elif bad == "rank":
        w = w[0]
    with pytest.raises(err):
        tops.gossip_drain(w, ring, slots)
    with pytest.raises(err):
        tops.gossip_drain_reference(w, ring, slots)


def test_build_targets_hopper_and_keys_on_source():
    cmd = build.nvcc_command("nvcc", "drain", build.BUILD_DIR / "x.so")
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert str(build.KERNELS / "gossip" / "csrc" / "drain.cu") in cmd
    path = build.library_path("drain")
    assert path.parent == build.BUILD_DIR
    assert path.name.startswith("libdrain-") and path.suffix == ".so"
    assert build.library_path("drain") == path  # stable for an unchanged source


@pytest.mark.parametrize("name", ["drain", "mix", "enqueue", "ssd_chunk"])
def test_build_knows_every_source_of_the_port(name):
    """One build covers every kernel package's csrc/, into one ignored
    directory."""
    assert build.source_path(name).is_file()
    assert build.source_path(name).parent.name == "csrc"
    assert build.library_path(name).parent == build.BUILD_DIR
    assert build.BUILD_DIR.parent == build.KERNELS


def test_build_compiles_source_text_keyed_on_it(monkeypatch, tmp_path):
    """`build(texts=...)` writes each text beside its library, runs the
    same nvcc command on it, and keys the library on the text: an
    unchanged text is not rebuilt, another one is."""
    nvcc = tmp_path / "nvcc"  # copies the source to the -o path
    nvcc.write_text(f"#!{sys.executable}\nimport shutil, sys\na = sys.argv\n"
                    "shutil.copy(a[-1], a[a.index('-o') + 1])\n"
                    "print('ptxas info    : Used 1 registers')\n")
    nvcc.chmod(0o755)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(build, "find_nvcc", lambda: str(nvcc))
    lib = build.build((), texts={"ssd_chunk-v": "// one\n"})["ssd_chunk-v"]
    assert lib.parent == build.BUILD_DIR and lib.name.startswith("libssd_chunk-v-")
    assert lib.read_text() == "// one\n"
    assert "registers" in lib.with_suffix(".log").read_text()
    monkeypatch.setattr(build, "find_nvcc", lambda: pytest.fail("rebuilt"))
    assert build.build((), texts={"ssd_chunk-v": "// one\n"})["ssd_chunk-v"] == lib
    monkeypatch.setattr(build, "find_nvcc", lambda: str(nvcc))
    other = build.build((), texts={"ssd_chunk-v": "// two\n"})["ssd_chunk-v"]
    assert other != lib and other.read_text() == "// two\n"
    # a device header on the include path keys every build too: an edit
    # to it rebuilds the same text
    header = tmp_path / "stream.cuh"
    header.write_text("// header one\n")
    monkeypatch.setattr(build, "headers", lambda: [header])
    first = build.build((), texts={"ssd_chunk-v": "// two\n"})["ssd_chunk-v"]
    assert first != other and first.read_text() == "// two\n"
    header.write_text("// header two\n")
    second = build.build((), texts={"ssd_chunk-v": "// two\n"})["ssd_chunk-v"]
    assert second != first and second.exists()


def test_build_includes_and_keys_on_the_shared_header():
    """drain.cu and enqueue.cu include ``gossip/csrc/stream.cuh``: the
    nvcc command has its directory on the include path (variant texts are
    built from ``build/``), and the library key covers its text."""
    header = build.KERNELS / "gossip" / "csrc" / "stream.cuh"
    assert header in build.headers()
    for name in ("drain", "enqueue"):
        assert '#include "stream.cuh"' in build.source_path(name).read_text()
        cmd = build.nvcc_command("nvcc", name, build.BUILD_DIR / "x.so")
        assert f"-I{header.parent}" in cmd
        assert cmd.index(f"-I{header.parent}") < cmd.index("-o")


def test_build_without_nvcc_raises(monkeypatch):
    monkeypatch.setenv("PATH", "")
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(build.os, "access", lambda *args: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.find_nvcc()


@pytest.mark.parametrize("seeds", [1, 3])
def test_drain_seed_axis_matches_vmapped_reference(seeds):
    """The seed axis (R, J, N, M) x (R, S, N, K): the reference's sweep
    vmaps its drain over seeds (a leading grid axis of the Pallas call);
    the port's plain version, with per-seed live sets (seed 0 has none),
    is each seed's own drain and matches the vmapped reference."""
    cases = [_case(j=3, n=7, m=7, k=300, s=4, seed=20 + r,
                   empty=(0, 1, 2) if r == 0 else ()) for r in range(seeds)]
    w = np.stack([c[0] for c in cases])
    ring = np.stack([c[1] for c in cases])
    slots = cases[0][2]
    got = tops.gossip_drain(torch.as_tensor(w), torch.as_tensor(ring), slots)
    assert got.shape == (seeds, 7, 300) and got.dtype == torch.float32
    for r in range(seeds):
        assert torch.equal(got[r], tops.gossip_drain(torch.as_tensor(w[r]),
                                                     torch.as_tensor(ring[r]), slots))
    assert not got[0].any()
    ref = jax.vmap(lambda wr, pr: jops.gossip_drain(wr, pr, jnp.asarray(slots), use_kernel=True,
                                                   interpret=True, block_d=128))(
        jnp.asarray(w), jnp.asarray(ring))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_drain_seed_axis_checks_its_shapes():
    w, ring, slots = _case(j=3, n=4, m=4, k=16, s=4)
    w4, ring4 = torch.as_tensor(w)[None].repeat(2, 1, 1, 1), torch.as_tensor(ring)[None]
    with pytest.raises(ValueError, match="seeds"):
        tops.gossip_drain(w4, ring4, slots)
    with pytest.raises(ValueError, match="seed axis"):
        tops.gossip_drain(w4, torch.as_tensor(ring), slots)
    with pytest.raises(ValueError, match="seeds"):
        tops.gossip_drain(w4[:0], ring4[:0], slots)
