"""The host side of the streamed gossip kernels (``csrc/drain.cu``,
``csrc/enqueue.cu``, ``csrc/mix.cu``, ``csrc/stream.cuh``): the routes and
shared-memory reckoning the wrappers check before a launch, their
agreement with the sources' constants, and the variants that
``chip_smoke.py --gossip-variants`` builds. The kernels themselves run
only on the card (tests/test_torch_cuda.py and chip_smoke.py)."""
import re

import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels.gossip import ops, variants

H100_SMEM = 232_448  # bytes a block may opt into on an H100


def _source_int(path, pattern):
    return int(re.search(pattern, path.read_text()).group(1))


def test_ring_constants_match_the_sources():
    """The Python reckoning uses the sources' own block, group, column,
    row and stage counts."""
    header = build.KERNELS / "gossip" / "csrc" / "stream.cuh"
    assert ops.CONSUMERS == _source_int(header, r"#define GOSSIP_CONSUMERS (\d+)")
    assert ops.GROUPS == _source_int(header, r"#define GOSSIP_GROUPS (\d+)")
    assert ops.RING_BARRIERS == _source_int(header, r"#define RING_BARRIERS (\d+)")
    for name in ("drain", "enqueue"):
        source = build.source_path(name)
        assert ops.STAGES == _source_int(source, r"constexpr int STAGES = (\d+);")
        assert ops.COLS == _source_int(source, r"constexpr int COLS = (\d+);")
        assert "constexpr int TILE = GOSSIP_CONSUMERS / GOSSIP_GROUPS * COLS;" in source.read_text()
        assert ops.STAGED_ROW - ops.TILE == _source_int(
            source, r"constexpr int ROW = TILE \+ (\d+);")
    assert ops.TILE == 128


@pytest.mark.parametrize("dtype,want", [(torch.float32, 66_800), (torch.bfloat16, 46_400)])
def test_drain_smem_at_the_main_path(dtype, want):
    """The ring's barriers, J = 3 buckets of 32 senders (25 padded to 8s)
    x 40 weights (two 16-receiver tiles and 8 floats against bank
    conflicts), four warps' 16 x 40 store buffers, three staged tiles of 25
    rows x 136 elements, their offsets, the live list and flags."""
    assert ops.drain_smem_bytes(3, 25, 25, dtype) == want
    assert want == 64 + 4 * 3 * 32 * 40 + 4 * 4 * 16 * 40 \
        + 3 * 25 * 136 * (4 if dtype == torch.float32 else 2) + 4 * 3 * 25 + 12 * 3


@pytest.mark.parametrize("dtype,want", [(torch.float32, 50_764), (torch.bfloat16, 30_364)])
def test_enqueue_smem_at_the_main_path(dtype, want):
    """The ring's barriers, J = 3 buckets of 25 senders x 32 weights, three
    staged tiles and their offsets."""
    assert ops.enqueue_smem_bytes(3, 25, dtype) == want
    assert want == 64 + 4 * 3 * 25 * 32 + 3 * 25 * 136 * (4 if dtype == torch.float32 else 2) \
        + 4 * 3 * 25


@pytest.mark.parametrize("depth", [2, 4, 8])
@pytest.mark.parametrize("n", [7, 25, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_the_tested_cases_fit_one_block(depth, n, dtype):
    """Every ring depth and width the port's tests use, up to J = 7 at
    N = M = 64 (230,292 bytes in f32), fits an H100 block."""
    ops.check_smem(ops.drain_smem_bytes(depth - 1, n, n, dtype), H100_SMEM, "drain")
    ops.check_smem(ops.enqueue_smem_bytes(depth - 1, n, dtype), H100_SMEM, "enqueue")
    assert ops.drain_smem_bytes(7, 64, 64, torch.float32) == 230_292


def test_refusal_above_the_block_limit():
    """J = 8 f32 buckets of 64 x 64 (and J = 15 in the enqueue) overflow
    the narrow route's block, so the wide route takes them; the wrappers
    refuse only what a wide block cannot hold either (a unit list of 256
    buckets x 140 sender chunks)."""
    need = ops.drain_smem_bytes(8, 64, 64, torch.float32)
    assert need == 246_688 > H100_SMEM
    with pytest.raises(ValueError, match="246688 bytes of shared memory, more than the 232448"):
        ops.check_smem(need, H100_SMEM, "drain kernel: 8 buckets of 64 x 64 weights")
    assert ops.drain_route(8, 64, 64, torch.float32, H100_SMEM) == "wide"
    assert ops.drain_route(7, 64, 64, torch.float32, H100_SMEM) == "narrow"
    assert ops.enqueue_smem_bytes(15, 64, torch.float32) > H100_SMEM
    assert ops.enqueue_route(15, 64, torch.float32, H100_SMEM) == "wide"
    ops.check_smem(ops.wide_smem_bytes(15, 64, torch.float32), H100_SMEM, "enqueue")
    assert ops.wide_smem_bytes(256, 4448, torch.float32) == H100_SMEM
    assert ops.drain_route(256, 4448, 8, torch.float32, H100_SMEM) == "wide"
    assert ops.drain_route(256, 4449, 8, torch.float32, H100_SMEM) is None
    with pytest.raises(ValueError, match="233472 bytes of shared memory"):
        ops.check_smem(ops.wide_smem_bytes(256, 4449, torch.float32), H100_SMEM, "drain")
    ops.check_smem(H100_SMEM, H100_SMEM, "at the limit")


def test_wide_constants_match_the_header():
    """The wide route's Python reckoning uses stream.cuh's own widths,
    rows, stages and source cap, and each source exports its wide
    reckoning and route."""
    header = build.KERNELS / "gossip" / "csrc" / "stream.cuh"
    assert ops.WIDE == _source_int(header, r"#define WIDE (\d+)")
    assert ops.WIDE_K == _source_int(header, r"#define WIDE_K (\d+)")
    assert "#define WIDE_TILE GOSSIP_CONSUMERS" in header.read_text()
    assert ops.WIDE_TILE == ops.CONSUMERS
    assert ops.WIDE_ROW - ops.WIDE_TILE == _source_int(
        header, r"#define WIDE_ROW \(WIDE_TILE \+ (\d+)\)")
    assert ops.WIDE_WROW == _source_int(header, r"#define WIDE_WROW (\d+)")
    assert ops.WIDE_STAGES == _source_int(header, r"#define WIDE_STAGES (\d+)")
    assert ops.WIDE_MAX_S == _source_int(header, r"#define WIDE_MAX_S (\d+)")
    for name, narrow in (("drain", r"#define DRAIN_MAX_N (\d+)"),
                         ("enqueue", r"#define ENQ_MAX_N (\d+)"),
                         ("mix", r"#define MIX_MAX_N (\d+)")):
        source = build.source_path(name)
        assert ops.NARROW_MAX == _source_int(source, narrow)
        assert f"{name}_wide_smem_bytes" in source.read_text()
    assert ops.NARROW_MAX == _source_int(build.source_path("drain"), r"#define DRAIN_MAX_M (\d+)")


@pytest.mark.parametrize("j,n,dtype,want", [
    (3, 100, torch.float32, 90_160), (3, 100, torch.bfloat16, 64_048),
    (1, 65, torch.float32, 90_128), (16, 64, torch.float32, 90_240),
    (3, 256, torch.float32, 90_208), (0, 100, torch.float32, 90_112)])
def test_wide_smem(j, n, dtype, want):
    """Four warps' 16 x 40 store buffers, three
    stages of 32 payload rows x 136 elements and 32 weight rows x 72 f32,
    and a 4-byte entry per (bucket, 32-sender
    chunk) padded to 4: no term grows with M, and N and J only through
    the unit list."""
    elem = 4 if dtype == torch.float32 else 2
    assert ops.wide_smem_bytes(j, n, dtype) == want == (
        4 * 4 * 16 * 40 + 3 * 32 * (136 * elem + 4 * 72)
        + 4 * (-(-(j * -(-n // 32)) // 4) * 4))


@pytest.mark.parametrize("n,parts,each", [(1, 1, 1), (64, 1, 64), (65, 2, 33), (100, 2, 50),
                                          (128, 2, 64), (129, 3, 43), (256, 4, 64)])
def test_wide_parts_are_balanced(n, parts, each):
    """Receivers in groups of at most 64, balanced: ceil(n / 64) groups of
    ceil(n / groups) (the header's wide_part); senders in chunks of 32,
    the last one short."""
    assert ops.wide_parts(n) == parts
    assert -(-n // parts) == each <= ops.WIDE
    assert (parts - 1) * each < n <= parts * each
    assert ops.wide_chunks(n) == -(-n // 32) and ops.WIDE_K == 32


@pytest.mark.parametrize("j,n,m,dtype,route", [
    (3, 25, 25, torch.float32, "narrow"), (7, 64, 64, torch.float32, "narrow"),
    (8, 64, 64, torch.float32, "wide"), (8, 64, 64, torch.bfloat16, "narrow"),
    (16, 64, 64, torch.bfloat16, "wide"), (3, 65, 65, torch.float32, "wide"),
    (3, 100, 40, torch.float32, "wide"), (3, 40, 100, torch.bfloat16, "wide"),
    (0, 25, 25, torch.float32, "narrow"), (0, 100, 100, torch.float32, "wide"),
    (257, 4, 4, torch.float32, None)])
def test_drain_route_from_the_shape(j, n, m, dtype, route):
    assert ops.drain_route(j, n, m, dtype, H100_SMEM) == route


def test_enqueue_and_mix_routes_from_the_shape():
    """The mix: the CUDA cores up to 64 clients, wgmma on the tensor cores
    while a block holds a receiver group's Q splits (272 clients in f32,
    328 in bf16, whose ring is half), stream.cuh's wide route past that."""
    assert ops.enqueue_route(3, 25, torch.float32, H100_SMEM) == "narrow"
    assert ops.enqueue_route(7, 64, torch.float32, H100_SMEM) == "narrow"
    assert ops.enqueue_route(8, 64, torch.float32, H100_SMEM) == "wide"
    assert ops.enqueue_route(3, 65, torch.bfloat16, H100_SMEM) == "wide"
    assert ops.enqueue_route(0, 8, torch.float32, H100_SMEM) is None
    assert [ops.mix_route(n, torch.float32, H100_SMEM)
            for n in (1, 4, 25, 64, 65, 100, 256, 272, 273, 1000)] == \
        ["narrow"] * 4 + ["tensor"] * 4 + ["wide"] * 2
    assert [ops.mix_route(n, torch.bfloat16, H100_SMEM) for n in (64, 281, 328, 329)] == \
        ["narrow", "tensor", "tensor", "wide"]


def test_mix_constants_match_the_source():
    """The tensor route's Python reckoning uses mix.cu's own tile, unit,
    row, stages, receiver blocks and output rows, and the route codes."""
    source = build.source_path("mix")
    text = source.read_text()
    assert ops.MIX_TC_TILE == _source_int(source, r"constexpr int TC_TILE = (\d+);")
    assert _source_int(source, r"#define TC_THREADS (\d+)") == 2 * ops.MIX_TC_TILE
    assert ops.MIX_TC_K == _source_int(source, r"constexpr int TC_K = (\d+);")
    assert ops.MIX_TC_ROW - 64 == _source_int(source, r"constexpr int TC_ROW = 64 \+ (\d+);")
    assert ops.MIX_TC_STAGES == _source_int(source, r"constexpr int TC_STAGES = (\d+);")
    assert ops.MIX_TC_NB == _source_int(source, r"constexpr int TC_NB = (\d+);")
    assert ops.MIX_TC_LD == 64 + _source_int(source, r"constexpr int TC_LD = 64 \+ (\d+);")
    assert "// 0 narrow, 1 tensor, 2 wide (ops.MIX_ROUTES)" in text
    assert ops.MIX_ROUTES == ("narrow", "tensor", "wide")
    assert "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32" in text


@pytest.mark.parametrize("n,shape,smem", [
    (65, (65, 2), 163_840), (100, (100, 2), 196_608), (128, (128, 2), 221_184),
    (129, (65, 2), 229_376), (256, (64, 1), 221_184), (272, (55, 1), 229_376)])
def test_mix_tensor_groups_and_smem(n, shape, smem):
    """One group of up to 128 receivers (two wgmma blocks of 64; each delta
    read once), else balanced groups, each the widest whose block (Q's hi
    and lo splits, senders padded to 8 x 64 per block, and per warpgroup
    three stages of 32 rows x 72 f32 and a 64 x 68 f32 output buffer) fits
    an H100 block: 256 in four groups of 64."""
    gw, nb = ops.mix_tensor_shape(n, torch.float32, H100_SMEM)
    assert (gw, nb) == shape and nb == -(-gw // 64) <= ops.MIX_TC_NB
    groups = -(-n // gw)
    assert (groups - 1) * gw < n <= groups * gw
    assert ops.mix_tensor_smem_bytes(n, nb, torch.float32) == smem <= H100_SMEM
    assert smem == 2 * 4 * (-(-n // 8) * 8) * 64 * nb + 2 * 3 * 32 * 72 * 4 + 2 * 64 * 68 * 4


def test_mix_tensor_route_ends_where_q_does_not_fit():
    """Past 272 clients in f32 (328 in bf16) not even one block of 64
    receivers fits beside the rings; the bf16 rings are half the f32 ones."""
    assert ops.mix_tensor_shape(273, torch.float32, H100_SMEM) is None
    assert ops.mix_tensor_shape(329, torch.bfloat16, H100_SMEM) is None
    assert ops.mix_tensor_shape(328, torch.bfloat16, H100_SMEM) == (55, 1)
    assert ops.mix_tensor_smem_bytes(100, 2, torch.float32) - \
        ops.mix_tensor_smem_bytes(100, 2, torch.bfloat16) == 2 * 3 * 32 * 72 * 2


@pytest.mark.parametrize("kernel,edit", sorted(
    (k, e) for k, edits in variants.EDITS.items() for e in edits))
def test_every_gossip_variant_edit_finds_its_text(kernel, edit):
    """Each edit of the variants (timing parts of a kernel, the ring's
    depth, the tensor-core design) still finds the text it replaces."""
    got = variants.variant_source(kernel, edit)
    assert got != variants.variant_source(kernel, "kernel")
    assert all(new in got for _, new in variants.EDITS[kernel][edit])


def test_mix_variants_apply(tmp_path):
    """The mix's own edits: the product and stores of both of its routes,
    the tensor route's terms and copies, and shapes that keep the
    arithmetic; the drain's ring and product edits do not apply to it, the
    default list builds, and the baseline is the mix of another tree."""
    assert variants.variant_source("mix", "kernel") == build.source_path("mix").read_text()
    for name in variants.DEFAULT:
        if variants.applies("mix", name):
            variants.variant_source("mix", name)
    assert not any(variants.applies("mix", name) for name in (
        "compute-only", "stages-2", "cuda-cores", "tensor-cores", "wide-no-mma"))
    assert variants.applies("mix", "no-fma+no-stores")
    assert {"narrow-ch-double", "narrow-ch-half"} <= variants.EXACT
    assert "acc[0][i] += p[j][i]" in variants.variant_source("mix", "no-fma")
    assert variants.variant_source("mix", "no-stores").count("(K >> 62)") == 2  # both routes
    assert variants.variant_source("mix", "one-term").count("wgmma_tf32(acc[b]") == 1
    old = tmp_path / "src" / "repro_torch" / "kernels" / build.SOURCES["mix"]
    old.parent.mkdir(parents=True)
    old.write_text("// an earlier design\n")
    assert variants.variant_source("mix", "baseline", tmp_path) == "// an earlier design\n"


@pytest.mark.parametrize("kernel", ["drain", "enqueue"])
def test_default_gossip_variants_apply(kernel, tmp_path):
    assert variants.variant_source(kernel, "kernel") == build.source_path(kernel).read_text()
    for name in variants.DEFAULT:
        if variants.applies(kernel, name):
            variants.variant_source(kernel, name)
    # each kernel's other product: the drain's default is the tensor cores
    other, own = ("cuda-cores", "tensor-cores") if kernel == "drain" else (
        "tensor-cores", "cuda-cores")
    assert variants.applies(kernel, other) and not variants.applies(kernel, own)
    assert variants.applies(kernel, f"{other}+stages-2")
    with pytest.raises(KeyError):
        variants.variant_source(kernel, "no-such-edit")
    with pytest.raises(ValueError, match="baseline"):
        variants.variant_source(kernel, "baseline")
    old = tmp_path / "src" / "repro_torch" / "kernels" / build.SOURCES[kernel]
    old.parent.mkdir(parents=True)
    old.write_text("// an earlier design\n")
    assert variants.variant_source(kernel, "baseline", tmp_path) == "// an earlier design\n"
