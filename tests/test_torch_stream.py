"""The host side of the streamed gossip kernels (``csrc/drain.cu``,
``csrc/enqueue.cu``, ``csrc/stream.cuh``): the shared-memory reckoning
the wrappers check before a launch, its agreement with the sources'
constants, and the variants that ``chip_smoke.py --gossip-variants``
builds. The kernels themselves run only on the card
(tests/test_torch_cuda.py and chip_smoke.py)."""
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
    need = ops.drain_smem_bytes(8, 64, 64, torch.float32)
    assert need == 246_688 > H100_SMEM
    with pytest.raises(ValueError, match="246688 bytes of shared memory, more than the 232448"):
        ops.check_smem(need, H100_SMEM, "drain kernel: 8 buckets of 64 x 64 weights")
    with pytest.raises(ValueError, match="shared memory"):
        ops.check_smem(ops.enqueue_smem_bytes(15, 64, torch.float32), H100_SMEM, "enqueue")
    ops.check_smem(H100_SMEM, H100_SMEM, "at the limit")


@pytest.mark.parametrize("kernel,edit", sorted(
    (k, e) for k, edits in variants.EDITS.items() for e in edits))
def test_every_gossip_variant_edit_finds_its_text(kernel, edit):
    """Each edit of the variants (timing parts of a kernel, the ring's
    depth, the tensor-core design) still finds the text it replaces."""
    got = variants.variant_source(kernel, edit)
    assert got != variants.variant_source(kernel, "kernel")
    assert all(new in got for _, new in variants.EDITS[kernel][edit])


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
