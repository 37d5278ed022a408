"""The port's roofline (`repro_torch.launch.roofline`) and dry run
(`repro_torch.launch.dryrun`), held against the JAX package's
`repro.launch.roofline` and the abstract inputs of its dry run.

The reference's `lower_pair` cannot run here (``test_dryrun_small``
fails under jax 0.9's ``Explicit`` mesh axes), so its parts are held:
`model_flops_analytic` and `Roofline.row()` exactly, given the
reference's peaks; the argument bytes against the summed bytes of the
reference's abstract specs for every architecture at full width (the
port's tokens are int64 where the reference's are int32); the counted
FLOPs of reduced train steps within a band of `model_flops_analytic`;
the world-less mesh's collective tally against a real gloo world's on
the same step; and the row's keys.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401  (autouse: one CPU thread)

import jax  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.launch import roofline as jroof  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.kernels import work  # noqa: E402
from repro_torch.kernels.gossip import ops as gossip_ops  # noqa: E402
from repro_torch.kernels.ssd import ops as ssd_ops  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.launch import roofline as troof  # noqa: E402

import _torch_roofline_ranks as R  # noqa: E402

PAIRS = [(a, s) for a in tbase.ARCH_IDS for s in tbase.SHAPES]
# the reference has one compute rate; no kernel work is counted in a
# reference row, so the kernels' rates are never read there
JAX_PEAKS = troof.Peaks(flops=jroof.PEAK_FLOPS, hbm_bw=jroof.HBM_BW, link_bw=jroof.ICI_BW,
                        f32_flops=jroof.PEAK_FLOPS, tf32_flops=jroof.PEAK_FLOPS)
# the keys `repro.launch.dryrun.lower_pair` adds to `Roofline.row()`
REFERENCE_ROW_EXTRAS = ("mix_mode", "psi", "mix_dtype", "blocked_threshold", "cache_shard",
                        "vocab_chunk", "seq_parallel", "t_lower_s", "t_compile_s",
                        "memory_analysis", "cost_correction")
# 6 N T against the counted products of a reduced train step: the
# embedding's lookups do no products and the vlm's cross-attention K/V
# project the patches, not the tokens (up to ~1.26); attention's own
# products and the loss add (down to ~0.88)
FLOPS_BAND = (0.85, 1.30)


@pytest.mark.parametrize("arch,shape", PAIRS)
def test_model_flops_analytic_equals_the_reference(arch, shape):
    got = troof.model_flops_analytic(tbase.get_config(arch), tbase.SHAPES[shape])
    assert got == jroof.model_flops_analytic(jbase.get_config(arch), jbase.SHAPES[shape])


@pytest.mark.parametrize("arch,shape", PAIRS)
def test_roofline_row_equals_the_reference_given_its_peaks(arch, shape):
    cfg, s = tbase.get_config(arch), tbase.SHAPES[shape]
    rng = np.random.default_rng(len(arch) * 7 + len(shape))
    kw = dict(arch=arch, shape=shape, mesh="16x1", mode=s.mode,
              flops_per_device=float(rng.uniform(1e12, 1e15)),
              bytes_per_device=float(rng.uniform(1e9, 1e12)),
              coll_bytes_per_device=float(rng.uniform(0, 1e10)),
              coll_breakdown={"all-gather": 3}, model_flops=troof.model_flops_analytic(cfg, s),
              peak_memory_bytes=float(rng.uniform(1e9, 1e11)), n_devices=16)
    mine = troof.Roofline(**kw, peaks=JAX_PEAKS).row()
    assert mine == jroof.Roofline(**kw).row()
    assert list(mine) == list(jroof.Roofline(**kw).row())


def test_default_peaks_are_the_h100():
    r = troof.Roofline("a", "s", "1x1", "train", 989e12, 3.35e12, 450e9)
    assert (r.t_compute, r.t_memory, r.t_collective) == (1.0, 1.0, 1.0)
    assert troof.Roofline.__dataclass_fields__["peaks"].default is troof.H100_SXM


def _jax_bytes(tree):
    """Summed bytes of the reference's abstract leaves, its int32 token
    leaves at the port's int64 (a 0-d int32, the cache position, stays)."""
    total = 0
    for leaf in jax.tree_util.tree_leaves(tree):
        item = np.dtype(leaf.dtype).itemsize
        if np.dtype(leaf.dtype) == np.int32 and len(leaf.shape) > 0:
            item = 8
        total += int(np.prod(leaf.shape, dtype=np.int64)) * item
    return total


@pytest.mark.parametrize("arch", tbase.ARCH_IDS)
def test_argument_bytes_equal_the_reference_specs_at_full_width(arch):
    jcfg, tcfg = jbase.get_config(arch), tbase.get_config(arch)
    for name, shape in jbase.SHAPES.items():
        if shape.mode == "train":
            ref = (jsteps.stack_clients_abstract(jsteps.param_specs_abstract(jcfg), 1),
                   jsteps.train_batch_specs(jcfg, shape, 1),
                   jax.ShapeDtypeStruct((1, 1), np.float32))
        elif shape.mode == "prefill":
            ref = (jsteps.param_specs_abstract(jsteps.serve_config(jcfg, shape)),
                   jsteps.prefill_batch_specs(jcfg, shape))
        else:
            ref = (jsteps.param_specs_abstract(jsteps.serve_config(jcfg, shape)),
                   *jsteps.serve_input_specs(jcfg, shape))
        mesh, _ = dryrun.make_dry_mesh(1)
        _, args = dryrun.build(tcfg, tbase.SHAPES[name], mesh)
        assert all(t.device.type == "meta" for t in troof.tensors_of(args))
        assert dryrun.nbytes(args) == _jax_bytes(ref), (arch, name)


@pytest.mark.parametrize("arch", tbase.ARCH_IDS)
def test_counted_flops_of_a_reduced_train_step_near_the_analytic(arch):
    cfg = tbase.get_reduced(arch)
    shape = tbase.ShapeConfig("t", 64, 4, "train")
    mesh, _ = dryrun.make_dry_mesh(2)
    got = dryrun.reckon(cfg, shape, mesh)
    ratio = troof.model_flops_analytic(cfg, shape) / (got["flops"] * 2)
    assert FLOPS_BAND[0] <= ratio <= FLOPS_BAND[1], ratio
    assert got["kernels"]["gossip_drain"]["calls"] == 1  # the dense mix, one drain
    if cfg.family in ("ssm", "hybrid"):
        assert got["kernels"]["ssd_chunk"]["calls"] >= 1


def test_kernels_count_their_bound_work_on_meta():
    seen = []
    with work.sink(lambda name, w: seen.append((name, w))):
        out = gossip_ops.gossip_drain(torch.empty((3, 4, 8), device="meta"),
                                      torch.empty((5, 4, 100), device="meta",
                                                  dtype=torch.bfloat16), [0, 2, 4])
        mixed = gossip_ops.gossip_mix(torch.empty((4, 4), device="meta"),
                                      torch.empty((4, 100), device="meta"))
        y, s = ssd_ops.ssd_chunk(*(torch.empty(sh, device="meta") for sh in (
            (1, 2, 3, 16, 8), (1, 2, 3, 16, 8), (1, 4, 3, 16, 6), (1, 4, 3, 16),
            (1, 4, 3, 16))))
    assert (tuple(out.shape), out.dtype) == ((8, 100), torch.float32)
    assert tuple(mixed.shape) == (4, 100) and tuple(y.shape) == (1, 4, 3, 16, 6)
    assert tuple(s.shape) == (1, 4, 3, 8, 6)
    assert seen == [("gossip_drain", work.drain(3, 4, 8, 100, 2)),
                    ("gossip_mix", work.mix(4, 100, 4)),
                    ("ssd_chunk", work.ssd_chunk(1, 4, 2, 3, 16, 8, 6, 4))]
    assert gossip_ops.gossip_drain.launches == 0 and ssd_ops.ssd_chunk.launches == 0


def test_dry_mesh_tally_equals_a_gloo_world():
    """The same train step in every mix mode: the world-less mesh on
    ``meta`` against rank 0 of a real 2-rank gloo world on the CPU."""
    worlds = mesh_lib.spawn_ranks(R.tallies, 2, backend="gloo", timeout=60.0, deadline=180.0)
    assert worlds[0] == worlds[1]
    cfg = tbase.get_reduced(R.ARCH)
    for name, mode, dtype in R.MODES:
        mesh, _ = dryrun.make_dry_mesh(2)
        got = dryrun.reckon(cfg, R.SHAPE, mesh, mix_mode=mode, mix_dtype=dtype)
        assert {**got["coll_breakdown"], "_counts": got["coll_counts"]} == worlds[0][name]
    assert worlds[0]["dense"]["reduce_scatter"] == 2 * worlds[0]["dense-bf16"]["reduce_scatter"]
    assert worlds[0]["ring"]["_counts"]["ring_exchange"] >= 1
    # a served batch of 1 with its ring's slots over "data": each step's merge
    # of the partial softmaxes, two client-axis all-reduces a layer
    mesh, _ = dryrun.make_dry_mesh(2)
    step, (params, tok, state) = dryrun.build(cfg.with_(sliding_window=R.SERVE_WINDOW),
                                              R.SERVE_SHAPE, mesh)
    for _ in range(R.SERVE_STEPS):
        _, state = step(params, tok, state)
    assert mesh.collective_tally() == worlds[0]["serve"]
    assert worlds[0]["serve"]["_counts"]["client_all_reduce"] == \
        2 * cfg.num_layers * R.SERVE_STEPS


def test_lower_pair_returns_every_key_of_the_reference_row():
    cfg = tbase.get_reduced("qwen2-1.5b")
    row = dryrun.lower_pair("qwen2-1.5b", "train_4k", clients=16, cfg=cfg, verbose=False)
    ref_keys = list(jroof.Roofline("a", "s", "m", "train", 1.0, 1.0, 1.0).row())
    assert set(ref_keys + list(REFERENCE_ROW_EXTRAS)) <= set(row)
    assert row["mesh"] == "16x1" and row["n_devices"] == 16
    assert row["cost_correction"] == {"method": "counted"}
    mem = row["memory_analysis"]
    assert mem["generated_code_size_in_bytes"] is None
    assert mem["argument_size_in_bytes"] > 0 and mem["temp_size_in_bytes"] > 0
    assert row["reckoned_peak_bytes"] == mem["argument_size_in_bytes"] + \
        mem["temp_size_in_bytes"]
    assert row["coll_breakdown"]["counts"]["reduce_scatter"] == 1


def test_production_mesh_and_seq_parallel_raise_naming_the_roadmap():
    cfg = tbase.get_reduced("qwen2-1.5b")
    row = dryrun.lower_pair("qwen2-1.5b", "decode_32k", cfg=cfg, verbose=False)
    assert row["mesh"] == "16x16" and row["n_devices"] == 256  # the reference's (16, 16)
    assert row["coll_breakdown"]["counts"]["model_all_gather"] > 0  # 16 ways cut its heads
    assert row["tp_routes"]["padded"] == cfg.num_layers
    ssm = dryrun.lower_pair("mamba2-2.7b", "decode_32k", cfg=tbase.get_reduced("mamba2-2.7b"),
                            verbose=False)  # 16 ssm heads over 16 ranks: one a rank
    assert ssm["tp_routes"]["ssm"] == 2 and ssm["tp_routes"]["ssm_heads"] == 1
    audio = dryrun.lower_pair("musicgen-large", "decode_32k",
                              cfg=tbase.get_reduced("musicgen-large"), verbose=False)
    assert audio["tp_routes"]["padded"] == 2  # 4 heads over 16 ranks: one a rank, or none
    # the cache's other layouts: head_dim over the 16 model ranks, every kv
    # head at 2 of the 32 head_dims, recorded
    hd = dryrun.lower_pair("qwen2-1.5b", "decode_32k", cfg=cfg, cache_shard="head_dim",
                           verbose=False)
    assert hd["cache_shard"] == "head_dim" and row["cache_layout"] is None
    assert hd["cache_layout"] == {"slots": None, "head_dim": "model", "kv_heads": "every"}
    assert hd["coll_breakdown"]["counts"]["model_all_reduce"] > \
        row["coll_breakdown"]["counts"]["model_all_reduce"]
    # sequence parallelism (ROADMAP item 20(e), ported) goes to the train step
    # alone: a decode pair with the flag reckons what it does without
    flagged = dryrun.lower_pair("qwen2-1.5b", "decode_32k", clients=2, seq_parallel=True,
                                cfg=cfg, verbose=False)
    plain = dryrun.lower_pair("qwen2-1.5b", "decode_32k", clients=2, cfg=cfg, verbose=False)
    assert flagged["seq_parallel"] and not plain["seq_parallel"]
    for key in ("coll_breakdown", "tp_routes", "reckoned_peak_bytes", "flops_per_device"):
        assert flagged[key] == plain[key], key
    sp = dryrun.lower_pair("qwen2-1.5b", "decode_32k", seq_parallel=True, cfg=cfg,
                           verbose=False)
    assert sp["coll_breakdown"] == row["coll_breakdown"]
    assert sp["tp_routes"] == row["tp_routes"] and sp["tp_routes"]["seq"] == 0
    # a batch of 1 on 16 client ranks: whole on each, the ring's slots over "data"
    long = dryrun.lower_pair("qwen2-1.5b", "long_500k", clients=16,
                             cfg=tbase.get_reduced("qwen2-1.5b"), verbose=False)
    assert long["serving_rows"] == 1 and long["cache_layout"]["slots"] == "data"
    assert long["coll_breakdown"]["counts"]["client_all_reduce"] == 2 * cfg.num_layers


def test_lower_pair_takes_a_reckoned_row():
    """A row reckoned before (in another process, say) stands for the
    counting: the same row, timings and all."""
    cfg = tbase.get_reduced("qwen2-1.5b")
    for shape, kw in (("train_4k", {"clients": 4}), ("long_500k", {})):
        row = dryrun.lower_pair("qwen2-1.5b", shape, cfg=cfg, verbose=False, **kw)
        again = dryrun.lower_pair("qwen2-1.5b", shape, cfg=cfg, verbose=False, reckoned=row,
                                  **kw)
        assert again == row


def test_temp_peak_tracks_live_storages():
    def step(x):
        a = x * 2  # 4 KiB live
        b = a + 1  # 8 KiB live
        del a
        c = b.sum()  # 4 KiB + 4 bytes
        return c

    x = torch.empty(1024, device="meta")
    got = troof.count_work(step, x)
    assert got.temp_peak == 2 * 4096
    assert got.bytes == (4096 + 4096) + (4096 + 4096) + (4096 + 4)  # in + out per op


def test_temp_peak_follows_the_cards_kernels():
    """Two places where the meta run under the counters differs from the
    card: under a dispatch mode a gather's backward scatters into its fresh
    zero tensor out of place (the card in place: one buffer), and CUDA's
    softmax backward forms ``grad * output`` in a temporary beside its
    output (the meta kernel makes none)."""
    n, v = 64, 1024
    full = n * v * 4

    def gather_grad(x, idx):
        (g,) = torch.autograd.grad(torch.gather(x, 1, idx).sum(), [x])
        return g

    x = torch.empty((n, v), device="meta", requires_grad=True)
    idx = torch.zeros((n, 1), dtype=torch.long, device="meta")
    assert full <= troof.count_work(gather_grad, x, idx).temp_peak < full + 1024

    def softmax_grad(x, go):
        (g,) = torch.autograd.grad(torch.softmax(x, -1), [x], go)
        return g

    go = torch.empty((n, v), device="meta")
    assert troof.count_work(softmax_grad, x, go).temp_peak == 3 * full  # y, dx, the temporary


def test_no_tpu_constant_in_the_port():
    import os
    import re

    port = os.path.join(os.path.dirname(__file__), "..", "src", "repro_torch")
    for rel in ("launch/roofline.py", "launch/dryrun.py", "kernels/work.py"):
        with open(os.path.join(port, rel)) as f:
            text = f.read()
        assert not re.search(r"197e12|819e9|\b50e9|TPU|v5e", text), rel
    assert (troof.H100_SXM.flops, troof.H100_SXM.hbm_bw, troof.H100_SXM.link_bw) != \
        (jroof.PEAK_FLOPS, jroof.HBM_BW, jroof.ICI_BW)


def test_kernel_bounds_on_the_h100():
    """The bound column's arithmetic: the drain at the EMNIST window (3
    live f32 buckets) is byte-bound, 0.0175 ms; 1 live of 3 reads one
    bucket's rows; the wide drain at N = M = 100 is bound by its f32
    products, and on the tensor cores by 3 TF32 products each; the SSD
    step at the trainer's shape reads 53.6 MB; its f32 twin issues 3
    TF32 products per operation."""
    h = troof.H100_SXM
    t, by = work.bound_s(work.drain(3, 25, 25, 146_447, 4), h)
    assert by == "bytes" and round(t * 1e3, 4) == 0.0175
    one = work.drain(3, 25, 25, 146_447, 4, live=1)
    assert one.bytes == 25 * 146_447 * 4 + 3 * 25 * 25 * 4 + 25 * 146_447 * 4
    assert one.ops == 2 * 25 * 25 * 146_447
    wide = work.drain(3, 100, 100, 146_447, 4)
    t, by = work.bound_s(wide, h)
    assert by == "operations" and t == wide.ops / h.f32_flops
    tc = work.tensor_core(wide, 4)
    assert (tc.issued, tc.rate) == (3 * wide.ops, "tf32_flops")
    main = work.ssd_chunk(2, 80, 1, 4, 128, 128, 64, 2)
    t, by = work.bound_s(main, h)
    assert by == "bytes" and main.bytes == 53_608_448 and round(t * 1e3, 4) == 0.0160
    f32 = work.ssd_chunk(2, 80, 1, 4, 128, 128, 64, 4)
    assert (f32.issued, f32.rate, f32.ops) == (3 * main.ops, "tf32_flops", main.ops)
    assert main.rate == "flops" and main.ops < main.issued < 3 * main.ops


def test_compute_term_reads_each_kernels_rate():
    """A row whose FLOPs include kernel work: the aten part at the bf16
    peak, the drain's f32 products at the f32 rate."""
    drain = work.drain(1, 1, 64, 10_000, 4)
    kernels = {"gossip_drain": {"calls": 1, "flops": drain.ops, "bytes": drain.bytes,
                                "issued": {drain.rate: drain.issued}}}
    r = troof.Roofline("a", "s", "1x1", "train", 1e12 + drain.ops, 1.0, 0.0,
                       kernel_work=kernels)
    h = troof.H100_SXM
    assert r.t_compute == pytest.approx(1e12 / h.flops + drain.ops / h.f32_flops, rel=1e-12)
    assert troof.Roofline("a", "s", "1x1", "train", 1e12, 1.0, 0.0).t_compute == 1e12 / h.flops


def test_count_work_sums_kernel_work_by_rate():
    w = troof.count_work(lambda a, b: (gossip_ops.gossip_mix(a, b), gossip_ops.gossip_mix(a, b)),
                         torch.empty((4, 4), device="meta"), torch.empty((4, 100), device="meta"))
    one = work.mix(4, 100, 4)
    assert w.kernels == {"gossip_mix": {"calls": 2, "flops": 2 * one.ops,
                                        "bytes": 2 * one.bytes,
                                        "issued": {"f32_flops": 2 * one.issued}}}


def test_row_bound_share_reads_only_the_work():
    """``t_bound_s``: model FLOPs over the ranks at the peak against the
    arguments read once and the outputs written once."""
    cfg = tbase.get_reduced("qwen2-1.5b")
    row = dryrun.lower_pair("qwen2-1.5b", "decode_32k", clients=16, cfg=cfg, verbose=False)
    mem = row["memory_analysis"]
    assert row["necessary_bytes"] == mem["argument_size_in_bytes"] + \
        mem["output_size_in_bytes"]
    h = troof.H100_SXM
    assert row["t_bound_s"] == max(row["model_flops"] / 16 / h.flops,
                                   row["necessary_bytes"] / h.hbm_bw)
    assert 0 < row["t_bound_s"] <= max(row["t_compute_s"], row["t_memory_s"])
