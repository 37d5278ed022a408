"""Shared by the port's entry-point tests (a helper, not a test module):
the reference benches' row names and JSON schemas, one quick bench run,
and a fixture that runs a test module's torch work on one CPU thread.

One thread: the whole suite runs in six pytest-xdist worker processes on
a few cores; torch's default intra-op pool (a thread per core, spinning
between parallel regions) then oversubscribes the machine, and the quick
benches' small matmuls slow down fifty-fold while starving every other
worker. On one thread each of these modules runs in about a minute.
"""
import json
import math
import os

import pytest
import torch

from benchmarks import torch_common, torch_run

# the reference bench's rows at --quick (benchmarks/run.py's f-strings at
# the quick arguments); `tasks` follows the reference registry's order
QUICK_ROWS = {
    "gossip": ["gossip_mix_plain_25x149k"],
    "ssd": ["ssd_forward_plain_T512", "ssd_sequential_T512"],
    "draco_window": ["draco_window_fused_N8_D4", "draco_window_legacy_N8_D4"],
    "simulate_fused": ["simulate_fused_W60_N8", "segment_loop_W60_N8"],
    "sweep": ["sweep_grid_8x6_N25_W8", "sweep_loop_8x6_N25_W8",
              "sweep_grid_steady_8x6_N25"],
    "events": ["draco_window_N8", "draco-event_N8", "fedasync-gossip_N8"],
    "fig3": ["fig3_emnist_draco_final_acc"],
    "fig4": ["fig4_best_psi"],
    "fig_dynamic": ["fig_dynamic_churn_robustness", "fig_dynamic_straggler_robustness"],
    "decode": ["decode_step_reduced_qwen2"],
}
# the reference's renamed rows: `gossip_mix_xla_25x149k` and
# `ssd_chunked_T512` named themselves by the JAX backend
RENAMED = {"gossip": ["gossip_mix_xla_25x149k"], "ssd": ["ssd_chunked_T512"]}
# the reference's JSON schemas (benchmarks/fig3_convergence.py,
# fig4_psi_sweep.py, fig_dynamic.py)
FIG_KEYS = {
    "fig3": {"task", "topology", "metric", "curves"},
    "fig4": {"task", "metric", "results"},
    "fig_dynamic": {"task", "windows", "metric", "results"},
}
FIG4_ROW = {"final_acc", "best_acc", "acc_curve", "msgs", "osc"}
DYNAMIC_ROW = {"final_acc", "best_acc", "final_consensus", "acc_curve", "consensus_curve",
               "msgs"}


@pytest.fixture(autouse=True, scope="module")
def single_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def reference_rows(bench):
    if bench != "tasks":
        return QUICK_ROWS[bench]
    from repro.tasks import list_tasks

    return [f"task_{name}_draco_window_N8" for name in list_tasks()] + [
        "task_mlp_adamw_draco_window_N8"]


def run_quick_bench(bench, out_dir, capsys):
    """`torch_run --quick --device cpu --only bench` into `out_dir`; checks
    that it emits and prints the reference's rows, finite, and not the
    renamed ones."""
    torch_common.RESULTS.clear()
    torch_run.main(["--quick", "--device", "cpu", "--only", bench, "--json", "",
                    "--out-dir", str(out_dir)])
    want = reference_rows(bench)
    assert list(torch_common.RESULTS) == want
    assert torch_common.finite()
    assert all(torch_common.RESULTS[name] > 0 for name in want if "fig" not in name)
    printed = capsys.readouterr().out.splitlines()
    assert printed[0] == "name,us_per_call,derived"
    for name in want:
        assert any(line.startswith(f"{name},") for line in printed), name
    for old in RENAMED.get(bench, ()):
        assert old not in torch_common.RESULTS
    if bench in ("sweep", "tasks", "events"):
        with open(os.path.join(out_dir, f"BENCH_torch_{bench}.json")) as f:
            assert all(math.isfinite(v) for v in json.load(f).values()
                       if isinstance(v, float))


def fig_json(bench, out_dir):
    """The fig bench's results/ JSON (run at --quick first if missing),
    checked against the reference's schema; returns the document."""
    path = os.path.join(out_dir, "results", f"{bench}_emnist.json")
    if not os.path.exists(path):
        torch_run.main(["--quick", "--device", "cpu", "--only", bench, "--json", "",
                        "--out-dir", str(out_dir)])
    with open(path) as f:
        doc = json.load(f)
    assert set(doc) == FIG_KEYS[bench]
    assert doc["task"] == "emnist" and doc["metric"] == "accuracy"
    return doc
