"""The longest quick benches of `benchmarks/torch_run.py` (fig3, fig4 and
sweep), split from tests/test_torch_entry_points.py so that two workers
share the quick set: each emits the reference bench's row names at the
quick arguments, finite, and the fig benches' JSON files have the
reference's keys (`benchmarks/fig3_convergence.py`, `fig4_psi_sweep.py`).
"""
import pytest

torch = pytest.importorskip("torch")

from _torch_entry import FIG4_ROW, fig_json, run_quick_bench  # noqa: E402
from _torch_entry import single_thread  # noqa: E402,F401  (autouse)


@pytest.fixture(scope="module")
def bench_dir(tmp_path_factory):
    return tmp_path_factory.mktemp("bench")


@pytest.mark.parametrize("bench", ["fig3", "fig4", "sweep"])
def test_quick_bench_emits_the_reference_rows(bench, bench_dir, capsys):
    run_quick_bench(bench, bench_dir, capsys)


def test_fig3_json_has_the_reference_keys(bench_dir):
    doc = fig_json("fig3", bench_dir)
    assert list(doc["curves"]) == ["draco", "sync-symm", "sync-push", "async-symm",
                                   "async-push"]
    assert {len(c) for c in doc["curves"].values()} == {4}  # m0 + 3 segments


def test_fig4_json_has_the_reference_keys(bench_dir):
    doc = fig_json("fig4", bench_dir)
    assert list(doc["results"]) == ["1", "4", "24"]
    assert all(set(r) == FIG4_ROW for r in doc["results"].values())
