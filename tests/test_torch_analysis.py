"""`repro_torch.analysis`, the port's analyzer: a known-bad and a
known-good snippet for every torch rule (the exact rule id and line),
the copied engine, MARKER-DISCIPLINE and DTYPE-PLANE-CONTRACT giving the
reference analyzer's findings on the same strings, and the port's tree
clean under ``--strict``. Every planted violation lives in a string
here, never in a file either analyzer scans.
"""
import json
import os
import subprocess
import sys
import textwrap

import pytest

pytest.importorskip("torch")

from repro import analysis as janalysis  # noqa: E402
from repro.analysis.core import analyze_file as janalyze_file  # noqa: E402
from repro_torch import analysis as tanalysis  # noqa: E402
from repro_torch.analysis.core import SUPPRESS_NO_REASON, analyze_file  # noqa: E402

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
PORT_RULES = ("HOST-SYNC-IN-HOT-PATH", "TENSOR-PY-BRANCH", "RNG-GENERATOR",
              "HOST-CONSTANT-IN-HOT-PATH", "KERNEL-BUILD-IN-LOOP", "TF32-ON",
              "DTYPE-PLANE-CONTRACT", "MARKER-DISCIPLINE")


def run(text, path="src/repro_torch/core/protocol.py", rule=None):
    rules = [tanalysis.RULES[rule]] if rule else None
    return analyze_file(path, rules=rules, text=textwrap.dedent(text))


def lines_of(findings, rule):
    return [f.line for f in findings if f.rule == rule]


def test_rule_table_and_exports_match_the_reference():
    assert set(PORT_RULES) == set(tanalysis.RULES)
    assert tanalysis.__all__ == janalysis.__all__
    # one suppression means one thing: the torch rules' ids are their own
    shared = set(tanalysis.RULES) & set(janalysis.RULES)
    assert shared == {"DTYPE-PLANE-CONTRACT", "MARKER-DISCIPLINE"}


# -- HOST-SYNC-IN-HOT-PATH / TENSOR-PY-BRANCH ----------------------------------

HOT = """\
import torch

def draco_window(state, cfg, q, adj, task, data):
    x = state.params * 2
    {line}
    return helper(x, cfg)

def helper(y, cfg):
    {helper}
    return y

def cold(z):
    return z.item()
"""


@pytest.mark.parametrize("line,helper,rule,lines", [
    ("n = x.sum().item()", "pass", "HOST-SYNC-IN-HOT-PATH", [5]),
    ("n = x.tolist()", "pass", "HOST-SYNC-IN-HOT-PATH", [5]),
    ("n = x.cpu()", "pass", "HOST-SYNC-IN-HOT-PATH", [5]),
    ("n = x.numpy()", "pass", "HOST-SYNC-IN-HOT-PATH", [5]),
    ("n = float(x.max())", "pass", "HOST-SYNC-IN-HOT-PATH", [5]),
    ("n = int(q[0, 0])", "pass", "HOST-SYNC-IN-HOT-PATH", [5]),
    ("pass", "v = y.mean().item()", "HOST-SYNC-IN-HOT-PATH", [9]),
    ("assert (x > 0).all()", "pass", "TENSOR-PY-BRANCH", [5]),
    ("n = bool(x.any())", "pass", "TENSOR-PY-BRANCH", [5]),
    ("n = 1 if x.sum() > 0 else 2", "pass", "TENSOR-PY-BRANCH", [5]),
    ("pass", "if y.sum() > 0: y = -y", "TENSOR-PY-BRANCH", [9]),
    ("pass", "while (y > 1).any(): y = y / 2", "TENSOR-PY-BRANCH", [9]),
])
def test_hot_path_hazard_bad(line, helper, rule, lines):
    findings = run(HOT.format(line=line, helper=helper), rule=rule)
    assert lines_of(findings, rule) == lines


@pytest.mark.parametrize("line", [
    "n = x.shape[0] + x.dim() + x.numel()",  # host metadata
    "n = int(x.shape[0])",
    "n = 1 if cfg.psi > 0 else 2",  # a config's host number
    "n = len(x)",
    "n = 1 if x is None else 2",
    "n = torch.where(x > 0, x, -x)",  # stays on the device
])
def test_hot_path_good(line):
    findings = run(HOT.format(line=line, helper="pass"))
    assert lines_of(findings, "HOST-SYNC-IN-HOT-PATH") == []
    assert lines_of(findings, "TENSOR-PY-BRANCH") == []


def test_hot_path_is_seeded_per_module():
    # the same function elsewhere is not a hot entry point; `cold` is
    # never called from one
    text = HOT.format(line="n = x.sum().item()", helper="pass")
    assert run(text, path="src/repro_torch/api/simulate.py") == []
    assert run(text, path="tests/test_x.py") == []


def test_hot_path_suppression_with_reason_silences():
    text = HOT.format(
        line="n = x.sum().item()  # repro-lint: disable=HOST-SYNC-IN-HOT-PATH(read once by design)",
        helper="pass")
    assert run(text, rule="HOST-SYNC-IN-HOT-PATH") == []


# -- RNG-GENERATOR -------------------------------------------------------------

@pytest.mark.parametrize("snippet,lines", [
    ("x = torch.rand((3,))", [4]),
    ("x = torch.randint(0, 5, (3,), device=dev)", [4]),
    ("x = torch.randn_like(y)", [4]),
    ("x = torch.randperm(5)", [4]),
    ("x = torch.empty(3).exponential_()", [4]),
    ("x = torch.multinomial(y, 2)", [4]),
    ("a = torch.Generator().manual_seed(s)\n    b = torch.Generator().manual_seed(s)", [5]),
    ("a = as_generator(seed + 1, dev)\n    b = as_generator(seed + 1, dev)", [5]),
])
def test_rng_generator_bad(snippet, lines):
    text = f"import torch\n\ndef f(y, s, seed, dev):\n    {snippet}\n    return y\n"
    findings = run(text, path="src/repro_torch/core/events.py", rule="RNG-GENERATOR")
    assert lines_of(findings, "RNG-GENERATOR") == lines


@pytest.mark.parametrize("snippet", [
    "x = torch.rand((3,), generator=g)",
    "x = torch.empty(3).exponential_(generator=g)",
    "x = torch.randint(0, 5, (3,), **kw)",  # the caller's keywords
    "a = torch.Generator().manual_seed(s)\n    b = torch.Generator().manual_seed(s + 1)",
    "x = np.random.default_rng(0).random(3)",  # a host draw
])
def test_rng_generator_good(snippet):
    text = f"import torch\n\ndef f(y, s, g, kw):\n    {snippet}\n    return y\n"
    findings = run(text, path="src/repro_torch/core/events.py", rule="RNG-GENERATOR")
    assert findings == []


def test_rng_generator_applies_to_the_port_only():
    text = "import torch\n\ndef f():\n    return torch.rand(3)\n"
    assert run(text, path="tests/test_torch_x.py", rule="RNG-GENERATOR") == []
    assert run(text, path="chip_smoke.py", rule="RNG-GENERATOR") == []


# -- HOST-CONSTANT-IN-HOT-PATH / KERNEL-BUILD-IN-LOOP --------------------------

def test_host_constant_in_hot_path_bad():
    findings = run(
        """\
        import numpy as np
        import torch

        TABLE = np.array([1.0, 2.0])

        def decode_step(params, cfg, tok, state):
            return tok * torch.as_tensor(TABLE, device=tok.device)
        """, path="src/repro_torch/models/model.py", rule="HOST-CONSTANT-IN-HOT-PATH")
    assert lines_of(findings, "HOST-CONSTANT-IN-HOT-PATH") == [7]
    assert findings[0].severity == "warning"


def test_host_constant_good():
    findings = run(
        """\
        import numpy as np
        import torch

        TABLE = np.array([1.0, 2.0])

        def decode_step(params, cfg, tok, state, table):
            return tok * table

        def setup(dev):
            return torch.as_tensor(TABLE, device=dev)
        """, path="src/repro_torch/models/model.py", rule="HOST-CONSTANT-IN-HOT-PATH")
    assert findings == []


def test_kernel_build_in_loop_bad():
    findings = run(
        """\
        from repro_torch.kernels import build

        def sweep(names):
            for name in names:
                lib = build.load(name)
            while names:
                build.build((names.pop(),))
        """, path="src/repro_torch/kernels/x.py", rule="KERNEL-BUILD-IN-LOOP")
    assert lines_of(findings, "KERNEL-BUILD-IN-LOOP") == [5, 7]


def test_kernel_build_good():
    findings = run(
        """\
        import functools
        from repro_torch.kernels import build

        @functools.lru_cache(maxsize=None)
        def _lib():
            return build.load("drain")

        def sweep(xs):
            build.build(("drain", "mix"))
            return [_lib() for x in xs]
        """, path="src/repro_torch/kernels/x.py", rule="KERNEL-BUILD-IN-LOOP")
    assert findings == []


# -- TF32-ON -------------------------------------------------------------------

@pytest.mark.parametrize("snippet", [
    "torch.backends.cuda.matmul.allow_tf32 = True",
    "torch.backends.cudnn.allow_tf32 = True",
    "torch.set_float32_matmul_precision('high')",
    "torch.set_float32_matmul_precision('medium')",
])
def test_tf32_on_bad(snippet):
    text = f"import torch\n\ndef f():\n    {snippet}\n"
    for path in ("tests/test_torch_x.py", "src/repro_torch/x.py", "chip_smoke.py"):
        assert lines_of(run(text, path=path, rule="TF32-ON"), "TF32-ON") == [4]


@pytest.mark.parametrize("snippet", [
    "torch.backends.cuda.matmul.allow_tf32 = False",
    "torch.set_float32_matmul_precision('highest')",
    "assert torch.backends.cuda.matmul.allow_tf32 is False",
])
def test_tf32_good(snippet):
    text = f"import torch\n\ndef f():\n    {snippet}\n"
    assert run(text, path="tests/test_torch_x.py", rule="TF32-ON") == []


# -- the copied parts give the reference's findings ----------------------------

COPIED_CASES = [
    # DTYPE-PLANE-CONTRACT: no docstring, wrong shape, right shape, out of scope
    ("def ravel(flat):\n    return flat\n", "src/repro_torch/core/flat.py"),
    ('def drain(ring, w_stack):\n    """ring (N, K) and w_stack (D, N, N)."""\n    return ring\n',
     "src/repro_torch/kernels/gossip/ops.py"),
    ('def push(buffer):\n    """buffer (D, N, Dflat): the ring."""\n    return buffer\n',
     "src/repro_torch/events/engine.py"),
    ("def ravel(flat):\n    return flat\n", "src/repro_torch/api/simulate.py"),
    # MARKER-DISCIPLINE
    ("def test_a():\n    pass\n", "tests/test_torch_foo_parity.py"),
    ("import pytest\npytestmark = pytest.mark.slow\n\ndef test_a():\n    pass\n",
     "tests/test_torch_foo_mesh.py"),
    ("from hypothesis import given\n\n@given(1)\ndef test_a(x):\n    pass\n",
     "tests/test_torch_foo.py"),
    ("def test_a():\n    pass\n", "tests/test_torch_foo.py"),
    # the engine: suppressions with and without a reason, a parse error
    ("def ravel(flat):  # repro-lint: disable=DTYPE-PLANE-CONTRACT(fixture)\n    return flat\n",
     "src/repro_torch/core/flat.py"),
    ("def ravel(flat):  # repro-lint: disable=DTYPE-PLANE-CONTRACT\n    return flat\n",
     "src/repro_torch/core/flat.py"),
    ("# repro-lint: disable-file=MARKER-DISCIPLINE(fixture)\ndef test_a():\n    pass\n",
     "tests/test_torch_foo_system.py"),
    ("def broken(:\n    pass\n", "src/repro_torch/core/flat.py"),
]


@pytest.mark.parametrize("text,path", COPIED_CASES)
def test_copied_rules_match_the_reference(text, path):
    shared = ("DTYPE-PLANE-CONTRACT", "MARKER-DISCIPLINE")
    mine = analyze_file(path, rules=[tanalysis.RULES[r] for r in shared], text=text)
    ref = janalyze_file(path, rules=[janalysis.RULES[r] for r in shared], text=text)
    assert [f.to_json() for f in mine] == [f.to_json() for f in ref]


def test_suppression_without_reason_does_not_silence():
    findings = run(HOT.format(
        line="n = x.sum().item()  # repro-lint: disable=HOST-SYNC-IN-HOT-PATH",
        helper="pass"))
    assert lines_of(findings, SUPPRESS_NO_REASON) == [5]
    assert lines_of(findings, "HOST-SYNC-IN-HOT-PATH") == [5]


def test_json_report_matches_the_reference_shape():
    findings = run(HOT.format(line="n = x.tolist()", helper="pass"),
                   rule="HOST-SYNC-IN-HOT-PATH")
    mine = json.loads(tanalysis.report_json(findings, files_scanned=1))
    ref = json.loads(janalysis.report_json([], files_scanned=1))
    assert set(mine) == set(ref)
    assert mine["counts"] == {"HOST-SYNC-IN-HOT-PATH": 1}
    assert mine["rules"] == sorted(PORT_RULES)


# -- the port's tree ------------------------------------------------------------

def test_port_tree_is_clean():
    """The port, the tests and chip_smoke.py stay clean (the CI gate)."""
    findings, files = tanalysis.analyze_paths(
        [os.path.join(ROOT, "src", "repro_torch"), os.path.join(ROOT, "tests"),
         os.path.join(ROOT, "chip_smoke.py")])
    assert files > 100
    assert [f.format() for f in findings] == []


def test_cli_strict_runs_without_torch_or_jax():
    """``python -m repro_torch.analysis ... --strict`` exits 0, and the
    analyzer's own modules import neither torch nor jax (the package's
    ``__init__`` imports torch, so the modules are loaded by path)."""
    code = textwrap.dedent(f"""\
        import importlib.util, sys, types
        pkg = types.ModuleType("repro_torch"); pkg.__path__ = [{os.path.join(ROOT, "src", "repro_torch")!r}]
        sys.modules["repro_torch"] = pkg
        from repro_torch.analysis.__main__ import main
        rc = main(["src/repro_torch", "tests", "chip_smoke.py", "--strict"])
        bad = sorted(m for m in sys.modules if m.split(".")[0] in ("torch", "jax"))
        assert not bad, bad
        sys.exit(rc)
        """)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=240)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1].startswith("OK: ")
