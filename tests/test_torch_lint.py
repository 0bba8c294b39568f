"""The port's static analysis against the reference's, on the CPU.

On every lint fixture (``tests/fixtures/lint``) the port's suite,
lockset, deadlock, crash-consistency (walcheck) and history passes give
the reference's findings, rule, file, line, anchor, severity, column and
message each, and its width pass gives the reference's width findings on
the JAX fixtures. ``lint --format json|sarif`` prints the reference's
document for the same findings; a baseline round-trips through
``--write-baseline`` and ``--prune-stale``; the suite registry check
resolves all of the port's ``SUITES`` rows; and the port's own code is
clean against its baseline, through ``python -m jepsen_tpu_torch lint``
and ``tools/torch_lint_gate.py``.
"""

import io
import json
import os
import subprocess
import sys
from contextlib import redirect_stderr, redirect_stdout

import pytest
import torch

from jepsen_tpu import analysis as j_analysis
from jepsen_tpu import cli as j_cli
from jepsen_tpu import suites as j_suites
from jepsen_tpu.analysis import jax_lint as j_jax_lint

from jepsen_tpu_torch import analysis, suites
from jepsen_tpu_torch.__main__ import main
from jepsen_tpu_torch.analysis import baseline as bl
from jepsen_tpu_torch.analysis import sarif, suite_lint, width_lint

# one intra-op thread: the tier-1 run puts six workers on eight cores
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIX = os.path.join(ROOT, "tests", "fixtures", "lint")
FIXTURES = sorted(os.listdir(FIX))
CODE_PASSES = ("suite", "lockset", "deadlock", "walcheck")
#: the passes both packages name alike
SHARED = ("suite", "history", "lockset", "deadlock", "walcheck")
WIDTH_RULES = ("JAX-INT32-OVERFLOW", "JAX-SHIFT-WIDTH")


def rows(findings):
    return sorted((f.rule, f.path, f.line, f.anchor, f.severity, f.col,
                   f.message) for f in findings)


def port(argv):
    buf = io.StringIO()
    with redirect_stdout(buf), redirect_stderr(io.StringIO()):
        rc = main(argv)
    return rc, buf.getvalue()


def reference(argv):
    buf = io.StringIO()
    with redirect_stdout(buf), redirect_stderr(io.StringIO()):
        rc = j_cli.run(j_cli.default_commands(), argv)
    return rc, buf.getvalue()


# ---------------------------------------------------------------------------
# every pass against the reference on the fixtures
# ---------------------------------------------------------------------------

CASES = [(name, p) for name in FIXTURES for p in
         (("history",) if name.endswith(".jsonl") else CODE_PASSES)]


@pytest.mark.parametrize("name,pass_", CASES,
                         ids=[f"{n}-{p}" for n, p in CASES])
def test_each_pass_gives_the_references_findings(name, pass_):
    path = os.path.join(FIX, name)
    got = analysis.lint_files([path], passes=(pass_,), root=ROOT)
    ref = j_analysis.lint_files([path], passes=(pass_,), root=ROOT)
    assert rows(got) == rows(ref)
    if name.startswith("bad_") and name.split("_", 1)[1].split(".")[0] \
            .split("_")[0] in (pass_, "history"):
        assert got, f"{name} fires nothing under {pass_}"


def test_the_bad_fixtures_fire_every_pass():
    fired = {p for name in FIXTURES if name.startswith("bad_")
             for p in SHARED
             if analysis.lint_files([os.path.join(FIX, name)], passes=(p,),
                                    root=ROOT)}
    assert fired == set(SHARED)


@pytest.mark.parametrize("name", ["bad_jax.py", "good_jax.py"])
def test_the_width_pass_gives_the_references_width_findings(name):
    path = os.path.join(FIX, name)
    got = width_lint.lint_file(path, root=ROOT)
    ref = [f for f in j_jax_lint.lint_file(path, root=ROOT)
           if f.rule in WIDTH_RULES]
    assert rows(got) == rows(ref)
    assert bool(got) == name.startswith("bad_")
    assert {f.rule for f in got} <= set(WIDTH_RULES)
    assert analysis.lint_files([path], passes=("width",), root=ROOT) == got


def test_named_constants_fold_through_imports(tmp_path):
    """A width imported from another module of the repository folds, as
    in the reference; a local that shadows it does not."""
    pkg = tmp_path / "pkg"
    pkg.mkdir()
    (pkg / "__init__.py").write_text("")
    (pkg / "widths.py").write_text("BITS = 40\nBIG = 2 ** BITS\n")
    (pkg / "use.py").write_text(
        "import numpy as np\nfrom pkg.widths import BIG, BITS\n\n"
        "def f(x):\n    return (x << BITS), np.int32(BIG)\n\n"
        "def g(x, BITS=3):\n    return x << BITS\n")
    path = str(pkg / "use.py")
    got = width_lint.lint_file(path, root=str(tmp_path))
    ref = [f for f in j_jax_lint.lint_file(path, root=str(tmp_path))
           if f.rule in WIDTH_RULES]
    assert rows(got) == rows(ref)
    assert sorted(f.rule for f in got) == sorted(WIDTH_RULES)
    assert all(f.anchor.startswith("f/") for f in got)


# ---------------------------------------------------------------------------
# reports and the baseline
# ---------------------------------------------------------------------------

def _shared_argv(*extra):
    argv = ["lint", "--no-baseline", "--root", ROOT]
    for p in SHARED:
        argv += ["--pass", p]
    return argv + [os.path.join(FIX, n) for n in FIXTURES] + list(extra)


@pytest.mark.parametrize("fmt", ["text", "json", "sarif"])
def test_the_reports_are_the_references(fmt):
    argv = _shared_argv("--format", fmt)
    got, ref = port(argv), reference(argv)
    assert got == ref
    assert got[0] == 1
    if fmt == "sarif":
        doc = json.loads(got[1])
        assert doc["version"] == sarif.SARIF_VERSION
        results = doc["runs"][0]["results"]
        assert results and all(r["partialFingerprints"]["jtpuAnchor/v1"]
                               for r in results)
    if fmt == "json":
        doc = json.loads(got[1])
        assert doc["counts"] == analysis.summarize(
            analysis.lint_files([os.path.join(FIX, n) for n in FIXTURES],
                                passes=SHARED, root=ROOT))


def test_the_sarif_document_is_the_references_for_the_same_findings():
    from jepsen_tpu.analysis import sarif as j_sarif
    fs = analysis.lint_files([os.path.join(FIX, n) for n in FIXTURES],
                             passes=SHARED, root=ROOT)
    jfs = j_analysis.lint_files([os.path.join(FIX, n) for n in FIXTURES],
                                passes=SHARED, root=ROOT)
    assert sarif.render(fs) == j_sarif.render(jfs)


def test_a_baseline_round_trips(tmp_path):
    b = tmp_path / "b.baseline"
    target = os.path.join(FIX, "bad_lockset_class.py")
    other = os.path.join(FIX, "bad_deadlock.py")
    rc, out = port(["lint", "--baseline", str(b), "--write-baseline",
                    target, other])
    assert rc == 0 and "baseline written" in out
    assert bl.stubbed(bl.load(str(b)))
    rc, out = port(["lint", "--baseline", str(b), target, other])
    assert rc == 0 and "# lint: clean" in out and "accepted by" in out
    # a stub justification does not pass --strict
    assert port(["lint", "--baseline", str(b), "--strict", target,
                 other])[0] == 1
    b.write_text(b.read_text().replace(bl.STUB, "reviewed: a fixture"))
    assert port(["lint", "--baseline", str(b), "--strict", target,
                 other])[0] == 0
    # the deadlock fixture's entries go stale once it is not linted
    rc, out = port(["lint", "--baseline", str(b), "--prune-stale",
                    target])
    assert rc == 0 and "pruned from" in out
    kept = bl.load(str(b))
    assert kept and all("bad_deadlock" not in k for k in kept)
    assert set(kept.values()) == {"reviewed: a fixture"}
    rc, out = port(["lint", "--baseline", str(b), "--prune-stale",
                    target])
    assert "0 stale baseline entries pruned" in out
    assert port(["lint", "--baseline", str(b), target])[0] == 0


def test_a_missing_path_is_not_clean():
    rc, out = port(["lint", os.path.join(FIX, "no_such_fixture.py")])
    assert rc == 1 and "LINT-MISSING-FILE" in out


def test_plan_renders_sarif():
    rc, out = port(["plan", "--dims", "150,3,5", "--device", "cpu",
                    "--format", "sarif"])
    doc = json.loads(out)
    assert rc == 0 and doc["version"] == "2.1.0"
    rc, out = port(["plan", "--dims", "400,0,1000", "--device", "cpu",
                    "--format", "sarif"])
    results = json.loads(out)["runs"][0]["results"]
    assert {r["ruleId"] for r in results} == {"PLAN-WINDOW-UNBOUNDED"}
    assert all(r["locations"][0]["physicalLocation"]["artifactLocation"]
               ["uri"] == "<plan>" for r in results)


# ---------------------------------------------------------------------------
# the registry and the port's own code
# ---------------------------------------------------------------------------

def test_the_registry_check_resolves_every_row():
    files = analysis._expand(analysis.DEFAULT_SCOPES["suite"], ROOT)
    fs = suite_lint.lint_suites(files, root=ROOT)
    assert not [f for f in fs if f.rule.startswith("SUITE-REGISTRY")
                or f.rule == "SUITE-CTOR-ARITY"]
    assert len(suites.SUITES) == len(j_suites.SUITES) == 53
    assert set(suites.SUITES) == set(j_suites.SUITES)
    # a row that points nowhere is caught
    bad = dict(suites.SUITES, nowhere=("chronos", "no_such_test"),
               gone=("no_such_module", "x_test"))
    fs = suite_lint.lint_suites(files, root=ROOT, registry=bad)
    assert sorted(f.anchor for f in fs if f.rule == "SUITE-REGISTRY-MISSING") \
        == ["registry/gone", "registry/nowhere"]


def test_the_ports_code_is_clean_against_its_baseline():
    rc, out = port(["lint"])
    assert rc == 0, out
    assert "# lint: clean" in out
    assert port(["lint", "--strict"])[0] == 0
    # every accepted finding is live and justified
    live = {f.key() for f in analysis.lint_repo()}
    accepted = bl.load(bl.default_path())
    assert accepted and set(accepted) <= live
    assert not bl.stubbed(accepted)


def test_the_scopes_name_only_files_of_the_port():
    for scope, paths in analysis.DEFAULT_SCOPES.items():
        for p in paths:
            assert p.startswith("jepsen_tpu_torch/"), (scope, p)
            assert os.path.exists(os.path.join(ROOT, p)), (scope, p)


def test_the_lint_gate_is_clean():
    p = subprocess.run([sys.executable,
                        os.path.join(ROOT, "tools", "torch_lint_gate.py")],
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stdout + p.stderr
    assert "clean against the baseline" in p.stdout
