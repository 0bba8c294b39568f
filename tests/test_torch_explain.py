"""The port's ``explain`` against the JAX package's, on the CPU.

Stored runs are made as each package's tests make them: a valid search
with its ``searchstats.json``, an invalid history, an unknown one (a
pinned tiny rung truncates live configurations: lossy truncation at
named levels), a suite's composed result (the linear checker under
``"linear"``), a run whose process died, and torn ones (``searchstats``
cut mid-write, ``results.json`` gone, ``history.jsonl`` torn). Each is
written once by the port (its device search on the kernels' plain
versions) and once by the reference (its device search on JAX's CPU).
On every directory ``explain_report`` of both packages is equal, key for
key apart from ``run-dir``, and so is ``render_text``. ``python -m
jepsen_tpu_torch explain`` prints the ``# explain:`` lines or the JSON
report and answers 0 / 1 / 254 as the reference's command does, reading
the latest run under ``--store-root`` by default.
"""

import json
import os

import pytest
import torch

from jepsen_tpu import explain as jx
from jepsen_tpu import store as js
from jepsen_tpu import testing as jtest
from jepsen_tpu.checker import tpu as JT
from jepsen_tpu.history import History as JHistory
from jepsen_tpu.history import Op as JOp
from jepsen_tpu.models import CASRegister as JCASRegister
from jepsen_tpu.obs import searchstats as j_searchstats

from jepsen_tpu_torch import explain as px
from jepsen_tpu_torch import obs, store, testing
from jepsen_tpu_torch.__main__ import main as port_main
from jepsen_tpu_torch.checker import gpu as G
from jepsen_tpu_torch.history import History, Op
from jepsen_tpu_torch.models import CASRegister
from jepsen_tpu_torch.obs import searchstats as p_searchstats

# one intra-op thread: the tier-1 run puts six workers on eight cores
torch.set_num_threads(1)

TS = "20260805T120000.000"
INVALID_ROWS = [(0, "invoke", "write", 1), (0, "ok", "write", 1),
                (1, "invoke", "read", None), (1, "ok", "read", 2)]
#: the lost update of the toctou suite, as its run records it
TOCTOU_ROWS = [(0, "invoke", "write", 0), (0, "ok", "write", 0),
               (1, "invoke", "cas", (0, 2)), (0, "invoke", "cas", (0, 1)),
               (1, "ok", "cas", (0, 2)), (0, "ok", "cas", (0, 1)),
               (2, "invoke", "read", None), (2, "ok", "read", 1)]


def rows_history(rows, pkg):
    H, O = (History, Op) if pkg == "port" else (JHistory, JOp)
    return H([O(type=t, f=f, value=v, process=p, time=i * 1000, index=i)
              for i, (p, t, f, v) in enumerate(rows)])


def sim(pkg, n=40, seed=2, procs=3, overlap=0.6):
    mod = testing if pkg == "port" else jtest
    return mod.simulate_register_history(n, n_procs=procs, seed=seed,
                                         overlap_p=overlap)


def check(pkg, h, **kw):
    if pkg == "port":
        return G.check_history_gpu(h, CASRegister(), device="cpu", **kw)
    return JT.check_history_tpu(h, JCASRegister(), **kw)


def run_dir(root, pkg, name, history, results, state="done"):
    """A stored run, as ``core.run`` leaves one."""
    st = store if pkg == "port" else js
    d = os.path.join(str(root), pkg, name, TS)
    os.makedirs(d, exist_ok=True)
    st.write_history(d, history)
    if results is not None:
        st.write_results(d, results)
    st.write_state(d, state)
    return d


def stats_run(root, pkg, name, history, monkeypatch, **kw):
    """A run whose check wrote ``searchstats.json`` into its directory."""
    monkeypatch.setenv("JTPU_TRACE", "1")
    d = run_dir(root, pkg, name, history, None)
    if pkg == "port":
        monkeypatch.setattr(p_searchstats, "WRITE_INTERVAL_S", 0.0)
        obs.start_run(d)
        try:
            out = check(pkg, history, **kw)
        finally:
            obs.finish_run()
    else:
        monkeypatch.setattr(j_searchstats, "WRITE_INTERVAL_S", 0.0)
        j_searchstats.attach(d)
        try:
            out = check(pkg, history, **kw)
        finally:
            j_searchstats.detach()
    (store if pkg == "port" else js).write_results(d, out)
    return d, out


def make(kind, root, pkg, monkeypatch):
    if kind == "valid":
        d, out = stats_run(root, pkg, "reg-valid", sim(pkg), monkeypatch)
        assert out["valid"] is True
        return d
    if kind == "invalid":
        h = rows_history(INVALID_ROWS, pkg)
        out = check(pkg, h)
        assert out["valid"] is False
        return run_dir(root, pkg, "reg-invalid", h, out)
    if kind == "unknown":
        d, out = stats_run(root, pkg, "reg-unknown",
                           sim(pkg, 60, seed=7, procs=6, overlap=0.98),
                           monkeypatch, capacity=2, window=16, expand=2)
        assert out["valid"] == "unknown" and out["capacity-overflow"]
        return d
    if kind == "composed":
        h = rows_history(TOCTOU_ROWS, pkg)
        lin = check(pkg, h)
        assert lin["valid"] is False
        return run_dir(root, pkg, "sqlite-register-toctou", h, {
            "valid": False, "perf": {"valid": True}, "linear": lin})
    if kind == "dead":
        h = rows_history(INVALID_ROWS[:3], pkg)
        d = run_dir(root, pkg, "reg-dead", h, None, state="running")
        st = store if pkg == "port" else js
        st.write_state(d, "running", pid=2 ** 22 + 12345)
        return d
    d = make("valid", root, pkg, monkeypatch)
    if kind == "torn-searchstats":
        with open(os.path.join(d, "searchstats.json"), "w") as f:
            f.write('{"ts": 1, "levels": [[3,')
        os.unlink(os.path.join(d, "results.json"))
    elif kind == "torn-history":
        out = check(pkg, rows_history(INVALID_ROWS, pkg))
        (store if pkg == "port" else js).write_results(d, out)
        with open(os.path.join(d, "history.jsonl"), "w") as f:
            f.write('{"type": "invoke", "f": "wri')
    return d


KINDS = ("valid", "invalid", "unknown", "composed", "dead",
         "torn-searchstats", "torn-history")


def reports(d):
    ours, theirs = px.explain_report(d), jx.explain_report(d)
    for r in (ours, theirs):
        assert r.pop("run-dir") == os.path.abspath(d)
    assert ours == theirs
    ours["run-dir"] = theirs["run-dir"] = os.path.abspath(d)
    assert px.render_text(ours) == jx.render_text(theirs)
    return ours


@pytest.mark.parametrize("pkg", ["port", "ref"])
@pytest.mark.parametrize("kind", KINDS)
def test_both_packages_explain_a_run_alike(tmp_path, monkeypatch, kind,
                                           pkg):
    rep = reports(make(kind, tmp_path, pkg, monkeypatch))
    want = {"valid": "valid", "invalid": "invalid", "unknown": "unknown",
            "composed": "invalid", "dead": "unknown",
            "torn-searchstats": "unknown", "torn-history": "invalid"}[kind]
    assert rep["kind"] == want
    text = px.render_text(rep)
    assert text.startswith("# explain:")
    if kind == "valid":
        assert rep["searchstats"]["levels"] > 0 and rep["frontier-series"]
        assert "search shape" in text and "frontier/level" in text
    elif kind in ("invalid", "composed"):
        assert rep["counterexample"]["violating-level"] is not None
        assert "non-linearizable" in text
    elif kind == "unknown":
        causes = {c["cause"]: c for c in rep["cause-chain"]}
        assert causes["lossy-truncation"]["levels"]
        assert "cause: lossy-truncation" in text
    elif kind == "dead":
        assert rep["status"] == "dead"
        assert [c["cause"] for c in rep["cause-chain"]] == ["run-died"]
    elif kind == "torn-searchstats":
        assert [c["cause"] for c in rep["cause-chain"]] == ["no-verdict"]
    else:
        # the torn line is skipped: no op is left to pack
        assert rep["counterexample"]["n-required"] == 0


def test_the_command_line(tmp_path, monkeypatch, capsys):
    valid = make("valid", tmp_path, "port", monkeypatch)
    invalid = make("invalid", tmp_path, "ref", monkeypatch)
    assert port_main(["explain", "--store", valid]) == 0
    out = capsys.readouterr().out
    assert out.strip() == px.render_text(px.explain_report(valid))
    assert port_main(["explain", "--store", invalid,
                      "--format", "json"]) == 1
    assert json.loads(capsys.readouterr().out)["kind"] == "invalid"
    assert port_main(["explain", "--store",
                      str(tmp_path / "no-such-dir")]) == 254
    # the latest run under --store-root by default
    store.update_symlinks({"name": "reg-invalid", "store-dir": invalid,
                           "store-root": str(tmp_path / "ref")})
    assert port_main(["explain", "--store-root",
                      str(tmp_path / "ref")]) == 1
    assert "reg-invalid/" + TS in capsys.readouterr().out
    assert port_main(["explain", "--store-root",
                      str(tmp_path / "empty")]) == 254
    assert port_main(["explain", "--store", valid, "--model",
                      "no-such-model"]) == 254
