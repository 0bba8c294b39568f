"""The port's op WAL and store against the JAX package's, on the CPU.

The WAL's records are byte for byte the reference's (``encode_record``
and a ``Journal``'s file), and a WAL with a corrupt record and a torn
tail reads back to the same history and stats in both packages
(``read_wal``), as do its dangling invokes (``reconcile``). A run stored
by either package loads with the other's ``store.load``: the same
``history.jsonl`` ops and ``results.json``; ``run.state`` reads the same
(``run_status``, ``dead_runs``). The port's ``recover_run`` orders the
recovered history by op time (a run's history is stored in time order by
the port's ``core``): it is the reference's ``read_wal`` and
``reconcile``, ordered by time.
"""

import os
import random
import subprocess
import sys

import pytest
import torch

from jepsen_tpu import journal as jj
from jepsen_tpu import store as js
from jepsen_tpu.history import History as JHistory

from jepsen_tpu_torch import journal as pj
from jepsen_tpu_torch import store as ps
from jepsen_tpu_torch.history import History, Op
from jepsen_tpu_torch.testing import simulate_register_history

# one intra-op thread: the tier-1 run puts six workers on eight cores
torch.set_num_threads(1)


def ops_fixture():
    """A register history with crashed ops, plus the shapes a run records
    besides: nemesis infos with map values, cas pairs, sets, errors and
    open keys, and two dangling invokes at the end."""
    h = simulate_register_history(60, n_procs=4, n_vals=5, seed=3,
                                  crash_p=0.1)
    extra = [
        Op(type="info", f="start", value={"kv1": ["paused", "kvnode"]},
           process="nemesis", time=10**9),
        Op(type="invoke", f="cas", value=(1, 2), process=7, time=10**9 + 1),
        Op(type="info", f="cas", value=(1, 2), process=7, time=10**9 + 2,
           error="ConnectionRefusedError"),
        Op(type="ok", f="read", value=frozenset({3, 1}), process=8,
           time=10**9 + 3, extra={"node": "kv2"}),
        Op(type="invoke", f="write", value=4, process=9, time=10**9 + 4),
        Op(type="invoke", f="read", value=None, process=10, time=10**9 + 3),
    ]
    out = History(list(h) + extra)
    return out


def dicts(h):
    return [o.to_dict() for o in h]


def test_records_are_the_references_bytes():
    from jepsen_tpu.history import Op as JOp
    for o in ops_fixture():
        assert pj.encode_record(o) == jj.encode_record(
            JOp.from_dict(o.to_dict()))


@pytest.mark.parametrize("sync", ["op", "batch", "off"])
def test_journal_files_are_equal(tmp_path, sync):
    from jepsen_tpu.history import Op as JOp
    mine = pj.Journal(str(tmp_path / "port.wal"), sync=sync)
    theirs = jj.Journal(str(tmp_path / "ref.wal"), sync=sync)
    for o in ops_fixture():
        mine.append(o)
        theirs.append(JOp.from_dict(o.to_dict()))
    mine.close()
    theirs.close()
    assert mine.records == theirs.records == len(ops_fixture())
    assert (tmp_path / "port.wal").read_bytes() == \
        (tmp_path / "ref.wal").read_bytes()


@pytest.mark.parametrize("damage", ["clean", "torn", "corrupt", "both"])
def test_read_wal_and_reconcile_agree(tmp_path, damage):
    body = b"".join(pj.encode_record(o) for o in ops_fixture())
    lines = body.split(b"\n")
    if damage in ("corrupt", "both"):
        lines[5] = b"deadbeef " + lines[5][9:]       # a CRC mismatch
        lines[9] = b"not a record"
    body = b"\n".join(lines)
    if damage in ("torn", "both"):
        body += pj.encode_record(ops_fixture()[0])[:17]   # cut mid-write
    path = tmp_path / "history.wal"
    path.write_bytes(body)
    got, gstats = pj.read_wal(str(path))
    want, wstats = jj.read_wal(str(path))
    assert gstats == wstats
    assert dicts(got) == dicts(want)
    assert gstats["torn"] == (damage in ("torn", "both"))
    assert gstats["corrupt"] == (2 if damage in ("corrupt", "both") else 0)
    rg, ng = pj.reconcile(got)
    rw, nw = jj.reconcile(want)
    assert ng == nw == 2 and dicts(rg) == dicts(rw)


def test_recover_run_is_the_references_read_in_time_order(tmp_path):
    d = tmp_path / "run"
    d.mkdir()
    ops = list(ops_fixture())
    random.Random(1).shuffle(ops)   # append order is not time order
    (d / "history.wal").write_bytes(b"".join(pj.encode_record(o)
                                             for o in ops))
    rec = ps.recover_run(str(d))
    want, _ = jj.read_wal(str(d / "history.wal"))
    want, n = jj.reconcile(want)
    want = JHistory(sorted(want, key=lambda o: o.time)).index()
    assert dicts(rec["history"]) == dicts(want)
    assert rec["stats"]["reconciled"] == n >= 2
    assert ps.read_state(str(d))["recovered"] is True
    # the reference loads what the port recovered
    assert dicts(js.load(str(d))["history"]) == dicts(want)


def _save(store_ns, history_ns, root, name, results):
    test = {"name": name, "store-root": str(root), "nodes": ["n1", "n2"],
            "concurrency": 2,
            "history": history_ns.History.of(dicts(ops_fixture())).index(),
            "results": results}
    store_ns.prepare_dir(test)
    store_ns.save_1(test)
    store_ns.save_2(test)
    return test["store-dir"]


RESULTS = {"valid": False, "linear": {"valid": False, "levels": 12,
                                      "rung": (32, 32, 4),
                                      "final-states": [1, 2]},
           "perf": {"valid": True}}


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_a_stored_run_loads_in_the_other_package(tmp_path, writer):
    import jepsen_tpu.history as jh
    import jepsen_tpu_torch.history as ph
    if writer == "port":
        d = _save(ps, ph, tmp_path, "w", RESULTS)
    else:
        d = _save(js, jh, tmp_path, "w", RESULTS)
    mine, theirs = ps.load(d), js.load(d)
    assert dicts(mine["history"]) == dicts(theirs["history"])
    assert len(mine["history"]) == len(ops_fixture())
    assert mine["results"] == theirs["results"]
    assert mine["results"]["linear"]["rung"] == [32, 32, 4]
    assert {k: v for k, v in mine.items() if k not in ("history",)} == \
        {k: v for k, v in theirs.items() if k not in ("history",)}
    for name in ("history.txt", "history.jsonl", "results.json",
                 "test.json"):
        assert os.path.exists(os.path.join(d, name))
    assert ps.latest(str(tmp_path))["store-dir"] == \
        js.latest(str(tmp_path))["store-dir"]


def test_store_files_are_the_references_bytes(tmp_path):
    import jepsen_tpu.history as jh
    import jepsen_tpu_torch.history as ph
    a = _save(ps, ph, tmp_path / "a", "w", RESULTS)
    b = _save(js, jh, tmp_path / "b", "w", RESULTS)
    for name in ("history.txt", "history.jsonl", "results.json"):
        with open(os.path.join(a, name), "rb") as fa, \
                open(os.path.join(b, name), "rb") as fb:
            assert fa.read() == fb.read(), name


def _dead_pid() -> int:
    p = subprocess.Popen([sys.executable, "-c", "pass"])
    p.wait(timeout=60)
    return p.pid


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_run_status_and_dead_runs_agree(tmp_path, writer):
    import json
    ns = ps if writer == "port" else js
    dead = _dead_pid()
    root = tmp_path / "store"
    states = {"live": ("running", {}), "dead": ("running", {}),
              "dead-analyzing": ("analyzing", {}), "done": ("done", {}),
              "recovered": ("done", {"recovered": True}), "none": None}
    for name, st in states.items():
        d = root / name / "20260101T000000.000"
        d.mkdir(parents=True)
        if st is None:
            continue
        ns.write_state(str(d), st[0], **st[1])
        if name.startswith("dead"):
            doc = json.loads((d / "run.state").read_text())
            doc["pid"] = dead
            (d / "run.state").write_text(json.dumps(doc))
    for name in states:
        d = str(root / name / "20260101T000000.000")
        assert ps.run_status(d) == js.run_status(d), name
    assert ps.dead_runs(str(root)) == js.dead_runs(str(root))
    assert [os.path.basename(os.path.dirname(d))
            for d in ps.dead_runs(str(root))] == ["dead", "dead-analyzing"]
