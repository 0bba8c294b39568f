"""The search's telemetry on the CPU, against the reference's.

* The supervised result's ``searchstats`` is the reference's rollup
  (``levels``, ``expanded-total``, ``dup-kills``, ``dominance-kills``,
  ``trunc-losses``, ``frontier-area``, ``frontier-peak``, ``dup-rate``,
  ``prune-efficiency``), not the raw column sums.
* On seeded register (300 and 2,000 ops), mutex and set histories the
  port with ``device="cpu"`` and the reference on JAX CPU, both in
  segments of 64 levels, give equal ``searchstats``, ``segment-levels``,
  ``segments`` and ``frontier-hwm``, the same ``device-s`` keys, the same
  ``cost`` kinds, rungs and levels, equal ``searchstats.json`` rows and
  equal ``(level, frontier)`` sequences in ``progress.json``.
* With ``JTPU_TRACE=0`` there is no ``searchstats`` or ``cost``, the
  other telemetry stays, the checkpoints have 13 carry slots and round-trip with
  the reference's, and the verdict fields are unchanged; K4's plain
  version given no stats buffer writes everything else as with one.
* The keyed result carries a top-level ``cost``, one ``batch`` entry per
  cohort, as the reference's does.

Tolerance: none (integer counters, equal fields).
"""

import json
import os

import numpy as np
import pytest
import torch

from jepsen_tpu import resilience as JR
from jepsen_tpu import testing as jt
from jepsen_tpu.checker import tpu as JT
from jepsen_tpu.history import History as JHistory
from jepsen_tpu.models import core as J
from jepsen_tpu.obs import observatory as j_observatory
from jepsen_tpu.obs import searchstats as j_searchstats
from jepsen_tpu.ops.encode import pack_with_init as j_pack

from jepsen_tpu_torch import obs
from jepsen_tpu_torch import resilience as R
from jepsen_tpu_torch import testing as pt
from jepsen_tpu_torch.checker import gpu as G
from jepsen_tpu_torch.history import History
from jepsen_tpu_torch.kernels import parity
from jepsen_tpu_torch.kernels import search as K
from jepsen_tpu_torch.models import core as P
from jepsen_tpu_torch.obs import observatory as p_observatory
from jepsen_tpu_torch.ops.encode import pack_with_init

torch.set_num_threads(1)

SEG = 64

#: name: (the port's history, its model, the reference's model); the
#: reference checks the same ops through its own History
CASES = {
    "register-300": (lambda: pt.simulate_register_history(
        300, n_procs=5, n_vals=8, seed=3, crash_p=0.02),
        P.CASRegister, J.CASRegister),
    "register-2000": (lambda: pt.simulate_register_history(
        2000, n_procs=5, n_vals=16, seed=11, crash_p=0.002),
        P.CASRegister, J.CASRegister),
    "mutex": (lambda: pt.simulate_mutex_history(
        400, n_procs=4, seed=5, crash_p=0.01), P.Mutex, J.Mutex),
    "set": (lambda: pt.simulate_set_history(
        300, n_procs=4, seed=7, crash_p=0.01, lost_p=0.0),
        P.SetModel, J.SetModel),
}


def _both(name):
    make, pm, jm = CASES[name]
    h = make()
    p, k = pack_with_init(h, pm())
    jp, jk = j_pack(JHistory.of(o.to_dict() for o in h), jm())
    return p, k, jp, jk


def _runs(name, tmp_path, monkeypatch):
    """Both packages' supervised results over one history, each with a
    run directory attached (searchstats.json, progress.json), and each
    package's observatory snapshots in the order they were written."""
    p, k, jp, jk = _both(name)
    writes = {"port": [], "ref": []}
    for mod, tag in ((p_observatory, "port"), (j_observatory, "ref")):
        monkeypatch.setattr(mod, "WRITE_INTERVAL_S", 0.0)
        orig = mod.OBSERVATORY._write

        def spy(snap, force=False, orig=orig, tag=tag):
            writes[tag].append(dict(snap))
            orig(snap, force)
        monkeypatch.setattr(mod.OBSERVATORY, "_write", spy)
    monkeypatch.setattr(j_searchstats, "WRITE_INTERVAL_S", 0.0)
    dirs = {t: tmp_path / t for t in ("port", "ref")}
    for d in dirs.values():
        d.mkdir()
    obs.start_run(str(dirs["port"]))
    try:
        ours = R.supervised_check_packed(p, k, device="cpu",
                                         segment_iters=SEG)
    finally:
        obs.finish_run()
    j_observatory.attach(str(dirs["ref"]))
    j_searchstats.attach(str(dirs["ref"]))
    try:
        ref = JR.supervised_check_packed(jp, jk, segment_iters=SEG)
    finally:
        j_observatory.detach()
        j_searchstats.detach()
    return ours, ref, dirs, writes


def test_the_supervised_searchstats_is_the_references_rollup():
    p, k, jp, jk = _both("register-300")
    ours = R.supervised_check_packed(p, k, device="cpu", segment_iters=SEG)
    ref = JR.supervised_check_packed(jp, jk, segment_iters=SEG)
    assert ours["valid"] is ref["valid"] is True
    assert set(ours["searchstats"]) == set(ref["searchstats"]) == {
        "levels", "expanded-total", "dup-kills", "dominance-kills",
        "trunc-losses", "frontier-area", "frontier-peak", "dup-rate",
        "prune-efficiency"}
    assert ours["searchstats"] == ref["searchstats"]


@pytest.mark.parametrize("name", sorted(CASES))
def test_the_telemetry_equals_the_references(name, tmp_path, monkeypatch):
    ours, ref, dirs, writes = _runs(name, tmp_path, monkeypatch)
    for f in ("valid", "levels", "searchstats", "segment-levels",
              "segments", "frontier-hwm"):
        assert ours[f] == ref[f], f
    assert ours["device-s"].keys() == ref["device-s"].keys()
    assert ours["transfer-bytes"] > 0
    keys = ("kind", "rung", "levels")
    assert ([{f: e[f] for f in keys} for e in ours["cost"]]
            == [{f: e[f] for f in keys} for e in ref["cost"]])
    assert all(e["unroll"] == 2 and e["flops"] > 0
               and e["bytes-accessed"] > 0 for e in ours["cost"])
    # searchstats.json: the same per-level rows, rung and summary
    docs = [json.loads((dirs[t] / "searchstats.json").read_text())
            for t in ("port", "ref")]
    for f in ("cols", "rung", "levels", "summary"):
        assert docs[0][f] == docs[1][f], f
    # progress.json: the same (level, frontier) sequence, and its end
    seq = {t: [(w["level"], w["frontier-rows"]) for w in writes[t]
               if w.get("state") == "searching"] for t in writes}
    assert seq["port"] == seq["ref"] and seq["port"]
    ends = [json.loads((dirs[t] / "progress.json").read_text())
            for t in ("port", "ref")]
    assert ends[0]["state"] == ends[1]["state"] == "done"
    assert ends[0]["level"] == ends[1]["level"]
    # the port's run directory holds its other artifacts too
    assert (dirs["port"] / "trace.jsonl").exists()
    assert (dirs["port"] / "metrics.json").exists()


def test_tracing_off_drops_the_stats_lane(tmp_path, monkeypatch):
    monkeypatch.setenv("JTPU_TRACE", "0")
    p, k, jp, jk = _both("register-300")
    ours_cp, ref_cp = [], []
    obs.start_run(str(tmp_path))
    try:
        ours = R.supervised_check_packed(p, k, device="cpu",
                                         segment_iters=SEG,
                                         on_checkpoint=ours_cp.append)
    finally:
        obs.finish_run()
    ref = JR.supervised_check_packed(jp, jk, segment_iters=SEG,
                                     on_checkpoint=ref_cp.append)
    for key in ("searchstats", "cost"):
        assert key not in ours and key not in ref
    for key in ("segment-levels", "frontier-hwm"):
        assert ours[key] == ref[key]
    assert ours["device-s"].keys() == ref["device-s"].keys()
    assert os.listdir(tmp_path) == []
    for f in ("valid", "levels", "segments", "rung"):
        assert ours[f] == ref[f]
    assert len(ours_cp) == len(ref_cp) > 1
    for a, b in zip(ours_cp, ref_cp):
        assert len(a.carry) == len(b.carry) == 13
    a, b = ours_cp[-1], ref_cp[-1]
    a.save(str(tmp_path / "port.npz"))
    b.save(str(tmp_path / "ref.npz"))
    back = JR.Checkpoint.load(str(tmp_path / "port.npz"))
    ours_back = R.Checkpoint.load(str(tmp_path / "ref.npz"))
    for x, y, z in zip(a.carry, back.carry, ours_back.carry):
        assert np.array_equal(np.asarray(x), np.asarray(y))
        assert np.array_equal(np.asarray(x), np.asarray(z))
        assert np.asarray(x).dtype == np.asarray(z).dtype
    # a 13-slot checkpoint resumes to the uninterrupted verdict
    res = R.supervised_check_packed(p, k, device="cpu", segment_iters=SEG,
                                    resume=ours_cp[0])
    assert (res["valid"], res["levels"]) == (ours["valid"], ours["levels"])


def test_tracing_off_keeps_every_verdict_field(monkeypatch):
    p, k, _, _ = _both("mutex")
    on = R.supervised_check_packed(p, k, device="cpu", segment_iters=SEG)
    monkeypatch.setenv("JTPU_TRACE", "0")
    off = R.supervised_check_packed(p, k, device="cpu", segment_iters=SEG)
    for key in ("searchstats", "cost"):
        on.pop(key)
    # the host-timed seconds differ from run to run; their keys do not
    assert on.pop("device-s").keys() == off.pop("device-s").keys()
    # without the stats lane less comes up and down
    assert off.pop("transfer-bytes") < on.pop("transfer-bytes")
    assert on == off


def test_k4_without_a_stats_buffer_writes_everything_else():
    h = jt.simulate_register_history(200, n_procs=5, n_vals=8, seed=4,
                                     crash_p=0.03)
    p, kernel = pack_with_init(History.of(o.to_dict() for o in h),
                               P.CASRegister())
    cols = G._split_packed(p, G._bucket(p.n_required),
                           G._crash_width(p.n - p.n_required), kernel)
    lv = parity.Level(cols, (32, 32, 4), "cpu")
    for _ in range(6):
        G.search_level(lv.cols, lv.carry, lv.scratch, lv.shape, lv.nr,
                       G.PLAIN)
    on = lv.dedup_inputs()
    off = parity.copy_state(*on)
    off[0].stats = None
    for c, s in (on, off):
        lv.dedup_call(K.dedup_truncate)(c, s)
    outs = [list(s.pool_next.tensors()) + [c.pk, c.ps, c.pa, c.scal, s.acc]
            for c, s in (on, off)]
    assert parity.max_abs_err(*outs) == 0
    assert int(on[0].stats.abs().sum()) > 0
    # the stats-off view of a level walks with no counter rows at all
    off_lv = lv.without_stats()
    assert off_lv.carry.stats is None
    for name, _, _, _, err in off_lv.walk():
        assert err == 0, name


def test_the_keyed_result_carries_a_top_level_cost():
    hs = {k: jt.simulate_register_history(60, n_procs=4, n_vals=6,
                                          seed=k, crash_p=0.02)
          for k in range(4)}
    ref = JT.check_keyed_tpu(hs, J.CASRegister())
    ours = G.check_keyed_gpu(
        {k: History.of(o.to_dict() for o in h) for k, h in hs.items()},
        P.CASRegister(), device="cpu")
    assert ours["valid"] is ref["valid"]
    keys = ("kind", "rung", "levels", "keys", "crash_width")
    assert ([{f: e[f] for f in keys} for e in ours["cost"]]
            == [{f: e[f] for f in keys} for e in ref["cost"]])
    assert all(e["kind"] == "batch" and e["flops"] > 0
               for e in ours["cost"])
    assert all("cost" not in r for r in ours["results"].values())
