"""The plan gate of the port (``jepsen_tpu_torch.checker.plan``) on the CPU,
against ``jepsen_tpu.checker.plan`` on JAX's CPU.

* ``enumerate_candidates``: the same labels on a grid of dims (one key
  and keyed, with crashed ops, a wide window, an explicit rung).
* ``check_dims`` and ``check_candidate`` with no byte budget: the same
  rules on the four ``tests/fixtures/plan`` fixtures and on an int32
  grid. Compared as sets of (rule, severity): the port's level counter
  runs to the budget of the padded widths (``LevelShape.lmax``), so near
  2**30 required ops it adds one more PLAN-INT32-OVERFLOW message of a
  rule both packages already raise.
* ``gate_ladder`` and the supervised search's ``plan`` entry: the same
  ladder and entry, except ``predicted-bytes``, which is held to the
  port's own allocation instead (the summed ``nbytes`` of a fresh
  ``Engine.state`` and ``Engine.cols``). The keyed batch's ``plan``
  equals ``check_keyed_tpu``'s the same way. Under a byte budget that
  holds a keyed rung for one key only, the rung runs its keys in chunks
  (the reference prices and drops it at every key), and each key ends as
  with no budget.
* ``seed_rung`` and the supervised search under a pinned byte budget: the
  seeded pool fits, its double does not, and the seeded search equals an
  explicit one at that capacity; an explicit rung that cannot fit raises
  ``PlanRejectedError`` before ``Engine.state`` is called; with
  ``JTPU_PLAN_GATE=0`` the same results and no ``plan``.
* ``python -m jepsen_tpu_torch plan`` on the four fixtures: the
  reference's exit codes and rule ids.
* The headroom pre-shrink, ``headroom_ratio`` patched low in both
  packages: the same ``preemptive-halve-to-N`` trail and verdict.

Tolerance: none (integer sizes, equal result fields).
"""

import contextlib
import io
import json
import os
import re

import pytest
import torch

from jepsen_tpu import cli as JCLI
from jepsen_tpu import resilience as JR
from jepsen_tpu import testing as jt
from jepsen_tpu.analysis.plan_lint import \
    findings_from_report as j_findings_from_report
from jepsen_tpu.checker import plan as JP
from jepsen_tpu.checker import tpu as JT
from jepsen_tpu.models import CASRegister as JCASRegister
from jepsen_tpu.ops.encode import pack_with_init as j_pack

from jepsen_tpu_torch import resilience as R
from jepsen_tpu_torch import testing as T
from jepsen_tpu_torch.__main__ import main
from jepsen_tpu_torch.analysis.plan_lint import (PlanRejectedError,
                                                 findings_from_report)
from jepsen_tpu_torch.checker import engine as engine_mod
from jepsen_tpu_torch.checker import gpu as G
from jepsen_tpu_torch.checker import plan
from jepsen_tpu_torch.history import History
from jepsen_tpu_torch.kernels import cost as kcost
from jepsen_tpu_torch.models import CASRegister
from jepsen_tpu_torch.ops.encode import pack_with_init

# one intra-op thread: the tier-1 run puts six workers on eight cores
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIX = os.path.join(REPO, "tests", "fixtures", "plan")
FIXTURES = sorted(f for f in os.listdir(FIX) if f.endswith(".json"))
CPU = torch.device("cpu")
SEG = 64


@pytest.fixture(autouse=True)
def no_limit(monkeypatch):
    monkeypatch.delenv("JTPU_PLAN_BYTES_LIMIT", raising=False)
    monkeypatch.delenv("JTPU_PLAN_GATE", raising=False)
    monkeypatch.setattr(engine_mod, "_DEFAULT", engine_mod.Engine())


def _history(n=120, seed=6, crash_p=0.02):
    return jt.simulate_register_history(n, n_procs=5, n_vals=8, seed=seed,
                                        crash_p=crash_p)


def _both(h):
    """(port packed, its kernel, reference packed, its kernel)."""
    p, k = pack_with_init(History.of(o.to_dict() for o in h), CASRegister())
    jp, jk = j_pack(h, JCASRegister())
    return p, k, jp, jk


def _fixture(name):
    with open(os.path.join(FIX, name)) as fh:
        d = json.load(fh)
    kw = dict(n_required=d["n_required"], n_crashed=d.get("n_crashed", 0),
              window_needed=d.get("window_needed", 1),
              n_events=d.get("n_events"))
    rung = {k: d.get(k) for k in ("capacity", "window", "expand")}
    return kw, rung


def _no_bytes(entry):
    return {k: v for k, v in entry.items() if k != "predicted-bytes"}


def _allocated(shape, cols_np):
    """The summed nbytes of a fresh engine's state and columns."""
    eng = engine_mod.Engine()
    carry, scratch = eng.state(shape, CPU)
    cols = eng.cols(cols_np, CPU)
    ts = (list(carry.pool.tensors()) + [carry.pk, carry.ps, carry.pa,
                                        carry.scal, carry.stats]
          + list(scratch.pool_next.tensors())
          + [scratch.acc, scratch.rows, scratch.g, scratch.gagg]
          + ([scratch.rows_alt] if scratch.rows_alt is not None else [])
          + list(cols.values()))
    return sum(t.nbytes for t in ts)


@pytest.mark.parametrize("dims,rung", [
    (dict(n_required=150, n_crashed=3, window_needed=5), {}),
    (dict(n_required=3000, n_crashed=0, window_needed=12), {}),
    (dict(n_required=700, n_crashed=40, window_needed=9), {}),
    (dict(n_required=400, n_crashed=2, window_needed=60), {}),
    (dict(n_required=400, n_crashed=2, window_needed=100), {}),
    (dict(n_required=150, n_crashed=3, window_needed=5),
     dict(capacity=256, window=64, expand=16)),
    (dict(n_required=150, window_needed=5), dict(capacity=64)),
    (dict(n_required=500, n_crashed=0, window_needed=8, keys=16), {}),
    (dict(n_required=900, n_crashed=12, window_needed=70, keys=5), {}),
    (dict(n_required=500, window_needed=8, keys=16),
     dict(capacity=128, window=32, expand=8)),
    (dict(n_required=100, n_crashed=200, window_needed=4), {}),
])
def test_candidate_labels_equal_the_references(dims, rung):
    ours = plan.enumerate_candidates(plan.PlanDims(**dims), device="cpu",
                                     **rung)
    ref = JP.enumerate_candidates(JP.PlanDims(**dims), **rung)
    assert [c.label() for c in ours] == [c.label() for c in ref]
    assert [c.tiebreak for c in ours] == [c.tiebreak for c in ref]


def _rules(issues):
    return {(i.rule, i.severity) for i in issues}


def _dims_and_candidate_rules(mod, kw, rung, device_kw):
    dims = mod.PlanDims(**kw)
    out = {"dims": _rules(mod.check_dims(dims))}
    for c in mod.enumerate_candidates(dims, **rung, **device_kw):
        out[c.label()] = _rules(mod.check_candidate(c, dims, None))
    return out


@pytest.mark.parametrize("name", FIXTURES)
def test_rules_on_the_fixtures_equal_the_references(name):
    kw, rung = _fixture(name)
    ours = _dims_and_candidate_rules(plan, kw, rung, {"device": "cpu"})
    ref = _dims_and_candidate_rules(JP, kw, rung, {})
    assert ours == ref


@pytest.mark.parametrize("nr", [1, 1000, 2**29 - 100, 2**29 + 1,
                                2**30 - 100, 2**30, 1_200_000_000])
@pytest.mark.parametrize("n_crashed", [0, 3, 129])
@pytest.mark.parametrize("n_events", [None, 100, 2**31 - 1])
def test_int32_rules_equal_the_references(nr, n_crashed, n_events):
    kw = dict(n_required=nr, n_crashed=n_crashed, window_needed=4,
              n_events=n_events)
    assert _rules(plan.check_dims(plan.PlanDims(**kw))) == _rules(
        JP.check_dims(JP.PlanDims(**kw)))
    cand = dict(capacity=64, window=32, expand=8)
    assert _dims_and_candidate_rules(plan, kw, cand, {"device": "cpu"}) \
        == _dims_and_candidate_rules(JP, kw, cand, {})


@pytest.mark.parametrize("n,crash_p,seed", [(120, 0.02, 6), (80, 0.0, 3),
                                            (300, 0.05, 9)])
def test_gate_ladder_equals_the_references(n, crash_p, seed):
    p, k, jp, jk = _both(_history(n, seed, crash_p))
    wneed = G._window_needed(p)
    ladder, entry = plan.gate_ladder(
        p, k, G._ladder_for(wneed, CPU), kind="segment", explicit=False,
        derate=True, device="cpu")
    jladder, jentry = JP.gate_ladder(jp, jk, JT._ladder_for(wneed),
                                     kind="segment", explicit=False,
                                     derate=True)
    assert ladder == jladder
    assert _no_bytes(entry) == _no_bytes(jentry)
    cap, win, exp = ladder[0]
    shape = plan.Candidate("segment", cap, win, exp, G._bucket(p.n_required),
                           G._crash_width(p.n - p.n_required)).shape()
    cols = G._split_packed(p, shape.n, shape.CR, k)
    assert entry["predicted-bytes"] == _allocated(shape, cols)
    # and the supervised search carries the same entry
    ours = R.supervised_check_packed(p, k, device="cpu", segment_iters=SEG)
    ref = JR.supervised_check_packed(jp, jk, segment_iters=SEG)
    assert _no_bytes(ours["plan"]) == _no_bytes(ref["plan"])
    assert ours["plan"]["predicted-bytes"] == entry["predicted-bytes"]
    assert (ours["valid"], ours["levels"]) == (ref["valid"], ref["levels"])


@pytest.mark.parametrize("rung", [(32, 32, 4), (1024, 64, 64),
                                  (512, 128, 512)])
def test_the_footprint_is_the_engines_allocation(rung):
    """Every component, on shapes with and without K2's second rows
    buffer and crashed ops."""
    p, k, _, _ = _both(_history(300, 9, 0.05))
    cap, win, exp = rung
    cand = plan.Candidate("segment", cap, win, exp, G._bucket(p.n_required),
                          G._crash_width(p.n - p.n_required))
    cols = G._split_packed(p, cand.breq, cand.crw, k)
    fp = plan.footprint(cand)
    assert fp["total-bytes"] == _allocated(cand.shape(), cols) == (
        fp["cols-bytes"] + fp["carry-bytes"] + fp["scratch-bytes"])
    assert fp["total-bytes"] <= fp["allocated-bytes"] < fp["total-bytes"] \
        + 512 * 32
    assert plan.trace_candidate(cand, k) == {
        "ok": True, "error": None,
        "cost": kcost.per_level(cand.shape(k.name))}


def test_seed_rung_and_a_seeded_search(monkeypatch):
    p, k, _, _ = _both(_history())
    breq, crw = G._bucket(p.n_required), G._crash_width(p.n - p.n_required)

    def fp(cap, exp):
        return plan.footprint(plan.Candidate("segment", cap, 32, exp, breq,
                                             crw))["total-bytes"]

    limit = (fp(16, 2) + fp(32, 4)) // 2
    monkeypatch.setenv("JTPU_PLAN_BYTES_LIMIT", str(limit))
    cap, exp, pred, lim = plan.seed_rung(32, 32, 4, breq, crw, floor=8,
                                         device="cpu")
    assert (cap, exp, lim) == (16, 2, limit)
    assert pred == fp(16, 2) <= limit < fp(2 * cap, 2 * exp)
    # the floor stops the halving, fitting or not
    assert plan.seed_rung(32, 32, 4, breq, crw, floor=32,
                          device="cpu")[0] == 32
    seeded = R.supervised_check_packed(p, k, device="cpu", segment_iters=SEG)
    seeds = [a for a in seeded["attempts"] if a.get("event") == "plan"]
    assert [a["outcome"] for a in seeds] == ["plan-seeded-pool-16"]
    assert seeds[0]["predicted-bytes"] <= limit
    assert seeded["rung"] == (16, 32, 2)
    assert seeded["plan"]["bytes-limit"] == limit
    monkeypatch.delenv("JTPU_PLAN_BYTES_LIMIT")
    explicit = R.supervised_check_packed(p, k, device="cpu", capacity=16,
                                         expand=2, segment_iters=SEG)
    for f in ("valid", "levels", "best-k", "rung", "searchstats"):
        assert seeded[f] == explicit[f], f


def test_an_explicit_rung_that_cannot_fit_is_rejected_first(monkeypatch):
    monkeypatch.setenv("JTPU_PLAN_BYTES_LIMIT", "200000")

    def no_state(*a, **kw):
        raise AssertionError("Engine.state was called")

    monkeypatch.setattr(engine_mod.Engine, "state", no_state)
    h = History.of(o.to_dict() for o in _history(120, 3))
    with pytest.raises(PlanRejectedError) as ei:
        G.check_history_gpu(h, CASRegister(), capacity=16384, window=32,
                            expand=1024, device="cpu")
    assert "PLAN-OOM" in str(ei.value)
    assert {f.rule for f in ei.value.findings} == {"PLAN-OOM"}
    assert ei.value.report["selected"] is None


def test_the_kill_switch_gives_the_same_results(monkeypatch):
    p, k, _, _ = _both(_history(160, 9, 0.05))
    on = R.supervised_check_packed(p, k, device="cpu", segment_iters=SEG)
    monkeypatch.setenv("JTPU_PLAN_GATE", "0")
    off = R.supervised_check_packed(p, k, device="cpu", segment_iters=SEG)
    assert "plan" in on and "plan" not in off
    on.pop("plan")
    # the host-timed seconds differ from run to run; their keys do not
    assert on.pop("device-s").keys() == off.pop("device-s").keys()
    assert on == off


def test_the_keyed_plan_equals_the_references():
    from jepsen_tpu.checker.tpu import check_keyed_tpu
    hs = {k: _history(60, k, 0.0 if k % 2 else 0.03) for k in range(3)}
    ref = check_keyed_tpu(hs, JCASRegister())
    ours = G.check_keyed_gpu(
        {k: History.of(o.to_dict() for o in h) for k, h in hs.items()},
        CASRegister(), device="cpu")
    assert ours["valid"] is ref["valid"] is True
    assert ours["plan"]["selected"].startswith("batch ")
    assert _no_bytes(ours["plan"]) == _no_bytes(ref["plan"])


def _keyed(wide: bool):
    hs = {k: T.simulate_register_history(60, n_procs=5, n_vals=8, seed=k)
          for k in range(6)}
    if wide:
        # needs a 64-offset window: deferred to the (512, 64, 512) rung
        hs["wide"] = T.wide_history(n_procs=40, rounds=1, seed=1)
    return hs


@pytest.mark.parametrize("case", ["a-deferred-key-on-a-wide-rung",
                                  "the-first-rung-in-chunks"])
def test_a_keyed_batch_under_a_byte_budget_runs_in_chunks(monkeypatch,
                                                          case):
    """A byte budget that holds a rung for one key but not for every key
    keeps the rung: the keys it runs go in chunks that fit, and every key
    ends as it does with no budget. Priced at every key, the (512, 64,
    512) rung would be dropped, and the one key that needs it with it."""
    wide = case == "a-deferred-key-on-a-wide-rung"
    hs = _keyed(wide)
    if not wide:
        # a ladder whose every rung holds one key under the budget, so
        # that the budget drops none and only the chunks differ
        monkeypatch.setattr(G, "_keyed_auto_ladder", lambda dev: (
            (32, 32, 4), (32, 32, 8), (64, 32, 16)))
    base = G.check_keyed_gpu(hs, CASRegister(), device="cpu")
    breq = G._bucket(max(pack_with_init(h, CASRegister())[0].n_required
                         for h in hs.values()))
    if wide:
        one = plan.footprint(plan.Candidate("batch", 512, 64, 512, breq, 0))
        limit = 2 * one["total-bytes"]
        assert plan.footprint(plan.Candidate(
            "batch", 512, 64, 512, breq, 0,
            keys=len(hs)))["total-bytes"] > limit
    else:
        limit = plan.footprint(plan.Candidate(
            "batch", 64, 32, 16, breq, 0, keys=2))["total-bytes"]
    monkeypatch.setenv("JTPU_PLAN_BYTES_LIMIT", str(limit))
    ours = G.check_keyed_gpu(hs, CASRegister(), device="cpu")
    assert ours["plan"]["bytes-limit"] == limit
    for key, r in base["results"].items():
        got = ours["results"][key]
        assert (got["valid"], got["levels"], got["rung"]) == (
            r["valid"], r["levels"], r["rung"]), key
    if wide:
        assert base["results"]["wide"]["rung"] == (512, 64, 512)
        assert (512, 64, 512) in [b["rung"] for b in ours["batches"]]
    else:
        assert max(b["keys"] for b in base["batches"]) == 6
        assert len(ours["batches"]) > len(base["batches"])
        assert not ours["plan"]["rejected"]
    # every launch fits the budget
    for b in ours["batches"]:
        assert plan.footprint(plan.Candidate(
            "batch", *b["rung"], breq, b["crash-width"],
            keys=b["keys"]))["total-bytes"] <= limit, b


def _run_ours(args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(["plan"] + args)
    return rc, buf.getvalue()


def _run_ref(args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = JCLI.run(JCLI.default_commands(), ["plan"] + args)
    return rc, buf.getvalue()


def _json_rules(out):
    return sorted({i["rule"] for i in json.loads(out)["issues"]})


@pytest.mark.parametrize("name", FIXTURES)
def test_the_plan_command_equals_the_references(name, capsys):
    spec = ["--dims", "@" + os.path.join(FIX, name)]
    ref_rc, ref_out = _run_ref(spec + ["--no-trace", "--format", "json"])
    rc, out = _run_ours(spec + ["--format", "json"])
    if name == "dims_mesh_indivisible.json":
        assert ref_rc == JCLI.TEST_FAILED
    assert rc == ref_rc
    assert _json_rules(out) == _json_rules(ref_out)
    rc_text, text = _run_ours(spec + ["--device", "cpu", "--no-trace"])
    ref_rc_text, ref_text = _run_ref(spec + ["--no-trace"])
    assert rc_text == ref_rc_text == rc
    # traced, the port's rows add one level's work from the cost model
    rc_traced, traced = _run_ours(spec + ["--device", "cpu"])
    assert rc_traced == rc
    assert all(" MOP/level " in ln for ln in traced.splitlines()
               if ln.startswith("# plan: ok "))
    # the text lines, but the footprints and the level budget's value
    # (the port's is of the padded widths)

    def lines(out):
        return [re.sub(r"\s+[\d.]+ MB", " MB",
                       re.sub(r"level budget \d+", "level budget", ln))
                for ln in out.splitlines()]

    assert lines(text) == lines(ref_text)


def test_the_plan_command_refuses_what_it_lacks(capsys):
    # --mesh is taken now: the sharded plan, as the reference's
    assert _run_ours(["--dims", "100", "--mesh", "4", "--device",
                      "cpu"])[0] == _run_ref(["--dims", "100", "--mesh",
                                              "4", "--no-trace"])[0]
    assert _run_ours(["--dims", "x"])[0] == 254
    assert _run_ours([])[0] == 254
    capsys.readouterr()
    # SARIF is rendered now, as the reference renders it
    rc, out = _run_ours(["--dims", "100", "--device", "cpu", "--format",
                         "sarif"])
    assert rc == 0 and json.loads(out)["version"] == "2.1.0"


def test_findings_from_a_report():
    rep = plan.analyze(plan.PlanDims(n_required=150, n_crashed=3,
                                     window_needed=5), bytes_limit=10_000,
                       device="cpu")
    fs = findings_from_report(rep)
    assert fs and all(f.rule == "PLAN-OOM" for f in fs)
    assert all(f.anchor.endswith("/PLAN-OOM") for f in fs)
    jrep = JP.analyze(JP.PlanDims(n_required=150, n_crashed=3,
                                  window_needed=5), bytes_limit=10_000)
    assert [f.anchor for f in fs] == [
        f.anchor for f in j_findings_from_report(jrep)]


def test_the_headroom_pre_shrink_equals_the_references(monkeypatch):
    from jepsen_tpu.obs import devices as jdevices
    from jepsen_tpu_torch.obs import devices
    # inert without a device that reports memory
    assert devices.poll("cpu") == [] and devices.headroom_ratio([]) is None
    assert devices.headroom_ratio(device="cpu") is None
    assert devices.headroom_threshold() == 0.05
    monkeypatch.setattr(devices, "headroom_ratio", lambda *a, **kw: 0.01)
    monkeypatch.setattr(jdevices, "headroom_ratio", lambda rows=None: 0.01)
    p, k, jp, jk = _both(_history())
    ours = R.supervised_check_packed(p, k, device="cpu", segment_iters=SEG)
    ref = JR.supervised_check_packed(jp, jk, segment_iters=SEG)
    assert ours["attempts"] == ref["attempts"]
    assert ours["attempts"][0]["outcome"] == "preemptive-halve-to-16"
    for f in ("valid", "levels", "rung", "rung-requested"):
        assert ours[f] == ref[f], f


def test_the_summary_line_and_the_column_bytes():
    h = _history(300, 9, 0.05)
    ours = plan.summary_line(History.of(o.to_dict() for o in h),
                             CASRegister(), device="cpu")
    ref = JP.summary_line(h, JCASRegister())
    # the same candidates and choice; the predicted MB are the port's own
    assert re.sub(r"predicted [\d.]+ MB", "", ours) == re.sub(
        r"predicted [\d.]+ MB", "", ref)
    assert ours.startswith("# plan: 8 candidate(s), 0 rejected, cheapest "
                           "single 32/32/4 @256+8")
    p, k, _, _ = _both(h)
    cols = engine_mod.Engine().cols(G._split_packed(p, 256, 8, k), CPU)
    assert plan.cols_nbytes(256, 8) == sum(t.nbytes for t in cols.values())
