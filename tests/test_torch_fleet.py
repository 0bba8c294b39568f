"""The port's elastic fleet (``jepsen_tpu_torch.fleet``) against the JAX
package's, on the CPU.

In-process hosts (``LocalHost`` on the CPU) on both sides, the same packed
history and the same segment length: the verdicts, ``levels``, the fleet's
counters and the trail's events (host loss and remesh, steal, join
admitted and rejected, the interconnect retry, all hosts lost) equal the
reference's. The pool surgery at the merge barrier (``merge_pool``,
``split_pool``, ``repad_pool``, ``shard_imbalance``) and
``_pool_sort_host``'s permutation equal the reference's on the same
pools. One real worker process (``ProcHost``) answers a search. The
``JTPU_FLEET`` switch: unset, 0 and 1 leave the single-host result as it
is.

Tolerance: none (integer state).
"""

import json
import os

import numpy as np
import pytest
import torch

from jepsen_tpu import fleet as jfleet
from jepsen_tpu import testing as jt
from jepsen_tpu.checker import tpu as T
from jepsen_tpu.models import CASRegister as JCASRegister
from jepsen_tpu.ops.encode import pack_with_init as jpack

from jepsen_tpu_torch import fleet
from jepsen_tpu_torch.checker import UNKNOWN
from jepsen_tpu_torch.checker import gpu as G
from jepsen_tpu_torch.fleet import (FleetPolicy, LocalHost,
                                    check_packed_fleet, merge_pool,
                                    repad_pool, shard_imbalance, split_pool)
from jepsen_tpu_torch.history import History
from jepsen_tpu_torch.models import CASRegister
from jepsen_tpu_torch.ops.encode import pack_with_init
from jepsen_tpu_torch.resilience import DCN, RetryPolicy

# one intra-op thread: the tier-1 run puts six workers on eight cores
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def fleet_env(monkeypatch):
    """No ambient fleet or plan knob; the switch is off unless a test
    turns it on; retries back off for a millisecond. The straggler
    detector is off (JTPU_FEDERATE=0): it scores hosts by wall-clock
    segment time, and a host's first segment of a shape (a JAX compile in
    the reference) would flag it in one package and not the other."""
    for var in ("JTPU_FLEET", "JTPU_FLEET_IMBALANCE_MAX",
                "JTPU_FLEET_IMBALANCE_LEVELS", "JTPU_FLEET_STEAL",
                "JTPU_FLEET_DEAD_S", "JTPU_PLAN_BYTES_LIMIT",
                "JTPU_SEGMENT_ITERS"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("JEPSEN_RETRY_BASE", "0.001")
    monkeypatch.setenv("JTPU_FEDERATE", "0")


def _both(seed=7, n=150, crash_p=0.02):
    """The same history packed by both packages: ((p, kernel), (jp,
    jkernel))."""
    h = jt.simulate_register_history(n, n_procs=5, n_vals=4, seed=seed,
                                     crash_p=crash_p)
    return (pack_with_init(History.of(o.to_dict() for o in h),
                           CASRegister()),
            jpack(h, JCASRegister()))


def _events(out):
    return [(e.get("event"), e.get("outcome")) for e in out["attempts"]]


def _stats(out):
    return {k: v for k, v in out["fleet"].items()}


def _same(got, want):
    for k in ("valid", "levels", "max-linearized-prefix", "final-states",
              "rung", "segments", "segment-iters", "segment-levels"):
        assert got.get(k) == want.get(k), (k, got.get(k), want.get(k))
    assert _stats(got) == _stats(want)
    assert _events(got) == _events(want)


def _skewed_pool(cap=32, live=6, window=32, crw=8):
    mw, mc = (window + 31) // 32, max((crw + 31) // 32, 1)
    k = np.zeros(cap, np.int32)
    k[:live] = np.arange(live, 0, -1, dtype=np.int32)
    mask = np.zeros((cap, mw), np.uint32)
    cmask = np.zeros((cap, mc), np.uint32)
    state = np.arange(cap, dtype=np.int32)
    alive = np.zeros(cap, bool)
    alive[:live] = True
    return (k, mask, cmask, state, alive)


def _random_pool(rng, cap=48, mw=2, mc=1):
    return (rng.integers(0, 6, cap).astype(np.int32),
            rng.integers(0, 4, (cap, mw)).astype(np.uint32),
            rng.integers(0, 3, (cap, mc)).astype(np.uint32),
            rng.integers(0, 3, cap).astype(np.int32),
            rng.random(cap) < 0.6)


def _pools_equal(a, b):
    return all(np.array_equal(x, y) for x, y in zip(a, b))


# ---------------------------------------------------------------------------
# Pool surgery
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(4))
def test_pool_surgery_matches_reference(seed):
    rng = np.random.default_rng(seed)
    pools = [_random_pool(rng) for _ in range(3)]
    for cap in (24, 48, 200):
        got, gd = merge_pool(pools, cap)
        want, wd = jfleet.merge_pool(pools, cap)
        assert gd == wd and _pools_equal(got, want)
    for n in (1, 2, 3, 4):
        for inter in (False, True):
            for a, b in zip(split_pool(pools[0], n, interleave=inter),
                            jfleet.split_pool(pools[0], n,
                                              interleave=inter)):
                assert _pools_equal(a, b)
        assert shard_imbalance(pools[0], n) == \
            jfleet.shard_imbalance(pools[0], n)
    for cap in (20, 48, 64):
        got, gd = repad_pool(pools[1], cap)
        want, wd = jfleet.repad_pool(pools[1], cap)
        assert gd == wd and _pools_equal(got, want)
    assert np.array_equal(G._pool_sort_host(*pools[2]),
                          T._pool_sort_host(*pools[2]))


def test_split_interleave_deals_live_rows():
    pool = _skewed_pool(cap=32, live=6)
    assert shard_imbalance(pool, 4)[0] == 4.0
    parts = split_pool(pool, 4, interleave=True)
    assert sorted(int(np.count_nonzero(p[4])) for p in parts) == [1, 1, 2, 2]
    merged, dropped = merge_pool(parts, 32)
    assert not dropped and int(np.count_nonzero(merged[4])) == 6


def test_merge_dedups_truncates_and_orders():
    pool = _skewed_pool(cap=8, live=3)
    merged, dropped = merge_pool([pool, pool], 8)
    assert not dropped and int(np.count_nonzero(merged[4])) == 3
    assert merged[4][:3].all() and not merged[4][3:].any()
    other = _skewed_pool(cap=8, live=8)
    other[3][:] += 100
    _, dropped = merge_pool([_skewed_pool(cap=8, live=8), other], 8)
    assert dropped


def test_carry_and_gang_request_roundtrip(tmp_path):
    (p, kernel), _ = _both()
    cols = G._split_packed(p, G._bucket(p.n_required), 8, kernel)
    carry = G._carry0_host(32, 32, 8, cols["ini"], int(cols["nr"]))
    path = str(tmp_path / "c.npz")
    fleet.save_carry(path, carry, round=3, trace="abc")
    back, meta = fleet.load_carry(path)
    assert meta == {"round": 3, "trace": "abc"}
    assert all(np.array_equal(np.asarray(a), np.asarray(b))
               for a, b in zip(carry, back))
    stacked = {c: np.stack([cols[c], cols[c]]) for c in cols}
    batch = tuple(np.stack([x, x]) for x in carry)
    gpath = str(tmp_path / "g.npz")
    fleet.save_gang_request(gpath, stacked, batch, kernel.name, expand=8)
    gcols, gcarry, kname, gmeta = fleet.load_gang_request(gpath)
    assert kname == kernel.name and gmeta == {"expand": 8}
    assert all(np.array_equal(gcols[c], stacked[c]) for c in stacked)
    assert gcarry[5].shape == (2,) and gcarry[8].dtype == np.int32
    assert fleet.kernel_by_name(kname) is kernel


# ---------------------------------------------------------------------------
# The fleet's search against the reference's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", (3, 11))
def test_fleet_matches_reference(seed):
    (p, kernel), (jp, jk) = _both(seed=seed)
    got = check_packed_fleet(p, kernel, hosts=2, segment_iters=8,
                             device="cpu")
    want = jfleet.check_packed_fleet(jp, jk, hosts=2, segment_iters=8)
    _same(got, want)
    single = G.check_packed_gpu(p, kernel, device="cpu")
    assert got["valid"] == single["valid"]
    assert got["fleet"]["hosts"] == ["host0", "host1"]


def test_host_kill_remesh_matches_reference():
    (p, kernel), (jp, jk) = _both()

    def chaos(round_idx, fl):
        if round_idx == 2 and fl.hosts[1].state == "live":
            fl.hosts[1].kill()

    got = check_packed_fleet(p, kernel, hosts=2, segment_iters=2,
                             on_round=chaos, device="cpu")
    want = jfleet.check_packed_fleet(jp, jk, hosts=2, segment_iters=2,
                                     on_round=chaos)
    _same(got, want)
    outcomes = [o for _, o in _events(got)]
    assert "host-removed" in outcomes and "remesh-to-1-hosts" in outcomes
    assert got["fleet"]["live"] == ["host0"]


def test_all_hosts_lost_is_unknown():
    (p, kernel), (jp, jk) = _both()

    def chaos(round_idx, fl):
        for h in fl.hosts:
            h.kill()

    got = check_packed_fleet(p, kernel, hosts=2, segment_iters=2,
                             on_round=chaos, device="cpu")
    want = jfleet.check_packed_fleet(jp, jk, hosts=2, segment_iters=2,
                                     on_round=chaos)
    assert got["valid"] is UNKNOWN and "all fleet hosts lost" in \
        got["error"]
    assert (got["levels"], _events(got)) == (want["levels"], _events(want))


def test_steal_matches_reference(monkeypatch):
    (p, kernel), (jp, jk) = _both()
    monkeypatch.setenv("JTPU_FLEET_IMBALANCE_MAX", "1.01")
    monkeypatch.setenv("JTPU_FLEET_IMBALANCE_LEVELS", "1")
    got = check_packed_fleet(p, kernel, hosts=2, segment_iters=2,
                             device="cpu")
    want = jfleet.check_packed_fleet(jp, jk, hosts=2, segment_iters=2)
    _same(got, want)
    steals = [e for e in got["attempts"]
              if e.get("outcome") == "steal-rebalance"]
    assert steals and got["fleet"]["steal-count"] == len(steals)
    assert all(s["imbalance_after"] <= s["imbalance_before"]
               for s in steals)


def test_join_admitted_and_rejected_match_reference():
    (p, kernel), (jp, jk) = _both()

    def join(late):
        asked = []

        def chaos(round_idx, fl):
            if round_idx == 1 and not asked:
                asked.append(1)
                fl.request_join(late())
        return chaos

    got = check_packed_fleet(p, kernel, hosts=2, segment_iters=2,
                             device="cpu",
                             on_round=join(lambda: LocalHost(
                                 "late", device="cpu")))
    want = jfleet.check_packed_fleet(
        jp, jk, hosts=2, segment_iters=2,
        on_round=join(lambda: jfleet.LocalHost("late")))
    _same(got, want)
    outcomes = [o for _, o in _events(got)]
    assert "join-admitted-3-hosts" in outcomes
    assert "remesh-to-3-hosts" in outcomes

    def collapse(late):
        asked = []

        def chaos(round_idx, fl):
            if round_idx == 1 and not asked:
                asked.append(1)
                os.environ["JTPU_PLAN_BYTES_LIMIT"] = "1"
                fl.request_join(late())
        return chaos

    try:
        got = check_packed_fleet(p, kernel, hosts=2, segment_iters=2,
                                 device="cpu",
                                 on_round=collapse(lambda: LocalHost(
                                     "late", device="cpu")))
    finally:
        os.environ.pop("JTPU_PLAN_BYTES_LIMIT", None)
    rej = next(e for e in got["attempts"]
               if e.get("outcome") == "join-rejected")
    assert "PLAN-OOM" in rej["rules"]
    assert "late" not in got["fleet"]["hosts"]


def test_dcn_retries_then_removes_host():
    (p, kernel), (jp, jk) = _both()
    policy = FleetPolicy(retry=RetryPolicy(backoff_base_s=0.001,
                                           backoff_cap_s=0.01))
    boom = {"left": 2}

    def flaky(ctx):
        if boom["left"]:
            boom["left"] -= 1
            raise RuntimeError("DCN all-reduce collective timed out")

    out = check_packed_fleet(
        p, kernel, segment_iters=8, policy=policy, device="cpu",
        hosts=[LocalHost("h0", device="cpu"),
               LocalHost("h1", chaos=flaky, device="cpu")])
    retries = [e for e in out["attempts"] if e["event"] == "host-retry"]
    assert out["valid"] is True and len(retries) == 2
    assert all(r["class"] == DCN for r in retries)
    assert out["fleet"]["hosts-lost"] == 0

    def always(ctx):
        raise RuntimeError("NCCL all-gather aborted")

    out = check_packed_fleet(
        p, kernel, segment_iters=8, device="cpu",
        policy=FleetPolicy(retry=RetryPolicy(max_retries=1,
                                             backoff_base_s=0.001)),
        hosts=[LocalHost("h0", device="cpu"),
               LocalHost("h1", chaos=always, device="cpu")])
    lost = [e for e in out["attempts"] if e["event"] == "host-lost"]
    assert out["valid"] is True
    assert lost and lost[0]["host"] == "h1" and lost[0]["class"] == DCN


@pytest.mark.parametrize("save_hosts,resume_hosts", [(4, 2), (2, 4)])
def test_fleet_resume_across_mesh_sizes(save_hosts, resume_hosts):
    (p, kernel), _ = _both()
    cps = []
    base = check_packed_fleet(p, kernel, hosts=save_hosts, segment_iters=2,
                              on_checkpoint=cps.append, device="cpu")
    cp = cps[len(cps) // 2]
    resumed = check_packed_fleet(p, kernel, hosts=resume_hosts,
                                 segment_iters=2, resume=cp, device="cpu")
    assert resumed["valid"] == base["valid"]
    pool, dropped = repad_pool(cp.carry[:5], 36)
    assert not dropped
    assert int(np.count_nonzero(pool[4])) == int(np.count_nonzero(
        cp.carry[4]))


# ---------------------------------------------------------------------------
# The switch, the observatory, a worker process
# ---------------------------------------------------------------------------


def test_fleet_hosts_env_parsing(monkeypatch):
    assert G._fleet_hosts() == 0
    for off in ("0", "1", "", "  ", "nope", "-3"):
        monkeypatch.setenv("JTPU_FLEET", off)
        assert G._fleet_hosts() == 0 == T._fleet_hosts()
    monkeypatch.setenv("JTPU_FLEET", "2")
    assert G._fleet_hosts() == 2


def test_switch_off_leaves_single_host_result(monkeypatch, tmp_path):
    """Unset, 0 and 1: the single-host result, key for key (but the
    timings), and the history file untouched; 2 routes the search
    through the fleet with the same verdict."""
    h = jt.simulate_register_history(150, n_procs=5, n_vals=4, seed=7,
                                     crash_p=0.02)
    art = tmp_path / "history.json"
    art.write_text(json.dumps([o.to_dict() for o in h]))
    before = art.read_bytes()

    def check():
        hist = History.of(json.loads(art.read_text()))
        r = G.check_history_gpu(hist, CASRegister(), segment_iters=8,
                                device="cpu")
        return {k: v for k, v in r.items() if k not in ("device-s", "cost")}

    base = check()
    for off in ("0", "1"):
        monkeypatch.setenv("JTPU_FLEET", off)
        assert check() == base
    assert art.read_bytes() == before and "fleet" not in base
    monkeypatch.setenv("JTPU_FLEET", "2")
    r = check()
    assert r["fleet"]["hosts"] == ["host0", "host1"]
    assert r["valid"] == base["valid"]


def test_fleet_publishes_imbalance(tmp_path, monkeypatch):
    from jepsen_tpu_torch.obs import observatory
    monkeypatch.setenv("JTPU_TRACE", "1")
    (p, kernel), _ = _both()
    G._SHARD_IMBALANCE.set(-1.0)
    observatory.attach(str(tmp_path))
    try:
        check_packed_fleet(p, kernel, hosts=2, segment_iters=2,
                           device="cpu")
    finally:
        observatory.detach()
    prog = json.loads((tmp_path / "progress.json").read_text())
    assert prog["state"] == "done" and prog.get("imbalance") is not None
    assert prog["fleet"]["hosts"] >= 1
    assert G._SHARD_IMBALANCE.value() >= 1.0


def test_worker_process_fleet(tmp_path):
    """Two real workers (``python -m jepsen_tpu_torch.fleet worker``) on
    the CPU: the verdict and levels of the same fleet of in-process
    hosts, heartbeats, and both stopped at the end."""
    (p, kernel), _ = _both(seed=3, n=100)
    hosts = [fleet.ProcHost(f"w{i}", str(tmp_path / f"w{i}"),
                            device="cpu") for i in range(2)]
    out = check_packed_fleet(p, kernel, hosts=hosts, segment_iters=16,
                             device="cpu")
    local = check_packed_fleet(p, kernel, hosts=2, segment_iters=16,
                               device="cpu")
    assert (out["valid"], out["levels"]) == (local["valid"],
                                             local["levels"])
    for i in range(2):
        hb = fleet.read_heartbeat(str(tmp_path / f"w{i}"))
        assert hb and hb.get("pid")
        with open(tmp_path / f"w{i}" / fleet.CONFIG_NAME) as f:
            assert json.load(f) == {"device": "cpu"}
    assert all(h.state == "dead" for h in hosts)
