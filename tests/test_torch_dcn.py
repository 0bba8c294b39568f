"""The port's multi-process mesh on the CPU: one pool-sharded search and
one keyed check over a mesh whose entries belong to two processes.

One pair of gloo ranks (a ``file://`` init, each rank with 2 logical CPU
shards: 4 global entries) runs every leg; the histories are built here
and handed to the ranks as JSON, so that no rank imports JAX. Held equal:

* each rank's ``check_history_sharded`` against the JAX package's on its
  4-device pool mesh (``valid``, ``levels``, ``max-linearized-prefix``,
  ``final-states``, ``pool-sharding``): the reference dryrun's valid and
  stale-read histories and six crashy random histories;
* every segment end's carry of the 2-rank search of
  ``wide_history(30, 2, seed=5)`` at capacity 256 in segments of 4
  levels against the port's single-process
  4-shard carry and its unsharded carry, bit for bit, on both ranks;
* ``check_keyed_gpu(mesh=global)`` against the reference's keyed mesh,
  key by key, the stale-read key among them;
* each level's one exchange, its bytes and its recorded times;
* a checkpoint of the 2-rank search resumed in one process on 2 shards;
* a rank killed mid-search: the other raises a ``dcn``-class error
  within the group's timeout;
* an uneven mesh raises before any device state is made, and nccl with a
  shared card raises before the group is made.

Tolerance: none (integer state).
"""

import json
import os
import pickle
import random
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from jepsen_tpu import parallel as jparallel
from jepsen_tpu import testing as jt
from jepsen_tpu.checker import tpu as T
from jepsen_tpu.models import CASRegister as JCASRegister
from test_linearizable import random_register_history

from jepsen_tpu_torch import parallel, resilience
from jepsen_tpu_torch.analysis.plan_lint import PlanRejectedError
from jepsen_tpu_torch.checker import gpu as G
from jepsen_tpu_torch.history import History
from jepsen_tpu_torch.models import CASRegister
from jepsen_tpu_torch.ops.encode import pack_with_init
from jepsen_tpu_torch.testing import wide_history

# one intra-op thread: the tier-1 run puts six workers on eight cores
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VERDICT = ("valid", "levels", "max-linearized-prefix", "final-states",
           "pool-sharding")
KEYED = ("valid", "levels", "max-linearized-prefix", "rung",
         "crash-width", "tiebreak", "work")
#: the wide search's rung and segment length (its 13 levels in 4
#: segments, so that there are segment ends inside the search to hold)
WIDE_KW = dict(capacity=256, segment_iters=4)
#: the group's timeout, within which a lost rank must end the search
TIMEOUT_S = 20

#: one rank of the pair: every leg, its results pickled to out_<rank>
CHILD = r"""
import json, os, pickle, signal, sys, time
job = json.loads(sys.argv[1])
sys.path.insert(0, job["repo"])
sys.path.insert(0, os.path.join(job["repo"], "tools"))
import torch
torch.set_num_threads(1)
from jepsen_tpu_torch import parallel, resilience
from jepsen_tpu_torch.checker import gpu as G
from jepsen_tpu_torch.history import History
from jepsen_tpu_torch.models import CASRegister
from jepsen_tpu_torch.ops.encode import pack_with_init
import torch_dryrun_dcn as dcn

rank, world = job["rank"], 2
parallel.initialize_multihost(job["init"], world, rank,
                              timeout_s=job["timeout"])
out = {}
try:
    parallel.make_mesh(axis="pool", devices=["cpu"] * (2 - rank))
    out["uneven"] = None
except ValueError as e:
    out["uneven"] = str(e)
hist = lambda ops: History.of(ops)
keyed = {(k if k == "invalid" else int(k)): hist(ops)
         for k, ops in job["keyed"].items()}
legs = dcn.dcn_legs(["cpu"] * 2, keyed=keyed, valid=hist(job["valid"]),
                    out=lambda s: None)
out["keyed"], out["dcn"] = legs["keyed"], [legs["valid"], legs["refuted"]]
mesh = parallel.make_mesh(axis="pool", devices=["cpu"] * 2)
out["crashy"] = [G.check_history_sharded(hist(ops), CASRegister(), mesh,
                                         capacity=64, expand=16)
                 for ops in job["crashy"]]
p, kernel = pack_with_init(hist(job["wide"]), CASRegister())
ends = []

def keep(cp):
    ends.append(cp.carry)
    if rank == 0 and cp.segment == 1:
        cp.save(job["first"])
out["wide"] = G.check_packed_sharded(
    p, kernel, mesh, window=job["window"], on_checkpoint=keep,
    checkpoint_path=job["final"] + str(rank), **job["wide_kw"])
out["ends"] = ends
# two levels with the exchange recorded: (start, end, collective seconds)
cols_np = G._prep_single(p, kernel)[0]
shape = G.K.LevelShape(C=256, W=job["window"], E=32,
                       n=cols_np["f"].shape[0], CR=cols_np["cf"].shape[0],
                       model=kernel.name)
st = G.ShardedState(mesh.devices, cols_np, shape, True, mesh.ranks,
                    mesh.rank)
st.exchange_log = []
st.level()
st.level()
out["exchange"] = (st.exchange_log, st.exchange_bytes)
path = os.path.join(job["dir"], f"out_{rank}.pkl")
if rank == 1:
    with open(path, "wb") as fh:
        pickle.dump(out, fh)

def die(cp):
    if rank == 1 and cp.segment == 2:
        os.kill(os.getpid(), signal.SIGKILL)
t0 = time.monotonic()
try:
    G.check_packed_sharded(p, kernel, mesh, window=job["window"],
                           capacity=256, segment_iters=2,
                           on_checkpoint=die)
    out["lost"] = None
except Exception as e:
    out["lost"] = (resilience.classify_failure(e), str(e),
                   time.monotonic() - t0)
with open(path, "wb") as fh:
    pickle.dump(out, fh)
os._exit(0)
"""


def _ops(h):
    return [o.to_dict() for o in h]


def _port(h):
    return History.of(_ops(h))


def _carries_equal(a, b):
    return len(a) == len(b) and all(
        np.array_equal(np.asarray(x), np.asarray(y)) for x, y in zip(a, b))


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """The inputs, and each rank's outputs of one run of the pair."""
    d = tmp_path_factory.mktemp("dcn")
    keyed_j, valid_j = {}, jt.simulate_register_history(
        60, n_procs=4, seed=11, crash_p=0.05)
    for k in range(8):
        keyed_j[k] = jt.simulate_register_history(12, n_procs=3,
                                                  seed=100 + k, crash_p=0.1)
    keyed_j["invalid"] = graft._stale_read_history()
    rng = random.Random(23)
    crashy = [random_register_history(rng, n_procs=4, n_ops=10, n_vals=3,
                                      crash_p=0.1) for _ in range(6)]
    wide = wide_history(30, 2, seed=5)
    p, _ = pack_with_init(wide, CASRegister())
    window = G._window_bucket(G._window_needed(p))
    job = {"repo": REPO, "init": "file://" + str(d / "init"),
           "timeout": TIMEOUT_S, "dir": str(d),
           "keyed": {str(k): _ops(h) for k, h in keyed_j.items()},
           "valid": _ops(valid_j), "crashy": [_ops(h) for h in crashy],
           "wide": _ops(wide), "window": window, "wide_kw": WIDE_KW,
           "first": str(d / "first.npz"), "final": str(d / "final.npz")}
    procs = [subprocess.Popen(
        [sys.executable, "-c", CHILD, json.dumps(dict(job, rank=r))],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
        for r in range(2)]
    errs = []
    try:
        for pr in procs:
            _, err = pr.communicate(timeout=150)
            errs.append(err)
    finally:
        for pr in procs:
            if pr.poll() is None:
                pr.kill()
                pr.wait()
    outs = []
    for r in range(2):
        path = d / f"out_{r}.pkl"
        assert path.exists(), errs[r][-3000:]
        with open(path, "rb") as fh:
            outs.append(pickle.load(fh))
    return {"job": job, "outs": outs, "keyed": keyed_j, "valid": valid_j,
            "crashy": crashy, "wide": wide, "window": window, "dir": d}


def test_the_ranks_give_the_references_verdicts(pair):
    jmesh = jparallel.make_mesh(4, axis=T.POOL_AXIS)
    wants = [T.check_history_sharded(h, JCASRegister(), jmesh, capacity=64,
                                     expand=8)
             for h in (pair["valid"], graft._stale_read_history())]
    wants += [T.check_history_sharded(h, JCASRegister(), jmesh, capacity=64,
                                      expand=16) for h in pair["crashy"]]
    assert [w["valid"] for w in wants[:2]] == [True, False]
    for out in pair["outs"]:
        gots = out["dcn"] + out["crashy"]
        for i, (got, want) in enumerate(zip(gots, wants)):
            for k in VERDICT:
                assert got.get(k) == want.get(k), (i, k, got, want)
            assert got["ranks"] == 2
    # every rank returns the same result
    a, b = (o["dcn"] + o["crashy"] for o in pair["outs"])
    assert a == b


def test_every_segment_end_equals_one_process_bit_for_bit(pair):
    p, kernel = pack_with_init(pair["wide"], CASRegister())
    kw = dict(window=pair["window"], **WIDE_KW)
    single, unsharded = [], []
    alone = G.check_packed_sharded(p, kernel, parallel.make_mesh(
        axis="pool", devices=["cpu"] * 4), on_checkpoint=single.append, **kw)
    expand = alone["rung"][2]
    resilience.supervised_check_packed(
        p, kernel, capacity=kw["capacity"], window=kw["window"],
        expand=expand, segment_iters=kw["segment_iters"],
        device=torch.device("cpu"), on_checkpoint=unsharded.append)
    assert len(single) == len(unsharded) >= 2
    for out in pair["outs"]:
        assert len(out["ends"]) == len(single)
        for got, a, b in zip(out["ends"], single, unsharded):
            assert _carries_equal(got, a.carry)
            assert _carries_equal(got, b.carry)
        for f in ("valid", "levels", "max-linearized-prefix", "rung"):
            assert out["wide"].get(f) == alone.get(f), f


def test_the_keyed_mesh_across_ranks_equals_the_reference(pair):
    want = T.check_keyed_tpu(pair["keyed"], JCASRegister(), capacity=64,
                             window=16, mesh=jparallel.make_mesh(4))
    for out in pair["outs"]:
        got = out["keyed"]
        assert got["ranks"] == 2 and got["valid"] is False
        assert got["results"]["invalid"]["valid"] is False
        assert set(got["results"]) == set(want["results"])
        for k in want["results"]:
            for f in KEYED:
                assert got["results"][k].get(f) == \
                    want["results"][k].get(f), (k, f)
        assert {b["rank"] for b in got["batches"]} == {0, 1}


def test_each_level_is_one_recorded_exchange(pair):
    shape = G.K.LevelShape(C=256, W=pair["window"], E=32, n=1, CR=0)
    local = G.K.LevelShape(C=64, W=pair["window"], E=8, n=1, CR=0)
    # each rank's block: 2 shards' live rows and scalar rows, of 2 ranks
    want = 4 * 2 * 2 * (local.R * shape.NK + G.K.NSCAL + G.K.NACC)
    for out in pair["outs"]:
        log, nbytes = out["exchange"]
        assert nbytes == want
        assert len(log) == 2
        assert all(t0 <= t1 and 0 <= g <= t1 - t0 for t0, t1, g in log)


def test_a_checkpoint_of_two_ranks_resumes_in_one_process(pair):
    d = pair["dir"]
    # rank 0 alone writes the checkpoint path
    assert (d / "final.npz0").exists() and not (d / "final.npz1").exists()
    cp = resilience.Checkpoint.load(str(d / "first.npz"))
    assert cp.segment == 1
    p, kernel = pack_with_init(pair["wide"], CASRegister())
    resumed = G.check_packed_sharded(
        p, kernel, parallel.make_mesh(axis="pool", devices=["cpu"] * 2),
        window=pair["window"], resume=cp, **WIDE_KW)
    unint = pair["outs"][0]["wide"]
    assert (resumed["valid"], resumed["levels"]) == (unint["valid"],
                                                     unint["levels"])


def test_a_lost_rank_raises_dcn_within_the_timeout(pair):
    lost = pair["outs"][0]["lost"]
    assert lost is not None, "the survivor finished the search alone"
    cls, text, seconds = lost
    assert cls == resilience.DCN, text
    assert "all_gather" in text
    assert seconds < TIMEOUT_S, seconds


def test_an_uneven_mesh_and_nccl_on_a_shared_card_raise_first(
        pair, monkeypatch, tmp_path):
    for out in pair["outs"]:
        assert "same number of entries" in (out["uneven"] or "")
    # a mesh whose ranks hold 2 and 1 entries: refused by the gate, and
    # without the gate before the search's state is made
    mesh = parallel.Mesh(tuple(torch.device("cpu") for _ in range(3)),
                         G.POOL_AXIS, (0, 0, 1), 0)
    h = _port(pair["valid"])
    with pytest.raises(PlanRejectedError, match="PLAN-SHARD-INDIVISIBLE"):
        G.check_history_sharded(h, CASRegister(), mesh, capacity=96,
                                expand=12)
    made = []
    monkeypatch.setattr(G, "empty_carry",
                        lambda *a, **k: made.append(a) or 1 / 0)
    monkeypatch.setenv("JTPU_PLAN_GATE", "0")
    with pytest.raises(ValueError, match="same number of entries"):
        G.check_history_sharded(h, CASRegister(), mesh, capacity=96,
                                expand=12)
    assert not made
    # nccl with two ranks and no card on this host: refused before init
    import torch.distributed as dist
    init = "file://" + str(tmp_path / "init")
    for how in ("argument", "environment"):
        if how == "environment":
            monkeypatch.setenv(parallel.BACKEND_ENV, "nccl")
            kw = {}
        else:
            kw = {"backend": "nccl"}
        t0 = time.monotonic()
        with pytest.raises(ValueError, match="NCCL refuses two ranks"):
            parallel.initialize_multihost(init, 2, 0, **kw)
        assert time.monotonic() - t0 < 5
        assert not dist.is_initialized()
