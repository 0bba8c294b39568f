"""The port's device meshes, its pool-sharded search (B8) and its keyed
mesh against the JAX package, on the CPU.

The reference runs its meshes on 8 simulated CPU devices
(``tests/conftest.py``); the port's meshes list the CPU 8 times (logical
shards). Held equal on the same inputs:

* ``check_history_sharded`` on 8 logical shards against the reference's
  8-device mesh: verdict, ``levels``, ``max-linearized-prefix`` and
  ``pool-sharding``;
* the sharded carry at each segment end against the port's unsharded
  search, bit for bit under ``lex``, and resumed on a mesh of another
  size;
* ``check_keyed_gpu(mesh=)`` against the reference's keyed mesh and the
  meshless batch, key by key; ``check_keyed_distributed`` over two gloo
  ranks against the meshless result;
* ``plan --mesh N``'s findings against the reference's.

Tolerance: none (integer state).
"""

import json
import os
import random
import subprocess
import sys

import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from jepsen_tpu import parallel as jparallel
from jepsen_tpu import testing as jt
from jepsen_tpu.checker import plan as jplan
from jepsen_tpu.checker import tpu as T
from jepsen_tpu.models import CASRegister as JCASRegister
from test_linearizable import random_register_history

from jepsen_tpu_torch import parallel, resilience
from jepsen_tpu_torch.analysis.plan_lint import PlanRejectedError
from jepsen_tpu_torch.checker import UNKNOWN
from jepsen_tpu_torch.checker import gpu as G
from jepsen_tpu_torch.checker import plan
from jepsen_tpu_torch.history import History
from jepsen_tpu_torch.models import CASRegister
from jepsen_tpu_torch.ops.encode import pack_with_init

# one intra-op thread: the tier-1 run puts six workers on eight cores
torch.set_num_threads(1)

CPU8 = ["cpu"] * 8
VERDICT = ("valid", "levels", "max-linearized-prefix", "final-states")
KEYED = ("valid", "levels", "max-linearized-prefix", "rung",
         "crash-width", "tiebreak", "work")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port(h):
    return History.of(o.to_dict() for o in h)


def _pool_mesh(n=8):
    return parallel.make_mesh(n, axis=G.POOL_AXIS, devices=["cpu"] * n)


def _carries_equal(a, b):
    return len(a) == len(b) and all(
        np.array_equal(np.asarray(x), np.asarray(y)) for x, y in zip(a, b))


# ---------------------------------------------------------------------------
# Meshes
# ---------------------------------------------------------------------------


def test_make_mesh_shape_subset_and_overflow():
    mesh = parallel.make_mesh(devices=CPU8)
    assert mesh.shape == {"keys": 8} == dict(jparallel.make_mesh().shape)
    assert parallel.make_mesh(4, devices=CPU8).shape == {"keys": 4}
    assert parallel.make_mesh(2, axis="pool", devices=CPU8).shape == {
        "pool": 2}
    with pytest.raises(ValueError, match="asked for 9 devices, have 8"):
        parallel.make_mesh(9, devices=CPU8)
    # a repeated device gives logical shards; CUDA gets its index
    assert all(d == torch.device("cpu") for d in mesh.devices)


def test_shardings_are_descriptors():
    mesh = parallel.make_mesh(2, devices=CPU8)
    s = parallel.keyed_sharding(mesh)
    r = parallel.replicated_sharding(mesh)
    assert (s.mesh, s.axis) == (mesh, "keys")
    assert (r.mesh, r.axis) == (mesh, None)


def test_initialize_multihost_needs_an_explicit_coordinator(monkeypatch):
    monkeypatch.delenv(parallel.COORDINATOR_ENV, raising=False)
    assert parallel.initialize_multihost() is False
    assert jparallel.initialize_multihost() is False


def test_rank_shares_of_a_global_mesh_cover_every_entry_once():
    ranks = (0, 0, 1, 1, 2, 2, 3, 3)
    assert parallel.check_ranks(ranks, 4) == 2
    shares = [parallel.Mesh(("cpu",) * 8, parallel.KEYS_AXIS, ranks,
                            r).local() for r in range(4)]
    assert shares == [[0, 1], [2, 3], [4, 5], [6, 7]]
    for bad in ((0, 0, 0, 1), (1, 1, 0, 0), (0, 0, 2, 2)):
        with pytest.raises(ValueError, match="same number of entries"):
            parallel.check_ranks(bad, 2 if 2 not in bad else 3)


# ---------------------------------------------------------------------------
# The pool-sharded search
# ---------------------------------------------------------------------------


def test_sharded_matches_reference_mesh_and_unsharded():
    """12 small crashy histories on 8 logical shards, against the
    reference's 8-device mesh and the port's unsharded search at the
    same rung: every verdict field and the pool-sharding key."""
    jmesh = jparallel.make_mesh(axis=T.POOL_AXIS)
    mesh = _pool_mesh()
    rng = random.Random(23)
    decided = 0
    for i in range(12):
        jh = random_register_history(rng, n_procs=4, n_ops=10, n_vals=3,
                                     crash_p=0.1)
        want = T.check_history_sharded(jh, JCASRegister(), jmesh,
                                       capacity=64, expand=16)
        got = G.check_history_sharded(_port(jh), CASRegister(), mesh,
                                      capacity=64, expand=16,
                                      segment_iters=0)
        for k in VERDICT + ("pool-sharding",):
            assert got.get(k) == want.get(k), (i, k, got, want)
        p, kernel = pack_with_init(_port(jh), CASRegister())
        alone = G.check_packed_gpu(p, kernel, capacity=64,
                                   window=got["rung"][1], expand=16,
                                   segment_iters=0, device="cpu")
        for k in VERDICT:
            assert got.get(k) == alone.get(k), (i, k)
        decided += got["valid"] is not UNKNOWN
    assert decided > 6


def test_sharded_carry_equals_unsharded_at_each_segment_end():
    """The segmented sharded search's carry at every segment end is the
    unsharded search's, bit for bit (lex), on meshes of 2 and 8."""
    h = jt.simulate_register_history(300, n_procs=5, n_vals=4, seed=11,
                                     crash_p=0.02)
    p, kernel = pack_with_init(_port(h), CASRegister())
    want = []
    alone = resilience.supervised_check_packed(
        p, kernel, capacity=64, window=32, expand=16, segment_iters=8,
        device=torch.device("cpu"), on_checkpoint=want.append)
    for n in (2, 8):
        got = []
        out = G.check_packed_sharded(p, kernel, _pool_mesh(n), capacity=64,
                                     window=32, expand=16, segment_iters=8,
                                     on_checkpoint=got.append)
        assert len(got) == len(want) > 4
        for a, b in zip(want, got):
            assert _carries_equal(a.carry, b.carry)
            assert a.segment == b.segment
        assert (out["valid"], out["levels"]) == (alone["valid"],
                                                 alone["levels"])
        assert out["pool-sharding"] == f"pool={n}"
        assert out["shard-balance"]["devices"] == n


def test_sharded_refutation_carries_final_states():
    rows = [graft._stale_read_history()]
    mesh = _pool_mesh()
    r = G.check_history_sharded(_port(rows[0]), CASRegister(), mesh,
                                capacity=64, expand=8)
    want = T.check_history_sharded(rows[0], JCASRegister(),
                                   jparallel.make_mesh(axis=T.POOL_AXIS),
                                   capacity=64, expand=8)
    assert r["valid"] is False and r.get("final-states")
    assert r["final-states"] == want["final-states"]
    assert r["pool-sharding"] == "pool=8"


@pytest.mark.parametrize("save_axis,resume_axis", [(4, 2), (2, 4)])
def test_sharded_resume_across_mesh_sizes(save_axis, resume_axis):
    """A checkpoint saved under one axis resumes under another with the
    uninterrupted search's verdict, levels and final carry."""
    h = jt.simulate_register_history(120, n_procs=5, n_vals=4, seed=11,
                                     crash_p=0.02)
    p, kernel = pack_with_init(_port(h), CASRegister())
    kw = dict(capacity=64, window=32, expand=16, segment_iters=4)
    ends = []
    unint = G.check_packed_sharded(p, kernel, _pool_mesh(save_axis),
                                   on_checkpoint=ends.append, **kw)
    assert len(ends) >= 2
    tail = []
    resumed = G.check_packed_sharded(p, kernel, _pool_mesh(resume_axis),
                                     resume=ends[0],
                                     on_checkpoint=tail.append, **kw)
    assert (resumed["valid"], resumed["levels"]) == (unint["valid"],
                                                     unint["levels"])
    assert _carries_equal(tail[-1].carry, ends[-1].carry)


def test_divisibility_enforced(monkeypatch):
    h = _port(graft._stale_read_history())
    mesh = _pool_mesh()
    with pytest.raises(PlanRejectedError, match="PLAN-SHARD-INDIVISIBLE"):
        G.check_history_sharded(h, CASRegister(), mesh, capacity=65)
    monkeypatch.setenv("JTPU_PLAN_GATE", "0")
    with pytest.raises(ValueError, match="divide"):
        G.check_history_sharded(h, CASRegister(), mesh, capacity=65)


def test_shard_balance_matches_reference():
    rng = np.random.default_rng(3)
    pk = rng.integers(0, 50, 64).astype(np.int32)
    ps = rng.integers(0, 9, 64).astype(np.int32)
    pa = rng.random(64) < 0.3
    for n in (1, 2, 8, 7):
        assert G._shard_balance((pk, ps, pa), n) == \
            T._shard_balance((pk, ps, pa), n)


# ---------------------------------------------------------------------------
# The keyed mesh
# ---------------------------------------------------------------------------


def test_keyed_mesh_routing_uneven_escalation():
    """Uneven key count (padding rows), a refuted key, and a key only
    the escalated rung refutes, on 8 shards: each key's result equals
    the reference's 8-device mesh, and the verdicts the meshless
    batch's."""
    keyed = {k: random_register_history(random.Random(40 + k),
                                           n_procs=3, n_ops=6, n_vals=3)
             for k in range(11)}
    keyed["invalid"] = graft._stale_read_history()
    keyed["escalates"] = graft._pool_buster_history()
    ladder = ((8, 16, 4), (256, 16, 64))
    want = T.check_keyed_tpu(keyed, JCASRegister(),
                             mesh=jparallel.make_mesh(8), ladder=ladder)
    pk = {k: _port(h) for k, h in keyed.items()}
    got = G.check_keyed_gpu(pk, CASRegister(), ladder=ladder,
                            mesh=parallel.make_mesh(8, devices=CPU8))
    alone = G.check_keyed_gpu(pk, CASRegister(), ladder=ladder,
                              device="cpu")
    assert got["results"]["invalid"]["valid"] is False
    assert got["results"]["escalates"]["valid"] is False
    assert got["valid"] is False and len(got["results"]) == 13
    for k in keyed:
        for f in KEYED:
            assert got["results"][k].get(f) == \
                want["results"][k].get(f), (k, f)
        assert got["results"][k]["valid"] == alone["results"][k]["valid"]
        assert got["results"][k]["levels"] == alone["results"][k]["levels"]
    # each shard's batch is a multiple of the axis: 16 rows on 8 devices
    first = [b for b in got["batches"] if b["rung"] == ladder[0]]
    assert len(first) == 8 and sum(b["keys"] for b in first) == 13


def test_keyed_distributed_two_gloo_ranks(tmp_path):
    """Two processes join a gloo group through a file:// init method,
    each checks its share of the keys, and both return the whole keyed
    result, equal key by key to one process's check."""
    keyed = {k: jt.simulate_register_history(60, n_procs=3, n_vals=4,
                                             seed=500 + k, crash_p=0.02)
             for k in range(9)}
    want = G.check_keyed_gpu({k: _port(h) for k, h in keyed.items()},
                             CASRegister(), device="cpu")
    child = (
        "import json, sys\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "from jepsen_tpu_torch import parallel\n"
        "from jepsen_tpu_torch.history import History\n"
        "from jepsen_tpu_torch.models import CASRegister\n"
        "from jepsen_tpu_torch.testing import simulate_register_history\n"
        "keyed = {k: simulate_register_history(60, n_procs=3, n_vals=4,\n"
        "                                      seed=500 + k, crash_p=0.02)\n"
        "         for k in range(9)}\n"
        "res = parallel.check_keyed_distributed(keyed, CASRegister(),\n"
        "                                       device='cpu')\n"
        "print(json.dumps({'ranks': res.get('ranks'), 'results': {\n"
        "    str(k): [repr(r['valid']), r.get('levels'), r.get('rung')]\n"
        "    for k, r in res['results'].items()}}))\n")
    init = "file://" + str(tmp_path / "gloo-init")
    procs = [subprocess.Popen(
        [sys.executable, "-c", child], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, JTPU_COORDINATOR_ADDRESS=init,
                 JTPU_NUM_PROCESSES="2", JTPU_PROCESS_ID=str(r),
                 OMP_NUM_THREADS="1"))
        for r in range(2)]
    outs = []
    for pr in procs:
        out, err = pr.communicate(timeout=120)
        assert pr.returncode == 0, err[-3000:]
        outs.append(json.loads(out.strip().splitlines()[-1]))
    expect = {str(k): [repr(r["valid"]), r.get("levels"),
                       list(r["rung"])]
              for k, r in want["results"].items()}
    for o in outs:
        assert o["ranks"] == 2
        assert o["results"] == expect


# ---------------------------------------------------------------------------
# plan --mesh
# ---------------------------------------------------------------------------


def _rules(report):
    return sorted((i["rule"], i["severity"], i["label"])
                  for i in report["issues"])


@pytest.mark.parametrize("dims,knobs", [
    (dict(n_required=120, n_crashed=3, window_needed=20), {}),
    (dict(n_required=120, n_crashed=3, window_needed=20),
     dict(capacity=64, expand=16)),
    (dict(n_required=400, n_crashed=0, window_needed=70),
     dict(capacity=4096, expand=24)),
    (dict(n_required=50, n_crashed=0, window_needed=5),
     dict(capacity=66, expand=8)),
])
@pytest.mark.parametrize("naxis", [2, 3, 8])
def test_plan_mesh_findings_match_reference(dims, knobs, naxis):
    """``plan --mesh N``'s sharded candidate and its findings, as the
    reference reports them for the same knobs (no byte budget, as on a
    host without a card)."""
    want = jplan.analyze(jplan.PlanDims(**dims), mesh_axis=naxis,
                         use_device_limit=False, kinds=("sharded",),
                         **knobs)
    got = plan.analyze(plan.PlanDims(**dims), mesh_axis=naxis,
                       use_device_limit=False, kinds=("sharded",),
                       device="cpu", **knobs)
    assert [c["label"] for c in got["candidates"]] == \
        [c["label"] for c in want["candidates"]]
    assert _rules(got) == _rules(want)
    assert got["selected"] == want["selected"]


def test_plan_command_mesh(capsys):
    from jepsen_tpu.cli import default_commands, run as jrun
    from jepsen_tpu_torch.__main__ import main
    argv = ["plan", "--dims", "120,3,20", "--mesh", "3", "--capacity", "64",
            "--expand", "16", "--format", "json"]
    rc = main(argv + ["--device", "cpu"])
    got = json.loads(capsys.readouterr().out)
    jrc = jrun(default_commands(), argv + ["--no-trace"])
    want = json.loads(capsys.readouterr().out)
    # the sharded candidate's PLAN-SHARD-INDIVISIBLE is an error in both
    assert rc == jrc == 1
    assert _rules(got) == _rules(want)
    assert any("pool=3" in c["label"] for c in got["candidates"])


def test_check_remesh_pads_and_validates():
    h = jt.simulate_register_history(150, n_procs=5, n_vals=4, seed=7,
                                     crash_p=0.02)
    p, _ = pack_with_init(_port(h), CASRegister())
    rm = plan.check_remesh(p, 3, 32, 32, 8)
    assert rm["ok"] is True and rm["capacity"] == 33 and rm["expand"] == 9
    assert rm["per-device-bytes"] > 0
    bad = plan.check_remesh(p, 2, 16384, 32, 1024, bytes_limit=10_000)
    assert bad["ok"] is False
    assert any(i["rule"] == "PLAN-OOM" for i in bad["issues"])
    assert plan.pad_for_axis(32, 3) == 33 and plan.pad_for_axis(1, 8) == 8
