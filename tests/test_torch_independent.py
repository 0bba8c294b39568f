"""The port's independent checker against the JAX one, on the CPU.

The same ``[k v]`` history (per-key register histories interleaved, plus
un-keyed nemesis ops that land in every subhistory) goes through
``independent.checker(linearizable(CASRegister(), ...))`` of both
packages: the port's on its plain versions (``device="cpu"``), the JAX
one's keyed batch on its CPU backend. Verdicts, failures, per-key
verdicts and the per-key artifact files must agree.
"""

import json
import os
import random

import pytest
import torch

from jepsen_tpu import independent as jind
from jepsen_tpu import testing as jt
from jepsen_tpu.checker.wgl import linearizable as j_linearizable
from jepsen_tpu.history import History as JHistory, Op as JOp
from jepsen_tpu.models import CASRegister as JCASRegister

from jepsen_tpu_torch import independent as ind
from jepsen_tpu_torch.checker import UNKNOWN, check_safe, merge_valid
from jepsen_tpu_torch.checker.wgl import linearizable
from jepsen_tpu_torch.history import History, Op
from jepsen_tpu_torch.models import CASRegister
from jepsen_tpu_torch.util import real_pmap

# one intra-op thread: the tier-1 run puts six workers on eight cores
torch.set_num_threads(1)


def _key_histories():
    hs = {
        0: jt.simulate_register_history(120, n_procs=3, n_vals=5, seed=1,
                                        overlap_p=0.05),
        1: jt.simulate_register_history(120, n_procs=3, n_vals=5, seed=2),
        2: jt.corrupt_one_read(
            jt.simulate_register_history(100, n_procs=5, n_vals=8, seed=15),
            random.Random(15)),
        "k3": jt.simulate_register_history(80, n_procs=3, n_vals=5, seed=4,
                                           crash_p=0.05),
    }
    return hs


def keyed_history(op_cls, kv):
    """Every key's ops with ``[k v]`` values and processes of their own,
    interleaved by time, with a nemesis start/stop pair in the middle."""
    events = []
    for n, (k, h) in enumerate(_key_histories().items()):
        for o in h:
            p = o.process
            proc = p + 100 * (n + 1) if isinstance(p, int) else p
            events.append((o.time, n, op_cls(
                type=o.type, f=o.f, value=kv(k, o.value), process=proc,
                time=o.time)))
    events.sort(key=lambda e: (e[0], e[1]))
    ops = [e[2] for e in events]
    mid = len(ops) // 2
    ops[mid:mid] = [
        op_cls(type="info", f="start", value=None, process="nemesis",
               time=ops[mid].time),
        op_cls(type="info", f="stop", value=None, process="nemesis",
               time=ops[mid].time)]
    return [o.replace(index=i) for i, o in enumerate(ops)]


def _both(tmp_path):
    jh = JHistory(keyed_history(JOp, jind.KV))
    ph = History(keyed_history(Op, ind.KV))
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    ref = jind.checker(j_linearizable(JCASRegister(), backend="tpu")).check(
        {"store-dir": str(jdir)}, jh)
    ours = ind.checker(linearizable(CASRegister(), device="cpu")).check(
        {"store-dir": str(pdir)}, ph)
    return jh, ph, ref, ours, jdir, pdir


def test_verdicts_and_failures_match_jax(tmp_path):
    _, _, ref, ours, _, _ = _both(tmp_path)
    assert ours["valid"] == ref["valid"] is False
    assert ours["failures"] == ref["failures"] == [2]
    assert list(ours["results"]) == list(ref["results"])
    for k, r in ref["results"].items():
        assert ours["results"][k]["valid"] == r["valid"], k
    assert ours["results"][2]["max-linearized-prefix"] == \
        ref["results"][2]["max-linearized-prefix"]


def test_artifacts_match_jax(tmp_path):
    _, _, ref, _, jdir, pdir = _both(tmp_path)
    for k in ref["results"]:
        jd = jdir / ind.DIR / str(k)
        pd = pdir / ind.DIR / str(k)
        assert sorted(os.listdir(pd)) == sorted(os.listdir(jd)) == [
            "history.jsonl", "results.json"]
        assert (pd / "history.jsonl").read_bytes() == \
            (jd / "history.jsonl").read_bytes()
        pr = json.loads((pd / "results.json").read_text())
        jr = json.loads((jd / "results.json").read_text())
        for field in ("valid", "levels", "max-linearized-prefix", "rung",
                      "work", "crash-width", "tiebreak"):
            assert pr.get(field) == jr.get(field), (k, field)


def test_history_keys_and_subhistories_match_jax():
    jh = keyed_history(JOp, jind.KV)
    ph = keyed_history(Op, ind.KV)
    assert ind.history_keys(ph) == jind.history_keys(jh) == {0, 1, 2, "k3"}
    for k in ind.history_keys(ph):
        ps, js = ind.subhistory(k, ph), jind.subhistory(k, jh)
        assert [o.to_dict() for o in ps] == [o.to_dict() for o in js]
        assert sum(o.process == "nemesis" for o in ps) == 2


def test_the_host_backend_checks_each_key(tmp_path):
    """With the host backend there is no batch: every key goes through
    the inner checker, in parallel threads."""
    ph = History(keyed_history(Op, ind.KV))
    out = ind.checker(linearizable(CASRegister(), backend="cpu")).check(
        {}, ph)
    assert out["valid"] is False and out["failures"] == [2]
    assert {r["backend"] for r in out["results"].values()} == {"cpu"}


def test_kv_is_not_a_tuple():
    kv = ind.tuple_(1, (2, 3))
    assert ind.is_tuple(kv) and not ind.is_tuple((1, 2))
    assert list(kv) == [1, (2, 3)] and repr(kv) == "[1 (2, 3)]"
    assert kv == ind.KV(1, (2, 3)) and hash(kv) == hash(ind.KV(1, (2, 3)))


def test_merge_valid_and_check_safe():
    assert merge_valid([True, UNKNOWN, True]) == UNKNOWN
    assert merge_valid([True, UNKNOWN, False]) is False
    assert merge_valid([]) is True

    class Boom:
        def check(self, test, history, opts=None):
            raise RuntimeError("boom")

    out = check_safe(Boom(), {}, [])
    assert out["valid"] == UNKNOWN and "boom" in out["error"]
    assert real_pmap(lambda x: x * 2, range(5)) == [0, 2, 4, 6, 8]
    assert real_pmap(lambda x: x, []) == []
    with pytest.raises(ValueError):
        real_pmap(lambda x: int("x"), [1, 2])


def test_subhistories_equal_each_subhistory():
    ph = keyed_history(Op, ind.KV)
    subs = ind.subhistories(ph)
    assert list(subs) == sorted(ind.history_keys(ph), key=repr)
    for k, h in subs.items():
        assert [o.to_dict() for o in h] == [
            o.to_dict() for o in ind.subhistory(k, ph)]


def test_keyed_history_round_trips():
    from jepsen_tpu_torch.testing import (keyed_history,
                                          simulate_register_history)
    hs = {k: simulate_register_history(40, n_procs=3, seed=k)
          for k in range(3)}
    kh = keyed_history(hs)
    assert len(kh) == sum(len(h) for h in hs.values())
    for k, sub in ind.subhistories(kh).items():
        assert [(o.type, o.f, o.value) for o in sub] == [
            (o.type, o.f, o.value) for o in hs[k]]
