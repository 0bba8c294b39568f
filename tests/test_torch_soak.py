"""The port's randomized differential soak
(``tools/torch_soak_differential.py``) on the CPU: its generators draw
the reference soak's histories, a short soak answers every engine and
the device and keyed rounds, a rigged engine is caught, and no CUDA
means no round at all.

The reference tool runs its soak at import, so its ``gen_history``
(``tools/soak_differential.py:40-74``) is rebuilt here from the JAX
package's generators and its tests' fixtures.
"""

import os
import random
import sys

import pytest
import torch

from jepsen_tpu import models as jmodels
from jepsen_tpu.testing import corrupt_one_read as j_corrupt_one_read
from jepsen_tpu.testing import simulate_register_history as j_simulate
from jepsen_tpu.testing import wide_history as j_wide_history
from jepsen_tpu_torch import accel
from test_checker_tpu import (random_fifo_history as j_fifo,
                              random_queue_history as j_queue,
                              random_set_history as j_set)
from test_linearizable import random_register_history as j_register

# one intra-op thread: the tier-1 run puts six workers on eight cores
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))

import torch_soak_differential as soak  # noqa: E402

SEEDS = 40


def ref_gen_history(fam, r2, n_ops, n_procs):
    """The reference soak's ``gen_history``, over the JAX package."""
    if fam == "stag":
        h = j_simulate(n_ops, n_procs=n_procs, n_vals=4,
                       seed=r2.getrandbits(30),
                       crash_p=r2.choice([0.0, 0.15]),
                       overlap_p=r2.choice([0.02, 0.1]))
        if r2.random() < 0.5:
            h = j_corrupt_one_read(h, r2)
        return h, jmodels.CASRegister()
    if fam == "wide":
        return (j_wide_history(r2.randint(8, 18), r2.randint(1, 2),
                               write_frac=0.4, seed=r2.getrandbits(30),
                               corrupt=r2.random() < 0.3),
                jmodels.CASRegister())
    if fam == "reg":
        return (j_register(r2, n_procs=n_procs, n_ops=n_ops, n_vals=3,
                           crash_p=0.2), jmodels.CASRegister())
    if fam == "set":
        return (j_set(r2, n_procs=min(n_procs, 4), n_ops=n_ops, n_vals=4),
                jmodels.SetModel())
    if fam == "queue":
        return (j_queue(r2, n_procs=min(n_procs, 4), n_ops=n_ops,
                        n_vals=4), jmodels.UnorderedQueue())
    return (j_fifo(r2, n_procs=min(n_procs, 3), n_ops=n_ops),
            jmodels.FIFOQueue())


@pytest.mark.parametrize("fam", soak.FAMILIES + ["wide"])
def test_the_generators_draw_the_references_histories(fam):
    rng = random.Random(fam)
    for _ in range(SEEDS):
        seed = rng.getrandbits(32)
        n_ops, n_procs = rng.randint(6, 16), rng.randint(2, 5)
        got, model = soak.gen_history(fam, random.Random(seed), n_ops,
                                      n_procs)
        want, jmodel = ref_gen_history(fam, random.Random(seed), n_ops,
                                       n_procs)
        assert [o.to_dict() for o in got] == [o.to_dict() for o in want], \
            (fam, seed)
        assert type(model).__name__ == type(jmodel).__name__


def _summary(out):
    import json
    line = next(ln for ln in out.splitlines() if ln.startswith("# soak: "))
    return json.loads(line[len("# soak: "):])


def test_a_short_cpu_soak_answers_every_round_kind(capsys):
    """Rounds until the keyed round (the 13th) has run, within a few
    seconds: no mismatch, the device and keyed rounds answered."""
    rc = soak.main(["3", "--seed", "7", "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.splitlines()[0] == "# soak seed 7 device cpu"
    s = _summary(out)
    assert rc == 0 and s["mismatches"] == 0, out
    assert "DONE " in out and s["rounds"] >= 13
    assert s["keyed"] >= 1 and s["answered"]["keyed-keys"] >= 3
    assert s["answered"]["device"] >= 1
    assert s["answered"]["python"] == s["rounds"] - s["skipped"]


def test_a_rigged_engine_fails_the_soak(monkeypatch, capsys):
    real = soak.native.check_history_native

    def flipped(h, model, max_configs=None):
        r = dict(real(h, model, max_configs=max_configs))
        if r["valid"] in (True, False):
            r["valid"] = not r["valid"]
        return r

    monkeypatch.setattr(soak.native, "check_history_native", flipped)
    rc = soak.main(["60", "--seed", "3", "--device", "cpu"])
    out = capsys.readouterr().out
    mism = [ln for ln in out.splitlines() if ln.startswith("MISMATCH ")]
    assert rc == 1 and len(mism) == soak.MAX_MISMATCHES, out
    assert "'native': " in mism[0] and "DONE" not in out


def test_cuda_without_a_card_runs_no_round(monkeypatch, capsys):
    monkeypatch.delenv("JEPSEN_ACCEL_OK", raising=False)
    monkeypatch.setenv("JEPSEN_ACCEL_PROBE_TIMEOUT", "60")
    accel._reset_probe_for_tests()
    try:
        rc = soak.main(["5", "--seed", "1"])
    finally:
        accel._reset_probe_for_tests()
    captured = capsys.readouterr()
    assert rc == 2
    assert captured.out.splitlines() == ["# soak seed 1 device cuda"]
    assert "does not fall back to the CPU" in captured.err
