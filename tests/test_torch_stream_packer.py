"""The port's streaming packer, chunk CRC and carry reopening against the
JAX package's (``jepsen_tpu.ops.encode.StreamPacker``, ``stream.chunk_crc``,
``checker.tpu._reopen_carry``), on the same op dicts.

* At every chunk barrier the stable prefix's packed columns, watermark
  and required-op count equal the reference packer's, for the register
  and the mutex; a longer stable prefix extends a shorter one.
* ``close()`` equals the reference's ``pack_history`` and the port's own
  over the whole history, remap and validate included, for the register,
  the mutex and the set; ``online_ok`` agrees for every model.
* ``chunk_crc`` gives the reference's CRC on random chunks.
* ``_reopen_carry`` clears ``done`` as the reference does, and on a
  device carry clears the ``DONE`` lane in place.
"""

import random

import numpy as np
import pytest
import torch

from jepsen_tpu import models as jmodels
from jepsen_tpu.checker import tpu as T
from jepsen_tpu.history import History as JHistory
from jepsen_tpu.models.core import kernel_spec_for as j_kernel_spec_for
from jepsen_tpu.ops import encode as jencode
from jepsen_tpu.stream import chunk_crc as j_chunk_crc

from jepsen_tpu_torch import models as pmodels
from jepsen_tpu_torch import testing
from jepsen_tpu_torch.checker import gpu as G
from jepsen_tpu_torch.history import History
from jepsen_tpu_torch.kernels import search as K
from jepsen_tpu_torch.ops import encode as pencode
from jepsen_tpu_torch.stream import chunk_crc

from test_stream import _conc_ops

# one intra-op thread: the tier-1 run puts six workers on eight cores
torch.set_num_threads(1)

COLS = ("f", "v1", "v2", "inv", "ret", "process")


def _dicts(h):
    return [o.to_dict() for o in h]


#: model name -> (port model, reference model, op dicts of a history)
HISTORIES = {
    "cas-register": (pmodels.CASRegister, jmodels.CASRegister,
                     lambda: _conc_ops(240, 21)),
    "cas-register-crashed": (
        pmodels.CASRegister, jmodels.CASRegister,
        lambda: _dicts(testing.simulate_register_history(
            300, n_procs=5, n_vals=8, seed=4, crash_p=0.02))),
    "mutex": (pmodels.Mutex, jmodels.Mutex,
              lambda: _dicts(testing.simulate_mutex_history(
                  240, n_procs=4, seed=3, crash_p=0.01))),
    "set": (pmodels.SetModel, jmodels.SetModel,
            lambda: _dicts(testing.simulate_set_history(
                120, n_procs=4, seed=5, crash_p=0.02, lost_p=0.0))),
    "unordered-queue": (pmodels.UnorderedQueue, jmodels.UnorderedQueue,
                        lambda: _dicts(testing.simulate_queue_history(
                            160, n_procs=4, seed=6, backlog=4,
                            fifo=False))),
    "fifo-queue": (pmodels.FIFOQueue, jmodels.FIFOQueue,
                   lambda: _dicts(testing.simulate_queue_history(
                       160, n_procs=3, seed=7, backlog=2, fifo=True))),
}


def _packers(name):
    """(port packer, reference packer, op dicts), each packer with its
    package's pack_with_init initial state."""
    pmodel, jmodel, ops = HISTORIES[name]
    out = []
    for model, spec_for, enc in ((pmodel(), pmodels.kernel_spec_for,
                                  pencode),
                                 (jmodel(), j_kernel_spec_for, jencode)):
        kernel = spec_for(model)
        intern = enc._Interner()
        init = (kernel.pack_init(model, intern.id)
                if kernel.pack_init is not None else kernel.init_state)
        out.append(enc.StreamPacker(kernel, init_state=init, intern=intern))
    return out[0], out[1], ops()


def _same(a, b, what):
    for c in COLS:
        assert np.array_equal(getattr(a, c), getattr(b, c)), (what, c)
    assert a.n_required == b.n_required, what
    assert a.init_state == b.init_state, what
    assert list(a.value_table) == list(b.value_table), what


@pytest.mark.parametrize("name", ["cas-register", "cas-register-crashed",
                                  "mutex"])
@pytest.mark.parametrize("chunk", [1, 7, 32])
def test_every_barrier_packs_the_references_stable_prefix(name, chunk):
    port, ref, ops = _packers(name)
    prev = None
    for i in range(0, len(ops), chunk):
        part = ops[i:i + chunk]
        port.feed_ops(part)
        ref.feed_ops(part)
        assert port.watermark == ref.watermark, i
        assert port.stable_required == ref.stable_required, i
        assert port.n_events == ref.n_events == i + len(part)
        p = port.stable_packed()
        _same(p, ref.stable_packed(), f"barrier at {i}")
        if prev is not None:
            # the longer stable prefix extends the shorter one's columns
            for c in COLS:
                assert np.array_equal(getattr(p, c)[:prev.n],
                                      getattr(prev, c)), (i, c)
        prev = p
    assert port.online_ok and ref.online_ok


@pytest.mark.parametrize("name", sorted(HISTORIES))
def test_close_is_pack_history_over_the_whole_stream(name):
    port, ref, ops = _packers(name)
    assert port.online_ok == ref.online_ok
    assert port.online_ok == (name in ("cas-register",
                                       "cas-register-crashed", "mutex"))
    for i in range(0, len(ops), 25):
        port.feed_ops(ops[i:i + 25])
        ref.feed_ops(ops[i:i + 25])
    pmodel, jmodel, _ = HISTORIES[name]
    whole = port.close()
    assert port.close() is whole
    assert port.n_events == len(ops)
    _same(whole, ref.close(), "close against the reference's close")
    _same(whole, pencode.pack_with_init(History.of(ops), pmodel())[0],
          "close against the port's pack_history")
    _same(whole, jencode.pack_with_init(JHistory.of(ops), jmodel())[0],
          "close against the reference's pack_history")
    with pytest.raises(ValueError):
        port.feed_ops(ops[:1])
    if not port.online_ok:
        with pytest.raises(ValueError):
            port.stable_packed()


def test_a_crash_pins_the_watermark_and_an_open_invoke_holds_it():
    port, ref, _ = _packers("cas-register")
    for packer in (port, ref):
        packer.feed_ops([{"type": "invoke", "f": "write", "value": 1,
                          "process": 0}])
        assert packer.watermark == 0
        packer.feed_ops([{"type": "ok", "f": "write", "value": 1,
                          "process": 0}])
        assert (packer.watermark, packer.stable_required) == (2, 1)
        packer.feed_ops([{"type": "invoke", "f": "write", "value": 2,
                          "process": 1},
                         {"type": "info", "f": "write", "value": 2,
                          "process": 1},
                         {"type": "invoke", "f": "read", "value": None,
                          "process": 0},
                         {"type": "ok", "f": "read", "value": 2,
                          "process": 0}])
        assert (packer.watermark, packer.stable_required) == (2, 1)
        p = packer.close()
        assert (p.n, p.n_required) == (3, 2)


def test_chunk_crc_is_the_references():
    rng = random.Random(3)
    for trial in range(200):
        ops = _conc_ops(rng.randint(0, 40), trial)
        for o in ops:
            if rng.random() < 0.2:
                o["value"] = [rng.randint(0, 9), rng.randint(0, 9)]
            if rng.random() < 0.1:
                o["extra"] = {"b": rng.random(), "a": "ü"}
        assert chunk_crc(ops) == j_chunk_crc(ops), ops
    assert chunk_crc([]) == j_chunk_crc([])


@pytest.mark.parametrize("nr", [0, 1, 57])
def test_reopen_carry_is_the_references(nr):
    rng = np.random.default_rng(nr)
    carry = G._carry0_host(32, 32, 8, 3, 10, stats_rows=30)
    carry = (rng.integers(0, 50, 32, dtype=np.int32),) + carry[1:4] + (
        rng.random(32) < 0.5, np.bool_(True), np.bool_(False),
        np.bool_(True), np.int32(41), np.int32(17)) + carry[10:]
    mine, theirs = G._reopen_carry(carry, nr), T._reopen_carry(carry, nr)
    assert len(mine) == len(theirs) == len(carry)
    for a, b in zip(mine, theirs):
        assert np.array_equal(np.asarray(a), np.asarray(b))
        assert np.asarray(a).dtype == np.asarray(b).dtype
    assert bool(mine[5]) is (nr == 0)
    # the device form: the DONE lane of the same tensor, nothing else
    from jepsen_tpu_torch import interop
    dev = interop.carry_from_numpy(carry, "cpu")
    scal = dev.scal
    before = scal.clone()
    assert G._reopen_carry(dev, nr) is dev and dev.scal is scal
    assert int(scal[0, K.DONE]) == int(nr == 0)
    before[0, K.DONE] = int(nr == 0)
    assert (scal == before).all()
    back = interop.carry_to_numpy(dev)
    for a, b in zip(back, theirs):
        assert np.array_equal(np.asarray(a), np.asarray(b))
