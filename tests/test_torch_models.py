"""The port's host modules against the JAX package's: the CAS-register
step (numpy and torch) on an exhaustive grid, packing, the history gate
and the simulators. All comparisons are exact."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jepsen_tpu.analysis.history_lint import (
    MalformedHistoryError as JMalformed, gate_history as j_gate)
from jepsen_tpu.models.core import CAS_REGISTER_KERNEL as J_KERNEL
from jepsen_tpu.models import CASRegister as JCASRegister
from jepsen_tpu.ops.encode import pack_with_init as j_pack
from jepsen_tpu import testing as jt

from jepsen_tpu_torch import testing as pt
from jepsen_tpu_torch.analysis.history_lint import (MalformedHistoryError,
                                                    gate_history)
from jepsen_tpu_torch.history import History, Op
from jepsen_tpu_torch.models import (CAS_REGISTER_KERNEL, CASRegister,
                                     cas_register_step,
                                     cas_register_step_torch)
from jepsen_tpu_torch.ops.encode import pack_with_init


def _grid():
    vals = np.arange(-1, 5, dtype=np.int32)
    fs = np.arange(0, 4, dtype=np.int32)     # read, write, cas, unknown
    s, f, v1, v2 = np.meshgrid(vals, fs, vals, vals, indexing="ij")
    return [x.ravel() for x in (s, f, v1, v2)]


def test_cas_step_torch_matches_jax_numpy_and_jnp():
    s, f, v1, v2 = _grid()
    ref_s, ref_ok = J_KERNEL.step(s, f, v1, v2)
    js, jok = J_KERNEL.step(*(jnp.asarray(x) for x in (s, f, v1, v2)))
    ts, tok = cas_register_step_torch(*(torch.from_numpy(x)
                                        for x in (s, f, v1, v2)))
    assert ts.dtype == torch.int32
    np.testing.assert_array_equal(ts.numpy(), ref_s)
    np.testing.assert_array_equal(tok.numpy(), ref_ok)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))


def test_cas_step_numpy_matches_jax():
    s, f, v1, v2 = _grid()
    ref_s, ref_ok = J_KERNEL.step(s, f, v1, v2)
    ps, pok = cas_register_step(s, f, v1, v2)
    np.testing.assert_array_equal(ps, ref_s)
    np.testing.assert_array_equal(pok, ref_ok)
    # scalars, as the host search steps them
    for i in range(0, s.size, 37):
        a = cas_register_step(int(s[i]), int(f[i]), int(v1[i]), int(v2[i]))
        assert (int(a[0]), bool(a[1])) == (int(ref_s[i]), bool(ref_ok[i]))


def test_readonly_and_f_codes_match():
    assert CAS_REGISTER_KERNEL.f_codes == J_KERNEL.f_codes
    assert CAS_REGISTER_KERNEL.init_state == J_KERNEL.init_state
    s, f, v1, v2 = _grid()
    for i in range(0, s.size, 11):
        args = (int(f[i]), int(v1[i]), int(v2[i]))
        assert CAS_REGISTER_KERNEL.readonly(*args) == J_KERNEL.readonly(*args)


def _port(h):
    return History.of(o.to_dict() for o in h)


HISTORIES = {
    "plain": lambda: jt.simulate_register_history(300, n_procs=5, seed=7),
    "crashed": lambda: jt.simulate_register_history(300, n_procs=6, seed=8,
                                                    crash_p=0.1),
    "staggered": lambda: jt.simulate_register_history(200, seed=9,
                                                      overlap_p=0.1),
    "wide": lambda: jt.wide_history(30, 2, seed=1),
}


@pytest.mark.parametrize("name", sorted(HISTORIES))
def test_pack_matches_jax(name):
    h = HISTORIES[name]()
    jp, _ = j_pack(h, JCASRegister())
    pp, kernel = pack_with_init(_port(h), CASRegister())
    assert kernel is CAS_REGISTER_KERNEL
    for col in ("f", "v1", "v2", "inv", "ret", "process"):
        a, b = getattr(jp, col), getattr(pp, col)
        assert a.dtype == b.dtype and np.array_equal(a, b), col
    assert (pp.n_required, pp.init_state) == (jp.n_required, jp.init_state)
    assert pp.value_table == jp.value_table
    assert [(i.to_dict(), c.to_dict() if c else None) for i, c in pp.ops] \
        == [(i.to_dict(), c.to_dict() if c else None) for i, c in jp.ops]


def test_pack_with_initial_value():
    h = jt.simulate_register_history(50, seed=3)
    jp, _ = j_pack(h, JCASRegister(2))
    pp, _ = pack_with_init(_port(h), CASRegister(2))
    assert pp.init_state == jp.init_state
    assert np.array_equal(pp.v1, jp.v1)


@pytest.mark.parametrize("seed", [0, 1, 5])
def test_simulate_register_history_matches_jax(seed):
    kw = dict(n_procs=4, n_vals=8, seed=seed, crash_p=0.05)
    a = jt.simulate_register_history(400, **kw)
    b = pt.simulate_register_history(400, **kw)
    assert [o.to_dict() for o in a] == [o.to_dict() for o in b]


@pytest.mark.parametrize("corrupt", [False, True])
def test_wide_history_matches_jax(corrupt):
    a = jt.wide_history(60, 3, seed=4, corrupt=corrupt)
    b = pt.wide_history(60, 3, seed=4, corrupt=corrupt)
    assert [o.to_dict() for o in a] == [o.to_dict() for o in b]


def test_corrupt_one_read_matches_jax():
    changed = 0
    for seed in range(30):
        base = jt.simulate_register_history(100, seed=seed)
        a = jt.corrupt_one_read(base, random.Random(seed))
        b = pt.corrupt_one_read(_port(base), random.Random(seed))
        assert [o.to_dict() for o in a] == [o.to_dict() for o in b]
        changed += [o.value for o in a] != [o.value for o in base]
    assert changed > 0


MALFORMED = {
    "unmatched": [Op("ok", "read", 1, process=0)],
    "reuse": [Op("invoke", "write", 1, process=0),
              Op("invoke", "write", 1, process=0)],
    "dangling": [Op("invoke", "write", 1, process=0),
                 Op("invoke", "read", None, process=0)],
    "bad-type": [Op("invoke", "read", None, process=0),
                 Op("done", "read", 1, process=0)],
    "f-mismatch": [Op("invoke", "read", None, process=0),
                   Op("ok", "write", 1, process=0)],
}


@pytest.mark.parametrize("name", sorted(MALFORMED))
def test_history_gate_matches_jax(name):
    ops = MALFORMED[name]
    with pytest.raises(JMalformed) as je:
        j_gate([o.to_dict() for o in ops])
    with pytest.raises(MalformedHistoryError) as pe:
        gate_history(History(ops))
    assert ([f.rule for f in pe.value.findings]
            == [f.rule for f in je.value.findings])


def test_history_gate_passes_crashed_ops():
    h = pt.simulate_register_history(200, seed=2, crash_p=0.1)
    findings = gate_history(h)
    assert findings == [] or all(f.severity != "error" for f in findings)
