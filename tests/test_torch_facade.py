"""The port's ``LinearizableChecker`` host routing against the JAX
package's facade, on the CPU.

The same histories go through both facades with the same ``algorithm``
and ``max_configs``: the resolved algorithm, and the result's
``valid``, ``configs-explored``, ``max-linearized-prefix``,
``final-states``, ``frontier-op``, ``tiers-escalated``, ``error``,
``engine`` and ``backend`` are equal, with no tolerance (integer
searches). A race's winner depends on thread timing: its verdict is
held equal. The device route with ``device="cpu"``: a history the device
search leaves UNKNOWN (a candidate past its 128-offset window) ends in
the native engine, labelled ``fallback-from: "gpu"``, as the reference's
``backend="tpu"`` ends there labelled ``"tpu"``. On ``valid: false``
with a ``store-dir``, both facades write byte-equal ``linear.svg`` files
and return the same ``counterexample``, ``final-path`` and ``configs``.

The no-op model is the one documented difference: the port's word
kernel packs every op, so its host route is the native engine (``engine:
"native"``); the reference's has no f-codes and takes the object search.
"""

import random

import pytest
import torch

from jepsen_tpu import independent as j_independent
from jepsen_tpu.checker import native as jn
from jepsen_tpu.checker.wgl import LinearizableChecker as JChecker
from jepsen_tpu.history import History as JHistory
from jepsen_tpu.history import Op as JOp
from jepsen_tpu.models import core as J

from jepsen_tpu_torch import independent, testing as pt
from jepsen_tpu_torch.checker import UNKNOWN
from jepsen_tpu_torch.checker import native as pn
from jepsen_tpu_torch.checker.wgl import LinearizableChecker
from jepsen_tpu_torch.history import History
from jepsen_tpu_torch.models import core as P

from test_checker_tpu import random_set_history
from test_linearizable import H, random_register_history

# one intra-op thread: the tier-1 run puts six workers on eight cores
torch.set_num_threads(1)

pytestmark = pytest.mark.skipif(
    not (pn.available() and jn.available()),
    reason="native engine unavailable (no g++?)")

ALGORITHMS = ("auto", "wgl", "linear", "native", "competition")
KEYS = ("valid", "configs-explored", "max-linearized-prefix",
        "final-states", "frontier-op", "tiers-escalated", "error", "engine",
        "backend", "failed-at-event", "failed-op", "final-models")
RENDER = ("counterexample", "final-path", "configs", "counterexample-error")


def _port(jh) -> History:
    return History.of(o.to_dict() for o in jh)


def _jax(h) -> JHistory:
    return JHistory.of(o.to_dict() for o in h)


def _fields(r, keys=KEYS):
    return {k: r.get(k) for k in keys}


def facades(jh, pm, jm, algorithm, max_configs=None, test=None,
            jtest=None):
    """Both facades on the CPU (host search) over one history; their
    resolved algorithms and results held equal. Returns both results."""
    port = LinearizableChecker(pm, backend="cpu", algorithm=algorithm,
                               max_configs=max_configs)
    ref = JChecker(jm, backend="cpu", algorithm=algorithm,
                   max_configs=max_configs)
    assert port.algorithm == ref.algorithm
    got = port.check(test or {}, _port(jh))
    want = ref.check(jtest or {}, jh)
    if algorithm == "competition":
        assert got["valid"] is want["valid"], (got, want)
        assert got["algorithm"] in ("wgl", "linear", "native")
    else:
        assert _fields(got) == _fields(want), (got, want)
    return got, want


def _fixtures():
    """(name, JAX history, port model, JAX model): the packed path for
    the register, mutex and set, and the object path for a FIFO queue
    deeper than its word's 7 slots."""
    rng = random.Random(31)
    out = []
    for i in range(3):
        h = random_register_history(rng, n_procs=4, n_ops=12, n_vals=3,
                                    crash_p=0.1)
        out.append((f"register{i}", h, P.CASRegister(), J.CASRegister()))
    head = pt.simulate_register_history(1000, n_procs=5, n_vals=16, seed=42,
                                        crash_p=0.002)
    out.append(("register1k", _jax(head), P.CASRegister(), J.CASRegister()))
    out.append(("register1k-corrupt",
                _jax(pt.corrupt_model_history(head, "cas-register")),
                P.CASRegister(), J.CASRegister()))
    m = pt.simulate_mutex_history(200, n_procs=3, seed=4, crash_p=0.01)
    out.append(("mutex", _jax(m), P.Mutex(), J.Mutex()))
    out.append(("mutex-corrupt", _jax(pt.corrupt_model_history(m, "mutex")),
                P.Mutex(), J.Mutex()))
    out.append(("set", random_set_history(random.Random(3), n_procs=3,
                                          n_ops=10, n_vals=4),
                P.SetModel(), J.SetModel()))
    rows = []
    for v in range(1, 10):
        rows += [(0, "invoke", "enqueue", v), (0, "ok", "enqueue", v)]
    for v in range(1, 10):
        rows += [(1, "invoke", "dequeue", None), (1, "ok", "dequeue", v)]
    out.append(("fifo-deep", H(*rows), P.FIFOQueue(), J.FIFOQueue()))
    rows[-1] = (1, "ok", "dequeue", 3)
    out.append(("fifo-deep-bad", H(*rows), P.FIFOQueue(), J.FIFOQueue()))
    return out


FIXTURES = _fixtures()


@pytest.mark.parametrize("algorithm", ALGORITHMS)
def test_algorithm_routes_as_the_reference(algorithm):
    """Every algorithm on every fixture: the same engine answers with the
    same result."""
    seen = set()
    for name, jh, pm, jm in FIXTURES:
        got, _ = facades(jh, pm, jm, algorithm)
        seen.add(got["valid"])
        if algorithm in ("auto", "native") and not name.startswith("fifo"):
            assert got["engine"] == "native", (name, got)
        if name.startswith("fifo") or algorithm in ("wgl", "linear"):
            assert "engine" not in got, (name, got)
    assert seen == {True, False}


def test_auto_is_native_where_it_builds(monkeypatch):
    assert LinearizableChecker(P.CASRegister()).algorithm == "native"
    monkeypatch.setattr(pn, "available", lambda: False)
    assert LinearizableChecker(P.CASRegister()).algorithm == "wgl"
    with pytest.raises(ValueError):
        LinearizableChecker(P.CASRegister(), algorithm="bogus")
    with pytest.raises(ValueError):
        LinearizableChecker(P.CASRegister(), backend="tpu")


def test_native_without_an_engine_falls_back_to_python(monkeypatch):
    """``algorithm="native"`` on a host where the engine did not build:
    the Python WGL answers, unlabelled, as the reference's does."""
    monkeypatch.setattr(pn, "_lib", lambda: None)
    jh = FIXTURES[4][1]
    got = LinearizableChecker(P.CASRegister(), backend="cpu",
                              algorithm="native").check({}, _port(jh))
    want = JChecker(J.CASRegister(), backend="cpu",
                    algorithm="wgl").check({}, jh)
    assert _fields(got) == _fields(want) and "engine" not in got


@pytest.mark.parametrize("algorithm", ("auto", "wgl", "linear", "native"))
@pytest.mark.parametrize("budget", (1, 40))
def test_max_configs_packed_and_object_paths(algorithm, budget):
    """A budget on the packed path (the 1,000-op register history) and on
    the object path (the deep FIFO queue)."""
    for name in ("register1k", "register1k-corrupt", "fifo-deep"):
        _, jh, pm, jm = next(f for f in FIXTURES if f[0] == name)
        got, _ = facades(jh, pm, jm, algorithm, max_configs=budget)
        if budget == 1:
            assert got["valid"] is UNKNOWN, (name, got)


def test_max_configs_competition():
    _, jh, pm, jm = FIXTURES[3]
    got, want = facades(jh, pm, jm, "competition", max_configs=1)
    assert got["valid"] is want["valid"] is UNKNOWN


def test_noop_takes_the_native_engine():
    """The port's no-op kernel packs every op: its host route is the
    native engine, where the reference's takes the object search; both
    answer True."""
    jh = FIXTURES[0][1]
    got = LinearizableChecker(P.NoOp(), backend="cpu").check({}, _port(jh))
    want = JChecker(J.NoOp(), backend="cpu").check({}, jh)
    assert got["valid"] is want["valid"] is True
    assert got["engine"] == "native" and "engine" not in want


def test_device_unknown_ends_in_the_native_engine():
    """The far-write history: the device search (on the CPU's plain
    kernels) cannot reach the write 129 offsets past the frontier and
    answers UNKNOWN; under ``auto`` the native engine answers, labelled,
    as the reference's device route does."""
    for value, verdict in ((7, True), (8, False)):
        h = pt.far_write_history(130, value)
        got = LinearizableChecker(P.CASRegister(), device="cpu").check({}, h)
        want = JChecker(J.CASRegister(), backend="tpu").check({}, _jax(h))
        assert got["valid"] is want["valid"] is verdict
        assert got["engine"] == want["engine"] == "native"
        assert got["fallback-from"] == "gpu" and want["fallback-from"] == \
            "tpu"
        assert got["fallback-reason"] == want["fallback-reason"] == \
            "candidate window exceeded"
        assert _fields(got) == _fields(want)


def test_device_route_algorithm_applies_after_the_device():
    """The device route's host fallback follows ``algorithm`` too."""
    h = pt.far_write_history(130, 7)
    got = LinearizableChecker(P.CASRegister(), device="cpu",
                              algorithm="linear").check({}, h)
    assert got["valid"] is True and got["fallback-from"] == "gpu"
    assert "engine" not in got and got["configs-explored"] > 0


def test_deadline_timeout_is_returned_as_it_is():
    """A deadline already past: the device's timeout, no host search."""
    import time
    h = pt.simulate_register_history(200, seed=3)
    r = LinearizableChecker(P.CASRegister(), device="cpu").check(
        {}, h, {"deadline": time.monotonic() - 1.0})
    assert r["valid"] is UNKNOWN and r["error"] == ":info/timeout"
    assert "fallback-from" not in r and "engine" not in r


@pytest.mark.parametrize("name", ["register1k-corrupt", "mutex-corrupt",
                                  "far-write-corrupt"])
def test_linear_svg_equals_the_references(tmp_path, name):
    """On valid:false with a store-dir both facades write byte-equal
    linear.svg files and return the same counterexample keys."""
    if name == "far-write-corrupt":
        # refuted on the native engine's 256-offset tier
        jh = _jax(pt.far_write_history(130, 8))
        pm, jm = P.CASRegister(), J.CASRegister()
    else:
        _, jh, pm, jm = next(f for f in FIXTURES if f[0] == name)
    mine, theirs = tmp_path / "port", tmp_path / "ref"
    got, want = facades(jh, pm, jm, "auto", test={"store-dir": str(mine)},
                        jtest={"store-dir": str(theirs)})
    assert got["valid"] is False
    assert _fields(got, RENDER) == _fields(want, RENDER)
    assert got["counterexample"] == "linear.svg"
    assert got["final-path"] and got["configs"]
    a = (mine / "linear.svg").read_bytes()
    assert a == (theirs / "linear.svg").read_bytes()
    assert a.startswith(b"<svg")


def test_object_path_refutation_draws_nothing(tmp_path):
    _, jh, pm, jm = next(f for f in FIXTURES if f[0] == "fifo-deep-bad")
    got, want = facades(jh, pm, jm, "auto",
                        test={"store-dir": str(tmp_path / "a")},
                        jtest={"store-dir": str(tmp_path / "b")})
    assert got["valid"] is want["valid"] is False
    assert "counterexample" not in got and "counterexample" not in want
    assert not (tmp_path / "a" / "linear.svg").exists()


def test_a_render_failure_never_masks_the_verdict(tmp_path, monkeypatch):
    from jepsen_tpu_torch.checker import counterexample

    def boom(*a):
        raise RuntimeError("render fault")
    monkeypatch.setattr(counterexample, "render_linear_svg", boom)
    _, jh, pm, _ = FIXTURES[4]
    r = LinearizableChecker(pm, backend="cpu").check(
        {"store-dir": str(tmp_path)}, _port(jh))
    assert r["valid"] is False and "render fault" in r[
        "counterexample-error"]
    assert "counterexample" not in r


def test_device_refutation_draws_linear_svg(tmp_path):
    """A refutation by the device search (the CPU's plain kernels) is
    drawn as well, from the device result's frontier states."""
    h = pt.corrupt_model_history(pt.simulate_register_history(
        300, n_procs=5, n_vals=16, seed=11), "cas-register")
    r = LinearizableChecker(P.CASRegister(), device="cpu").check(
        {"store-dir": str(tmp_path)}, h)
    assert r["valid"] is False and r["backend"] == "gpu"
    assert r["counterexample"] == "linear.svg" and r["configs"]
    assert (tmp_path / "linear.svg").read_bytes().startswith(b"<svg")


def test_keyed_cpu_route_runs_the_native_engine_per_key():
    """``independent.checker(linearizable(..., backend="cpu"))``: each key
    through the native engine over real_pmap, key by key equal to the
    reference's."""
    rng = random.Random(41)
    per_key = {k: random_register_history(rng, n_procs=3, n_ops=10,
                                          n_vals=3, crash_p=0.1)
               for k in range(8)}
    ph = pt.keyed_history({k: _port(h) for k, h in per_key.items()})
    jh = JHistory.of(JOp(o.type, o.f, j_independent.tuple_(*o.value),
                         o.process, o.time, o.index) for o in ph)
    got = independent.checker(LinearizableChecker(
        P.CASRegister(), backend="cpu")).check({}, ph)
    want = j_independent.checker(JChecker(
        J.CASRegister(), backend="cpu")).check({}, jh)
    assert got["valid"] == want["valid"]
    assert sorted(got["failures"]) == sorted(want["failures"])
    for k in per_key:
        assert _fields(got["results"][k]) == _fields(want["results"][k])
        assert got["results"][k]["engine"] == "native"


def test_linearizable_is_exported():
    from jepsen_tpu_torch.checker import linearizable
    c = linearizable(P.CASRegister(), "cpu", None, 10, "wgl")
    assert (c.backend, c.max_configs, c.algorithm) == ("cpu", 10, "wgl")
    assert isinstance(c, LinearizableChecker)
