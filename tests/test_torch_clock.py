"""The clock nemeses of the port, held against the reference on the CPU.

The three clock helpers' sources are the reference's byte for byte and
compile with g++; only their usage paths run here (no arguments: exit 1),
since any other call reaches ``settimeofday`` or ``adjtimex``. Under the
dummy control plane the port's ``faketime.wrap``, the helpers' install,
bump, strobe, slew and reset, and ``ClockNemesis``'s setup, ops and
teardown log the reference's commands on the same nodes, and the random
fault generators (``reset_gen``, ``bump_gen``, ``strobe_gen``,
``clock_gen``) draw the reference's ops from the same seed.
"""

import os
import random
import subprocess

import pytest
import torch

from jepsen_tpu import faketime as j_faketime
from jepsen_tpu import generator as jgen
from jepsen_tpu.history import Op as JOp
from jepsen_tpu.nemesis import time as j_nt

from jepsen_tpu_torch import faketime
from jepsen_tpu_torch import generator as pgen
from jepsen_tpu_torch.history import Op
from jepsen_tpu_torch.nemesis import time as nt

from test_torch_generator import drain
from test_torch_suite_substrate import logs_of

# one intra-op thread: the tier-1 run puts six workers on eight cores
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def both_logs(ref_fn, port_fn, responses=None, **over):
    """Each package's logs of the same call under its dummy control
    plane, equal once each package's own helper-source directory (the
    local side of an upload) is read as one name; the port's logs."""
    from jepsen_tpu import control as j_control
    from jepsen_tpu_torch import control

    def norm(logs, res):
        return {n: [c.replace(res, "<resources>") for c in cmds]
                for n, cmds in logs.items()}
    ref = norm(logs_of(j_control, ref_fn, responses, **over),
               j_nt.RESOURCE_DIR)
    got = logs_of(control, port_fn, responses, **over)
    assert norm(got, nt.RESOURCE_DIR) == ref
    assert any(ref.values()), "the call ran no command"
    return got


# ---------------------------------------------------------------------------
# the helpers' sources
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(nt.HELPERS))
def test_the_helper_sources_are_the_references(name):
    src = nt.HELPERS[name]
    assert src == j_nt.HELPERS[name]
    assert os.path.dirname(nt.RESOURCE_DIR) == os.path.join(
        ROOT, "jepsen_tpu_torch", "nemesis")
    with open(os.path.join(nt.RESOURCE_DIR, src), "rb") as a, \
            open(os.path.join(j_nt.RESOURCE_DIR, src), "rb") as b:
        assert a.read() == b.read()


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """The port's three helpers compiled with g++, as the control plane
    compiles them on a node."""
    d = tmp_path_factory.mktemp("clock-helpers")
    bins = {}
    for name, src in nt.HELPERS.items():
        out = str(d / name)
        subprocess.run(["g++", "-O2", "-o", out,
                        os.path.join(nt.RESOURCE_DIR, src)],
                       check=True, capture_output=True)
        bins[name] = out
    return bins


@pytest.mark.parametrize("name,word", [("bump-time", b"usage"),
                                       ("strobe-time", b"delta"),
                                       ("adj-time", b"usage")])
def test_each_helper_compiles_and_gives_its_usage(built, name, word):
    """No arguments: the usage on stderr and exit 1, before any clock
    call."""
    p = subprocess.run([built[name]], capture_output=True, timeout=30)
    assert p.returncode == 1
    assert word in p.stderr.lower()


# ---------------------------------------------------------------------------
# faketime
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("offset,rate", [(-30, 5), (10, 0.5), (0, 1),
                                         (2.7, 3), (-0.4, 2)])
def test_faketime_script_is_the_references(offset, rate):
    assert faketime.script("/usr/bin/db", offset, rate) == \
        j_faketime.script("/usr/bin/db", offset, rate)


@pytest.mark.parametrize("wrapped", [True, False],
                         ids=["already wrapped", "first wrap"])
def test_faketime_wrap_logs_the_reference_commands(wrapped):
    responses = {} if wrapped else {"test -e": (1, "", "")}
    got = both_logs(
        lambda t: j_faketime.wrap(t, "n2", "/opt/db/bin", -5, 2),
        lambda t: faketime.wrap(t, "n2", "/opt/db/bin", -5, 2), responses)
    assert any(c.startswith("mv ") for c in got["n2"]) is not wrapped


# ---------------------------------------------------------------------------
# the helpers over the control plane
# ---------------------------------------------------------------------------

#: (name, the reference's call, the port's call)
CALLS = [
    ("install-all", lambda m, t: m.install(t), None),
    ("install-one", lambda m, t: m.install(t, "n3"), None),
    ("bump", lambda m, t: m.bump_time(t, "n2", -250.5), None),
    ("slew", lambda m, t: m.slew_time(t, "n4", 120), None),
    ("strobe", lambda m, t: m.strobe_time(t, "n5", 200, 10, 2), None),
    ("reset", lambda m, t: m.reset_time(t, "n1"), None),
    ("reset-server", lambda m, t: m.reset_time(t, "n1"),
     {"ntp-server": "time.example"}),
]


@pytest.mark.parametrize("name,call,over", CALLS,
                         ids=[c[0] for c in CALLS])
def test_the_helpers_log_the_reference_commands(name, call, over):
    got = both_logs(lambda t: call(j_nt, t), lambda t: call(nt, t),
                    **(over or {}))
    if name.startswith("install"):
        # every helper uploaded from the port's own resources
        uploads = [c for cmds in got.values() for c in cmds
                   if c.startswith("UPLOAD")]
        assert uploads and all(nt.RESOURCE_DIR in c for c in uploads)


def nop(op_cls, f, value=None):
    return op_cls(type="info", f=f, value=value, process="nemesis", time=0)


#: ClockNemesis ops: f and value
NEMESIS_OPS = [("reset", ["n1", "n5"]),
               ("bump", {"n2": 5000, "n4": -250.5}),
               ("strobe", {"n3": {"delta": 100, "period": 10,
                                  "duration": 2}}),
               ("bump", {}), ("strobe", None)]


@pytest.mark.parametrize("f,value", NEMESIS_OPS,
                         ids=[f"{f}-{i}" for i, (f, _) in
                              enumerate(NEMESIS_OPS)])
def test_the_clock_nemesis_op_logs_the_reference_commands(f, value):
    outs = []

    def run(mod, op_cls):
        def fn(t):
            out = mod.clock_nemesis().invoke(t, nop(op_cls, f, value))
            outs.append((out.type, out.f, out.value))
        return fn
    got = both_logs(run(j_nt, JOp), run(nt, Op)) if value else None
    if not value:
        # an empty plan runs nothing, in both
        from jepsen_tpu import control as j_control
        from jepsen_tpu_torch import control
        assert logs_of(j_control, run(j_nt, JOp)) == \
            logs_of(control, run(nt, Op))
    assert outs[0] == outs[1]
    if got and f == "bump":
        assert any("/opt/jepsen/bump-time 5000" in c for c in got["n2"])
        assert got["n1"] == []


def test_the_clock_nemesis_setup_and_teardown_log_the_reference():
    got = both_logs(lambda t: j_nt.clock_nemesis().setup(t),
                    lambda t: nt.clock_nemesis().setup(t))
    for cmds in got.values():
        assert any("g++ -O2 -o strobe-time" in c for c in cmds)
        assert any("ntpdate" in c for c in cmds)
    both_logs(lambda t: j_nt.clock_nemesis().teardown(t),
              lambda t: nt.clock_nemesis().teardown(t))


def test_an_unknown_clock_op_raises_in_both():
    from test_torch_suite_substrate import dummy_map
    from jepsen_tpu import control as j_control
    from jepsen_tpu_torch import control
    for ctl, mod, op_cls in ((j_control, j_nt, JOp), (control, nt, Op)):
        t = dummy_map()
        with ctl.session_pool(t):
            with pytest.raises(ValueError, match="warp"):
                mod.clock_nemesis().invoke(t, nop(op_cls, "warp"))


# ---------------------------------------------------------------------------
# the fault generators
# ---------------------------------------------------------------------------

TEST = {"concurrency": 3, "nodes": ["n1", "n2", "n3", "n4", "n5"]}


@pytest.mark.parametrize("fn", ["reset_gen", "bump_gen", "strobe_gen"])
@pytest.mark.parametrize("seed", [0, 7, 123])
def test_each_fault_generator_draws_the_references_op(fn, seed):
    random.seed(seed)
    want = [getattr(j_nt, fn)(TEST, 0) for _ in range(20)]
    random.seed(seed)
    got = [getattr(nt, fn)(TEST, 0) for _ in range(20)]
    assert got == want
    random.seed(seed)
    assert nt.random_nonempty_subset(TEST["nodes"]) == \
        (random.seed(seed) or j_nt.random_nonempty_subset(TEST["nodes"]))


@pytest.mark.parametrize("seed", [0, 7, 123])
def test_clock_gen_draws_the_references_ops(seed):
    random.seed(seed)
    want = drain(jgen, j_nt.clock_gen(), ["nemesis"], 60, ("nemesis",))
    random.seed(seed)
    got = drain(pgen, nt.clock_gen(), ["nemesis"], 60, ("nemesis",))
    assert got == want
    assert {o[1] for o in got} == {"reset", "bump", "strobe"}
    assert nt.random_nonempty_subset([]) == []
