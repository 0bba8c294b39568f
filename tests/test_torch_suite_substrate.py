"""The suites' substrate in the port, held against the reference: the
``Net`` backends, the OS modules, the codec, ``report.to``, the RESP
client's wire format and the reconnecting wrapper.

Each command-log test runs the same call through both packages under
their dummy control planes, with the same scripted ``dummy-responses``
and the same seed for the temporary directories' names, and asserts
equal per-node logs. The helpers here (:func:`both_logs`) serve the
suite files too.
"""

import random
import threading

import pytest
import torch

from jepsen_tpu import codec as j_codec
from jepsen_tpu import control as j_control
from jepsen_tpu import net as j_net
from jepsen_tpu import reconnect as j_reconnect
from jepsen_tpu import report as j_report
from jepsen_tpu.os import debian as j_debian
from jepsen_tpu.os import smartos as j_smartos
from jepsen_tpu.os import ubuntu as j_ubuntu
from jepsen_tpu.suites import resp as j_resp

from jepsen_tpu_torch import codec, control, net, reconnect, report
from jepsen_tpu_torch.os import debian, smartos, ubuntu
from jepsen_tpu_torch.suites import resp

# one intra-op thread: the tier-1 run puts six workers on eight cores
torch.set_num_threads(1)

NODES = ["n1", "n2", "n3", "n4", "n5"]


def dummy_map(responses=None, **over):
    t = {"nodes": list(NODES), "concurrency": 5,
         "ssh": {"mode": "dummy", "dummy-responses": dict(responses or {})}}
    t.update(over)
    return t


def logs_of(ctl, fn, responses=None, seed=0, **over):
    """Each node's command log after ``fn(test)`` under ``ctl``'s dummy
    control plane."""
    t = dummy_map(responses, **over)
    random.seed(seed)
    with ctl.session_pool(t):
        fn(t)
        return {n: list(s.log) for n, s in t["_sessions"].items()}


def both_logs(ref_fn, port_fn, responses=None, **over):
    """The reference's and the port's logs of the same call; asserts they
    are equal and not empty, and returns them."""
    ref = logs_of(j_control, ref_fn, responses, **over)
    got = logs_of(control, port_fn, responses, **over)
    assert got == ref
    assert any(ref.values()), "the call ran no command"
    return got


# ---------------------------------------------------------------------------
# Net
# ---------------------------------------------------------------------------

NET_CALLS = {
    "drop": lambda n, t: n.drop(t, "n2", "n1"),
    "heal": lambda n, t: n.heal(t),
    "slow": lambda n, t: n.slow(t),
    "slow-opts": lambda n, t: n.slow(t, {"mean": 100, "variance": 5,
                                         "distribution": "pareto"}),
    "flaky": lambda n, t: n.flaky(t),
    "fast": lambda n, t: n.fast(t),
}


@pytest.mark.parametrize("backend", ["iptables", "ipfilter"])
@pytest.mark.parametrize("call", sorted(NET_CALLS))
def test_net_backends_log_the_reference_commands(backend, call):
    f = NET_CALLS[call]
    ips = {"node-ips": {"n2": "10.0.0.2"}}
    both_logs(lambda t: f(getattr(j_net, backend)("eth1"), t),
              lambda t: f(getattr(net, backend)("eth1"), t), **ips)


@pytest.mark.parametrize("err,raises", [
    ("RTNETLINK answers: No such file or directory", False),
    ("Error: Cannot delete qdisc with handle of zero.", False),
    ("Error: Device does not exist.", True)])
def test_fast_tolerates_what_the_reference_tolerates(err, raises):
    responses = {"qdisc del": (2, "", err)}
    for ctl, mod in ((j_control, j_net), (control, net)):
        t = dummy_map(responses)
        with ctl.session_pool(t):
            if raises:
                with pytest.raises(ctl.RemoteError):
                    mod.iptables().fast(t)
            else:
                mod.iptables().fast(t)


def test_noop_net_runs_nothing():
    t = dummy_map()
    with control.session_pool(t):
        n = net.noop()
        for f in NET_CALLS.values():
            f(n, t)
        assert all(s.log == [] for s in t["_sessions"].values())
    assert isinstance(n, net.Net) and net.TC == j_net.TC


# ---------------------------------------------------------------------------
# OS
# ---------------------------------------------------------------------------

OS_RESPONSES = {
    "debian fresh": {"cat /etc/hosts": "127.0.0.1\tweird\n10.0.0.2 n2",
                     "date +%s": "1000000000",
                     "stat -c": "1",
                     "dpkg --get-selections": "wget\tinstall\ncurl\tinstall"},
    "debian current": {"cat /etc/hosts": "127.0.0.1\tlocalhost",
                       "date +%s": "1000000000", "stat -c": "999999999",
                       "dpkg --get-selections": "\n".join(
                           f"{p}\tinstall" for p in j_debian.BASE_PACKAGES)},
}


@pytest.mark.parametrize("case", sorted(OS_RESPONSES))
@pytest.mark.parametrize("os_name", ["debian", "ubuntu"])
def test_os_setup_logs_the_reference_commands(case, os_name):
    ref_os = {"debian": j_debian, "ubuntu": j_ubuntu}[os_name].os()
    port_os = {"debian": debian, "ubuntu": ubuntu}[os_name].os()
    got = both_logs(lambda t: ref_os.setup(t, "n1"),
                    lambda t: port_os.setup(t, "n1"),
                    OS_RESPONSES[case])
    assert [n for n, cmds in got.items() if cmds] == ["n1"]


@pytest.mark.parametrize("with_net", [False, True])
def test_os_setup_heals_the_net(with_net):
    """With a ``net`` in the test map, setup heals it on every node, as
    the reference's does."""
    resp_ = OS_RESPONSES["debian current"]
    ref = logs_of(j_control, lambda t: j_debian.os().setup(
        dict(t, net=j_net.iptables()) if with_net else t, "n1"), resp_)
    got = logs_of(control, lambda t: debian.os().setup(
        dict(t, net=net.iptables()) if with_net else t, "n1"), resp_)
    assert got == ref
    assert (sum(1 for cmds in got.values() if cmds) == 5) is with_net


@pytest.mark.parametrize("pkgs", ["wget-1.19.1 desc\ncurl-7.55 desc", ""])
def test_smartos_setup_logs_the_reference_commands(pkgs):
    both_logs(lambda t: j_smartos.os().setup(t, "n1"),
              lambda t: smartos.os().setup(t, "n1"), {"pkgin list": pkgs})


DEBIAN_CALLS = {
    "install list": (lambda m, t: m.install(t, "n1", ["wget", "ntpdate"]),
                     {"dpkg --get-selections": "wget\tinstall"}),
    "install pinned": (lambda m, t: m.install(t, "n1", {"db": "2.0",
                                                        "dbd": "2.0"}),
                       {"apt-cache policy": "Installed: 1.0\n"}),
    "uninstall": (lambda m, t: m.uninstall(t, "n1", ["a", "b"]),
                  {"dpkg --get-selections": "b\tinstall"}),
    "add key": (lambda m, t: m.add_key(t, "n1", "hkp://keys", "ABCD"), {}),
    "add repo": (lambda m, t: m.add_repo(t, "n1", "r", "deb http://x y z",
                                         "hkp://keys", "ABCD"),
                 {"stat ": (1, "", "no such file")}),
    "maybe update": (lambda m, t: m.maybe_update(t, "n1"),
                     {"date +%s": "1000000000", "stat -c": "5"}),
    "update": (lambda m, t: m.update(t, "n1"), {}),
}


@pytest.mark.parametrize("call", sorted(DEBIAN_CALLS))
def test_debian_helpers_log_the_reference_commands(call):
    f, responses = DEBIAN_CALLS[call]
    both_logs(lambda t: f(j_debian, t), lambda t: f(debian, t), responses)


def test_debian_queries_answer_as_the_reference():
    responses = {"dpkg --get-selections": "wget\tinstall\ncurl\tdeinstall",
                 "apt-cache policy": "Installed: 3.4\n",
                 "date +%s": "1000", "stat -c": "400"}
    out = []
    for ctl, m in ((j_control, j_debian), (control, debian)):
        t = dummy_map(responses)
        with ctl.session_pool(t):
            out.append((m.installed(t, "n1", ["wget", "curl", "vim"]),
                        m.installed_version(t, "n1", "zookeeper"),
                        m.time_since_last_update(t, "n1")))
    assert out[0] == out[1] == ({"wget"}, "3.4", 600)
    assert debian.BASE_PACKAGES == j_debian.BASE_PACKAGES
    assert ubuntu.PACKAGES == j_ubuntu.PACKAGES
    assert smartos.BASE_PACKAGES == j_smartos.BASE_PACKAGES


# ---------------------------------------------------------------------------
# codec, report, RESP
# ---------------------------------------------------------------------------

VALUES = [None, 0, -7, 3.5, "x", "é", [1, 2], {"a": [1, {"b": None}]},
          True, [], {}]


@pytest.mark.parametrize("value", VALUES, ids=repr)
def test_codec_bytes_equal_the_reference(value):
    b = codec.encode(value)
    assert b == j_codec.encode(value)
    assert codec.decode(b) == j_codec.decode(b)
    assert codec.decode(b) == (value if value is not None else None)


def test_codec_empty_decodes_to_none():
    assert codec.decode(b"") is None and codec.encode(None) == b""


def test_report_to_writes_into_the_store(tmp_path):
    for mod, name in ((report, "port.txt"), (j_report, "ref.txt")):
        with mod.to({"store-dir": str(tmp_path / "d")}, name) as f:
            print("all good")
            print("second", file=f)
    assert (tmp_path / "d" / "port.txt").read_text() == \
        (tmp_path / "d" / "ref.txt").read_text() == "all good\nsecond\n"


@pytest.mark.parametrize("args", [("SET", "k", 5), ("GET", "jepsen"),
                                  ("ADDJOB", "q", b"\x00{}", 100),
                                  ("EXEC",)], ids=repr)
def test_resp_commands_encode_as_the_reference(args):
    assert resp.RespClient.encode_command(args) == \
        j_resp.RespClient.encode_command(args)


class _Replay:
    """A socket stand-in that returns canned reply bytes in small
    pieces."""

    def __init__(self, data: bytes, step: int = 3):
        self.data, self.step, self.sent = data, step, b""

    def recv(self, n):
        out, self.data = self.data[:self.step], self.data[self.step:]
        return out

    def sendall(self, b):
        self.sent += b


REPLIES = b"+OK\r\n:42\r\n$5\r\nhello\r\n$-1\r\n*2\r\n$1\r\na\r\n:1\r\n*-1\r\n"


def test_resp_replies_parse_as_the_reference():
    out = []
    for mod in (resp, j_resp):
        c = mod.RespClient("127.0.0.1", 1)
        c.sock = _Replay(REPLIES)
        out.append([c._read_reply() for _ in range(6)])
        c.sock = _Replay(b"-ERR bad\r\n")
        with pytest.raises(mod.RespError, match="ERR bad"):
            c._read_reply()
    assert out[0] == out[1] == ["OK", 42, b"hello", None, [b"a", 1], None]


# ---------------------------------------------------------------------------
# reconnect (tests/test_aux.py's cases, in both packages)
# ---------------------------------------------------------------------------

MODS = {"port": reconnect, "reference": j_reconnect}


class Conn:
    def __init__(self, made):
        self.closed = False
        made.append(self)


def wrap(mod, made, **kw):
    return mod.wrapper(open=lambda: Conn(made),
                       close=lambda c: setattr(c, "closed", True),
                       name="test-conn", **kw)


@pytest.fixture(params=sorted(MODS))
def mod(request):
    return MODS[request.param]


def test_reconnect_open_is_idempotent_and_lazy(mod):
    made = []
    w = wrap(mod, made)
    assert "closed" in repr(w) and "failures=0" in repr(w)
    with w.with_conn() as c:
        assert isinstance(c, Conn)
    w.open()
    assert w.conn is c and len(made) == 1 and "open" in repr(w)
    w.close()
    assert c.closed and w.conn is None


def test_reconnect_error_reopens_and_rethrows(mod):
    made = []
    w = wrap(mod, made).open()
    c1 = w.conn
    for n in (1, 2, 3):
        with pytest.raises(RuntimeError):
            with w.with_conn():
                raise RuntimeError("down")
        assert w.failures == n and f"failures={n}" in repr(w)
    assert c1.closed and not w.conn.closed and len(made) == 4
    with w.with_conn():
        pass
    assert w.failures == 0


def test_reconnect_concurrent_errors_reopen_once(mod):
    made = []
    w = wrap(mod, made, backoff_base_s=0.0).open()
    barrier = threading.Barrier(4)
    errs = []

    def use():
        try:
            with w.with_conn():
                barrier.wait(timeout=5)
                raise RuntimeError("boom")
        except RuntimeError:
            errs.append(1)

    ts = [threading.Thread(target=use) for _ in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=10)
    assert len(errs) == 4 and len(made) == 2


def test_reconnect_backoff_is_capped_exponential_with_jitter(mod):
    w = wrap(mod, [], backoff_base_s=0.1, backoff_cap_s=0.4)
    assert w.backoff_s() == 0.0
    for n, full in ((1, 0.1), (2, 0.2), (3, 0.4), (9, 0.4)):
        w.failures = n
        for _ in range(8):
            assert full / 2 <= w.backoff_s() <= full


def test_reconnect_backoff_reads_the_environment(mod, monkeypatch):
    monkeypatch.setenv("JEPSEN_RECONNECT_BASE", "0.25")
    monkeypatch.setenv("JEPSEN_RECONNECT_CAP", "0.75")
    w = wrap(mod, [])
    assert (w._backoff_base, w._backoff_cap) == (0.25, 0.75)
    monkeypatch.setenv("JEPSEN_RECONNECT_BASE", "bogus")
    assert wrap(mod, [])._backoff_base == mod.BACKOFF_BASE_S


def test_reconnect_reopen_waits_out_the_backoff(mod):
    import time
    w = wrap(mod, [], backoff_base_s=0.05, backoff_cap_s=0.05).open()
    for _ in range(2):
        t0 = time.time()
        with pytest.raises(RuntimeError):
            with w.with_conn():
                raise RuntimeError("down")
        dt = time.time() - t0
    assert dt >= 0.025
    assert reconnect.BACKOFF_BASE_S == j_reconnect.BACKOFF_BASE_S
    assert reconnect.BACKOFF_CAP_S == j_reconnect.BACKOFF_CAP_S
