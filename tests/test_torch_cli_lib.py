"""The port's command-line library against the reference's
``jepsen_tpu.cli`` on the CPU: the same inputs through both packages.

``parse_concurrency``, ``read_nodes_file`` and ``test_opt_fn`` (equal on
every key the reference's sets; the port's writes no environment),
``run``'s exit codes on the same command maps (an unknown command, bad
arguments, ``--help``, a crash, no command), ``merge_commands``,
``default_commands``' names, ``single_test_cmd`` end to end with
``--device cpu`` (a valid run exits 0 with its store, an invalid one 1,
``--test-count`` repeats, ``--watch`` attaches the status printer), the
command-scoped environment of ``--segment-iters``, ``--profile`` and
``--fleet``, and each suite module's ``main``: the command map it hands
to ``cli.main`` against the reference's, and cockroachdb's ``test`` against
``run --suite cockroachdb``. The dry run of ``chip_smoke.py``'s ``cli
library`` phase is in ``test_torch_cli_lib_smoke.py``.
"""

import importlib
import io
import json
import os
from contextlib import redirect_stderr, redirect_stdout

import pytest
import torch

from jepsen_tpu import cli as j_cli
from jepsen_tpu import core as j_core
from jepsen_tpu import generator as j_gen
from jepsen_tpu.checker import Unbridled as JUnbridled
from jepsen_tpu.checker.wgl import linearizable as j_linearizable
from jepsen_tpu.models import CASRegister as JCASRegister
from jepsen_tpu.testing import atom_test as j_atom_test

from jepsen_tpu_torch import cli, core, store
from jepsen_tpu_torch import generator as gen
from jepsen_tpu_torch.__main__ import main
from jepsen_tpu_torch.checker import Unbridled
from jepsen_tpu_torch.checker.wgl import linearizable
from jepsen_tpu_torch.models import CASRegister
from jepsen_tpu_torch.testing import atom_test

# one intra-op thread: the tier-1 run puts six workers on eight cores
torch.set_num_threads(1)

#: the environment the reference's test options write
ENV = ("JTPU_SEGMENT_ITERS", "JTPU_PROF", "JTPU_FLEET")
#: the keys the reference's test_opt_fn sets
OPT_KEYS = ("nodes", "ssh", "concurrency", "time-limit", "test-count",
            "op-timeout", "segment-iters", "profile", "fleet")
#: suite module -> its main's attribute
SUITE_MAINS = {"aerospike": "main", "chronos": "main", "cockroachdb": "main",
               "consul": "main", "disque": "main", "elasticsearch": "main",
               "etcd": "main", "galera": "main", "hazelcast": "main",
               "mongodb": "main", "rabbitmq": "main", "raftis": "main",
               "sql_family": "tidb_main", "sqlitedb": "main",
               "zookeeper": "main"}


@pytest.fixture
def clean_env(monkeypatch):
    """The environment the reference's options write, unset, and put back
    as it was after the test (``setenv`` records the old value; a bare
    ``delenv`` of an unset variable records nothing to restore)."""
    for var in ENV:
        monkeypatch.setenv(var, "")
        monkeypatch.delenv(var)


def quiet(fn, *args):
    """``fn(*args)`` with its output swallowed: (result, stdout)."""
    out = io.StringIO()
    with redirect_stdout(out), redirect_stderr(io.StringIO()):
        rc = fn(*args)
    return rc, out.getvalue()


# ---------------------------------------------------------------------------
# option processing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("c,n", [("3n", 5), ("10", 5), ("1n", 1), ("0", 3),
                                 ("12n", 2), ("7", 0)])
def test_parse_concurrency(c, n):
    assert cli.parse_concurrency(c, n) == j_cli.parse_concurrency(c, n)


@pytest.mark.parametrize("c", ["3x", "x3", "n", "-1", "", "2.5"])
def test_parse_concurrency_refuses(c):
    for mod in (cli, j_cli):
        with pytest.raises(mod._ArgError):
            mod.parse_concurrency(c, 5)


def test_read_nodes_file(tmp_path):
    f = tmp_path / "nodes"
    f.write_text("h1\n  h2  \n\n\nh3\n")
    assert cli.read_nodes_file(str(f)) == j_cli.read_nodes_file(str(f)) \
        == ["h1", "h2", "h3"]


def _parsed(mod, argv):
    p = mod.Parser(prog="t")
    mod.add_test_opts(p)
    return vars(p.parse_args(argv))


ARGVS = [[], ["--node", "a", "--node", "b", "--concurrency", "3n"],
         ["--concurrency", "7"],
         ["--username", "u", "--password", "p",
          "--strict-host-key-checking", "--ssh-private-key", "k",
          "--ssh-mode", "dummy"],
         ["--time-limit", "5", "--test-count", "3", "--op-timeout", "2.5"],
         ["--segment-iters", "256", "--profile", "--fleet", "2"],
         ["-n", "x", "--concurrency", "1"]]


@pytest.mark.parametrize("argv", ARGVS)
def test_test_opt_fn_equals_the_references(argv, clean_env):
    ours = cli.test_opt_fn(_parsed(cli, argv))
    # the port's options take effect for the command only
    assert not any(var in os.environ for var in ENV)
    theirs = j_cli.test_opt_fn(_parsed(j_cli, argv))
    for k in OPT_KEYS:
        assert ours[k] == theirs[k], k
    assert ours["device"] is None and ours["backend"] == "gpu"
    assert ours["store-root"] == "store"


def test_test_opt_fn_on_the_references_dicts(tmp_path, clean_env):
    f = tmp_path / "nodes"
    f.write_text("h1\nh2\n\nh3\n")
    for opts in ({"node": None, "nodes_file": str(f), "concurrency": "2n"},
                 {"node": ["a", "b"], "concurrency": "1n"},
                 {"node": None, "nodes_file": None, "username": "root",
                  "password": "root", "strict_host_key_checking": False,
                  "ssh_private_key": None, "ssh_mode": None,
                  "concurrency": "1n", "test_count": 1, "time_limit": 60}):
        ours = cli.test_opt_fn(dict(opts))
        theirs = j_cli.test_opt_fn(dict(opts))
        for k in OPT_KEYS:
            assert ours[k] == theirs[k], (opts, k)


def test_test_opt_fn_reads_the_device():
    assert cli.test_opt_fn(_parsed(cli, ["--device", "cpu"]))["device"] \
        == "cpu"
    assert cli.test_opt_fn(_parsed(cli, ["--backend", "cpu"]))["backend"] \
        == "cpu"


def test_the_check_environment_is_the_commands_only(clean_env,
                                                    monkeypatch):
    seen = []
    monkeypatch.setenv("JTPU_PROF", "0")

    def build(opts):
        seen.append({var: os.environ.get(var) for var in ENV})
        raise RuntimeError("stop here")

    rc, _ = quiet(cli.run, cli.single_test_cmd(build),
                  ["test", "--device", "cpu", "--segment-iters", "8",
                   "--profile", "--fleet", "3"])
    assert rc == cli.CRASHED
    assert seen == [{"JTPU_SEGMENT_ITERS": "8", "JTPU_PROF": "1",
                     "JTPU_FLEET": "3"}]
    assert os.environ.get("JTPU_PROF") == "0"
    assert "JTPU_SEGMENT_ITERS" not in os.environ
    assert "JTPU_FLEET" not in os.environ


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

def _maps(mod, atom):
    def boom(opts):
        raise RuntimeError("kaboom")
    return {"single": mod.single_test_cmd(lambda opts: atom()),
            "crash": {"test": {"parser": lambda: mod.Parser(prog="t"),
                               "run": boom}},
            "empty": {}}


@pytest.mark.parametrize("which,argv,rc", [
    ("empty", ["bogus"], 254), ("empty", [], 254),
    ("single", [], 254), ("single", ["bogus"], 254),
    ("single", ["test", "--no-such-flag"], 254),
    ("single", ["test", "--concurrency", "x3"], 254),
    ("single", ["test", "--test-count", "many"], 254),
    ("single", ["test", "--help"], 0),
    ("crash", ["test"], 255), ("crash", ["test", "extra"], 254)])
def test_run_exit_codes_equal_the_references(which, argv, rc):
    ours, ours_out = quiet(cli.run, _maps(cli, atom_test)[which], argv)
    theirs, theirs_out = quiet(j_cli.run, _maps(j_cli, j_atom_test)[which],
                               argv)
    assert ours == theirs == rc
    if argv[-1:] == ["--help"]:
        assert "--concurrency" in ours_out and "--concurrency" in theirs_out
    if argv[:1] != ["test"]:
        # no command, or an unknown one: the usage and the command list
        assert ours_out.splitlines() == theirs_out.splitlines()


def test_main_exits_with_runs_code():
    for argv, rc in (([], 254), (["test", "--help"], 0)):
        with pytest.raises(SystemExit) as e:
            quiet(cli.main, cli.single_test_cmd(lambda o: atom_test()),
                  argv)
        assert e.value.code == rc


def test_merge_commands():
    a = {"x": {"run": 1}, "y": {"run": 2}}
    b = {"y": {"run": 3}, "z": {"run": 4}}
    for mod in (cli, j_cli):
        assert mod.merge_commands() == {}
        assert mod.merge_commands(a, b) == {"x": {"run": 1}, "y": {"run": 3},
                                            "z": {"run": 4}}
    assert set(cli.merge_commands(cli.single_test_cmd(atom_test),
                                  cli.serve_cmd())) \
        == set(j_cli.merge_commands(j_cli.single_test_cmd(j_atom_test),
                                    j_cli.serve_cmd())) == {"test", "serve"}


def test_default_commands_are_the_references():
    ours = cli.default_commands()
    assert set(ours) == set(j_cli.default_commands())
    assert len(ours) == 13
    for spec in ours.values():
        assert callable(spec["parser"]) and callable(spec["run"])
    rc, out = quiet(main, [])
    assert rc == 254
    assert out.splitlines()[1] == "Commands: " + ", ".join(sorted(ours))


def test_a_command_builds_its_own_parser_only(monkeypatch):
    built = []
    cmds = cli.default_commands()
    for name, spec in cmds.items():
        monkeypatch.setitem(spec, "parser",
                            lambda n=name, f=spec["parser"]:
                            built.append(n) or f())
    assert quiet(cli.run, cmds, ["lint", "--help"])[0] == 0
    assert quiet(cli.run, cmds, ["trace", "--help"])[0] == 0
    assert built == ["lint", "trace"]


# ---------------------------------------------------------------------------
# single_test_cmd end to end
# ---------------------------------------------------------------------------

class _AlwaysInvalid(Unbridled):
    def check(self, test, history, opts=None):
        return {"valid": False}


class _JAlwaysInvalid(JUnbridled):
    def check(self, test, history, opts=None):
        return {"valid": False}


def _test_fn(valid, port=True):
    def build(opts):
        if port:
            t = atom_test(**{"nodes": opts["nodes"],
                             "concurrency": opts["concurrency"],
                             "store-root": opts["_root"]})
            t["generator"] = gen.clients(gen.limit(20, gen.cas_gen()))
            t["checker"] = (linearizable(CASRegister(),
                                         device=opts["device"])
                            if valid else _AlwaysInvalid())
        else:
            t = j_atom_test(**{"nodes": opts["nodes"],
                               "concurrency": opts["concurrency"],
                               "store-root": opts["_root"]})
            t["generator"] = j_gen.clients(j_gen.limit(20, j_gen.cas_gen()))
            t["checker"] = (j_linearizable(JCASRegister()) if valid
                            else _JAlwaysInvalid())
        return t
    return build


@pytest.mark.parametrize("valid,rc", [(True, 0), (False, 1)])
def test_single_test_cmd_end_to_end(tmp_path, valid, rc):
    runs = {}
    for name, mod, port in (("port", cli, True), ("ref", j_cli, False)):
        root = str(tmp_path / name)
        cmds = mod.single_test_cmd(
            _test_fn(valid, port), opt_fn=lambda o, r=root: {**o,
                                                             "_root": r})
        argv = ["test", "--ssh-mode", "dummy", "--concurrency", "3"]
        runs[name] = quiet(mod.run, cmds,
                           argv + (["--device", "cpu"] if port else []))[0]
        latest = os.path.join(root, "latest")
        assert os.path.exists(os.path.join(latest, "history.jsonl"))
        with open(os.path.join(latest, "results.json")) as fh:
            assert json.load(fh)["valid"] is valid
    assert runs == {"port": rc, "ref": rc}


def test_single_test_cmd_repeats_and_watches(tmp_path, monkeypatch):
    from jepsen_tpu_torch.obs import observatory
    stops = []
    monkeypatch.setattr(observatory, "live_status_printer",
                        lambda: lambda: stops.append(1))
    root = str(tmp_path)
    cmds = cli.single_test_cmd(_test_fn(True),
                               opt_fn=lambda o: {**o, "_root": root})
    rc, _ = quiet(cli.run, cmds, ["test", "--device", "cpu", "--test-count",
                                  "2", "--watch", "--concurrency", "2"])
    assert rc == 0 and stops == [1]
    runs = [d for d in os.listdir(os.path.join(root, "atom-cas"))
            if d != "latest"]
    assert len(runs) == 2
    for d in runs:
        t = store.load(os.path.join(root, "atom-cas", d))
        assert t["results"]["valid"] is True
    # the first run that is not valid ends the loop with 1
    calls = []
    monkeypatch.setattr(core, "run", lambda t: calls.append(t) or dict(
        t, results={"valid": False}))
    assert quiet(cli.run, cmds, ["test", "--device", "cpu", "--test-count",
                                 "3"])[0] == 1
    assert len(calls) == 1


def test_single_test_cmd_on_the_card_probes_it(monkeypatch):
    from jepsen_tpu_torch import accel

    def refuse(caller="checker", timeout=None):
        raise accel.AcceleratorUnavailable("no CUDA device")
    monkeypatch.setattr(accel, "ensure_usable", refuse)
    built = []
    cmds = cli.single_test_cmd(lambda o: built.append(o) or atom_test())
    assert quiet(cli.run, cmds, ["test"])[0] == cli.CRASHED
    assert built == []


# ---------------------------------------------------------------------------
# the suite modules' mains
# ---------------------------------------------------------------------------

def suite_map(pkg, mod, monkeypatch):
    """The command map ``pkg.suites.mod``'s main hands to ``cli.main``."""
    cli_mod = importlib.import_module(f"{pkg}.cli")
    seen = []
    monkeypatch.setattr(cli_mod, "main",
                        lambda cmds, argv=None: seen.append((cmds, argv)))
    m = importlib.import_module(f"{pkg}.suites.{mod}")
    getattr(m, SUITE_MAINS[mod])(["test"])
    (cmds, argv), = seen
    assert argv == ["test"]
    return cmds


def _option_strings(parser):
    return set(parser._option_string_actions)


@pytest.mark.parametrize("mod", sorted(SUITE_MAINS))
def test_each_suite_main_is_the_references_command_map(mod, monkeypatch):
    ours = suite_map("jepsen_tpu_torch", mod, monkeypatch)
    theirs = suite_map("jepsen_tpu", mod, monkeypatch)
    assert set(ours) == set(theirs) == {"test", "serve"}
    for name in ours:
        p, jp = ours[name]["parser"](), theirs[name]["parser"]()
        assert _option_strings(jp) <= _option_strings(p), \
            (name, _option_strings(jp) - _option_strings(p))
    # the suite's own options: the reference's defaults and choices
    bare = j_cli.Parser(prog="t")
    j_cli.add_test_opts(bare)
    p, jp = ours["test"]["parser"](), theirs["test"]["parser"]()
    for opt in _option_strings(jp) - _option_strings(bare):
        a, b = p._option_string_actions[opt], jp._option_string_actions[opt]
        assert (a.default, sorted(a.choices or ())) == \
            (b.default, sorted(b.choices or ())), (mod, opt)


def _captured(monkeypatch, pkg_core):
    seen = []
    monkeypatch.setattr(pkg_core, "run", lambda t: seen.append(t) or dict(
        t, results={"valid": True}))
    return seen


def test_cockroachdbs_test_is_run_suite_cockroachdb(monkeypatch):
    seen = _captured(monkeypatch, core)
    cmds = suite_map("jepsen_tpu_torch", "cockroachdb", monkeypatch)
    flags = ["--workload", "bank", "--nemesis", "parts", "--device", "cpu",
             "--time-limit", "3"]
    assert quiet(cli.run, cmds, ["test", *flags])[0] == 0
    assert quiet(main, ["run", "--suite", "cockroachdb", *flags])[0] == 0
    test, run = seen
    assert test["name"] == run["name"] == "cockroachdb-bank:parts+blank"
    assert type(test["nemesis"]) is type(run["nemesis"])
    assert type(test["client"]) is type(run["client"])
    # and the reference's test command builds the same name
    j_seen = _captured(monkeypatch, j_core)
    j_cmds = suite_map("jepsen_tpu", "cockroachdb", monkeypatch)
    assert quiet(j_cli.run, j_cmds, ["test", "--workload", "bank",
                                     "--nemesis", "parts"])[0] == 0
    assert j_seen[0]["name"] == test["name"]

