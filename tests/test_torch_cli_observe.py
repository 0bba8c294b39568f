"""The port's observing commands against the reference's on the CPU:
``watch``, ``trace export|summary|request|find``, the ``serve`` flags,
``stream --store`` and ``run --watch``.

A daemon started as ``python -m jepsen_tpu_torch serve --check-daemon
--device cpu --batch-max 2 --auth-token T`` (with ``JTPU_SERVE_BATCH_MAX``
and ``JTPU_SERVE_TOKEN`` set to other values, which the flags beat)
answers same-bucket requests in gangs of at most 2, refuses a POST
without the token with 401, and takes a stored run through ``stream
--store``; then each ``trace`` command over its directory prints what the
reference's command prints over it, as do ``watch`` over a run
directory and ``stitch_request``/``merge`` over two host directories.
"""

import io
import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from contextlib import redirect_stderr, redirect_stdout

import pytest
import torch

from jepsen_tpu import cli as j_cli
from jepsen_tpu.obs import fleet as j_fleet

from jepsen_tpu_torch import journal as journal_ns
from jepsen_tpu_torch import serve as S
from jepsen_tpu_torch import store
from jepsen_tpu_torch.__main__ import main
from jepsen_tpu_torch.cli import serve_cmd, serve_config
from jepsen_tpu_torch.obs import fleet, observatory

from test_torch_gang import bad_read, conc_ops

# one intra-op thread: the tier-1 run puts six workers on eight cores
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOKEN = "sesame"
#: same-bucket requests POSTed at once; the gangs hold at most BATCH_MAX
GANG_REQUESTS, BATCH_MAX = 6, 2


def port(argv):
    """(rc, stdout) of the port's command line."""
    buf = io.StringIO()
    with redirect_stdout(buf), redirect_stderr(io.StringIO()):
        rc = main(argv)
    return rc, buf.getvalue()


def serve_opts(argv):
    """The options ``serve``'s parser makes of ``argv``."""
    return vars(serve_cmd()["serve"]["parser"]().parse_args(argv))


def reference(argv):
    """(rc, stdout) of the reference's command line."""
    buf = io.StringIO()
    with redirect_stdout(buf), redirect_stderr(io.StringIO()):
        rc = j_cli.run(j_cli.default_commands(), argv)
    return rc, buf.getvalue()


def http(base, method, path, doc=None, token=TOKEN):
    req = urllib.request.Request(
        base + path, method=method,
        data=None if doc is None else json.dumps(doc).encode(),
        headers={"Content-Type": "application/json"})
    if token:
        req.add_header("Authorization", f"Bearer {token}")
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, json.loads(r.read() or b"{}")
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def stored_run(root):
    """A small atom-test run checked on the CPU: its store directory."""
    from jepsen_tpu_torch import core
    from jepsen_tpu_torch import generator as gen
    from jepsen_tpu_torch.checker.wgl import linearizable
    from jepsen_tpu_torch.models import CASRegister
    from jepsen_tpu_torch.testing import atom_test
    t = core.run(atom_test(
        checker=linearizable(CASRegister(), device="cpu"),
        generator=gen.clients(gen.limit(200, gen.cas_gen())),
        concurrency=4, name="atom-observe", **{"store-root": root}))
    assert t["results"]["valid"] is True
    return t["store-dir"]


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """The daemon's directory after a burst of gang requests, one request
    past its deadline, a refused POST and a ``stream --store``; with what
    each step answered."""
    tmp = tmp_path_factory.mktemp("observe")
    serve_dir = str(tmp / "serve")
    run_dir = stored_run(str(tmp / "store"))
    env = dict(os.environ, PYTHONPATH=ROOT, JTPU_SERVE_BATCH_MAX="8",
               JTPU_SERVE_TOKEN="not-the-flag")
    proc = subprocess.Popen(
        [sys.executable, "-m", "jepsen_tpu_torch", "serve",
         "--check-daemon", "--host", "127.0.0.1", "--port", "0",
         "--serve-dir", serve_dir, "--device", "cpu", "--batch-max",
         str(BATCH_MAX), "--batch-wait-ms", "300", "--auth-token", TOKEN],
        cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.DEVNULL, text=True)
    out = {"dir": serve_dir, "run": run_dir}
    try:
        line = proc.stdout.readline()
        assert line.startswith("Listening on http://127.0.0.1:"), line
        base = "http://127.0.0.1:" + line.split(":")[2].split("/")[0]
        out["unauthorized"] = http(base, "POST", "/check",
                                   {"history": conc_ops(40, 1)}, token=None)
        out["wrong-token"] = http(base, "POST", "/check",
                                  {"history": conc_ops(40, 1)},
                                  token="not-the-flag")
        hists = [conc_ops(160, 10 + i) for i in range(GANG_REQUESTS)]
        hists[1] = bad_read(hists[1])
        ids = []
        for i, h in enumerate(hists):
            code, body = http(base, "POST", "/check",
                              {"history": h, "tenant": f"t{i % 2}"})
            assert code == 202, body
            ids.append(body["id"])
        code, body = http(base, "POST", "/check",
                          {"history": conc_ops(2000, 99), "tenant": "late",
                           "deadline-s": 0.001})
        assert code == 202, body
        ids.append(body["id"])
        docs = {}
        for rid in ids:
            deadline = time.monotonic() + 120
            while time.monotonic() < deadline:
                code, doc = http(base, "GET", f"/check/{rid}")
                if code == 200 and doc.get("state") == "done":
                    docs[rid] = doc
                    break
                time.sleep(0.05)
        assert len(docs) == len(ids)
        out["ids"], out["docs"], out["late"] = ids[:-1], docs, ids[-1]
        out["stream"] = port(["stream", "--url", base, "--store", run_dir,
                              "--auth-token", TOKEN, "--chunk", "50",
                              "--poll", "0.05"])
        out["stream-history"] = port(
            ["stream", "--url", base, "--history",
             os.path.join(run_dir, "history.jsonl"), "--auth-token", TOKEN,
             "--chunk", "50", "--poll", "0.05"])
        assert http(base, "POST", "/drain")[0] == 200
        out["rc"] = proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        proc.stdout.close()
    return out


# ---------------------------------------------------------------------------
# the serve flags
# ---------------------------------------------------------------------------

def test_the_daemon_gangs_at_most_batch_max_and_drains(served):
    assert served["rc"] == 0
    records, _ = journal_ns.read_json_records(
        os.path.join(served["dir"], S.WAL_NAME))
    gangs = [r["ids"] for r in records if r.get("event") == "gang"]
    assert gangs and max(len(g) for g in gangs) == BATCH_MAX, gangs
    sizes = [d["result"]["serve"].get("gang", {}).get("size", 1)
             for d in served["docs"].values()]
    assert max(sizes) <= BATCH_MAX and BATCH_MAX in sizes, sizes
    verdicts = [served["docs"][rid]["result"]["valid"]
                for rid in served["ids"]]
    assert verdicts == [True, False] + [True] * (GANG_REQUESTS - 2)


def test_the_token_flag_wins_and_a_post_without_it_gets_401(served):
    assert served["unauthorized"][0] == 401
    assert served["wrong-token"][0] == 401


def test_each_flag_beats_its_variable(monkeypatch):
    for var, value in (("JTPU_SERVE_BATCH_MAX", "8"),
                       ("JTPU_SERVE_BATCH_WAIT_MS", "5"),
                       ("JTPU_SERVE_TOKEN", "env"),
                       ("JTPU_ENGINE_MAX_BUCKETS", "9"),
                       ("JTPU_SERVE_RATE", "7"),
                       ("JTPU_SERVE_BACKEND", "gpu")):
        monkeypatch.setenv(var, value)
    opts = serve_opts(
        ["--check-daemon", "--batch-max", "2", "--batch-wait-ms",
         "50", "--auth-token", "T", "--engine-max-buckets", "3",
         "--rate-limit", "1.5", "--serve-backend", "cpu"])
    cfg = serve_config(opts)
    assert (cfg.batch_max, cfg.batch_enabled, cfg.batch_wait_ms,
            cfg.auth_token, cfg.engine_max_buckets, cfg.rate_limit,
            cfg.backend) == (2, True, 50.0, "T", 3, 1.5, "cpu")
    env_only = serve_config(serve_opts(["--check-daemon"]))
    assert (env_only.batch_max, env_only.auth_token,
            env_only.engine_max_buckets) == (8, "env", 9)
    off = serve_config(serve_opts(["--check-daemon", "--batch-max", "1"]))
    assert off.batch_enabled is False


def test_serve_refuses_the_fleet_and_takes_a_compile_cache(tmp_path,
                                                           monkeypatch):
    from jepsen_tpu_torch.kernels import build
    # --fleet N places the gangs on N fleet hosts
    cfg = serve_config(serve_opts(["--check-daemon", "--fleet", "2"]))
    assert cfg.fleet_hosts == 2 and cfg.fleet_enabled
    monkeypatch.setattr(build, "BUILD_DIR", build.BUILD_DIR)
    serve_config(serve_opts(["--check-daemon", "--compile-cache",
                             str(tmp_path)]))
    assert build.BUILD_DIR == str(tmp_path)
    assert build.library_path().startswith(str(tmp_path))


# ---------------------------------------------------------------------------
# stream --store
# ---------------------------------------------------------------------------

def test_stream_store_reaches_the_verdict_of_history_and_analyze(served):
    rc, text = served["stream"]
    rc2, text2 = served["stream-history"]
    res = json.loads(text[text.index("\n{") + 1:])
    res2 = json.loads(text2[text2.index("\n{") + 1:])
    # the streamed levels depend on where the barriers fell (one more for
    # each barrier at which the next required op is forced), so the two
    # streams are held to the verdict and to the offline levels as a floor
    rc3, out = port(["analyze", "--store", served["run"], "--device",
                     "cpu"])
    again = json.loads(out[out.index("\n{") + 1:])
    assert rc == rc2 == rc3 == 0
    assert res["valid"] is res2["valid"] is again["valid"] is True
    assert min(res["levels"], res2["levels"]) >= again["levels"]


def test_stream_without_a_store_or_history_uses_the_latest(tmp_path,
                                                           monkeypatch):
    monkeypatch.chdir(tmp_path)
    assert port(["stream", "--url", "http://127.0.0.1:9"])[0] == 254
    assert port(["stream", "--store", str(tmp_path / "nope")])[0] == 254


# ---------------------------------------------------------------------------
# trace, against the reference's command on the same directory
# ---------------------------------------------------------------------------

TRACE_CASES = {
    "summary": ["trace", "summary"],
    "summary top": ["trace", "summary", "--top", "3"],
    "summary json": ["trace", "summary", "--format", "json"],
    "export chrome": ["trace", "export", "--format", "chrome"],
    "export jsonl": ["trace", "export", "--format", "jsonl"],
    "find": ["trace", "find"],
    "find tenant": ["trace", "find", "--tenant", "t1"],
    "find device": ["trace", "find", "--min-device-s", "0"],
    "find device json": ["trace", "find", "--min-device-s", "0",
                         "--format", "json"],
    "find error class": ["trace", "find", "--error-class", "wedge"],
    "find none": ["trace", "find", "--min-device-s", "1e9"],
}


@pytest.mark.parametrize("case", sorted(TRACE_CASES))
def test_each_trace_command_is_the_references(served, case):
    argv = TRACE_CASES[case] + ["--store", served["dir"]]
    got, ref = port(argv), reference(argv)
    assert got == ref
    assert got[0] == 0 and got[1].strip()


def test_trace_find_lists_the_gang_with_device_seconds(served):
    rc, text = port(["trace", "find", "--min-device-s", "0", "--format",
                     "json", "--store", served["dir"]])
    rows = {r["id"]: r for r in json.loads(text)["requests"]}
    assert set(served["ids"]) <= set(rows)
    assert all(rows[rid]["device-s"] > 0 for rid in served["ids"])
    rc, text = port(["trace", "find", "--error-class", "wedge", "--format",
                     "json", "--store", served["dir"]])
    assert [r["id"] for r in json.loads(text)["requests"]] == \
        [served["late"]]


@pytest.mark.parametrize("fmt", ["text", "json", "chrome", "jsonl"])
def test_trace_request_is_the_references(served, fmt):
    records, _ = journal_ns.read_json_records(
        os.path.join(served["dir"], S.WAL_NAME))
    gang = next(r["ids"] for r in records if r.get("event") == "gang")
    argv = ["trace", "request", gang[0], "--format", fmt, "--store",
            served["dir"]]
    got, ref = port(argv), reference(argv)
    assert got == ref and got[0] == 0
    if fmt == "text":
        lines = got[1].splitlines()
        assert "record(s) across 1 process(es)" in lines[0]
        assert any("serve.verdict" in ln for ln in lines)
        assert any("checker.device.batch-segment" in ln for ln in lines)


def test_trace_refuses_what_the_reference_refuses(served, tmp_path):
    for argv in (["trace", "request", "--store", served["dir"]],
                 ["trace", "request", "nope", "--store", served["dir"]],
                 ["trace", "summary", "--store", str(tmp_path)],
                 ["trace", "summary", "--store", str(tmp_path / "no")]):
        assert port(argv) == reference(argv)
        assert port(argv)[0] == 254


def _host_dir(root, name, shift_ns, trace_id):
    """A host directory whose trace holds one request's spans and a sync
    anchor, its clock ``shift_ns`` off the first host's."""
    d = os.path.join(root, name)
    os.makedirs(d)
    recs = [{"name": "trace.sync", "ts": 10 + shift_ns, "dur": 0, "tid": 1,
             "sid": 1, "wall_ns": 1_000_000_000},
            {"name": "checker.segment", "ts": 500 + shift_ns, "dur": 300,
             "tid": 1, "sid": 2, "trace": trace_id, "phase": "execute"},
            {"name": "core.run", "ts": 100 + shift_ns, "dur": 2000,
             "tid": 2, "sid": 3},
            {"name": "checker.segment", "ts": 900 + shift_ns, "dur": 50,
             "tid": 1, "sid": 4, "trace": "f" * 32}]
    with open(os.path.join(d, "trace.jsonl"), "w") as f:
        for r in recs:
            f.write(json.dumps(r) + "\n")
        f.write('{"name": "torn')
    with open(os.path.join(d, "progress.json"), "w") as f:
        json.dump({"level": 7, "level-budget": 100, "state": "running",
                   "frontier-rows": 3}, f)
    return d


def test_stitch_and_merge_over_two_hosts_are_the_references(tmp_path):
    tid = "a" * 32
    a = _host_dir(str(tmp_path), "h1", 0, tid)
    b = _host_dir(str(tmp_path), "h2", 7_000, tid)
    got = fleet.stitch_request(None, tid, extra_dirs=[a, b])
    ref = j_fleet.stitch_request(None, tid, extra_dirs=[a, b])
    assert got == ref and got["method"] == "wall-clock"
    assert len(got["records"]) == 2 and got["hosts"] == ["h1", "h2"]
    merged, jmerged = fleet.merge([a, b]), j_fleet.merge([a, b])
    assert {k: v for k, v in merged.items() if k != "summary"} == \
        {k: v for k, v in jmerged.items() if k != "summary"}
    assert fleet.format_fleet(merged) == j_fleet.format_fleet(jmerged)
    assert fleet.to_chrome(merged) == j_fleet.to_chrome(jmerged)
    argv = ["watch", "--once", "--fleet", a, b]
    assert port(argv) == reference(argv)
    assert port(["watch", "--once", "--fleet", str(tmp_path / "x")])[0] \
        == 254


# ---------------------------------------------------------------------------
# watch
# ---------------------------------------------------------------------------

PROGRESS = [
    None,
    {"level": 12, "level-budget": 1000, "frontier-rows": 40,
     "segments": 2, "segments-est": 9, "levels-per-s": 250.5,
     "configs-per-s": 12345.6, "eta-s": 3.9, "dup-rate": 0.25,
     "trunc-losses": 2, "state": "running", "backend": "gpu"},
    {"level": 80, "level-budget": 1000, "state": "done", "valid": True},
    {"serve": {"queue-depth": 3, "inflight": 1, "completed": 9,
               "rejected": 2, "oldest-inflight-s": 0.5, "batches": 4,
               "max-batch": 2, "streams": 1, "stream-checked": 10,
               "stream-ops": 20}, "state": "serving"},
]


@pytest.mark.parametrize("i", range(len(PROGRESS)))
@pytest.mark.parametrize("state", [None, "running", "done"])
def test_watch_once_prints_the_references_line(tmp_path, i, state):
    d = str(tmp_path / "run")
    os.makedirs(d)
    if PROGRESS[i] is not None:
        with open(os.path.join(d, observatory.PROGRESS_NAME), "w") as f:
            json.dump(PROGRESS[i], f)
    if state:
        store.write_state(d, state)
    argv = ["watch", "--once", "--store", d]
    got, ref = port(argv), reference(argv)
    assert got == ref and got[0] == 0
    assert got[1].startswith(("# watch:", "# serve:"))


def test_watch_follows_until_the_run_is_done(tmp_path):
    d = str(tmp_path / "run")
    os.makedirs(d)
    store.write_state(d, "running")
    with open(os.path.join(d, observatory.PROGRESS_NAME), "w") as f:
        json.dump(PROGRESS[1], f)

    def finish():
        time.sleep(0.5)
        store.write_state(d, "done")
    t = threading.Thread(target=finish)
    t.start()
    t0 = time.monotonic()
    rc, text = port(["watch", "--store", d, "--interval", "0.05"])
    t.join()
    lines = text.splitlines()
    assert rc == 0 and 0.4 < time.monotonic() - t0 < 30
    assert len(lines) > 2 and lines[-1].endswith("[done]")
    assert all(ln.startswith("# watch: level 12/1000") for ln in lines)
    assert port(["watch", "--store", str(tmp_path / "no")])[0] == 254


# ---------------------------------------------------------------------------
# run --watch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("suite,want,limit", [
    ("local-kv", 0, ["--time-limit", "2"]),
    # its fixed schedule ends by itself, in about 3 s
    ("local-kv-unsafe", 1, [])])
def test_run_watch_exits_with_the_runs_code(tmp_path, suite, want, limit):
    """``run --watch`` in its own process (the local-kv nodes are real
    processes), its ticker on stderr."""
    p = subprocess.run(
        [sys.executable, "-m", "jepsen_tpu_torch", "run", "--suite", suite,
         "--device", "cpu", "--watch", *limit,
         "--store-root", str(tmp_path / "store")],
        cwd=str(tmp_path), env=dict(os.environ, PYTHONPATH=ROOT),
        capture_output=True, text=True, timeout=300)
    assert p.returncode == want, p.stderr[-2000:]
    lines = [ln for ln in p.stderr.splitlines()
             if ln.startswith("# watch:")]
    assert lines and "level" in lines[-1], p.stderr[-2000:]
    if suite == "local-kv-unsafe":
        # --fleet 2: the check under the elastic fleet, the same verdict
        p = subprocess.run(
            [sys.executable, "-m", "jepsen_tpu_torch", "run", "--suite",
             suite, "--device", "cpu", "--fleet", "2",
             "--store-root", str(tmp_path / "fleet")],
            cwd=str(tmp_path), env=dict(os.environ, PYTHONPATH=ROOT),
            capture_output=True, text=True, timeout=300)
        assert p.returncode == want, p.stderr[-2000:]

