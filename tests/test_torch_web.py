"""The port's results browser, held against the JAX package's.

One store (finished, dead, running and recovered runs; a traced and
profiled check of the port on the CPU; a run with no artifacts) is served
by both packages' browsers (``web.serve_background``): the home table's
rows, every route's status code, the listings, files, ``/live`` and
``/fleet`` documents and the explain page are equal; the pages differ
only where they name their own command line, which the comparison maps
to one name. The zip download is streamed in chunks with bounded memory
(the reference's ``tests/test_cli_web.py``), and a ``--profile``d run's
``/trace`` page has the device lane the reference's has no profile for.
"""

import io
import json
import os
import shutil
import urllib.error
import urllib.request
import zipfile

import pytest
import torch

from jepsen_tpu import web as ref_web
from jepsen_tpu_torch import web as port_web

# one intra-op thread: the tier-1 run puts six workers on eight cores
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(ROOT, "examples", "store")

#: (test, timestamp, example run or None, run.state doc or None)
RUNS = [
    ("atom-cas", "20260729T100000.000", "atom-cas",
     {"state": "done", "pid": 1}),
    ("atom-cas", "20260729T110000.000", "atom-cas-lost-update",
     {"state": "done", "pid": 1, "recovered": True}),
    ("local-kv", "20260729T120000.000", "local-kv",
     {"state": "running", "pid": 2 ** 22 + 17}),       # dead: no such pid
    ("local-kv", "20260729T130000.000", None,
     {"state": "running", "pid": os.getpid()}),        # alive
    ("sqlite-register", "20260729T140000.000", "sqlite-register", None),
]
TRACED = ("traced", "20260729T150000.000")


def _traced_run(d: str) -> None:
    """A check of the port's on the CPU, traced and profiled into ``d``:
    ``trace.jsonl``, ``progress.json``, ``profile/`` and the results."""
    from jepsen_tpu_torch import obs
    from jepsen_tpu_torch.checker.gpu import check_history_gpu
    from jepsen_tpu_torch.models import CASRegister
    from jepsen_tpu_torch.testing import simulate_register_history
    h = simulate_register_history(120, 3, seed=7)
    old = os.environ.get("JTPU_PROF")
    os.environ["JTPU_PROF"] = "1"
    obs.start_run(d)
    try:
        res = check_history_gpu(h, CASRegister(), device="cpu")
    finally:
        obs.finish_run()
        if old is None:
            os.environ.pop("JTPU_PROF", None)
        else:
            os.environ["JTPU_PROF"] = old
    with open(os.path.join(d, "results.json"), "w") as f:
        json.dump({"valid": res["valid"]}, f)


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    store = tmp_path_factory.mktemp("store")
    for name, ts, example, state in RUNS:
        d = store / name / ts
        if example is None:
            d.mkdir(parents=True)
        else:
            shutil.copytree(os.path.join(EXAMPLES, example), d)
        if state is not None:
            (d / "run.state").write_text(json.dumps(state))
    traced = store / TRACED[0] / TRACED[1]
    traced.mkdir(parents=True)
    _traced_run(str(traced))
    os.symlink(TRACED[1], store / TRACED[0] / "latest")
    out = {"store": str(store)}
    for name, web in (("ref", ref_web), ("port", port_web)):
        out[name] = web.serve_background(root=str(store))
    yield out
    for name in ("ref", "port"):
        out[name].shutdown()
        out[name].server_close()


def get(server, path):
    """(status, body, headers) of a GET; errors are answers too."""
    url = f"http://127.0.0.1:{server.server_port}{path}"
    try:
        with urllib.request.urlopen(url, timeout=60) as r:
            return r.status, r.read(), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, e.read(), dict(e.headers)


def norm(body: bytes) -> bytes:
    """One name for the two packages' command lines."""
    return (body.replace(b"python -m jepsen_tpu_torch", b"jtpu")
            .replace(b"python -m jepsen_tpu", b"jtpu"))


def test_the_home_table_rows_equal(servers):
    rows = port_web.run_rows(servers["store"])
    assert rows == ref_web.run_rows(servers["store"])
    states = {(n, ts): st for n, ts, _, st in rows}
    assert states[("local-kv", "20260729T120000.000")] == "dead"
    assert states[("local-kv", "20260729T130000.000")] == "running"
    assert states[("atom-cas", "20260729T110000.000")] == "recovered"
    assert states[("atom-cas", "20260729T100000.000")] == "done"
    assert {r[2] for r in rows} >= {True, False}


RUN = "atom-cas/20260729T110000.000"
PATHS = [
    "/", "/metrics", "/nope", "/files/", "/files/atom-cas/",
    f"/files/{RUN}/", f"/files/{RUN}/history.txt",
    f"/files/{RUN}/results.json", f"/files/{RUN}/linear.svg",
    f"/files/{RUN}/missing.txt", f"/files/{RUN}?zip",
    "/files/../../../etc/passwd", "/files/%2e%2e/%2e%2e/etc/passwd",
    "/files/traced/latest/", f"/live/{RUN}", "/live/nope/x",
    "/live/../..", f"/live/{TRACED[0]}/{TRACED[1]}",
    f"/live/{TRACED[0]}/{TRACED[1]}?wait=0.2&since=1e18",
    f"/trace/{TRACED[0]}/{TRACED[1]}", f"/trace/{RUN}", "/trace/../..",
    f"/explain/{RUN}", "/explain/atom-cas/20260729T100000.000",
    "/explain/nope/x", "/explain/../..",
    f"/fleet/{TRACED[0]}/{TRACED[1]}",
    f"/fleet/{TRACED[0]}/{TRACED[1]}?format=json", f"/fleet/{RUN}",
    "/fleet/nope/x",
]
#: pages whose bodies the two browsers answer alike (normalised)
SAME_BODY = {
    "/", "/nope", "/files/", "/files/atom-cas/", f"/files/{RUN}/",
    f"/files/{RUN}/history.txt", f"/files/{RUN}/results.json",
    f"/files/{RUN}/linear.svg", f"/files/{RUN}/missing.txt",
    "/files/../../../etc/passwd", "/files/traced/latest/", f"/live/{RUN}",
    "/live/nope/x", "/live/../..", f"/trace/{RUN}", "/trace/../..",
    f"/explain/{RUN}", "/explain/atom-cas/20260729T100000.000",
    "/explain/nope/x", f"/fleet/{RUN}", "/fleet/nope/x",
}


@pytest.mark.parametrize("path", PATHS)
def test_each_route_answers_as_the_reference(servers, path):
    code, body, hdrs = get(servers["port"], path)
    rcode, rbody, rhdrs = get(servers["ref"], path)
    assert code == rcode, (path, code, rcode)
    assert hdrs.get("Content-Type") == rhdrs.get("Content-Type")
    if path in SAME_BODY:
        assert norm(body) == norm(rbody), path
    if "/live/" in path and code == 200:
        doc, rdoc = json.loads(body), json.loads(rbody)
        assert doc == rdoc
        if TRACED[1] in path:
            assert doc["progress"]["state"] == "done"


def test_the_fleet_document_equals_the_reference(servers):
    path = f"/fleet/{TRACED[0]}/{TRACED[1]}?format=json"
    doc = json.loads(get(servers["port"], path)[1])
    rdoc = json.loads(get(servers["ref"], path)[1])
    assert doc == rdoc and len(doc["hosts"]) == 1


def test_the_trace_page_has_the_profiled_device_lane(servers):
    code, body, _ = get(servers["port"], f"/trace/{TRACED[0]}/{TRACED[1]}")
    text = body.decode()
    assert code == 200 and "device lane" in text
    assert "checker.segment" in text and "prof.capture" in text
    # the device lane comes before the host threads
    assert text.index("device lane") < text.index("<h3>thread ")
    rcode, rbody, _ = get(servers["ref"], f"/trace/{TRACED[0]}/{TRACED[1]}")
    assert rcode == 200 and b"device lane" not in rbody


def _zip_entries(body: bytes) -> dict:
    z = zipfile.ZipFile(io.BytesIO(body))
    assert z.testzip() is None
    return {n: z.read(n) for n in z.namelist()}


def test_the_zip_is_chunked_and_holds_the_references_files(servers):
    code, body, hdrs = get(servers["port"], f"/files/{RUN}?zip")
    rcode, rbody, _ = get(servers["ref"], f"/files/{RUN}?zip")
    assert code == rcode == 200
    assert hdrs.get("Transfer-Encoding") == "chunked"
    assert hdrs.get("Content-Length") is None
    assert hdrs["Content-Type"] == "application/zip" and body[:2] == b"PK"
    entries = _zip_entries(body)
    assert entries == _zip_entries(rbody)
    assert "history.txt" in entries and "run.state" in entries


def _rss_kb() -> int:
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1])
    return 0


def test_the_zip_streams_with_bounded_memory(tmp_path):
    """A 64 MiB incompressible run directory downloads while the process
    (server and client) grows by far less than the archive."""
    run = tmp_path / "big" / "20260730T000001.000"
    run.mkdir(parents=True)
    chunk = os.urandom(1 << 20)
    with open(run / "data.bin", "wb") as f:
        for _ in range(64):
            f.write(chunk)
    server = port_web.serve_background(root=str(tmp_path))
    try:
        rss0 = _rss_kb()
        total = 0
        url = (f"http://127.0.0.1:{server.server_port}"
               f"/files/big/20260730T000001.000?zip")
        with urllib.request.urlopen(url, timeout=120) as r:
            assert r.headers.get("Transfer-Encoding") == "chunked"
            while True:
                piece = r.read(1 << 20)
                if not piece:
                    break
                total += len(piece)
        grown_kb = _rss_kb() - rss0
    finally:
        server.shutdown()
        server.server_close()
    assert total > 60 * (1 << 20)
    assert grown_kb < 24 * 1024, grown_kb


def test_the_traversal_guard_equals_the_reference(tmp_path):
    (tmp_path / "a" / "b").mkdir(parents=True)
    (tmp_path / "ab").mkdir()
    root = str(tmp_path / "a")
    for p in ("", "b", "b/../..", "../ab", "../a", "/etc", "b/./x"):
        path = os.path.join(root, p)
        assert port_web._within(root, path) == ref_web._within(root, path)
    assert not port_web._within(root, os.path.join(root, "../ab"))


def _records():
    return [{"name": "serve.request", "ts": 1000, "dur": 5000, "tid": 1,
             "sid": 1, "trace": "ab" * 16, "id": "r1"},
            {"name": "checker.segment", "ts": 2000, "dur": 1000, "tid": 1,
             "sid": 2, "pid": 1, "phase": "execute"},
            {"name": "serve.gang.join", "ts": 1500, "dur": 0, "tid": 2,
             "sid": 3, "host": "h2"},
            {"name": "trace.sync", "ts": 0, "dur": 0, "tid": 1, "sid": 4}]


def test_the_helper_pages_equal_the_reference():
    stitched = {"records": _records(), "hosts": ["h1", "h2"],
                "method": "trace.sync", "trace-id": "ab" * 16}
    assert norm(port_web.request_trace_html(stitched).encode()) == norm(
        ref_web.request_trace_html(stitched).encode())
    dumps = [{"name": "drain-1700000000000.json", "reason": "drain",
              "wall-ts": 1700000000.0, "spans": 3, "trace-ids": 1,
              "bytes": 99}]
    assert norm(port_web.flightrec_html(dumps).encode()) == norm(
        ref_web.flightrec_html(dumps).encode())
    rows = [{"id": "r1", "tenant": "t", "ts": 1700000000.0, "valid": True,
             "seconds": 0.5, "device-s": 0.1, "hosts": ["local"],
             "error-class": None}]
    assert norm(port_web.trace_find_html(rows).encode()) == norm(
        ref_web.trace_find_html(rows).encode())
    assert "No matching" in port_web.trace_find_html([])
    assert "breaker trip, drain, and SIGTERM" in port_web.flightrec_html([])


def test_the_waterfall_groups_device_records_into_lanes():
    device = [{"name": "expand_kernel", "ts": 2100, "dur": 200,
               "tid": (1 << 40), "sid": 0, "track": "device",
               "lane": "device:0/stream:7", "pid": 2}]
    stats = {"torn": 0, "corrupt": 0}
    page = port_web._waterfall_html(_records() + device, stats)
    assert "device lane device:0/stream:7" in page
    assert "(1 on the device lane)" in page
    assert page.index("device lane") < page.index("<h3>thread 1</h3>")
    # without device records: the reference's page
    assert norm(port_web._waterfall_html(_records(), stats).encode()) == \
        norm(ref_web._waterfall_html(_records(), stats).encode())


def test_a_capture_for_the_card_initialises_cuda_first(monkeypatch):
    """A ``run``'s check is its process's first CUDA work: the capture
    for a search on the card initialises CUDA and traces its activity
    (before, it traced the CPU alone unless CUDA was initialised)."""
    from jepsen_tpu_torch.obs import profiler
    inits = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
    monkeypatch.setattr(torch.cuda, "init", lambda: inits.append(1))
    acts = torch.profiler.ProfilerActivity
    assert profiler._activities(True) == [acts.CPU, acts.CUDA]
    assert inits == [1]
    assert profiler._activities(False) == [acts.CPU] and inits == [1]
