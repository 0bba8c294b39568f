"""Persistence: test artifacts on disk.

Rebuild of jepsen.store (jepsen/src/jepsen/store.clj). Layout mirrors the
reference's ``store/<name>/<timestamp>/`` scheme with ``latest`` symlinks
(store.clj:113-142, 235-247):

    store/
      <test-name>/
        <YYYYMMDDTHHMMSS.mmm>/
          jepsen.log        — framework log for this run (store.clj:304-326)
          history.txt       — human-readable op log
          history.jsonl     — machine-readable history (reference: .edn)
          test.json         — serializable test map (store.clj:155-163 drops
                              functions/protocol impls)
          results.json      — checker output (store.clj:259-263)
        latest -> <timestamp>
      latest -> <test-name>/<timestamp>

Two-phase saving preserved: save_1 after the run (history snapshot,
store.clj:279-290), save_2 after analysis (results, 292-302) — so analysis
can be re-run offline on a saved history, the seam through which the
device checker re-checks a stored run.

The port's copy of ``jepsen_tpu.store``: the two packages read each
other's stored runs (same files, same JSON).

Crash safety:

- every artifact is written tmp + ``os.replace`` (and the ``latest``
  symlinks swap the same way), so a crash mid-save leaves either the old
  file or the new one, never a torn half behind a live pointer;
- a ``run.state`` marker (running -> analyzing -> done, atomically
  replaced) plus the per-op WAL (:mod:`jepsen_tpu_torch.journal`) make a run
  that died mid-flight *discoverable* (:func:`dead_runs`) and
  *recoverable* (:func:`recover_run`, surfaced as the ``recover`` CLI
  subcommand): its history is rebuilt from the journal and fed through
  the ordinary offline-analysis path.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import threading
from datetime import datetime
from typing import Any, Dict, List, Optional

from jepsen_tpu_torch.history import History
from jepsen_tpu_torch.util import chunk_vec, real_pmap

#: Keys dropped before serialization (store.clj:155-163).
NONSERIALIZABLE_KEYS = (
    "db", "os", "net", "client", "checker", "nemesis", "generator", "model",
    "barrier", "ssh", "remote",
)

#: Chunked parallel history writing threshold (util.clj:154-158).
PARALLEL_WRITE_THRESHOLD = 16384

DEFAULT_ROOT = "store"

#: The run-liveness marker file inside each run directory.
RUN_STATE = "run.state"


def _root(test: dict) -> str:
    return test.get("store-root") or DEFAULT_ROOT


def time_str(t: Optional[float] = None) -> str:
    dt = datetime.fromtimestamp(t) if t else datetime.now()
    return dt.strftime("%Y%m%dT%H%M%S.%f")[:-3]


def prepare_dir(test: dict) -> str:
    """Create (and record) the store directory for this run
    (store.clj:113-142 path!)."""
    d = test.get("store-dir")
    if not d:
        d = os.path.join(_root(test), str(test.get("name", "noop")),
                         time_str(test.get("start-time")))
        test["store-dir"] = d
    os.makedirs(d, exist_ok=True)
    return d


# ---------------------------------------------------------------------------
# Logging (store.clj:304-326)
# ---------------------------------------------------------------------------

def start_logging(test: dict) -> None:
    d = prepare_dir(test)
    handler = logging.FileHandler(os.path.join(d, "jepsen.log"))
    handler.setFormatter(logging.Formatter(
        "%(asctime)s %(levelname)s [%(threadName)s] %(name)s: %(message)s"))
    logger = logging.getLogger("jepsen")
    logger.setLevel(logging.INFO)
    logger.addHandler(handler)
    test["_log_handler"] = handler


def stop_logging(test: dict) -> None:
    handler = test.pop("_log_handler", None)
    if handler is not None:
        logging.getLogger("jepsen").removeHandler(handler)
        handler.close()


# ---------------------------------------------------------------------------
# Serialization
# ---------------------------------------------------------------------------

def serializable_test(test: dict) -> dict:
    """The test map minus functions/protocol impls/internal state
    (store.clj:155-163)."""
    out = {}
    for k, v in test.items():
        if k in NONSERIALIZABLE_KEYS or k.startswith("_"):
            continue
        if k in ("history", "results"):
            continue
        try:
            json.dumps(v)
            out[k] = v
        except (TypeError, ValueError):
            out[k] = repr(v)
    return out


def _json_default(x):
    if isinstance(x, (set, frozenset)):
        return sorted(x, key=repr)
    if isinstance(x, bytes):
        return x.decode("utf-8", "replace")
    return repr(x)


def _atomic_write(path: str, text: str) -> None:
    """Write tmp + fsync + ``os.replace``: a crash during save leaves
    either the previous artifact or the complete new one, never a torn
    half (the tmp lives in the same directory so the replace is a
    same-filesystem rename)."""
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        f.write(text)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def write_history(d: str, history: History) -> None:
    """history.txt + history.jsonl; big histories are formatted in parallel
    chunks (util.clj:149-170 pwrite-history!)."""
    ops = list(history)
    if len(ops) > PARALLEL_WRITE_THRESHOLD:
        chunks = chunk_vec(PARALLEL_WRITE_THRESHOLD, ops)
        txt_parts = real_pmap(
            lambda ch: "\n".join(str(o) for o in ch), chunks)
        jsonl_parts = real_pmap(
            lambda ch: "\n".join(
                json.dumps(o.to_dict(), default=_json_default)
                for o in ch),
            chunks)
        txt = "\n".join(txt_parts)
        jsonl = "\n".join(jsonl_parts)
    else:
        txt = "\n".join(str(o) for o in ops)
        jsonl = "\n".join(json.dumps(o.to_dict(), default=_json_default)
                          for o in ops)
    _atomic_write(os.path.join(d, "history.txt"), txt + "\n")
    _atomic_write(os.path.join(d, "history.jsonl"), jsonl + "\n")


def write_results(d: str, results: dict) -> None:
    _atomic_write(os.path.join(d, "results.json"),
                  json.dumps(results, indent=2, default=_json_default))


def update_symlinks(test: dict) -> None:
    """store/<name>/latest and store/latest (store.clj:235-247). The swap
    is symlink-at-tmp-name + ``os.replace``: ``latest`` always points at
    a run, never at nothing mid-swap."""
    d = test.get("store-dir")
    if not d:
        return
    d = os.path.abspath(d)
    name_dir = os.path.dirname(d)
    root = os.path.dirname(name_dir)
    for link_dir, target in ((name_dir, d), (root, d)):
        link = os.path.join(link_dir, "latest")
        tmp = f"{link}.tmp.{os.getpid()}"
        try:
            try:
                os.unlink(tmp)
            except FileNotFoundError:
                pass
            os.symlink(os.path.relpath(target, link_dir), tmp)
            os.replace(tmp, link)
        except OSError:
            pass


def save_1(test: dict) -> dict:
    """Phase 1: history + test snapshot, written in parallel futures
    (store.clj:279-290)."""
    d = prepare_dir(test)
    history = test.get("history") or History()

    def write_test():
        _atomic_write(os.path.join(d, "test.json"),
                      json.dumps(serializable_test(test), indent=2,
                                 default=_json_default))

    real_pmap(lambda f: f(), [write_test,
                              lambda: write_history(d, history)])
    update_symlinks(test)
    return test


def save_2(test: dict) -> dict:
    """Phase 2: results after analysis (store.clj:292-302)."""
    d = prepare_dir(test)
    write_results(d, test.get("results", {}))
    update_symlinks(test)
    return test


# ---------------------------------------------------------------------------
# Run liveness + recovery (doc/resilience.md "Crash-safe histories")
# ---------------------------------------------------------------------------

def write_state(test_or_dir, state: str, **extra) -> None:
    """Atomically update the run's ``run.state`` marker. Lifecycle:
    ``running`` (before the workload) -> ``analyzing`` (history saved,
    checker running) -> ``done`` (results written). The recorded pid is
    what lets :func:`run_status` tell a live run from a dead one."""
    d = test_or_dir if isinstance(test_or_dir, str) \
        else test_or_dir.get("store-dir")
    if not d or not os.path.isdir(d):
        return
    doc = {"state": state, "pid": os.getpid(), "updated": time_str()}
    doc.update(extra)
    try:
        _atomic_write(os.path.join(d, RUN_STATE),
                      json.dumps(doc, indent=2, default=_json_default))
    except OSError as e:  # liveness marker must never kill the run
        logging.getLogger("jepsen").warning(
            "couldn't write %s in %s: %s", RUN_STATE, d, e)


def read_state(d: str) -> Optional[dict]:
    """The run.state document, or None when absent/unreadable."""
    try:
        with open(os.path.join(d, RUN_STATE)) as f:
            doc = json.load(f)
        return doc if isinstance(doc, dict) else None
    except (OSError, ValueError):
        return None


def pid_alive(pid) -> bool:
    """Is a pid currently running (signal-0 probe)?"""
    if not isinstance(pid, int) or pid <= 0:
        return False
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True  # someone else's process, but alive
    except OSError:
        return False
    return True


def run_status(d: str) -> Optional[str]:
    """One of 'running' | 'dead' | 'done' | 'recovered', or None for a
    run with no run.state marker (pre-WAL runs: nothing to recover)."""
    st = read_state(d)
    if st is None:
        return None
    if st.get("state") == "done":
        return "recovered" if st.get("recovered") else "done"
    return "running" if pid_alive(st.get("pid")) else "dead"


def dead_runs(root: str = DEFAULT_ROOT) -> List[str]:
    """Run directories whose run.state says running/analyzing but whose
    recording process is gone — the ``recover`` scan."""
    return [d for d in tests(root=root) if run_status(d) == "dead"]


def recover_run(d: str) -> dict:
    """Reconstruct a dead run's history from its write-ahead journal.

    Reads the WAL (torn-tail tolerant: at most the final partial record
    is dropped), reconciles dangling invokes to ``:info`` exactly like
    worker-crash reincarnation, orders by time, indexes, and writes the
    standard ``history.jsonl``/``history.txt`` artifacts — after which the run
    analyzes exactly like a clean one (``load`` + any checker). Marks
    run.state ``analyzing`` with the recovery stats. Returns
    ``{"history": History, "stats": {...}}``."""
    from jepsen_tpu_torch import journal as journal_ns
    wal = os.path.join(d, journal_ns.WAL_NAME)
    if not os.path.exists(wal):
        raise FileNotFoundError(
            f"no {journal_ns.WAL_NAME} in {d}: nothing to recover "
            f"(the run predates the WAL or disabled it via JTPU_WAL=0)")
    h, stats = journal_ns.read_wal(wal)
    h, reconciled = journal_ns.reconcile(h)
    # the WAL is in append order; a run's history is in time order
    # (core._time_order)
    h.sort(key=lambda o: o.time)
    h.index()
    write_history(d, h)
    stats = dict(stats, reconciled=reconciled, ops=len(h))
    write_state(d, "analyzing", recovered=True, recovery=stats)
    return {"history": h, "stats": stats}


# ---------------------------------------------------------------------------
# Loading (store.clj:165-233)
# ---------------------------------------------------------------------------

def load(path: str) -> dict:
    """Load a saved test dir -> dict with 'history' and 'results'."""
    out: Dict[str, Any] = {}
    tj = os.path.join(path, "test.json")
    if os.path.exists(tj):
        with open(tj) as f:
            out.update(json.load(f))
    hj = os.path.join(path, "history.jsonl")
    if os.path.exists(hj):
        with open(hj) as f:
            out["history"] = History.from_jsonl(f.read())
    rj = os.path.join(path, "results.json")
    if os.path.exists(rj):
        with open(rj) as f:
            out["results"] = json.load(f)
    out["store-dir"] = path
    return out


def tests(name: Optional[str] = None, root: str = DEFAULT_ROOT) -> List[str]:
    """List saved test directories, newest last (store.clj:214-233)."""
    out = []
    names = [name] if name else sorted(os.listdir(root)) \
        if os.path.isdir(root) else []
    for n in names:
        nd = os.path.join(root, n)
        if not os.path.isdir(nd) or n == "latest":
            continue
        for ts in sorted(os.listdir(nd)):
            if ts == "latest":
                continue
            td = os.path.join(nd, ts)
            if os.path.isdir(td):
                out.append(td)
    return out


def latest(root: str = DEFAULT_ROOT) -> Optional[dict]:
    """Load the most recent test (repl.clj:6-13 last-test)."""
    link = os.path.join(root, "latest")
    if os.path.exists(link):
        return load(os.path.realpath(link))
    ts = tests(root=root)
    return load(ts[-1]) if ts else None


def delete(name: Optional[str] = None, root: str = DEFAULT_ROOT) -> None:
    """Delete stored tests (store.clj:328-345)."""
    if name:
        shutil.rmtree(os.path.join(root, name), ignore_errors=True)
    else:
        shutil.rmtree(root, ignore_errors=True)
