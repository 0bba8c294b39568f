"""CRC'd JSON-record journals: the serve daemon's request WAL format.

Copy of the generic-record half of ``jepsen_tpu/journal.py``. One record
per line::

    <crc32 as 8 lowercase hex chars> <compact JSON document>\\n

The CRC covers exactly the JSON payload bytes, so a reader tells a torn
final record (a write cut by a crash) from a corrupted earlier one. Each
record is one unbuffered write; with ``fsync`` each append is also synced
to the disk, which is what makes an acknowledged request survive a power
loss.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import zlib
from typing import Optional, Tuple

log = logging.getLogger("jepsen_tpu_torch.journal")


def _json_default(x):
    if isinstance(x, (set, frozenset)):
        return sorted(x, key=repr)
    if isinstance(x, bytes):
        return x.decode("utf-8", "replace")
    return repr(x)


def encode_json_record(doc: dict) -> bytes:
    """One CRC'd journal line for a JSON document."""
    payload = json.dumps(doc, separators=(",", ":"),
                         default=_json_default).encode("utf-8")
    return b"%08x " % (zlib.crc32(payload) & 0xFFFFFFFF) + payload + b"\n"


def decode_json_record(line: bytes) -> Optional[dict]:
    """One CRC'd journal line back to its document; None when the line is
    torn or corrupt (CRC mismatch, malformed JSON, not an object)."""
    if len(line) < 10 or line[8:9] != b" ":
        return None
    crc, payload = line[:8], line[9:]
    try:
        if int(crc, 16) != (zlib.crc32(payload) & 0xFFFFFFFF):
            return None
        d = json.loads(payload)
    except (ValueError, TypeError):
        return None
    return d if isinstance(d, dict) else None


def read_json_records(path: str) -> Tuple[list, dict]:
    """``(records, stats)`` of a journal: an undecodable unterminated last
    line is the crash's torn tail (``torn``), any other undecodable line
    is ``corrupt`` and skipped."""
    stats = {"records": 0, "torn": 0, "corrupt": 0}
    with open(path, "rb") as f:
        data = f.read()
    lines = data.split(b"\n")
    terminated = data.endswith(b"\n")
    if lines and lines[-1] == b"":
        lines.pop()
    out = []
    for i, line in enumerate(lines):
        d = decode_json_record(line)
        if d is not None:
            out.append(d)
            stats["records"] += 1
        elif i == len(lines) - 1 and not terminated:
            stats["torn"] += 1
        else:
            stats["corrupt"] += 1
            log.warning("journal %s: dropping corrupt record at line %d",
                        path, i + 1)
    return out, stats


class JsonRecordWriter:
    """Append-only writer of CRC'd records: one unbuffered write per
    record (a crash loses at most the torn tail); ``fsync=True`` syncs
    each append. A failed write disables the writer (:attr:`failed`)."""

    def __init__(self, path: str, fsync: bool = False):
        self.path = path
        self.fsync = fsync
        self.records = 0
        self.failed: Optional[str] = None
        self._lock = threading.Lock()
        self._f = open(path, "ab", buffering=0)

    def append(self, doc: dict) -> None:
        line = encode_json_record(doc)
        with self._lock:
            if self._f is None or self.failed is not None:
                return
            try:
                self._f.write(line)
                self.records += 1
                if self.fsync:
                    os.fsync(self._f.fileno())
            except OSError as e:
                self.failed = f"{type(e).__name__}: {e}"
                log.warning("journal append to %s failed (%s); the "
                            "writer is disabled", self.path, self.failed)

    def close(self) -> None:
        with self._lock:
            if self._f is None:
                return
            try:
                self._f.close()
            finally:
                self._f = None
