"""Redirect report output into the store.

Rebuild of jepsen.report (jepsen/src/jepsen/report.clj:7-16): a context
manager that captures prints into a file in the test's store directory.
The port's copy of ``jepsen_tpu.report``."""

from __future__ import annotations

import contextlib
import os
from typing import Iterator, TextIO


@contextlib.contextmanager
def to(test: dict, filename: str) -> Iterator[TextIO]:
    """Open store-dir/<filename> and redirect stdout into it for the
    duration of the block; also yields the file handle."""
    d = test.get("store-dir") or "."
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, filename)
    with open(path, "w") as f:
        with contextlib.redirect_stdout(f):
            yield f
