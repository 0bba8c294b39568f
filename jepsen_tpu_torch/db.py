"""DB lifecycle protocols.

Rebuild of jepsen.db (jepsen/src/jepsen/db.clj:4-25): DB (setup!/teardown!),
Primary (single-node one-time setup), LogFiles (paths to snarf), and cycle!
= teardown-then-setup. The port's copy of ``jepsen_tpu.db``.
"""

from __future__ import annotations

from typing import List


class DB:
    def setup(self, test: dict, node) -> None:
        """Set the node up to run the DB."""

    def teardown(self, test: dict, node) -> None:
        """Tear the DB down, destroying all data."""


class Primary:
    """Optional mixin: one-time setup on a single primary node
    (db.clj:8-10)."""

    def setup_primary(self, test: dict, node) -> None:
        pass


class LogFiles:
    """Optional mixin: which log files to download from nodes
    (db.clj:11-12)."""

    def log_files(self, test: dict, node) -> List[str]:
        return []


class NoopDB(DB):
    pass


def cycle(db: DB, test: dict, node) -> None:
    """Tear down, then set up (db.clj:20-25)."""
    db.teardown(test, node)
    db.setup(test, node)


def noop() -> NoopDB:
    return NoopDB()
