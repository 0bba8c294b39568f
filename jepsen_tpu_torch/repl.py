"""Interactive-analysis helpers.

Rebuild of jepsen.repl (jepsen/src/jepsen/repl.clj:6-13): reload the most
recent test from the store so analysis can be re-run offline: the seam
through which the device checker re-checks a stored run. The port's copy
of ``jepsen_tpu.repl``."""

from __future__ import annotations

from typing import Optional

from jepsen_tpu_torch import store


def last_test(root: str = store.DEFAULT_ROOT) -> Optional[dict]:
    """The most recently run test map, with history and results loaded."""
    return store.latest(root)


def recheck(test: dict, checker) -> dict:
    """Re-run a checker against a saved test's history (offline
    analysis)."""
    from jepsen_tpu_torch.checker import check_safe
    return check_safe(checker, test, test.get("history") or [])
