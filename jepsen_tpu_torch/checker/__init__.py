"""History checkers. A checker examines a completed history and returns a
result map whose ``valid`` key is True, False or :data:`UNKNOWN`.

The linearizability checker is :mod:`jepsen_tpu_torch.checker.wgl`; its
device search is :mod:`jepsen_tpu_torch.checker.gpu`.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

UNKNOWN = "unknown"


class Checker:
    """Base checker protocol."""

    def check(self, test: dict, history,
              opts: Optional[dict] = None) -> Dict[str, Any]:
        raise NotImplementedError

    def __call__(self, test, history, opts=None):
        return self.check(test, history, opts)
