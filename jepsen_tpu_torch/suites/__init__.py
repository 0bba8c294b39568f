"""Test suites of the port: ``<name>_test(opts) -> test map``
constructors, by name.

The port has the two local-kv suites (:mod:`.localkv`), whose nodes are
real local processes, and the three sqlite suites (:mod:`.sqlitedb`),
whose system is the real SQLite engine; every other suite of
``jepsen_tpu.suites`` is still to port (ROADMAP). Their linearizability
check runs on the card unless the options ask for the CPU (``backend:
"cpu"``, or ``device: "cpu"``).
"""

from __future__ import annotations

import importlib
from typing import Callable, Dict

#: name -> (module, constructor attribute)
SUITES = {
    "local-kv": ("localkv", "localkv_test"),
    "local-kv-unsafe": ("localkv", "localkv_unsafe_test"),
    "sqlite-register": ("sqlitedb", "sqlite_register_test"),
    "sqlite-bank": ("sqlitedb", "sqlite_bank_test"),
    "sqlite-register-toctou": ("sqlitedb", "sqlite_register_toctou_test"),
}


def registry() -> Dict[str, Callable[[dict], dict]]:
    """Suite name -> test constructor."""
    out: Dict[str, Callable[[dict], dict]] = {}
    for name, (mod, attr) in SUITES.items():
        m = importlib.import_module(f"jepsen_tpu_torch.suites.{mod}")
        out[name] = getattr(m, attr)
    return out
