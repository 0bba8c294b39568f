"""Observability of the port: spans, metrics, search analytics, the live
observatory, device memory and the device profiler.

Counterpart of ``jepsen_tpu/obs/``; each module is a copy of the
reference's or its counterpart on PyTorch, under the same name, with the
same metric names, span names and artifacts:

* :mod:`~jepsen_tpu_torch.obs.trace`: the span tracer (ring,
  ``trace.jsonl``, Chrome export, trace ids);
* :mod:`~jepsen_tpu_torch.obs.metrics`: counters, gauges and
  histograms, Prometheus text (the daemon's ``GET /metrics``) and
  ``metrics.json``;
* :mod:`~jepsen_tpu_torch.obs.searchstats`: the per-level counters K4
  writes, rolled up into the result and ``searchstats.json``;
* :mod:`~jepsen_tpu_torch.obs.observatory`: live progress gauges and
  ``progress.json``;
* :mod:`~jepsen_tpu_torch.obs.devices`: device memory gauges and the
  headroom ratio;
* :mod:`~jepsen_tpu_torch.obs.profiler`: ``torch.profiler`` captures of
  the search (``JTPU_PROF=1``) under the host spans.

Device phases are timed on the host around a CUDA synchronisation,
never inside a captured graph.

Kill switch: ``JTPU_TRACE=0`` turns it all off: spans are no-ops, no
artifact is written, and the search runs without its stats lane (K4
writes no counter row, the carry and its checkpoint have the
reference's 13 slots); verdicts and levels are unchanged.

The port has no stored run of its own: :func:`start_run` points the
sinks at a directory (``trace.jsonl``, ``progress.json``,
``searchstats.json``, ``profile/``) and :func:`finish_run` writes
``metrics.json`` there and detaches them.
"""

from __future__ import annotations

import os
from typing import Optional

from jepsen_tpu_torch.obs.trace import (  # noqa: F401
    TRACE_NAME, Tracer, enabled, event, read_trace, span, to_chrome,
    tracer)
from jepsen_tpu_torch.obs import metrics  # noqa: F401
from jepsen_tpu_torch.obs import devices  # noqa: F401
from jepsen_tpu_torch.obs import observatory  # noqa: F401
from jepsen_tpu_torch.obs import profiler  # noqa: F401
from jepsen_tpu_torch.obs import searchstats  # noqa: F401
from jepsen_tpu_torch.obs import trace as _trace

#: The metrics snapshot's filename inside a run directory.
METRICS_NAME = "metrics.json"

_RUN_DIR: Optional[str] = None


def start_run(store_dir: Optional[str]) -> None:
    """Attach the run-scoped telemetry sinks to ``store_dir``: the
    tracer's ``trace.jsonl``, the observatory's ``progress.json``, the
    search analytics' ``searchstats.json`` and, when ``JTPU_PROF`` opts
    in, the profiler's capture directory. Nothing is written with
    ``JTPU_TRACE=0``."""
    global _RUN_DIR
    _RUN_DIR = store_dir or None
    _trace.start_run(store_dir)
    observatory.attach(store_dir)
    searchstats.attach(store_dir)
    profiler.attach(store_dir)


def finish_run() -> None:
    """Write ``metrics.json`` into the run directory (tracing on) and
    detach every sink, also when the write fails."""
    global _RUN_DIR
    run_dir, _RUN_DIR = _RUN_DIR, None
    try:
        if run_dir is not None and enabled():
            metrics.write_snapshot(os.path.join(run_dir, METRICS_NAME))
    finally:
        _trace.finish_run()
        observatory.detach()
        searchstats.detach()
        profiler.detach()
