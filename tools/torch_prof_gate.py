#!/usr/bin/env python
"""CI profiling gate of the PyTorch/CUDA port: run ONE profiled local-kv
check and assert the merged host+device trace validates as
Chrome/Perfetto JSON, inside a wall-clock bound.

The port's copy of ``tools/prof_gate.py``. The device-profiling path
(``JTPU_PROF=1`` / ``--profile``) crosses four layers: the
``torch.profiler`` capture in the supervised search, the capture-file
parser, the host/device clock merge and the Chrome export. This gate is
one real profiled run: a local-kv suite (real daemons, real sockets)
checked on ``--device`` (default ``cuda``, probed first: no CUDA is exit
2) with profiling on, then the merged export validated:

* the export is valid JSON with a non-empty ``traceEvents`` list where
  every event carries ``name`` + ``ph`` and complete events carry
  numeric ``ts``/``dur``;
* the host trace holds ``checker.segment`` spans and a ``prof.capture``
  anchor;
* where the capture produced files, device records merged in, each
  under a host span (``pid``). On CUDA the merged records must name K1
  (``expand_kernel``), K2 (``sort_tile_kernel``) and K4
  (``dedup_block_kernel`` or ``dedup_kernel``), each under a host span.
  On the CPU a capture with no device records is reported, not failed.

Usage: python tools/torch_prof_gate.py [--budget SECONDS]
           [--time-limit S] [--device cuda|cpu]
Exit code 0 iff the merged trace validates within the budget (default
30 s)."""

import argparse
import contextlib
import io
import json
import os
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

os.environ["JTPU_PROF"] = "1"
# small segments: several segment ends, so the capture demonstrably spans
# segment boundaries
os.environ.setdefault("JTPU_SEGMENT_ITERS", "64")

#: the kernels a profiled search on CUDA must show, each by any one of
#: its CUDA kernels' names
KERNELS = {"K1": ("expand_kernel",), "K2": ("sort_tile_kernel",),
           "K4": ("dedup_block_kernel", "dedup_kernel")}


def export_problems(path):
    """What is wrong with a Chrome JSON export (empty: nothing)."""
    try:
        with open(path) as f:
            doc = json.load(f)
    except ValueError as e:
        return [f"export is not valid JSON: {e}"]
    evs = doc.get("traceEvents")
    if not isinstance(evs, list) or not evs:
        return ["export has no traceEvents"]
    for e in evs:
        if "name" not in e or "ph" not in e:
            return [f"malformed event: {e!r:.80}"]
        if e["ph"] == "X" and not (
                isinstance(e.get("ts"), (int, float))
                and isinstance(e.get("dur"), (int, float))):
            return [f"complete event without numeric ts/dur: {e!r:.80}"]
    return []


def named_kernels(merged_dev):
    """{K1/K2/K4: merged device records naming it under a host span}."""
    return {k: sum(1 for r in merged_dev if r.get("pid")
                   and any(n in r["name"] for n in names))
            for k, names in KERNELS.items()}


def gate(device, root, budget=30.0, time_limit=4):
    """Run the gate on ``device`` with its store under ``root``: (rc,
    summary line, problems, kernels named)."""
    t0 = time.time()
    from jepsen_tpu_torch import __main__ as cli
    from jepsen_tpu_torch import core
    from jepsen_tpu_torch.obs import profiler
    from jepsen_tpu_torch.obs import trace as trace_ns
    from jepsen_tpu_torch.suites.localkv import localkv_test

    run_dir = os.path.join(root, "local-kv", "run")
    test = localkv_test({"time-limit": time_limit, "nemesis-period": 2,
                         "backend": "gpu", "device": str(device)})
    test["store-dir"] = run_dir
    test = core.run(test)
    if test["results"].get("valid") is not True:
        return 1, None, [f"profiled local-kv run did not validate "
                         f"({test['results'].get('valid')!r})"], {}

    host, stats = trace_ns.read_trace(
        os.path.join(run_dir, trace_ns.TRACE_NAME))
    names = {r.get("name") for r in host}
    problems = []
    if "checker.segment" not in names:
        problems.append("no checker.segment host span recorded")
    captured = profiler.CAPTURE_SPAN in names
    dev, pstats = profiler.read_profile(run_dir)
    merged_dev = profiler.merge_into_host(host, dev, pstats.get("t0"))
    if captured and pstats["files"] and not merged_dev:
        problems.append("capture produced trace files but zero device "
                        "records merged")
    if merged_dev and not any(r.get("pid") for r in merged_dev):
        problems.append("no merged device record is parented under a "
                        "host span")
    kernels = named_kernels(merged_dev)
    if device.type == "cuda":
        if not captured:
            problems.append("no prof.capture span on CUDA")
        missing = sorted(k for k, n in kernels.items() if not n)
        if missing:
            problems.append(f"no device record under a host span names "
                            f"{missing} (records named "
                            f"{sorted({r['name'] for r in merged_dev})[:20]}"
                            f")")

    export = os.path.join(os.path.dirname(run_dir), "chrome.json")
    with contextlib.redirect_stdout(io.StringIO()):
        rc = cli.main(["trace", "export", "--store", run_dir, "-o", export])
    if rc != 0:
        problems.append(f"trace export exited {rc}")
    else:
        problems += export_problems(export)

    wall = time.time() - t0
    if wall > budget:
        problems.append(f"gate overran its {budget:.0f}s budget "
                        f"({wall:.1f}s)")
    line = (f"# prof-gate: {stats['spans']} host span(s), "
            f"{pstats['files']} capture file(s), {len(merged_dev)} device "
            f"record(s) merged"
            + ("" if captured else
               " (platform refused capture: opt-in degraded to no-op)")
            + f", kernels {json.dumps(kernels, sort_keys=True)}"
            + f", {wall:.1f}s")
    return (1 if problems else 0), line, problems, kernels


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--budget", type=float, default=30.0,
                    help="wall-clock bound for the whole gate (s)")
    ap.add_argument("--time-limit", type=int, default=4,
                    help="local-kv workload seconds")
    ap.add_argument("--device", default="cuda",
                    help="the check's device (default cuda)")
    args = ap.parse_args(argv)
    import torch

    from jepsen_tpu_torch import accel
    device = torch.device(args.device)
    try:
        accel.ensure_usable("torch_prof_gate", device=device)
    except accel.AcceleratorUnavailable as e:
        print(f"# prof-gate: FAILED — {e}", file=sys.stderr)
        return 2
    with tempfile.TemporaryDirectory(prefix="jepsen-prof-gate-") as root:
        rc, line, problems, _ = gate(device, root, args.budget,
                                     args.time_limit)
    if line:
        print(line)
    for p in problems:
        print(f"# prof-gate: FAILED — {p}", file=sys.stderr)
    if not rc:
        print("# prof-gate: merged trace validates as Chrome/Perfetto JSON")
    return rc


if __name__ == "__main__":
    sys.exit(main())
