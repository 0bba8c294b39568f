#!/usr/bin/env python3
"""Time the host work a stream's close does, step by step.

A stream whose stable prefixes were all checked online reaches its close
with a done carry: what the close still costs is host work. This times,
on the crash-free 10,000-op register history (``chip_smoke.py``'s
``STREAM_FREE``): feeding the 20,000 events to the packer, packing the
stable prefix at one barrier, the packer's close, splitting the packed
history into the search's columns, the needed window, writing the
``history.json`` artifact as the session's close does, and writing the
result as ``finish`` does. Each step is timed REPS times; the median is
printed, with the host's CPU, as one JSON line.

Run from the repository root: ``python3 tools/profile_torch_stream_close.py
[OUT_DIR]`` (the artifacts are written under OUT_DIR, by default a
temporary directory).
"""

import json
import os
import statistics
import sys
import tempfile
import time

REPS = 5


def main() -> int:
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from jepsen_tpu_torch import stream
    from jepsen_tpu_torch.checker import gpu as G
    from jepsen_tpu_torch.models import CASRegister, kernel_spec_for
    from jepsen_tpu_torch.ops.encode import StreamPacker
    from jepsen_tpu_torch.testing import simulate_register_history

    out = sys.argv[1] if len(sys.argv) > 1 else tempfile.mkdtemp()
    os.makedirs(out, exist_ok=True)
    ops = [o.to_dict() for o in simulate_register_history(
        10000, n_procs=5, n_vals=16, seed=42, crash_p=0.0)]
    kernel = kernel_spec_for(CASRegister())
    times = {}

    def timed(name, fn):
        t0 = time.perf_counter()
        res = fn()
        times.setdefault(name, []).append(time.perf_counter() - t0)
        return res

    for _ in range(REPS):
        packer = StreamPacker(kernel)
        timed("feed", lambda: packer.feed_ops(ops))
        timed("stable_packed", packer.stable_packed)
        p = timed("packer_close", packer.close)
        timed("split_packed", lambda: G._split_packed(
            p, G._bucket(p.n_required), 0, kernel))
        timed("window_needed", lambda: G._window_needed(p))
        timed("history_json", lambda: stream._atomic_json(
            os.path.join(out, stream.HISTORY_NAME), ops))
        result = G._result(True, False, False, 0, 7009, p)
        timed("result_json", lambda: stream._atomic_json(
            os.path.join(out, stream.RESULT_NAME), result))
    med = {k: statistics.median(v) for k, v in times.items()}
    cpu = "unknown"
    try:
        with open("/proc/cpuinfo") as f:
            fields = dict(line.split(":", 1) for line in f
                          if ":" in line and line.split(":")[0].strip()
                          in ("vendor_id", "cpu family", "model",
                              "model name"))
        cpu = " ".join(v.strip() for v in fields.values())
    except OSError:
        pass
    print(json.dumps({"events": len(ops), "reps": REPS, "median_s": med,
                      "close_steps_s": sum(med[k] for k in (
                          "packer_close", "split_packed", "window_needed",
                          "history_json", "result_json")),
                      "cpu": cpu, "cpus": os.cpu_count()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
