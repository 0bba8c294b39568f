#!/usr/bin/env python3
"""Profile the PyTorch/CUDA port's headline check on one NVIDIA GPU.

Runs ``linearizable(CASRegister())`` on the 10k-op headline history once
to warm up, then once more timed, and reports:

* the wall time and the levels;
* the device's busy share under the segment graph: the device time inside
  the segment graphs' launches (CUDA events recorded on the stream just
  before and just after each graph launch) over the check's wall time,
  and that device time per level;
* what ``torch.profiler`` (CPU and CUDA activities) sees of the same
  check: the device time it attributes to kernels and copies, and the
  largest kernels. It traces a kernel inside the graph's WHILE node once
  per graph launch, not once per level, so its busy share is not the
  device's; the kernel counts beside the levels show it.

The full ``key_averages`` table goes to ``<outdir>/profile_headline.txt``.

Run from the repository root: ``python3 tools/profile_torch_headline.py
[outdir [root]]`` (default ``profile_out``; ``root`` is the checkout
whose ``jepsen_tpu_torch`` is profiled, by default this one). Needs a
CUDA device.
"""

import json
import os
import subprocess
import sys
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

HEADLINE = dict(n_ops=10000, n_procs=5, n_vals=16, seed=42, crash_p=0.002)


def graph_share(checker, history):
    """(wall s, device s inside the segment graphs, result) of one check,
    each graph launch bracketed by CUDA events on its stream."""
    from jepsen_tpu_torch.kernels import search as K
    orig = K.SegmentGraph.launch
    marks = []

    def timed(self, bound):
        stream = torch.cuda.current_stream(self.seg.device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record(stream)
        orig(self, bound)
        end.record(stream)
        marks.append((start, end))

    K.SegmentGraph.launch = timed
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = checker.check({}, history)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        K.SegmentGraph.launch = orig
    device = sum(s.elapsed_time(e) for s, e in marks) / 1e3
    return wall, device, len(marks), out


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_torch_headline: no CUDA device", file=sys.stderr)
        return 1
    outdir = sys.argv[1] if len(sys.argv) > 1 else "profile_out"
    root = os.path.abspath(sys.argv[2] if len(sys.argv) > 2 else
                           os.path.dirname(os.path.dirname(
                               os.path.abspath(__file__))))
    sys.path.insert(0, root)
    from jepsen_tpu_torch.checker.wgl import linearizable
    from jepsen_tpu_torch.models import CASRegister
    from jepsen_tpu_torch.testing import simulate_register_history

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    history = simulate_register_history(**HEADLINE)
    checker = linearizable(CASRegister())
    warm = checker.check({}, history)
    assert warm["valid"] is True
    wall_g, device_g, launches, out = graph_share(checker, history)
    assert out["valid"] is True and out["levels"] == warm["levels"]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = checker.check({}, history)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    assert out["valid"] is True and out["levels"] == warm["levels"]
    device = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in device) / 1e3
    top = sorted(device, key=lambda e: -e.self_device_time_total)[:8]
    os.makedirs(outdir, exist_ok=True)
    with open(os.path.join(outdir, "profile_headline.txt"), "w") as fh:
        fh.write(prof.key_averages().table(
            sort_by="self_device_time_total", row_limit=40))
    levels = out["levels"]
    print(smi)
    print(json.dumps({
        "root": root, "levels": levels,
        "graph": {"wall_s": wall_g, "graph_launches": launches,
                  "device_s_in_graphs": device_g,
                  "device_busy_share": device_g / wall_g,
                  "device_ms_per_level": device_g / levels * 1e3,
                  "wall_ms_per_level": wall_g / levels * 1e3},
        "profiler": {"wall_s": wall,
                     "device_busy_ms": busy_ms if device else None,
                     "kernels": [{"name": e.key, "count": e.count,
                                  "device_ms": e.self_device_time_total
                                  / 1e3} for e in top]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
