#!/usr/bin/env python3
"""Profile the PyTorch/CUDA port's headline check on one NVIDIA GPU.

Runs ``linearizable(CASRegister())`` on the 10k-op headline history once
to warm up, then once more under ``torch.profiler`` (CPU and CUDA
activities), and reports the wall time, the device time the profiler
attributes to CUDA kernels and copies, the device's busy share of the
wall time, and the largest kernels. The profiler's own host overhead
inflates the wall time, so the busy share is a lower bound. The full
``key_averages`` table goes to ``<outdir>/profile_headline.txt``.

Run from the repository root: ``python3 tools/profile_torch_headline.py
[outdir]`` (default ``profile_out``). Needs a CUDA device.
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


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_torch_headline: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from jepsen_tpu_torch.checker.wgl import linearizable
    from jepsen_tpu_torch.models import CASRegister
    from jepsen_tpu_torch.testing import simulate_register_history

    outdir = sys.argv[1] if len(sys.argv) > 1 else "profile_out"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    history = simulate_register_history(**HEADLINE)
    checker = linearizable(CASRegister())
    warm = checker.check({}, history)
    assert warm["valid"] is True
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
    print(smi)
    print(json.dumps({
        "levels": out["levels"], "wall_s": wall,
        "device_busy_ms": busy_ms if device else None,
        "device_busy_share": busy_ms / (wall * 1e3) if device else None,
        "kernels": [{"name": e.key, "count": e.count,
                     "device_ms": e.self_device_time_total / 1e3}
                    for e in top]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
