#!/usr/bin/env python3
"""Profile the PyTorch/CUDA port's keyed batch on one NVIDIA GPU.

Builds chip_smoke.py's keyed headline (256 keys x 2,000 ops, key k from
seed 7000 + k, staggered and dense) as ``[k v]`` histories, checks each
once through ``independent.checker(linearizable(CASRegister()))`` to warm
up, times the host steps of a check one by one, then checks once more
under ``torch.profiler`` (CPU and CUDA activities), and reports per shape
the wall time, the device time the profiler
attributes to CUDA kernels and copies, the device's busy share of the
wall time, and the largest kernels. The profiler's own host overhead
inflates the wall time, so the busy share is a lower bound. The full
``key_averages`` tables go to ``<outdir>/profile_keyed_<shape>.txt``.

Run from the repository root: ``python3 tools/profile_torch_keyed.py
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

KEYS, KEY_OPS = 256, 2000
SHAPES = {"staggered": dict(crash_p=0.0, overlap_p=0.05),
          "dense": dict(crash_p=0.001)}


def host_breakdown(history) -> dict:
    """Seconds of each host step of one independent check of ``history``:
    splitting it per key, the history gate, packing, the columns, and
    ``check_keyed_gpu`` whole (which runs the gate, packing and columns
    again, then the device batches)."""
    from jepsen_tpu_torch import independent
    from jepsen_tpu_torch.analysis.history_lint import gate_history
    from jepsen_tpu_torch.checker import gpu as G
    from jepsen_tpu_torch.models import CASRegister
    from jepsen_tpu_torch.ops.encode import pack_with_init
    out = {}
    t0 = time.perf_counter()
    keyed = independent.subhistories(history)
    out["split"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    for h in keyed.values():
        gate_history(h)
    out["gate"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    packed = [pack_with_init(h, CASRegister()) for h in keyed.values()]
    out["pack"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    breq = G._bucket(max(p.n_required for p, _ in packed))
    for p, kernel in packed:
        G._split_packed(p, breq, G._crash_width(p.n - p.n_required),
                        kernel)
    out["columns"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = G.check_keyed_gpu(keyed, CASRegister())
    out["check_keyed_gpu"] = time.perf_counter() - t0
    out["batches"] = sum(b["seconds"] for b in res["batches"])
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_torch_keyed: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from jepsen_tpu_torch import independent
    from jepsen_tpu_torch.checker.wgl import linearizable
    from jepsen_tpu_torch.models import CASRegister
    from jepsen_tpu_torch.testing import (keyed_history,
                                          simulate_register_history)

    outdir = sys.argv[1] if len(sys.argv) > 1 else "profile_out"
    os.makedirs(outdir, exist_ok=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi)
    checker = independent.checker(linearizable(CASRegister()))
    for label, kw in SHAPES.items():
        history = keyed_history({k: simulate_register_history(
            KEY_OPS, n_procs=5, n_vals=8, seed=7000 + k, **kw)
            for k in range(KEYS)})
        warm = checker.check({}, history)
        assert warm["valid"] is True, label
        print(json.dumps({"shape": label, "host_s": host_breakdown(
            history)}))
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            out = checker.check({}, history)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        assert out["valid"] is True, label
        device = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA]
        busy_ms = sum(e.self_device_time_total for e in device) / 1e3
        top = sorted(device, key=lambda e: -e.self_device_time_total)[:8]
        with open(os.path.join(outdir, f"profile_keyed_{label}.txt"),
                  "w") as fh:
            fh.write(prof.key_averages().table(
                sort_by="self_device_time_total", row_limit=40))
        print(json.dumps({
            "shape": label, "keys": KEYS, "ops_per_key": KEY_OPS,
            "wall_s": wall,
            "device_busy_ms": busy_ms if device else None,
            "device_busy_share": busy_ms / (wall * 1e3) if device else None,
            "kernels": [{"name": e.key, "count": e.count,
                         "device_ms": e.self_device_time_total / 1e3}
                        for e in top]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
