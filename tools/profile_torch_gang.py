#!/usr/bin/env python3
"""Profile a gang of the port's serve path against its deepest member.

Takes the 8 first 2,000-op register histories
(``simulate_register_history(2000, n_procs=5, n_vals=16, seed=9000 + i,
crash_p=0.002)``) of the most common shape bucket among seeds 9000 to
9015 (the serve phase of ``chip_smoke.py``), and checks them as one gang
(``check_packed_gang_gpu``) and, one by one, with the serial search
(``check_packed_gpu``). It reports, for the gang and for the member whose
search is deepest checked alone: the median wall seconds over a few runs
in turns, the levels launched (``expand``'s wrapper calls: one a level),
and, from one more run of each under ``torch.profiler``, the device time
of the CUDA kernels and the device's busy share of the wall time (a
lower bound: the profiler slows the host). The ``key_averages`` tables go
to ``<outdir>/profile_gang.txt``.

Run from the repository root: ``python3 tools/profile_torch_gang.py
[outdir]`` (default ``profile_out``). Needs a CUDA device.
"""

import json
import os
import statistics
import subprocess
import sys
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

SERVE = dict(n_ops=2000, n_procs=5, n_vals=16, crash_p=0.002)
SEED, CANDIDATES, MEMBERS, REPS = 9000, 16, 8, 5


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_torch_gang: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from jepsen_tpu_torch.checker import gpu as G
    from jepsen_tpu_torch.checker.engine import Engine
    from jepsen_tpu_torch.kernels import search as K
    from jepsen_tpu_torch.models import CASRegister
    from jepsen_tpu_torch.ops.encode import pack_with_init
    from jepsen_tpu_torch.testing import simulate_register_history

    outdir = sys.argv[1] if len(sys.argv) > 1 else "profile_out"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    dev = torch.device("cuda")
    by_bucket = {}
    seed = SEED
    while True:
        h = simulate_register_history(seed=seed, **SERVE)
        p, kernel = pack_with_init(h, CASRegister())
        by_bucket.setdefault(Engine.bucket_key(p, kernel), []).append(p)
        seed += 1
        if seed >= SEED + CANDIDATES:
            main_bucket = max(by_bucket, key=lambda b: len(by_bucket[b]))
            if len(by_bucket[main_bucket]) >= MEMBERS:
                break
    pks = by_bucket[main_bucket][:MEMBERS]

    def gang():
        return G.check_packed_gang_gpu(pks, kernel, device=dev)

    first = gang()
    deepest = pks[max(range(MEMBERS), key=lambda i: first[i]["levels"])]

    def alone():
        return [G.check_packed_gpu(deepest, kernel, device=dev)]

    runs = {"gang": gang, "deepest alone": alone}
    walls = {name: [] for name in runs}
    for rep in range(REPS):
        for name in (list(runs) if rep % 2 == 0 else list(runs)[::-1]):
            t0 = time.perf_counter()
            runs[name]()
            torch.cuda.synchronize()
            walls[name].append(time.perf_counter() - t0)
    report = {"bucket": list(main_bucket), "members": MEMBERS,
              "levels": [r["levels"] for r in first]}
    os.makedirs(outdir, exist_ok=True)
    tables = []
    for name, fn in runs.items():
        K.reset_launches()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launched = K.launches["expand"]
        device = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA]
        busy_ms = sum(e.self_device_time_total for e in device) / 1e3
        wall_s = statistics.median(walls[name])
        report[name] = {
            "wall_s": walls[name], "median_wall_s": wall_s,
            "levels_launched": launched,
            "wall_ms_per_level": wall_s / launched * 1e3,
            "profiled_wall_s": wall,
            "device_busy_ms": busy_ms if device else None,
            "device_ms_per_level": busy_ms / launched if device else None,
            "device_busy_share": (busy_ms / (wall * 1e3) if device
                                  else None),
            "kernels": {e.key: {"count": e.count,
                                "device_ms": e.self_device_time_total / 1e3}
                        for e in sorted(device, key=lambda e:
                                        -e.self_device_time_total)[:6]}}
        tables.append(f"== {name}\n" + prof.key_averages().table(
            sort_by="self_device_time_total", row_limit=30))
    with open(os.path.join(outdir, "profile_gang.txt"), "w") as fh:
        fh.write("\n".join(tables))
    print(smi)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
