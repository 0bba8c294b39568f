#!/usr/bin/env python3
"""Time the PyTorch/CUDA port's single-history headline in one checkout.

Imports ``jepsen_tpu_torch`` from the checkout at ROOT (default: this
one), builds its kernels, checks the 10k-op CAS-register headline history
once cold and REPS times warm, and times each kernel of one level at the
headline rung (level 300 of its search) with CUDA events. Prints the
card's name and power limit and one JSON line. Two checkouts compare on
one card by running this once per checkout in turns (parent, change,
change, parent) on the same machine.

Run: ``python3 tools/time_torch_headline.py [ROOT] [REPS]``. Needs a CUDA
device.
"""

import json
import os
import statistics
import subprocess
import sys
import time

import torch

HEADLINE = dict(n_ops=10000, n_procs=5, n_vals=16, seed=42, crash_p=0.002)
RUNG, WARM_LEVELS, KERNEL_REPS = (128, 32, 8), 300, 30


def kernel_ms(fn, prep) -> float:
    """Median device time of ``fn(*prep())`` over KERNEL_REPS launches,
    each behind a device-side sleep so the events bracket device work."""
    times = []
    for _ in range(KERNEL_REPS):
        args = prep()
        torch.cuda.synchronize()
        torch.cuda._sleep(20_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main() -> int:
    if not torch.cuda.is_available():
        print("time_torch_headline: no CUDA device", file=sys.stderr)
        return 1
    root = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else
                           os.path.dirname(os.path.dirname(
                               os.path.abspath(__file__))))
    reps = int(sys.argv[2]) if len(sys.argv) > 2 else 5
    sys.path.insert(0, root)
    from jepsen_tpu_torch.checker import gpu as G
    from jepsen_tpu_torch.checker.wgl import linearizable
    from jepsen_tpu_torch.kernels import build, parity
    from jepsen_tpu_torch.models import CASRegister
    from jepsen_tpu_torch.ops.encode import pack_with_init
    from jepsen_tpu_torch.testing import simulate_register_history
    import jepsen_tpu_torch
    assert os.path.dirname(os.path.dirname(
        os.path.abspath(jepsen_tpu_torch.__file__))) == root

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    build.load()
    history = simulate_register_history(**HEADLINE)
    checker = linearizable(CASRegister())
    t0 = time.perf_counter()
    first = checker.check({}, history)
    cold = time.perf_counter() - t0
    assert first["valid"] is True
    warm = []
    for _ in range(reps):
        t0 = time.perf_counter()
        r = checker.check({}, history)
        warm.append(time.perf_counter() - t0)
        assert r["levels"] == first["levels"]
    packed, kernel = pack_with_init(history, CASRegister())
    cols = G._split_packed(packed, G._bucket(packed.n_required),
                           G._crash_width(packed.n - packed.n_required),
                           kernel)
    lv = parity.Level(cols, RUNG, torch.device("cuda"))
    lv.advance(WARM_LEVELS)
    kernels = {}
    for name, kern, _, state, err in lv.walk():
        assert err == 0, name
        kernels[name] = kernel_ms(kern, lambda: parity.copy_state(*state))
    print(smi)
    print(json.dumps({"root": root, "levels": first["levels"],
                      "cold_s": cold, "warm_s": warm,
                      "warm_median_s": statistics.median(warm),
                      "kernel_ms": kernels}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
