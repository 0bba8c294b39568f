#!/usr/bin/env python3
"""Time what the plan gate and the segment watchdog add to a check on the
card.

``python3 tools/time_torch_watchdog.py [OUT]`` checks the 10k-op register
headline (``chip_smoke.py``'s) through ``check_packed_gpu`` warm, in turns:
with no segment deadline, with a 30 s deadline (the watchdog thread and a
carry copy to the host at each segment end), with a checkpoint callback
alone (``supervised_check_packed(on_checkpoint=)``: the copy, no thread)
and with ``JTPU_PLAN_GATE=0`` (no gate), each REPS times; then, each a mean over many calls, the parts: the gate
(``PlanDims.from_packed`` and ``gate_ladder`` over the headline's rungs),
the headroom a segment barrier reads, a full ``poll`` (its rows' peak from
``torch.cuda.memory_stats``), a segment handed to the
watchdog's thread and back, a new thread started and joined, and the
carry's copy to the host. It prints one JSON line (and writes it to OUT
when given), with the card's ``nvidia-smi`` name and power limit. Needs a
CUDA device.
"""

import gc
import json
import os
import statistics
import sys
import threading
import time

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

REPS = 8
MICRO = 200


def mean_ms(fn, n=MICRO):
    for _ in range(5):
        fn()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    return (time.perf_counter() - t0) / n * 1e3


def main() -> int:
    if not torch.cuda.is_available():
        print("time_torch_watchdog: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from jepsen_tpu_torch import interop
    from jepsen_tpu_torch import resilience as R
    from jepsen_tpu_torch.checker import gpu as G
    from jepsen_tpu_torch.checker import plan
    from jepsen_tpu_torch.checker.engine import default_engine
    from jepsen_tpu_torch.kernels import search as K
    from jepsen_tpu_torch.models import CASRegister
    from jepsen_tpu_torch.obs import devices
    from jepsen_tpu_torch.ops.encode import pack_with_init
    from jepsen_tpu_torch.testing import simulate_register_history

    dev = torch.device("cuda")
    out = {"nvidia_smi": cs.nvidia_smi(),
           "device": torch.cuda.get_device_name(0)}
    head = simulate_register_history(**cs.HEADLINE)
    p, k = pack_with_init(head, CASRegister())
    first = G.check_packed_gpu(p, k, device=dev)
    out["segments"], out["levels"] = first["segments"], first["levels"]

    def check(**kw):
        return G.check_packed_gpu(p, k, device=dev, **kw)

    def checkpoint_only():
        return R.supervised_check_packed(p, k, device=dev,
                                         on_checkpoint=lambda cp: None)

    variants = {"unset": (check, {}),
                "deadline_30s": (lambda: check(deadline_s=30.0), {}),
                "checkpoint_only": (checkpoint_only, {}),
                "no_gate": (check, {"JTPU_PLAN_GATE": "0"})}
    times = {v: [] for v in variants}
    for turn in range(REPS):
        order = list(variants) if turn % 2 == 0 else list(
            reversed(list(variants)))
        for v in order:
            fn, env = variants[v]
            os.environ.update(env)
            try:
                gc.collect()
                t0 = time.perf_counter()
                r = fn()
                times[v].append(time.perf_counter() - t0)
            finally:
                for name in env:
                    del os.environ[name]
            assert r["levels"] == first["levels"], (v, r)
    out["warm_headline_s"] = {v: {"median": statistics.median(ts),
                                  "runs": ts} for v, ts in times.items()}

    wneed = G._window_needed(p)
    ladder = G._ladder_for(wneed, dev)
    out["gate_ms"] = mean_ms(lambda: plan.gate_ladder(
        plan.PlanDims.from_packed(p, wneed), k, ladder, kind="segment",
        explicit=False, derate=True, device=dev))
    out["headroom_ms"] = mean_ms(lambda: devices.headroom_ratio(device=dev))
    out["poll_rows_ms"] = mean_ms(lambda: devices.poll(dev))
    wd = R.SegmentWatchdog(dev, 30.0)
    out["watchdog_handoff_ms"] = mean_ms(lambda: wd.call(lambda stop: None))
    wd.close()

    def new_thread():
        t = threading.Thread(target=lambda: None)
        t.start()
        t.join(30)

    out["thread_start_join_ms"] = mean_ms(new_thread)
    carry, _ = default_engine().state(
        K.LevelShape(C=128, W=32, E=8, n=G._bucket(p.n_required),
                     CR=G._crash_width(p.n - p.n_required)), dev)
    out["carry_to_host_ms"] = mean_ms(lambda: interop.carry_to_numpy(carry))
    line = json.dumps(out)
    print(line)
    if len(sys.argv) > 1:
        with open(sys.argv[1], "w") as fh:
            fh.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
