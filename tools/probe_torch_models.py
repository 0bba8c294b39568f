#!/usr/bin/env python3
"""Each model family's full-size history on the card, rung by rung.

For the mutex, unordered queue, FIFO queue, set and no-op histories of
``chip_smoke.py`` (10,000 ops each), and their corrupted copies
(``testing.corrupt_model_history``), runs the device search one rung of
the history's ladder at a time (``resilience.supervised_check_packed``
with the rung pinned) until a rung decides it, and prints each rung's
verdict, levels, search counters and seconds. It also runs the set
histories whose crashed adds all took effect, or that have no crashed
adds, beside the default one, where a crashed add's effect may be lost.
It shows where the pool search decides a model's history and where it
goes UNKNOWN (the level budget spent, or the pool dead after a
truncation); the checker would then take the host object search.

Run on a machine with a CUDA device, from the repository root:
``python3 tools/probe_torch_models.py``. Prints the card's ``nvidia-smi``
name and power limit first, and one JSON line per rung.
"""

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("probe_torch_models: no CUDA device is available",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from jepsen_tpu_torch import models, resilience, testing
    from jepsen_tpu_torch.checker import gpu as G
    from jepsen_tpu_torch.kernels import build
    from jepsen_tpu_torch.ops.encode import pack_with_init

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda")
    build.load()

    def set_history(**kw):
        return testing.simulate_set_history(10000, n_procs=5, seed=42,
                                            **kw)

    runs = [
        ("mutex", models.Mutex(), testing.simulate_mutex_history(
            10000, n_procs=5, seed=42, crash_p=0.002)),
        ("unordered-queue", models.UnorderedQueue(),
         testing.simulate_queue_history(10000, n_procs=5, seed=42,
                                        backlog=8, fifo=False)),
        ("fifo-queue", models.FIFOQueue(), testing.simulate_queue_history(
            10000, n_procs=3, seed=42, backlog=2, fifo=True)),
        ("set", models.SetModel(), set_history(crash_p=0.002)),
        ("set crashed-applied", models.SetModel(),
         set_history(crash_p=0.002, lost_p=0.0)),
        ("set no-crash", models.SetModel(), set_history(crash_p=0.0)),
        ("noop", models.NoOp(), testing.simulate_register_history(
            10000, n_procs=5, n_vals=16, seed=42, crash_p=0.002)),
    ]
    for tag, model, h in runs:
        family = tag.split()[0]
        cases = [("valid", h)]
        if family != "noop":
            cases.append(("corrupt",
                          testing.corrupt_model_history(h, family)))
        for label, hh in cases:
            p, kernel = pack_with_init(hh, model)
            for rung in G._ladder_for(G._window_needed(p), dev):
                cap, win, exp = rung
                t0 = time.perf_counter()
                r = resilience.supervised_check_packed(
                    p, kernel, capacity=cap, window=win, expand=exp,
                    device=dev)
                line = {"history": tag, "copy": label, "rung": list(rung),
                        "valid": r["valid"], "levels": r.get("levels"),
                        "max-linearized-prefix":
                            r.get("max-linearized-prefix"),
                        "error": r.get("error"),
                        "searchstats": r.get("searchstats"),
                        "seconds": time.perf_counter() - t0}
                print(json.dumps(line), flush=True)
                if r["valid"] is True or r["valid"] is False:
                    break
    return 0


if __name__ == "__main__":
    sys.exit(main())
