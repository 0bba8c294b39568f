#!/usr/bin/env python3
"""Profile the first check of a fresh process (the cold headline), in one
checkout or in turns between two.

``python3 tools/profile_torch_cold.py ROOT MODE`` imports
``jepsen_tpu_torch`` from ROOT, builds its kernels, and times the 10k-op
register headline's (``chip_smoke.py``'s) first check through
``linearizable``, as ``tools/time_torch.py``'s ``headline_cold_s``, then
the median of WARM warm checks. MODE is one of

* ``raw``: as ``tools/time_torch.py`` does;
* ``ctx``: CUDA's context made first (a one-element tensor on the card,
  synchronized), so that the cold time leaves its creation out;
* ``prof``: ``raw`` under ``cProfile``: the cumulative seconds of the
  functions in PROBES and the first TOP functions by cumulative time.

It prints one JSON line.

``python3 tools/profile_torch_cold.py --turns A B [OUT]`` runs every mode
in a fresh process on A, B, B, A, A, B, B, A on one card, prints each line
and then one JSON line of the medians per checkout and mode (written to OUT
when given), with the card's ``nvidia-smi`` name and power limit. A change
is held against its parent this way, the parent a ``git archive`` of the
parent commit unpacked into a gitignored directory. Needs a CUDA device.
"""

import cProfile
import importlib.util
import json
import os
import pstats
import statistics
import subprocess
import sys
import time

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODES = ("raw", "ctx", "prof")
WARM = 5
TOP = 25
#: (file name, function) pairs whose cumulative seconds ``prof`` reports
PROBES = (("resilience.py", "<module>"), ("plan.py", "<module>"),
          ("resilience.py", "supervised_check_packed"),
          ("plan.py", "gate_ladder"), ("plan.py", "seed_rung"),
          ("plan.py", "from_packed"), ("devices.py", "headroom_ratio"),
          ("memory.py", "mem_get_info"), ("__init__.py", "_lazy_init"),
          ("engine.py", "state"), ("engine.py", "batch_cols"),
          ("engine.py", "segment_graph"), ("gpu.py", "run_segment"),
          ("gpu.py", "end_segment"), ("gpu.py", "_prep_single"),
          ("interop.py", "stack_cols"), ("interop.py", "carry_to_numpy"),
          ("interop.py", "batch_cols_from_numpy"),
          ("resilience.py", "_device_segment"))


def headline():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_tables", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.HEADLINE


def probes(prof: cProfile.Profile) -> tuple:
    stats = pstats.Stats(prof).stats
    found = {f"{f}:{fn}": 0.0 for f, fn in PROBES}
    rows = []
    for (path, line, fn), (_, _, tt, ct, _) in stats.items():
        name = os.path.basename(path)
        key = f"{name}:{fn}"
        if key in found:
            found[key] += ct
        rows.append((ct, tt, f"{name}:{line}:{fn}"))
    rows.sort(reverse=True)
    return found, [{"fn": r[2], "cum_s": r[0], "self_s": r[1]}
                   for r in rows[:TOP]]


def one_checkout(root: str, mode: str) -> dict:
    sys.path.insert(0, root)
    spec = headline()
    import jepsen_tpu_torch
    from jepsen_tpu_torch import testing
    from jepsen_tpu_torch.checker.wgl import linearizable
    from jepsen_tpu_torch.kernels import build
    from jepsen_tpu_torch.models import CASRegister
    assert os.path.dirname(os.path.dirname(
        os.path.abspath(jepsen_tpu_torch.__file__))) == root
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    build.load()
    out = {"root": root, "mode": mode, "build_s": time.perf_counter() - t0}
    head = testing.simulate_register_history(**spec)
    reg = linearizable(CASRegister(), device=dev)
    if mode == "ctx":
        t0 = time.perf_counter()
        torch.ones(1, device=dev)
        torch.cuda.synchronize()
        out["context_s"] = time.perf_counter() - t0
    prof = cProfile.Profile() if mode == "prof" else None
    t0 = time.perf_counter()
    if prof is not None:
        prof.enable()
    first = reg.check({}, head)
    if prof is not None:
        prof.disable()
    out["cold_s"] = time.perf_counter() - t0
    assert first["valid"] is True
    out["levels"] = first["levels"]
    if prof is not None:
        out["probes_s"], out["top"] = probes(prof)
    warm = []
    for _ in range(WARM):
        t0 = time.perf_counter()
        r = reg.check({}, head)
        warm.append(time.perf_counter() - t0)
        assert r["levels"] == first["levels"]
    out["warm_s"] = warm
    return out


def turns(a: str, b: str, dest=None) -> int:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    runs = []
    for root in (a, b, b, a, a, b, b, a):
        for mode in MODES:
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__),
                 os.path.abspath(root), mode], capture_output=True,
                text=True, timeout=900)
            sys.stderr.write(proc.stderr[-2000:])
            if proc.returncode != 0:
                print(f"profile_torch_cold: {root} {mode} failed "
                      f"({proc.returncode})")
                return 1
            line = json.loads(proc.stdout.strip().splitlines()[-1])
            print(json.dumps({k: v for k, v in line.items() if k != "top"}),
                  flush=True)
            runs.append(line)
    med = statistics.median
    summary = {"nvidia_smi": smi}
    for root in (a, b):
        mine = [r for r in runs if r["root"] == os.path.abspath(root)]
        one = {}
        for mode in MODES:
            rs = [r for r in mine if r["mode"] == mode]
            one[mode] = {"cold_s": [r["cold_s"] for r in rs],
                         "cold_median_s": med(r["cold_s"] for r in rs),
                         "warm_median_s": med(t for r in rs
                                              for t in r["warm_s"])}
            if mode == "ctx":
                one[mode]["context_s"] = [r["context_s"] for r in rs]
            if mode == "prof":
                one[mode]["probes_median_s"] = {
                    k: med(r["probes_s"][k] for r in rs)
                    for k in rs[0]["probes_s"]}
                one[mode]["top_first_run"] = rs[0]["top"]
        summary[root] = one
    print(json.dumps(summary), flush=True)
    if dest:
        with open(dest, "w") as fh:
            json.dump({"runs": runs, "summary": summary}, fh)
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_torch_cold: no CUDA device", file=sys.stderr)
        return 1
    args = sys.argv[1:]
    if args and args[0] == "--turns":
        return turns(args[1], args[2], args[3] if len(args) > 3 else None)
    root = os.path.abspath(args[0] if args else HERE)
    mode = args[1] if len(args) > 1 else "raw"
    if mode not in MODES:
        print(f"profile_torch_cold: mode {mode!r} is not one of {MODES}",
              file=sys.stderr)
        return 2
    print(json.dumps(one_checkout(root, mode)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
