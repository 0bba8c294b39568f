#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Builds the search kernels from ``jepsen_tpu_torch/csrc`` with nvcc, holds
each kernel bit for bit against its plain PyTorch version on the card at
the headline shape and at a wide shape, and times both. Then it checks the
10k-op CAS-register headline history end to end through
``linearizable(CASRegister())`` (the GPU backend), counting each kernel's
launches on that path and holding the run against the plain versions; then
an invalid history and a wide one. Every phase is a hard assertion.

It prints the card's ``nvidia-smi`` name and power limit, one JSON line of
per-kernel numbers and, last, ``{"ok": true, "device": {...}}``. Without a
CUDA device it exits non-zero and prints no result.

Run from the repository root: ``python3 chip_smoke.py``.
"""

import json
import os
import random
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

#: the headline history (the bench's cas-register-10k-op-linearize shape)
HEADLINE = dict(n_ops=10000, n_procs=5, n_vals=16, seed=42, crash_p=0.002)
HEADLINE_RUNG = (128, 32, 8)
#: levels run before the kernels are held against their plain versions
HEADLINE_WARM_LEVELS = 300
#: a 2,000-op history with one corrupted read (refuted on the third rung)
INVALID = dict(n_ops=2000, n_procs=5, n_vals=16, seed=16)
#: the wide history (needed window > 64: four mask words)
WIDE = dict(n_procs=100, rounds=2, seed=5)
WIDE_RUNG = (512, 128, 512)
WIDE_WINDOW = 128
WIDE_WARM_LEVELS = 8
#: ok writes of the wide history turned into crashes, so that CR > 0
WIDE_CRASHED_WRITES = 6

#: H100 SXM peaks from its datasheet: HBM bytes/s, and the
#: non-tensor 32-bit rate, against which the integer work is counted
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = 67e12
#: GPU-side delay before a timed launch, so the window holds device time
#: only (about 10 ms at H100 clocks)
SLEEP_CYCLES = 20_000_000
REPS = 30

SOURCE = "jepsen_tpu_torch/csrc/search.cu"
REPLACES = {
    "expand": "jepsen_tpu/checker/tpu.py:377",
    "sort_rows": "jepsen_tpu/checker/tpu.py:581",
    "group_scan": "jepsen_tpu/checker/tpu.py:605",
    "dedup_truncate": "jepsen_tpu/checker/tpu.py:589",
}


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0]


def device_ms(fn, prep):
    """Median device time of ``fn(*prep())``: a GPU-side sleep holds the
    stream while the host enqueues, so the events bracket device work."""
    times = []
    for _ in range(REPS):
        args = prep()
        torch.cuda.synchronize()
        torch.cuda._sleep(SLEEP_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_ms(fn, prep):
    """Median wall time of ``fn(*prep())`` from a synchronised start to a
    synchronised end (the plain versions synchronise inside)."""
    times = []
    for _ in range(REPS):
        args = prep()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(*args)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def check_and_time(lv, parity):
    """One level from ``lv``'s state, stage by stage: each kernel against
    its plain version from identical inputs (tolerance 0), then both
    timed from those inputs."""
    out = {}
    for name, kern, plain, state, err in lv.walk():
        assert err == 0, f"{name}: kernel and plain version disagree"
        out[name] = {
            "max_abs_err": err,
            "ms": device_ms(kern, lambda: parity.copy_state(*state)),
            "plain_ms": host_ms(plain, lambda: parity.copy_state(*state)),
            "library_ms": None,
        }
        if name == "sort_rows":
            keys = state[1].rows[:lv.shape.R, 0]
            # one PyTorch call as a yardstick: a stable sort of the first
            # key only (no single call sorts on the whole row)
            out[name]["library_ms"] = device_ms(
                lambda k: torch.sort(k, stable=True),
                lambda: (keys.clone(),))
    add_bounds(out, lv)
    return out


def add_bounds(out, lv):
    """The least time the card could take for each kernel's work on this
    state: bytes (each input read once, each output written once) over
    HBM bandwidth, against integer operations over the 32-bit rate."""
    sh = lv.shape
    C, E, W, R, NK, MW, MCX, CR = (sh.C, sh.E, sh.W, sh.R, sh.NK, sh.MW,
                                   sh.MCX, sh.CR)
    pool_b = C * (4 * (2 + MW + MCX) + 1)
    # the column entries the expanded rows' windows touch, five words each
    # (f, v1, v2, ro, inv), the crashed columns, and ret and sm per row
    k_e = lv.carry.pool.k[:E].to(torch.int64)
    window = k_e[:, None] + torch.arange(W, device=k_e.device)
    touched = int(torch.unique(window.clamp(0, sh.n - 1)).numel())
    cols_b = touched * 4 * 5 + CR * 4 * 5 + E * 4 * 2
    work = {
        "expand": (pool_b + cols_b + sh.RP * NK * 4, E * (W + CR) * 24),
        "sort_rows": (2 * R * NK * 4, R * max(1, int(np.log2(R))) * NK),
        "group_scan": (R * (3 + MW) * 4 + R * 4, R * (3 + MW)),
        "dedup_truncate": (R * NK * 4 + R * 4 + pool_b
                           + C * (4 * (4 + MW + MCX) + 2),
                           R * (NK + (8 * (3 + MW + MCX) if CR else 0))),
    }
    for name, (nbytes, nops) in work.items():
        tb, to = nbytes / PEAK_BYTES_S * 1e3, nops / PEAK_OPS_S * 1e3
        out[name].update(bound_ms=max(tb, to),
                         bound_by="bytes" if tb >= to else "operations",
                         bytes=nbytes, ops=nops)


def carries_equal(a, b):
    return len(a) == len(b) and all(
        np.array_equal(np.asarray(x), np.asarray(y)) for x, y in zip(a, b))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    smoke(torch.device("cuda"))
    return 0


def smoke(dev: torch.device) -> None:
    """Every phase on ``dev``; any failure raises."""
    from jepsen_tpu_torch import interop, resilience
    from jepsen_tpu_torch.checker import gpu as G
    from jepsen_tpu_torch.checker.wgl import linearizable
    from jepsen_tpu_torch.kernels import build, parity
    from jepsen_tpu_torch.kernels import search as K
    from jepsen_tpu_torch.models import CASRegister
    from jepsen_tpu_torch.ops.encode import pack_with_init
    from jepsen_tpu_torch.testing import (corrupt_one_read, crash_writes,
                                          simulate_register_history,
                                          wide_history)

    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    print(f"device: {kind} count={torch.cuda.device_count()} "
          f"torch={torch.__version__} cuda={torch.version.cuda}")
    print(smi)

    # -- build --------------------------------------------------------------
    t0 = time.perf_counter()
    build.load()
    print(f"build: {time.perf_counter() - t0:.2f} s "
          f"{os.path.relpath(build.library_path())}")
    with open(build.library_path()[:-3] + ".log") as fh:
        for line in fh:
            if "registers" in line or "spill" in line:
                print("  ptxas:", line.strip())

    def packed_cols(history):
        packed, kernel = pack_with_init(history, CASRegister())
        cr = G._crash_width(packed.n - packed.n_required)
        return packed, kernel, G._split_packed(
            packed, G._bucket(packed.n_required), cr, kernel)

    # -- kernels against their plain versions, timed ------------------------
    head = simulate_register_history(**HEADLINE)
    head_p, head_kernel, head_cols = packed_cols(head)
    wide = crash_writes(wide_history(**WIDE), WIDE_CRASHED_WRITES)
    _, _, wide_cols = packed_cols(wide)
    shapes, level_shapes = {}, {}
    for tag, cols_np, rung, warm in (
            ("headline", head_cols, HEADLINE_RUNG, HEADLINE_WARM_LEVELS),
            ("wide", wide_cols, WIDE_RUNG, WIDE_WARM_LEVELS)):
        lv = parity.Level(cols_np, rung, dev)
        live = lv.advance(warm)
        sh = lv.shape
        assert live > 0 and sh.CR > 0, tag
        res = check_and_time(lv, parity)
        shapes[tag], level_shapes[tag] = res, sh
        print(f"kernels at {tag}: rung={rung} n={sh.n} CR={sh.CR} MW={sh.MW} "
              f"R={sh.R} RP={sh.RP} NK={sh.NK} live={live} after {warm} "
              f"levels")
        for name, r in res.items():
            print(f"  {name:15s} err={r['max_abs_err']} "
                  f"ms={r['ms']:.4f} plain_ms={r['plain_ms']:.3f} "
                  f"bound_ms={r['bound_ms']:.6f} ({r['bound_by']})"
                  + (f" library_ms={r['library_ms']:.4f}"
                     if r["library_ms"] is not None else ""))
    # the wide shape crosses the sort's and the scan's block boundaries
    assert level_shapes["wide"].RP > 1024

    # -- headline end to end: the main path ---------------------------------
    checker = linearizable(CASRegister(), device=dev)
    K.reset_launches()
    t0 = time.perf_counter()
    r = checker.check({}, head)
    cold = time.perf_counter() - t0
    launches = dict(K.launches)
    print(f"headline: valid={r['valid']} levels={r['levels']} "
          f"rung={r['rung']} segments={r['segments']} cold_s={cold:.3f} "
          f"launches={launches}")
    assert r["valid"] is True and r["backend"] == "gpu"
    assert "fallback-from" not in r
    assert all(v > 0 for v in launches.values()), launches
    t0 = time.perf_counter()
    r2 = checker.check({}, head)
    warm_s = time.perf_counter() - t0
    assert r2["valid"] is True and r2["levels"] == r["levels"]
    print(f"headline: warm_s={warm_s:.3f} "
          f"per_level_ms={warm_s / r['levels'] * 1e3:.4f} "
          f"searchstats={r['searchstats']}")

    # the first segment, kernels against plain versions, every lane
    seg = {}
    for name, ops in (("kernels", G.KERNELS), ("plain", G.PLAIN)):
        lv = parity.Level(head_cols, r["rung"], dev)
        t0 = time.perf_counter()
        G.run_segment(lv.cols, lv.carry, lv.scratch, lv.shape, lv.nr,
                      G.DEFAULT_SEGMENT_ITERS, ops)
        seg[name] = interop.carry_to_numpy(lv.carry)
        print(f"first segment ({name}): {time.perf_counter() - t0:.3f} s, "
              f"level={int(seg[name][8])}")
    assert carries_equal(seg["kernels"], seg["plain"]), "first segment"

    # the whole run, against the plain versions' run
    t0 = time.perf_counter()
    rp = resilience.supervised_check_packed(head_p, head_kernel, device=dev,
                                            ops=G.PLAIN)
    print(f"headline plain run: valid={rp['valid']} levels={rp['levels']} "
          f"best_k={rp['best-k']} vs kernels best_k={r['best-k']} "
          f"({time.perf_counter() - t0:.1f} s)")
    assert (rp["valid"], rp["levels"], rp["best-k"], rp["rung"]) == (
        r["valid"], r["levels"], r["best-k"], r["rung"])

    # -- an invalid history -------------------------------------------------
    cfg = dict(INVALID)
    seed = cfg.pop("seed")
    bad = corrupt_one_read(simulate_register_history(seed=seed, **cfg),
                           random.Random(seed))
    t0 = time.perf_counter()
    ri = checker.check({}, bad)
    ti = time.perf_counter() - t0
    bad_p, bad_kernel, _ = packed_cols(bad)
    rip = resilience.supervised_check_packed(bad_p, bad_kernel, device=dev,
                                             ops=G.PLAIN)
    print(f"invalid: valid={ri['valid']} levels={ri['levels']} "
          f"rung={ri['rung']} prefix={ri.get('max-linearized-prefix')} "
          f"plain prefix={rip.get('max-linearized-prefix')} "
          f"work={ri['work']} ({ti:.2f} s)")
    assert ri["valid"] is False and ri["backend"] == "gpu"
    assert rip["valid"] is False
    assert ri["max-linearized-prefix"] == rip["max-linearized-prefix"]
    assert ri["levels"] == rip["levels"] and ri["work"] == rip["work"]

    # -- a wide history (four mask words) -----------------------------------
    wh = wide_history(**WIDE)
    t0 = time.perf_counter()
    rw = checker.check({}, wh)
    tw = time.perf_counter() - t0
    wp, wk, _ = packed_cols(wh)
    rwp = resilience.supervised_check_packed(wp, wk, device=dev, ops=G.PLAIN)
    print(f"wide: valid={rw['valid']} levels={rw['levels']} "
          f"rung={rw['rung']} ({tw:.2f} s); plain levels={rwp['levels']}")
    assert rw["valid"] is True and rw["rung"][1] == WIDE_WINDOW
    assert (rwp["valid"], rwp["levels"]) == (rw["valid"], rw["levels"])

    # -- summary ------------------------------------------------------------
    kernels = []
    for name in ("expand", "sort_rows", "group_scan", "dedup_truncate"):
        h, w = shapes["headline"][name], shapes["wide"][name]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": max(h["max_abs_err"], w["max_abs_err"]),
            "ms": h["ms"], "plain_ms": h["plain_ms"],
            "bound_ms": h["bound_ms"], "bound_by": h["bound_by"],
            "library_ms": h["library_ms"],
            "wide": {k: w[k] for k in ("ms", "plain_ms", "bound_ms",
                                       "bound_by", "library_ms")},
        })
    print(json.dumps({"kernels": kernels, "headline": {
        "cold_s": cold, "warm_s": warm_s, "levels": r["levels"],
        "invalid_s": ti, "wide_s": tw}, "nvidia_smi": smi}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
