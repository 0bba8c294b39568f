#!/usr/bin/env python3
"""Time the port's kernels and the paths they move, in one checkout or in
turns between two.

One checkout, ``python3 tools/time_torch.py ROOT``: imports
``jepsen_tpu_torch`` from ROOT, builds its kernels and prints one JSON
line with

* the 10k-op register headline's first check through ``linearizable``
  (cold: the level buffers are allocated in it);
* at every state ``chip_smoke.py`` holds the kernels at (single, wide,
  sequential, stag and dense under both tie-breaks, dwide, gang, the
  odd-pass state and each model's first rung), one level past it, each
  kernel held against its plain version and timed as ``chip_smoke.py``
  times it (``check_and_time`` without the plain versions' times): its
  device ms (median of 30 launches, each behind a device-side sleep), its
  ms as a node of a CUDA graph of 64 launches of it alone, its bound, and
  ``torch.sort``'s and ``torch.cummax``'s ms on K2's and K3's inputs;
  and the end of a level pair as graph nodes: K5 alone, and, where the
  checkout's K4 ends the pair itself, that K4 beside K4 alone; and the
  device ms a level of one segment graph launch of up to 512 levels from
  the state (CUDA events behind a device-side sleep, median of 5, each
  from the same state);
* warm, end to end: the 10k-op register headline through
  ``linearizable``, the set model's 10,000-add history, the mutex's
  10,000-op history, the 256-key dense batch through ``check_keyed_gpu``
  (wall and device-batch seconds), and a gang of 8 same-bucket 2,000-op
  requests against the same 8 one by one; the summary divides the
  seconds by their levels (per-level ms: the keyed batch's device
  seconds by its levels launched, the gang's by its deepest member's
  levels).

The states, histories and rungs are ``chip_smoke.py``'s (this checkout's
copy, read as data; its helpers import the package from ROOT).

In turns, ``python3 tools/time_torch.py --turns A B [OUT]``: runs
the one-checkout mode in a fresh process on A, B, B, A on one card and
prints each line, then one JSON line of the medians per checkout (and
writes it to OUT when given). A change is held against its parent this
way, the parent a ``git archive`` of the parent commit unpacked into a
gitignored directory. Needs a CUDA device.
"""

import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
E2E_REPS = 3


def smoke_module():
    """This checkout's chip_smoke.py, loaded under its own name."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_tables", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def one_checkout(root: str) -> dict:
    sys.path.insert(0, root)
    S = smoke_module()
    import jepsen_tpu_torch
    from jepsen_tpu_torch import models, testing
    from jepsen_tpu_torch.checker import gpu as G
    from jepsen_tpu_torch.checker.engine import Engine
    from jepsen_tpu_torch.checker.wgl import linearizable
    from jepsen_tpu_torch.kernels import build, parity
    from jepsen_tpu_torch.models import CASRegister
    from jepsen_tpu_torch.ops.encode import pack_with_init
    assert os.path.dirname(os.path.dirname(
        os.path.abspath(jepsen_tpu_torch.__file__))) == root
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    build.load()
    out = {"root": root, "build_s": time.perf_counter() - t0,
           "states": {}}
    head = testing.simulate_register_history(**S.HEADLINE)
    reg = linearizable(CASRegister(), device=dev)
    t0 = time.perf_counter()
    first = reg.check({}, head)
    out["headline_cold_s"] = time.perf_counter() - t0
    assert first["valid"] is True

    def cols_of(h, model=None, breq=None, cr=None):
        p, kernel = pack_with_init(h, model or CASRegister())
        if cr is None:
            cr = G._crash_width(p.n - p.n_required)
        return p, kernel, G._split_packed(
            p, breq or G._bucket(p.n_required), cr, kernel)

    def pair_end(lv):
        from jepsen_tpu_torch.kernels import search as K
        scal, lmax = lv.carry.scal.clone(), lv.shape.lmax
        seg = torch.tensor([0, 1 << 30, 0, 0], dtype=torch.int32,
                           device=dev)
        out = {"seg_active_graph_ms": S.graph_ms(
            lambda x: K.seg_active(scal, lmax, x), (seg,))}
        if hasattr(lv, "dedup_call"):
            r = S.check_pair_end(lv, plain_times=False)
            out.update(pair_end_graph_ms=r["graph_ms"],
                       dedup_graph_ms=r["dedup_graph_ms"])
        return out

    def segment(lv, levels=512, reps=5):
        state = parity.copy_state(lv.carry, lv.scratch)
        work = parity.copy_state(*state)

        def once():
            S.load_state(work, state)
            torch.cuda.synchronize()
            torch.cuda._sleep(S.SLEEP_CYCLES)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            words, graph = G.run_segment(lv.cols, work[0], work[1],
                                         lv.shape, lv.nr, levels)
            end.record()
            end.synchronize()
            run = G.end_segment(work[0], lv.shape, words, graph)[0]
            return start.elapsed_time(end), run
        once()
        res = [once() for _ in range(reps)]
        run = res[0][1]
        assert all(r == run for _, r in res)
        return {"levels": run,
                "ms_per_level": statistics.median(t for t, _ in res) / run}

    def state(tag, cols, rung, warm, **kw):
        lv = parity.Level(cols, rung, dev, **kw)
        assert lv.advance(warm) > 0, tag
        res = S.check_and_time(lv, parity, plain_times=False)
        out["states"][tag] = {"R": lv.shape.R, "B": lv.shape.B,
                              "pair_end": pair_end(lv),
                              "segment": segment(lv), **{
            name: {k: r[k] for k in ("ms", "graph_ms", "bound_ms",
                                     "library_ms")}
            for name, r in res.items()}}

    _, _, head_cols = cols_of(head)
    state("single", head_cols, S.HEADLINE_RUNG, S.HEADLINE_WARM_LEVELS)
    wide = testing.crash_writes(testing.wide_history(**S.WIDE),
                                S.WIDE_CRASHED_WRITES)
    state("wide", cols_of(wide)[2], S.WIDE_RUNG, S.WIDE_WARM_LEVELS)
    seq = testing.simulate_register_history(**S.SEQUENTIAL)
    state("sequential", cols_of(seq)[2], S.HEADLINE_RUNG, 0)

    keyed = {label: [testing.simulate_register_history(
        S.KEY_OPS, n_procs=5, n_vals=8, seed=7000 + k, **kw)
        for k in range(S.KEYS)] for label, kw in S.KEYED.items()}
    for name, label, rung, cr, warm, tbs, wide_only in S.KEYED_COHORTS:
        packs = [pack_with_init(h, CASRegister())[0] for h in keyed[label]]
        breq = G._bucket(max(p.n_required for p in packs))
        cohort = [cols_of(h, breq=breq, cr=cr)[2]
                  for h, p in zip(keyed[label], packs)
                  if (G._crash_width(p.n - p.n_required) or 0) == cr
                  and (not wide_only or G._window_needed(p) > 32)]
        for tb in tbs:
            state(f"{name} {tb}", cohort, rung, warm, tiebreak=tb)

    regs = [testing.simulate_register_history(seed=S.SERVE_SEED + i,
                                              **S.SERVE)
            for i in range(3 * S.GANG_SIZE)]
    packs = [pack_with_init(h, CASRegister()) for h in regs]
    keys = [Engine.bucket_key(p, k) for p, k in packs]
    main = max(set(keys), key=keys.count)
    gang = [p for (p, _), key in zip(packs, keys) if key == main]
    gang = gang[:S.GANG_SIZE]
    assert len(gang) == S.GANG_SIZE
    kernel = packs[0][1]
    state("gang", [G._split_packed(p, main[1], main[2], kernel)
                   for p in gang], S.GANG_RUNG, S.GANG_WARM_LEVELS)

    model_h = {}
    for tag, (cls, sim, kw) in S.MODEL_HISTORIES.items():
        model = getattr(models, cls)()
        h = getattr(testing, sim)(**kw)
        p, kernel, cols = cols_of(h, model)
        ladder = G._ladder_for(G._window_needed(p), dev)
        state(f"model {tag}", cols, ladder[0], S.MODEL_WARM_LEVELS,
              model=kernel.name)
        if tag == "mutex":
            state("odd", cols, ladder[1], S.MODEL_WARM_LEVELS,
                  model=kernel.name)
        model_h[tag] = (model, h)

    # -- end to end, warm ------------------------------------------------
    def warm(fn, reps=E2E_REPS):
        fn()
        times = []
        for _ in range(reps):
            t1 = time.perf_counter()
            r = fn()
            times.append(time.perf_counter() - t1)
        return r, times

    r, times = warm(lambda: reg.check({}, head))
    out["headline"] = {"levels": r["levels"], "warm_s": times}
    model, h = model_h["set"]
    mset = linearizable(model, device=dev)
    r, times = warm(lambda: mset.check({}, h), reps=2)
    out["set"] = {"levels": r["levels"], "warm_s": times}
    model, h = model_h["mutex"]
    mutex = linearizable(model, device=dev)
    r, times = warm(lambda: mutex.check({}, h))
    out["mutex"] = {"levels": r["levels"], "warm_s": times}

    dense = dict(enumerate(keyed["dense"]))
    batch_s = []

    def keyed_dense():
        res = G.check_keyed_gpu(dense, CASRegister(), device=dev)
        batch_s.append(sum(b["seconds"] for b in res["batches"]))
        return res
    r, times = warm(keyed_dense, reps=2)
    out["keyed_dense"] = {
        "valid": r["valid"], "wall_s": times, "batch_s": batch_s[1:],
        "levels_launched": sum(b["levels-launched"] for b in r["batches"])}

    kernel = packs[0][1]
    g_times, s_times = [], []
    members = G.check_packed_gang_gpu(gang, kernel, device=dev)
    for rep in range(E2E_REPS):
        for mode in (("gang", "serial") if rep % 2 == 0
                     else ("serial", "gang")):
            t1 = time.perf_counter()
            if mode == "gang":
                G.check_packed_gang_gpu(gang, kernel, device=dev)
                g_times.append(time.perf_counter() - t1)
            else:
                for p in gang:
                    G.check_packed_gpu(p, kernel, device=dev)
                s_times.append(time.perf_counter() - t1)
    out["gang_vs_serial"] = {"gang_s": g_times, "serial_s": s_times,
                             "levels": max(m["levels"] for m in members)}
    return out


def turns(a: str, b: str, dest=None) -> int:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    runs = []
    for root in (a, b, b, a):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               os.path.abspath(root)],
                              capture_output=True, text=True)
        sys.stderr.write(proc.stderr[-4000:])
        if proc.returncode != 0:
            print(f"time_torch: {root} failed ({proc.returncode})")
            return 1
        line = json.loads(proc.stdout.strip().splitlines()[-1])
        print(json.dumps(line), flush=True)
        runs.append(line)
    summary = {"nvidia_smi": smi}
    for root in (a, b):
        mine = [r for r in runs if r["root"] == os.path.abspath(root)]
        med = statistics.median
        states = mine[0]["states"]
        summary[root] = {
            # per state and kernel: [isolated ms, in-graph ms] of each run
            "kernels": {tag: {name: [[r["states"][tag][name][k]
                                      for k in ("ms", "graph_ms")]
                                     for r in mine]
                              for name in states[tag]
                              if name not in ("R", "B", "pair_end",
                                              "segment")}
                        for tag in states},
            # per state: each run's device ms a level of one segment
            # graph launch (and the levels it ran)
            "segment": {tag: [r["states"][tag]["segment"] for r in mine]
                        for tag in states},
            # per state: each run's graph-node ms of K5 alone and of K4
            # ending the pair beside K4 alone
            "pair_end": {tag: [r["states"][tag]["pair_end"] for r in mine]
                         for tag in states},
            "bound_ms": {tag: {name: v["bound_ms"]
                               for name, v in states[tag].items()
                               if name not in ("R", "B", "pair_end",
                                               "segment")}
                         for tag in states},
            "headline_cold_s": [r["headline_cold_s"] for r in mine],
            "headline_warm_s": med(t for r in mine
                                   for t in r["headline"]["warm_s"]),
            "headline_levels": mine[0]["headline"]["levels"],
            "set_warm_s": med(t for r in mine for t in r["set"]["warm_s"]),
            "set_levels": mine[0]["set"]["levels"],
            "mutex_warm_s": med(t for r in mine
                                for t in r["mutex"]["warm_s"]),
            "mutex_levels": mine[0]["mutex"]["levels"],
            "keyed_dense_wall_s": med(t for r in mine
                                      for t in r["keyed_dense"]["wall_s"]),
            "keyed_dense_batch_s": med(t for r in mine for t in
                                       r["keyed_dense"]["batch_s"]),
            "gang_s": med(t for r in mine
                          for t in r["gang_vs_serial"]["gang_s"]),
            "gang_levels": mine[0]["gang_vs_serial"]["levels"],
            "keyed_dense_levels": mine[0]["keyed_dense"]["levels_launched"],
            "serial_s": med(t for r in mine
                            for t in r["gang_vs_serial"]["serial_s"]),
        }
        one = summary[root]
        one["per_level_ms"] = {
            name: one[f"{name}_warm_s"] / one[f"{name}_levels"] * 1e3
            for name in ("headline", "set", "mutex")}
        one["per_level_ms"]["gang"] = (one["gang_s"] / one["gang_levels"]
                                       * 1e3)
        one["per_level_ms"]["keyed_dense"] = (
            one["keyed_dense_batch_s"] / one["keyed_dense_levels"] * 1e3)
    print(json.dumps(summary), flush=True)
    if dest:
        with open(dest, "w") as fh:
            json.dump({"runs": runs, "summary": summary}, fh)
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("time_torch: no CUDA device", file=sys.stderr)
        return 1
    args = sys.argv[1:]
    if args and args[0] == "--turns":
        return turns(args[1], args[2], args[3] if len(args) > 3 else None)
    root = os.path.abspath(args[0] if args else HERE)
    print(json.dumps(one_checkout(root)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
