#!/usr/bin/env python3
"""Time chosen phases of ``chip_smoke.py`` alone on one NVIDIA GPU.

``segment loop`` (with its ``resume``) is run once for each value of
``--loop-levels`` given, in that order, each time at every state the
smoke holds the kernels at (the headline, the wide and the sequential
states, the keyed cohorts under both tie-breaks, the gang, each model's
and the mutex's second rung), with each state's seconds split into its
warm levels, K4 ending a pair, K5 alone and the graph-against-host-loop
comparison (graph, host loop and plain route apart). ``cli`` runs the
smoke's command-line phase, over a local-kv run recorded first through
``python -m jepsen_tpu_torch run`` (in the smoke, the runner phase's);
``--telemetry`` runs the ``daemon telemetry`` phase after it (it implies
``--cli``, whose watched run and lone checks it serves). ``--runner``
runs the test runner phase, ``--fleet`` the ``fleet`` phase (the
pool-sharded search, the elastic fleet on worker processes, ``serve
--fleet 2``, and the keyed check and the pool-sharded search over two
gloo ranks), ``--suites`` the
``suites`` and ``cas-suites`` phases, and ``--ci-tools`` the ``ci
tools`` phase (the port's soak, chaos matrix and two gates, each a
process; a tree without the phase is reported and skipped, so that
parent and change can be timed in turns). Every assertion
of the smoke's phases holds here too. It prints each phase's seconds,
the card's ``nvidia-smi`` name and power limit and, last, one JSON line
with the phases' lines::

    python3 tools/time_torch_smoke_phases.py --loop-levels 128 16 --cli
    python3 tools/time_torch_smoke_phases.py --telemetry
    python3 tools/time_torch_smoke_phases.py --runner --fleet
    python3 tools/time_torch_smoke_phases.py --suites --ci-tools

Run from the repository root; it needs a CUDA device and nvcc.
"""

import argparse
import json
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as S  # noqa: E402


def loop_recipes(dev):
    """The (state, columns, rung, Level keywords, warm levels) recipes
    that chip_smoke.py's ``segment loop`` starts from, and the headline's
    packed history, kernel and result."""
    from jepsen_tpu_torch import resilience
    from jepsen_tpu_torch.checker import gpu as G
    from jepsen_tpu_torch.models import CASRegister
    from jepsen_tpu_torch.ops.encode import pack_with_init
    from jepsen_tpu_torch.testing import (crash_writes,
                                          simulate_register_history,
                                          wide_history)

    def packed_cols(history):
        packed, kernel = pack_with_init(history, CASRegister())
        cr = G._crash_width(packed.n - packed.n_required)
        return packed, kernel, G._split_packed(
            packed, G._bucket(packed.n_required), cr, kernel)

    head_p, head_kernel, head_cols = packed_cols(
        simulate_register_history(**S.HEADLINE))
    _, _, wide_cols = packed_cols(crash_writes(wide_history(**S.WIDE),
                                               S.WIDE_CRASHED_WRITES))
    _, _, seq_cols = packed_cols(simulate_register_history(**S.SEQUENTIAL))
    recipes = [("headline", head_cols, S.HEADLINE_RUNG, {},
                S.HEADLINE_WARM_LEVELS),
               ("wide", wide_cols, S.WIDE_RUNG, {}, S.WIDE_WARM_LEVELS),
               ("sequential", seq_cols, S.HEADLINE_RUNG, {}, 0)]
    keyed = {label: {k: simulate_register_history(
        S.KEY_OPS, n_procs=5, n_vals=8, seed=7000 + k, **kw)
        for k in range(S.KEYS)} for label, kw in S.KEYED.items()}
    for name, label, rung, cr, warm, tbs, wide in S.KEYED_COHORTS:
        cohort = S.cohort_cols(keyed[label].values(), cr, wide)
        for tb in tbs:
            recipes.append((f"keyed {name} {tb}", cohort, rung,
                            {"tiebreak": tb}, warm))
    r = resilience.supervised_check_packed(head_p, head_kernel, device=dev)
    return recipes, head_p, head_kernel, r


def local_kv_store(device: str = "cuda", root=None) -> str:
    """A local-kv run's store directory, recorded by ``python -m
    jepsen_tpu_torch run`` under ``root`` (default: a new temporary
    directory)."""
    import tempfile
    root = root or tempfile.mkdtemp(prefix="jtpu-kv-store-")
    rc, out, err = S.port_cmd("run", "--suite", "local-kv", "--device",
                              device, "--time-limit", "3", "--store-root",
                              root)
    assert rc == 0, (rc, out[-2000:], err[-2000:])
    runs = os.path.join(root, "local-kv")
    return os.path.join(runs, next(d for d in os.listdir(runs)
                                   if d != "latest"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--loop-levels", type=int, nargs="*", default=[],
                    help="run the segment loop phase at each of these "
                         "LOOP_LEVELS, in order")
    ap.add_argument("--cli", action="store_true",
                    help="run the command-line phase")
    ap.add_argument("--telemetry", action="store_true",
                    help="run the command-line phase, then the daemon "
                         "telemetry phase")
    ap.add_argument("--runner", action="store_true",
                    help="run the test runner phase")
    ap.add_argument("--fleet", action="store_true",
                    help="run the fleet phase")
    ap.add_argument("--suites", action="store_true",
                    help="run the suites and cas-suites phases")
    ap.add_argument("--ci-tools", action="store_true",
                    help="run the ci tools phase")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device is available", file=sys.stderr)
        return 1
    from jepsen_tpu_torch.kernels import build
    dev = torch.device("cuda")
    smi = S.nvidia_smi()
    print(smi, flush=True)
    seconds, out = {}, {}
    with S.phase("build", seconds):
        build.load()
    if args.loop_levels:
        with S.phase("recipes", seconds):
            recipes, head_p, head_kernel, r = loop_recipes(dev)
        for n in args.loop_levels:
            S.LOOP_LEVELS = n
            loop_seconds = {}
            loops, _ = S.segment_loop_phases(dev, loop_seconds,
                                             list(recipes), head_p,
                                             head_kernel, r)
            out[f"loop_{n}"] = {"phase_seconds": loop_seconds,
                                "states": loops}
            seconds[f"segment loop {n}"] = loop_seconds["segment loop"]
    if args.runner:
        line, launches, grid, segs, kv_store = S.runner_phase(dev, seconds,
                                                              smi)
        out["runner"] = dict(line, launches=launches, pair_ends=segs[
            "pair_ends"])
        import shutil
        shutil.rmtree(kv_store, ignore_errors=True)
    if args.fleet:
        line, launches, grid, segs, merge = S.fleet_phase(dev, seconds, smi)
        out["fleet"] = dict(line, launches=launches, merge=merge)
    if args.suites:
        for tag, fn in (("suites", S.suites_phase),
                        ("cas_suites", S.cas_suites_phase)):
            line, launches, grid, segs = fn(dev, seconds, smi)
            out[tag] = dict(line, launches=launches)
    if args.ci_tools:
        if hasattr(S, "ci_tools_phase"):
            line, launches, grid, segs = S.ci_tools_phase(dev, seconds, smi)
            out["ci_tools"] = dict(line, launches=launches)
        else:
            print("no ci tools phase in this tree", flush=True)
    if args.cli or args.telemetry:
        kv_store = local_kv_store()
        line, launches, pair_ends, kept = S.cli_phase(dev, seconds, smi,
                                                      kv_store)
        out["cli"] = dict(line, launches=launches, pair_ends=pair_ends)
        if args.telemetry:
            line, launches, pair_ends = S.daemon_telemetry_phase(
                dev, seconds, smi, kv_store, kept)
            out["daemon_telemetry"] = dict(line, launches=launches,
                                           pair_ends=pair_ends)
    print(json.dumps({"phase_seconds": seconds, "nvidia_smi": smi, **out},
                     default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
