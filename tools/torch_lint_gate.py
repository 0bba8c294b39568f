#!/usr/bin/env python
"""The port's lint gate: run the port's static-analyzer passes over
``jepsen_tpu_torch/`` and exit nonzero on any finding not covered by the
port's baseline (``jepsen_tpu_torch/analysis/lint.baseline``).

The port's copy of ``tools/lint_gate.py``. Stricter than ``python -m
jepsen_tpu_torch lint`` (whose exit code gates on new *errors* only): new
warnings fail it too; fix them or accept them into the baseline with a
one-line justification.

On top of the repo scan this gate runs the plan fixture matrix
(``jepsen_tpu_torch.analysis.plan_lint.PLAN_MATRIX``) with each
candidate's level shape checked against the kernels, on the CPU and with
no kernel built. ``--no-plan`` skips that (the arithmetic matrix still
runs inside the repo scan).

Stale baseline entries (accepted debt that was since fixed) warn, and
the warnings ESCALATE: a sidecar counter file next to the baseline
(``<baseline>.stale``) tracks how many consecutive gate runs each
entry has been stale; past ``--stale-grace`` runs (default 3) the gate
fails until someone runs ``python -m jepsen_tpu_torch lint
--prune-stale``.
A clean run deletes the sidecar.

Usage: python tools/torch_lint_gate.py [--baseline FILE] [--root DIR]
                                       [--sarif OUT] [--no-plan]
                                       [--stale-grace N]
Exit code 0 iff the tree is clean against the baseline.
``--sarif OUT`` additionally writes the new findings as SARIF 2.1.0 so
CI can annotate the pull request inline.
"""

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from jepsen_tpu_torch import analysis  # noqa: E402
from jepsen_tpu_torch.analysis import baseline as bl  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--baseline", default=None,
                    help="baseline file (default: "
                         "jepsen_tpu_torch/analysis/lint.baseline)")
    ap.add_argument("--root", default=None, help="repo root override")
    ap.add_argument("--sarif", default=None, metavar="OUT",
                    help="also write the new findings as SARIF 2.1.0 "
                         "(forge PR annotation)")
    ap.add_argument("--no-plan", action="store_true",
                    help="skip the plan matrix's shape check (the "
                         "arithmetic plan pass still runs)")
    ap.add_argument("--stale-grace", type=int, default=3, metavar="N",
                    help="fail once a baseline entry has been stale "
                         "for more than N consecutive gate runs "
                         "(default: 3; prune with 'python -m "
                         "jepsen_tpu_torch lint --prune-stale')")
    args = ap.parse_args()

    root = args.root or REPO
    bpath = args.baseline or bl.default_path(root)
    findings = analysis.lint_repo(root=root)
    if not args.no_plan:
        # the repo scan's arithmetic plan rows, again with each
        # candidate's level shape checked against the kernels
        from jepsen_tpu_torch.analysis import plan_lint
        t0 = time.time()
        traced = plan_lint.lint_matrix(trace=True)
        findings = ([f for f in findings if not f.path.startswith("plan:")]
                    + traced)
        print(f"# lint-gate: plan matrix shape-checked "
              f"({len(plan_lint.PLAN_MATRIX)} row(s) in "
              f"{time.time() - t0:.1f}s, no kernel built)")
    accepted_keys = bl.load(bpath)
    new, accepted = bl.split(findings, accepted_keys)

    # A baseline entry that no longer matches anything is stale — warn
    # so accepted debt gets cleaned out when the finding is fixed. The
    # warnings escalate: the sidecar counts consecutive stale runs per
    # key, and past the grace the gate fails until a prune.
    live = {f.key() for f in findings}
    stale = [k for k in accepted_keys if k not in live]
    sidecar = bpath + ".stale"
    counts = {}
    if os.path.exists(sidecar):
        try:
            with open(sidecar, encoding="utf-8") as f:
                counts = {k: int(v) for k, v in json.load(f).items()}
        except (OSError, ValueError):
            counts = {}
    counts = {k: counts.get(k, 0) + 1 for k in stale}
    if stale:
        try:
            with open(sidecar, "w", encoding="utf-8") as f:
                json.dump(counts, f, indent=0, sort_keys=True)
        except OSError:
            pass
    elif os.path.exists(sidecar):
        try:
            os.unlink(sidecar)
        except OSError:
            pass
    stale_over = sorted(k for k, n in counts.items()
                        if n > args.stale_grace)
    for k in stale:
        print(f"# lint-gate: stale baseline entry (fixed? remove it): "
              f"{k} [{counts[k]}/{args.stale_grace} warning(s)]")

    for f in sorted(new, key=lambda x: (x.path, x.line)):
        print(f.format())
    print(analysis.summary_line(new))
    if accepted:
        print(f"# lint-gate: {len(accepted)} finding(s) accepted by "
              f"{bpath}")
    if args.sarif:
        from jepsen_tpu_torch.analysis import sarif
        sarif.write(args.sarif, new)
        print(f"# lint-gate: wrote SARIF ({len(new)} new finding(s)) "
              f"to {args.sarif}")
    if new:
        print(f"# lint-gate: FAILED — {len(new)} new finding(s) not in "
              f"the baseline; fix them or accept them with a "
              f"justification", file=sys.stderr)
        return 1
    if stale_over:
        print(f"# lint-gate: FAILED — {len(stale_over)} baseline "
              f"entr{'y' if len(stale_over) == 1 else 'ies'} stale "
              f"past the {args.stale_grace}-run grace; run 'python -m "
              f"jepsen_tpu_torch lint --prune-stale'", file=sys.stderr)
        return 1
    print("# lint-gate: clean against the baseline")
    return 0


if __name__ == "__main__":
    sys.exit(main())
