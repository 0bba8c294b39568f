#!/usr/bin/env python3
"""The candidate window the device search needs for histories recorded by
the port's runner, in append order and in time order.

``core.run`` runs N atom tests (``testing.atom_test`` with
``gen.clients(gen.limit(OPS, gen.cas_gen()))`` at concurrency 5) and, for
each, prints the window the packed history needs (``checker.gpu``'s
``_window_needed``) as the ops were appended (the run's ``history.wal``)
and as the run stored them (ordered by op time). The device search holds
windows up to ``checker.gpu.MAX_WINDOW``. No device is used.

    python3 tools/torch_runner_windows.py [--runs N] [--ops OPS]
"""

import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=10)
    ap.add_argument("--ops", type=int, default=10000)
    args = ap.parse_args()
    import torch
    torch.set_num_threads(1)
    from jepsen_tpu_torch import core, journal
    from jepsen_tpu_torch import generator as gen
    from jepsen_tpu_torch.checker import gpu as G
    from jepsen_tpu_torch.models import CASRegister
    from jepsen_tpu_torch.ops.encode import pack_with_init
    from jepsen_tpu_torch.testing import atom_test

    def window(h):
        return G._window_needed(pack_with_init(h, CASRegister())[0])

    with tempfile.TemporaryDirectory() as root:
        for i in range(args.runs):
            t = core.run(atom_test(
                checker=None, concurrency=5, name=f"atom-{i}",
                generator=gen.clients(gen.limit(args.ops, gen.cas_gen())),
                **{"store-root": root}))
            appended, _ = journal.read_wal(
                os.path.join(t["store-dir"], journal.WAL_NAME))
            print(f"run {i}: {len(t['history'])} events, window needed "
                  f"{window(appended)} in append order, "
                  f"{window(t['history'])} in time order "
                  f"(device limit {G.MAX_WINDOW})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
