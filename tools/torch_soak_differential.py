#!/usr/bin/env python
"""Randomized differential soak of the PyTorch/CUDA port: the host object
search vs the native engine vs jitlin (vs the device search every 7th
round, and a keyed batch over an 8-shard mesh every 13th) across all
kernel families, random shapes and seeds, until the deadline. Any
disagreement prints MISMATCH and exits 1.

Usage:  python tools/torch_soak_differential.py [seconds=1200]
            [--seed N] [--device cuda|cpu]

The port's copy of ``tools/soak_differential.py``: the same families,
generators, rounds, output lines and exit codes, over
``jepsen_tpu_torch`` only. The device rounds run on ``--device``
(default ``cuda``, probed first: no CUDA is exit 2, before any round);
the keyed rounds split their keys over ``parallel.make_mesh(devices=
[device] * 8)``, eight logical shards. The seed (default: the clock) is
printed on the first line, so that a failed soak replays with
``--seed``. At the end it prints the rounds each engine answered, and on
CUDA the kernels' launches, the segment graphs captured and the card's
memory high-water mark (``torch.cuda.max_memory_allocated``)."""

import argparse
import json
import os
import random
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from jepsen_tpu_torch import accel, parallel  # noqa: E402
from jepsen_tpu_torch.checker import UNKNOWN  # noqa: E402
from jepsen_tpu_torch.checker import gpu, jitlin, native, wgl  # noqa: E402
from jepsen_tpu_torch.models import (CASRegister, FIFOQueue,  # noqa: E402
                                     SetModel, UnorderedQueue)
from jepsen_tpu_torch.testing import (corrupt_one_read,  # noqa: E402
                                      random_fifo_history,
                                      random_queue_history,
                                      random_register_history,
                                      random_set_history,
                                      simulate_register_history,
                                      wide_history)

FAMILIES = ["reg", "set", "queue", "fifo", "stag"]
#: exact linearizability is NP-hard: a config budget turns the rare
#: exponential round into a skip instead of a stall
CAP = 2_000_000
KEYED_LADDER = ((16, 16, 8), (256, 32, 64))
MAX_MISMATCHES = 5


def gen_history(fam, r2, n_ops, n_procs):
    """The reference soak's generator (``soak_differential.py:40-74``):
    one history of family ``fam`` drawn from ``r2``, and its model."""
    if fam == "stag":
        # staggered (rare-overlap) registers: the forced-fast-forward
        # regime, with occasional read corruption to fuzz refutation
        h = simulate_register_history(
            n_ops, n_procs=n_procs, n_vals=4,
            seed=r2.getrandbits(30), crash_p=r2.choice([0.0, 0.15]),
            overlap_p=r2.choice([0.02, 0.1]))
        if r2.random() < 0.5:
            h = corrupt_one_read(h, r2)
        return h, CASRegister()
    if fam == "wide":
        # high-concurrency bursts, small enough for the host oracle
        return (wide_history(r2.randint(8, 18), r2.randint(1, 2),
                             write_frac=0.4, seed=r2.getrandbits(30),
                             corrupt=r2.random() < 0.3),
                CASRegister())
    if fam == "reg":
        return (random_register_history(r2, n_procs=n_procs, n_ops=n_ops,
                                        n_vals=3, crash_p=0.2),
                CASRegister())
    if fam == "set":
        return (random_set_history(r2, n_procs=min(n_procs, 4),
                                   n_ops=n_ops, n_vals=4), SetModel())
    if fam == "queue":
        return (random_queue_history(r2, n_procs=min(n_procs, 4),
                                     n_ops=n_ops, n_vals=4),
                UnorderedQueue())
    return (random_fifo_history(r2, n_procs=min(n_procs, 3),
                                n_ops=n_ops), FIFOQueue())


class Soak:
    """One soak's state: its rounds, mismatches and per-engine counts.
    :meth:`round` runs one round; :meth:`run` rounds until a deadline."""

    def __init__(self, seed, device):
        self.seed = seed
        self.rng = random.Random(seed)
        self.device = device
        self.mesh = parallel.make_mesh(devices=[device] * 8)
        self.rounds = self.kround = self.mism = 0
        self.answered = dict.fromkeys(
            ("python", "native", "jit", "device", "keyed-keys"), 0)
        self.skipped = 0

    def _mismatch(self, line):
        self.mism += 1
        print(line, flush=True)
        return self.mism >= MAX_MISMATCHES

    def keyed_round(self, seed):
        """A keyed batch over the mesh (a random key count, so uneven
        shards pad; the two-rung escalation) against the per-key host
        oracle. True at the last mismatch allowed."""
        r2 = random.Random(seed)
        fam = r2.choice(FAMILIES)
        pairs = [gen_history(fam, random.Random(seed + 31 * k),
                             r2.randint(6, 16), r2.randint(2, 5))
                 for k in range(r2.randint(3, 12))]
        keyed = {k: h for k, (h, _) in enumerate(pairs)}
        model = pairs[0][1]
        out = gpu.check_keyed_gpu(keyed, model, mesh=self.mesh,
                                  ladder=KEYED_LADDER)
        for k, hk in keyed.items():
            want_k = wgl.check_model(hk, model, max_configs=CAP)["valid"]
            got_k = out["results"][k]["valid"]
            self.answered["keyed-keys"] += got_k is not UNKNOWN
            if UNKNOWN in (want_k, got_k) or got_k is want_k:
                continue
            if self._mismatch(f"KEYED MISMATCH fam={fam} seed={seed} "
                              f"key={k}: device={got_k} python={want_k}"):
                return True
        return False

    def round(self):
        """One round; True when the soak must stop at its fifth
        mismatch."""
        self.rounds += 1
        rng = self.rng
        seed = rng.getrandbits(32)
        r2 = random.Random(seed)
        fam = rng.choice(FAMILIES)
        if self.rounds % 11 == 0:
            # wide rounds cost far more (oracle, per-shape rungs): sampled
            fam = "wide"
        n_ops = rng.randint(6, 16)
        n_procs = rng.randint(2, 5)
        h, model = gen_history(fam, r2, n_ops, n_procs)
        want = wgl.check_model(h, model, max_configs=CAP)["valid"]
        if want is UNKNOWN:
            self.skipped += 1
            return False
        got_n = native.check_history_native(h, model,
                                            max_configs=CAP)["valid"]
        got_j = jitlin.check_jit_model(h, model, CAP)["valid"]
        verdicts = {"python": want, "native": got_n, "jit": got_j}
        if self.rounds % 7 == 0:  # the device path is slow: sampled
            dres = gpu.check_history_gpu(h, model, device=self.device)
            if dres is not None:
                verdicts["device"] = dres["valid"]
        if self.rounds % 13 == 0:  # the keyed batch over the mesh
            self.kround += 1
            if self.keyed_round(seed):
                return True
        for k, v in verdicts.items():
            self.answered[k] += v is not UNKNOWN
        bad = {k: v for k, v in verdicts.items()
               if v is not UNKNOWN and v is not want}
        if bad and self._mismatch(
                f"MISMATCH fam={fam} seed={seed} n_ops={n_ops} "
                f"n_procs={n_procs}: {verdicts}"):
            return True
        if self.rounds % 500 == 0:
            print(f"# {self.rounds} rounds ({self.kround} keyed), "
                  f"{self.mism} mismatches", flush=True)
            if self.device.type == "cuda":
                print(f"# device: {json.dumps(self.device_state())}",
                      flush=True)
        return False

    def run(self, seconds):
        """Rounds until ``seconds`` have passed; the exit code."""
        deadline = time.time() + seconds
        while time.time() < deadline:
            if self.round():
                return 1
        print(f"DONE {self.rounds} rounds ({self.kround} keyed), "
              f"{self.mism} mismatches", flush=True)
        return 1 if self.mism else 0

    def summary(self):
        """The engines' answered rounds and, on CUDA, the device's."""
        doc = {"seed": self.seed, "device": str(self.device),
               "rounds": self.rounds, "keyed": self.kround,
               "mismatches": self.mism, "skipped": self.skipped,
               "answered": self.answered}
        if self.device.type == "cuda":
            from jepsen_tpu_torch.kernels import search as K
            doc["launches"] = dict(K.launches)
            doc["grid_launches"] = dict(K.grid_launches_total)
            doc.update(self.device_state())
        return doc

    def device_state(self):
        """The card's memory now and at its high-water mark, and the
        segment graphs captured and launched so far."""
        import torch

        from jepsen_tpu_torch.kernels import search as K
        return {"memory_allocated": torch.cuda.memory_allocated(self.device),
                "max_memory_allocated": torch.cuda.max_memory_allocated(
                    self.device),
                "segments": dict(K.segments)}


def usable_device(name):
    """``torch.device(name)``, probed on CUDA first; None (and a line on
    stderr) when CUDA does not initialise: there is no move to the
    CPU."""
    import torch
    dev = torch.device(name)
    try:
        accel.ensure_usable("torch_soak_differential", device=dev)
    except accel.AcceleratorUnavailable as e:
        print(f"# soak: {e}", file=sys.stderr)
        return None
    return dev


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("seconds", nargs="?", type=float, default=1200.0)
    ap.add_argument("--seed", type=int, default=None,
                    help="the soak's seed (default: the clock)")
    ap.add_argument("--device", default="cuda",
                    help="the device rounds' device (default cuda)")
    args = ap.parse_args(argv)
    seed = int(time.time()) if args.seed is None else args.seed
    print(f"# soak seed {seed} device {args.device}", flush=True)
    dev = usable_device(args.device)
    if dev is None:
        return 2
    if dev.type == "cuda":
        from jepsen_tpu_torch.kernels import search as K
        K.reset_launches()
    soak = Soak(seed, dev)
    rc = soak.run(args.seconds)
    print(f"# soak: {json.dumps(soak.summary(), sort_keys=True)}",
          flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
