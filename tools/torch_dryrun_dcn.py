#!/usr/bin/env python
"""The port's multi-process dryrun: its counterpart of the reference's
``dryrun_dcn`` (``__graft_entry__.py``).

``--procs`` OS processes join one ``torch.distributed`` group through a
``file://`` init method (``parallel.initialize_multihost``; the backend
is ``JTPU_DIST_BACKEND``, gloo by default), each contributing
``--devices-per-proc`` mesh entries of ``--device`` (default ``cuda``,
probed first: no CUDA is exit 2, nothing moves to the CPU; a device may
repeat, giving logical shards). Each rank then runs the reference's two
legs on the global mesh (:func:`dcn_legs`) and prints its lines:

* ``# dcn[r/n]``: one keyed check (2·N keys of 12 ops, N the global
  entries, plus a stale-read key) over the ``keys`` mesh, every rank
  searching its own entries' keys and gathering the rest;
* ``# dcn-pool[r/n]``: one pool-sharded search of a 60-op valid history
  and one of the stale-read history at capacity 16·N and expansion 2·N,
  its shards' sorted runs exchanged between the ranks every level.

Usage: python tools/torch_dryrun_dcn.py [--procs 2] [--devices-per-proc 2]
           [--device cuda|cpu]
Exit code 0 iff every rank gave the reference's verdicts."""

import argparse
import os
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

#: how long the parent waits for a rank before it kills it
RANK_WAIT_S = 600


def stale_read_history():
    """A 4-event non-linearizable register history: a read returns a value
    nobody ever wrote."""
    from jepsen_tpu_torch.history import History, Op
    return History.of([
        Op(type="invoke", f="write", value=1, process=0, time=0),
        Op(type="ok", f="write", value=1, process=0, time=1),
        Op(type="invoke", f="read", value=None, process=1, time=2),
        Op(type="ok", f="read", value=9, process=1, time=3),
    ])


def dcn_histories(n_global):
    """The legs' histories, as ``_dcn_child`` builds them: the keyed map
    (2·N keys of 12 ops with crashes, plus ``"invalid"``) and the valid
    60-op history of the pool-sharded leg."""
    from jepsen_tpu_torch.testing import simulate_register_history
    keyed = {k: simulate_register_history(12, n_procs=3, seed=100 + k,
                                          crash_p=0.1)
             for k in range(2 * n_global)}
    keyed["invalid"] = stale_read_history()
    valid = simulate_register_history(60, n_procs=4, seed=11, crash_p=0.05)
    return keyed, valid


def dcn_legs(devices, keyed=None, valid=None, out=print):
    """The two legs of ``_dcn_child`` on the global mesh over this rank's
    ``devices`` (after ``initialize_multihost``): the keyed check and the
    pool-sharded searches of a valid and a refuted history, each
    asserted as the reference asserts it, and their lines printed with
    ``out``. ``keyed`` and ``valid`` default to :func:`dcn_histories`.
    Returns ``{"keyed", "valid", "refuted"}``, each the check's result."""
    from jepsen_tpu_torch import parallel
    from jepsen_tpu_torch.checker.gpu import (POOL_AXIS,
                                              check_history_sharded,
                                              check_keyed_gpu)
    from jepsen_tpu_torch.models import CASRegister
    mesh = parallel.make_mesh(devices=devices)
    n_global, world, rank = mesh.size, mesh.world, mesh.rank
    assert n_global == world * len(devices), mesh
    if keyed is None or valid is None:
        keyed, valid = dcn_histories(n_global)
    res_k = check_keyed_gpu(keyed, CASRegister(), capacity=64, window=16,
                            mesh=mesh)
    res = res_k["results"]
    keys = [k for k in keyed if k != "invalid"]
    n_valid = sum(1 for r in res.values() if r["valid"] is True)
    assert res["invalid"]["valid"] is False, res["invalid"]
    assert all(res[k]["valid"] is True for k in keys), res
    out(f"# dcn[{rank}/{world}]: {n_global} global devices "
        f"({len(devices)} local), {n_valid}/{len(res)} keys valid, "
        f"invalid-key verdict={res['invalid']['valid']} -> "
        f"batch valid={res_k['valid']}")
    pmesh = parallel.make_mesh(axis=POOL_AXIS, devices=devices)
    kw = dict(capacity=16 * n_global, expand=2 * n_global)
    rs = check_history_sharded(valid, CASRegister(), pmesh, **kw)
    assert rs["valid"] is True, rs
    rbad = check_history_sharded(stale_read_history(), CASRegister(), pmesh,
                                 **kw)
    assert rbad["valid"] is False, rbad
    out(f"# dcn-pool[{rank}/{world}]: single-history pool sharded over "
        f"{n_global} devices on {world} hosts -> valid={rs['valid']} / "
        f"refuted={rbad['valid']} ({rs.get('pool-sharding')}, runs "
        f"exchanged between ranks every level)")
    return {"keyed": res_k, "valid": rs, "refuted": rbad}


def child(init, world, rank, n_dev, device):
    """One rank: join the group, run the legs."""
    import torch
    from jepsen_tpu_torch import parallel
    torch.set_num_threads(1)
    parallel.initialize_multihost(init, world, rank)
    dcn_legs([device] * n_dev, out=lambda s: print(s, flush=True))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--procs", type=int, default=2)
    ap.add_argument("--devices-per-proc", type=int, default=2)
    ap.add_argument("--device", default="cuda",
                    help="each rank's device (default cuda)")
    args = ap.parse_args(argv)
    import torch

    from jepsen_tpu_torch import accel
    try:
        accel.ensure_usable("torch_dryrun_dcn",
                            device=torch.device(args.device))
    except accel.AcceleratorUnavailable as e:
        print(f"# dcn: FAILED — {e}", file=sys.stderr)
        return 2
    with tempfile.TemporaryDirectory(prefix="jepsen-dcn-") as root:
        init = "file://" + os.path.join(root, "init")
        procs = []
        for rank in range(args.procs):
            code = (f"import sys; sys.path.insert(0, {REPO!r}); "
                    f"sys.path.insert(0, {os.path.dirname(__file__)!r}); "
                    f"import torch_dryrun_dcn as d; "
                    f"d.child({init!r}, {args.procs}, {rank}, "
                    f"{args.devices_per_proc}, {args.device!r})")
            procs.append(subprocess.Popen(
                [sys.executable, "-c", code],
                env=dict(os.environ, JEPSEN_ACCEL_OK="1"),
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        outs = []
        try:
            for p in procs:
                try:
                    text, _ = p.communicate(timeout=RANK_WAIT_S)
                except subprocess.TimeoutExpired:
                    p.kill()
                    text, _ = p.communicate()
                outs.append(text or "")
                for line in outs[-1].splitlines():
                    if line.startswith("# dcn"):
                        print(line, flush=True)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    failed = [i for i, p in enumerate(procs) if p.returncode != 0]
    for i in failed:
        print(f"# dcn: rank {i} failed (rc {procs[i].returncode}):\n"
              f"{outs[i][-3000:]}", file=sys.stderr)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
