"""Command line of the port: ``python -m jepsen_tpu_torch serve
--check-daemon`` runs the check daemon (:mod:`jepsen_tpu_torch.serve`).

Its flags are the reference's daemon flags (``jtpu serve``): ``--host``,
``--port``, ``--serve-dir``, ``--workers``, ``--queue-max``,
``--tenant-max`` and ``--deadline-s``; ``--device cpu`` runs the searches
on the CPU (the kernels' plain versions) instead of CUDA. The process
serves until ``POST /drain`` (or an interrupt) and then exits 0.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m jepsen_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    s = sub.add_parser("serve", help="run the multi-tenant check daemon")
    s.add_argument("--check-daemon", action="store_true",
                   help="serve POST /check, GET /check/<id>, /healthz and "
                        "/drain (the only service of the port)")
    s.add_argument("-b", "--host", default="0.0.0.0")
    s.add_argument("-p", "--port", type=int, default=8080,
                   help="port to listen on (0: any free port)")
    s.add_argument("--serve-dir", default=os.path.join("store", "serve"),
                   metavar="DIR",
                   help="daemon directory: request journal and results")
    s.add_argument("--workers", type=int, default=None,
                   help="check worker threads (JTPU_SERVE_WORKERS)")
    s.add_argument("--queue-max", type=int, default=None,
                   help="queue depth past which POST /check answers 429 "
                        "(JTPU_SERVE_QUEUE)")
    s.add_argument("--tenant-max", type=int, default=None,
                   help="queued requests a tenant may have "
                        "(JTPU_SERVE_TENANT_MAX)")
    s.add_argument("--deadline-s", type=float, default=None,
                   help="default per-request deadline; past it a request "
                        "answers :info/timeout (JTPU_SERVE_DEADLINE_S)")
    s.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where the searches run (default: cuda)")
    return p


def serve(opts: argparse.Namespace) -> int:
    from jepsen_tpu_torch import serve as serve_ns
    if not opts.check_daemon:
        print("serve: the port serves only the check daemon; pass "
              "--check-daemon", file=sys.stderr)
        return 2
    cfg = serve_ns.ServeConfig(root=opts.serve_dir,
                               device="cpu" if opts.device == "cpu"
                               else None)
    for name in ("workers", "queue_max", "tenant_max"):
        if getattr(opts, name) is not None:
            setattr(cfg, name, getattr(opts, name))
    if opts.deadline_s is not None:
        cfg.deadline_s = opts.deadline_s or None
    daemon, server = serve_ns.run_daemon(cfg, host=opts.host,
                                         port=opts.port)
    print(f"Listening on http://{opts.host}:{server.server_port}/ (check "
          f"daemon: POST /check, GET /check/<id>, /healthz, /drain)",
          flush=True)
    try:
        daemon.drained.wait()
    except KeyboardInterrupt:
        daemon.drain(timeout_s=30.0)
    server.shutdown()
    server.server_close()
    daemon.stop()
    return 0


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO)
    return serve(_parser().parse_args(argv))


if __name__ == "__main__":
    sys.exit(main())
