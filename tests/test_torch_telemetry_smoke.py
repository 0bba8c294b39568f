"""chip_smoke.py's ``daemon telemetry`` phase end to end on the CPU.

Every step is a ``python -m jepsen_tpu_torch`` process, as on the card,
with each check on the CPU (the kernels' plain versions) and the gang
histories cut to 150 ops: the daemon's gangs under ``--batch-max 4`` with
``JTPU_SERVE_BATCH_VERIFY=1``, every verdict the lone check's, ``/usage``
against ``usage --json``, the SLOs, the time series, a traced stream, the
browser's pages over a stored local-kv run and a profiled check, and the
drain and SIGTERM dumps.
"""

import os
import shutil
import sys

import torch

# one intra-op thread: the tier-1 run puts six workers on eight cores
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_the_smoke_daemon_telemetry_phase_runs_on_the_cpu(monkeypatch,
                                                          tmp_path):
    """chip_smoke.py's ``daemon telemetry`` phase end to end on the CPU
    (each check the kernels' plain versions), its gang histories cut to
    150 ops, over a copy of a stored local-kv run and a profiled check of
    the port's."""
    sys.path.insert(0, ROOT)
    import chip_smoke
    from jepsen_tpu_torch.checker.gpu import check_history_gpu
    from jepsen_tpu_torch.models import CASRegister
    from test_torch_web import _traced_run
    monkeypatch.setattr(chip_smoke, "SERVE",
                        dict(chip_smoke.SERVE, n_ops=150))
    kv_store = str(tmp_path / "kv")
    shutil.copytree(os.path.join(ROOT, "examples", "store", "local-kv"),
                    kv_store)
    run = tmp_path / "kept" / "20260102T000000.000"
    run.mkdir(parents=True)
    _traced_run(str(run))
    gang8 = chip_smoke.serve_members()[4]
    lone = [check_history_gpu(m[0], CASRegister(), device="cpu")
            for m in gang8]
    line, launches, pair_ends = chip_smoke.daemon_telemetry_phase(
        torch.device("cpu"), {}, "cpu", kv_store,
        {"run": str(run), "lone": lone})
    assert line["verdicts_equal_lone"] == 8
    assert max(line["gang_sizes"]) <= chip_smoke.CLI_BATCH_MAX
    assert line["verify_segments"] >= 8 and line["tsdb_ticks"] >= 2
    assert line["dumps"] == ["drain", "sigterm"]
    assert sorted(line["usage"]) == ["tenant0", "tenant1", "tenant2"]
    assert line["pages"]["trace"] == line["pages"]["zip"] == 200
    # the plain versions launch no kernel; the phase removed its inputs
    assert set(launches) == set(chip_smoke.KERNELS) and pair_ends == 0
    assert not os.path.exists(kv_store) and not run.exists()
