"""chip_smoke.py's ``cli`` phase end to end on the CPU.

Every step is a ``python -m jepsen_tpu_torch`` process, as on the card,
with each check on the CPU (the kernels' plain versions) and the gang
histories cut to 150 ops: the daemon's gangs of at most 4 under
``--batch-max 4``, every verdict the lone check's, 401 without the token,
a local-kv run watched while in flight, ``stream --store`` of another
local-kv run against ``analyze --profile``, and the ``trace`` commands
over the daemon's directory and the profiled search.
"""

import os
import shutil
import sys

import torch

# one intra-op thread: the tier-1 run puts six workers on eight cores
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_the_smoke_cli_phase_runs_on_the_cpu(monkeypatch, tmp_path):
    """chip_smoke.py's ``cli`` phase end to end on the CPU, its gang
    histories cut to 150 ops: gangs of at most 4, every verdict the lone
    check's, 401 without the token, the run watched while in flight."""
    sys.path.insert(0, ROOT)
    import chip_smoke
    monkeypatch.setattr(chip_smoke, "SERVE",
                        dict(chip_smoke.SERVE, n_ops=150))
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    from time_torch_smoke_phases import local_kv_store
    seconds = {}
    kv_store = local_kv_store("cpu", str(tmp_path))
    line, launches, pair_ends, kept = chip_smoke.cli_phase(
        torch.device("cpu"), seconds, "cpu", kv_store)
    assert max(line["gang_sizes"]) <= chip_smoke.CLI_BATCH_MAX
    assert line["verdicts_equal_lone"] == 8 and line["unauthorized"] == 401
    assert line["watch_in_flight"] and line["run_rc"] == 0
    assert line["watch_once"].startswith("# watch: level")
    assert line["stream"]["valid"] is line["analyze"]["valid"] is True
    assert all(v > 0 for v in line["trace_find_device_s"].values())
    # the plain versions launch no kernel
    assert set(launches) == set(chip_smoke.KERNELS) and pair_ends == 0
    # the watched run was profiled, and outlives the phase for the next
    assert os.path.isdir(os.path.join(kept["run"], "profile"))
    assert len(kept["lone"]) == 8
    shutil.rmtree(os.path.dirname(kept["run"]))
