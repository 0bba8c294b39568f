"""chip_smoke.py's ``cli library`` phase end to end on the CPU.

A file of its own: the phase starts processes (the sqlitedb suite's
``test``, ``serve --help``, the timed starts), and under ``--dist
loadfile`` files go out to the workers most tests first, so a file of
one test runs at the end, away from the JAX package's wall-clock budget
test, which runs early.
"""

import os
import sys

import torch

# one intra-op thread: the tier-1 run puts six workers on eight cores
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_the_smoke_cli_library_phase_runs_on_the_cpu(monkeypatch):
    """chip_smoke.py's ``cli library`` phase on the CPU, its atom runs cut
    to 2,000 ops and the sqlitedb run to 2 s: two stored runs valid with
    the plain route's levels, the invalid run 1, the processes' codes."""
    sys.path.insert(0, ROOT)
    import chip_smoke
    monkeypatch.setattr(chip_smoke, "RUNNER_OPS", 2000)
    monkeypatch.setattr(chip_smoke, "CLI_LIB_SQLITE_S", 2)
    monkeypatch.setattr(chip_smoke, "CLI_LIB_STARTS", 1)
    seconds = {}
    line, launches, grid, segs = chip_smoke.cli_lib_phase(
        torch.device("cpu"), seconds, "cpu")
    assert len(line["runs"]) == chip_smoke.CLI_LIB_RUNS
    assert all(r["levels"] == r["plain_levels"] for r in line["runs"])
    assert line["invalid_rc"] == 1 and line["sqlitedb_test"]["rc"] == 0
    assert line["etcd_serve_help_rc"] == 0 and line["bare"]["rc"] == 254
    assert [len(v) for v in line["start_s"].values()] == [1, 1]
    # the plain versions launch no kernel
    assert set(launches) == set(chip_smoke.KERNELS) | {"merge_runs"} \
        and not any(grid.values())
    assert seconds["cli library"] > 0
