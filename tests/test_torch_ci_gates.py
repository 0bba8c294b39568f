"""The port's CI gates on the CPU: ``tools/torch_prof_gate.py`` and
``tools/torch_serve_gate.py`` exit 0 with ``--device cpu``, and exit
non-zero before any work when asked for CUDA on a host without it.

The kernels' plain versions on the CPU are far slower than the card, so
the serve gate runs in this process with a 1 s local-kv workload, a
2,000-op stream instead of 10,000, and a budget the CPU can meet; every
check of the gate holds as on the card.
"""

import os
import subprocess
import sys

import torch

# one intra-op thread: the tier-1 run puts six workers on eight cores
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))

import torch_serve_gate as serve_gate  # noqa: E402


def _tool(*args, timeout=150, **env):
    return subprocess.run(
        [sys.executable, *args], cwd=ROOT, capture_output=True, text=True,
        timeout=timeout, env=dict(os.environ, OMP_NUM_THREADS="1", **env))


def test_the_profiling_gate_passes_on_the_cpu():
    r = _tool(os.path.join("tools", "torch_prof_gate.py"), "--device", "cpu",
              "--time-limit", "2", "--budget", "120")
    assert r.returncode == 0, (r.stdout, r.stderr[-3000:])
    assert "# prof-gate: merged trace validates as Chrome/Perfetto JSON" \
        in r.stdout
    line = next(ln for ln in r.stdout.splitlines() if "capture file(s)" in ln)
    assert "1 capture file(s)" in line and "kernels {" in line


def test_the_serve_gate_passes_on_the_cpu(monkeypatch, capsys):
    monkeypatch.setattr(serve_gate, "STREAM_OPS", 2000)
    rc = serve_gate.main(["--device", "cpu", "--time-limit", "1",
                          "--budget", "300"])
    out = capsys.readouterr()
    assert rc == 0, (out.out, out.err[-3000:])
    assert "verdict matches offline" in out.out
    assert "# serve-gate: served verdict matches the offline path" in out.out


def test_the_gates_refuse_cuda_without_a_card():
    env = {"JEPSEN_ACCEL_PROBE_TIMEOUT": "60"}
    for tool in ("torch_prof_gate.py", "torch_serve_gate.py",
                 "torch_chaos_matrix.py"):
        r = _tool(os.path.join("tools", tool), timeout=120, **env)
        assert r.returncode == 2, (tool, r.stdout, r.stderr[-2000:])
        assert "does not fall back to the CPU" in r.stderr, tool
        assert "PASS" not in r.stdout and "prof-gate: " not in r.stdout
