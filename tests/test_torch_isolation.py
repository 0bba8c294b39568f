"""The port stands alone: it imports neither JAX nor the JAX package, its
entry points default to the GPU, and a kernel wrapper given CUDA tensors
launches the kernel or raises; it never falls back to the plain
version."""

import ast
import os
import subprocess
import sys

import pytest
import torch

from jepsen_tpu_torch.checker.gpu import check_history_gpu, empty_scratch
from jepsen_tpu_torch.kernels import build
from jepsen_tpu_torch.kernels import search as K
from jepsen_tpu_torch.models import CASRegister
from jepsen_tpu_torch.testing import simulate_register_history

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "jepsen_tpu")


def _port_files():
    files = [os.path.join(ROOT, "chip_smoke.py"),
             os.path.join(ROOT, "tools", "profile_torch_headline.py"),
             os.path.join(ROOT, "tests", "test_torch_cuda.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "jepsen_tpu_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    return files


def _forbidden(module: str) -> bool:
    return any(module == f or module.startswith(f + ".") for f in FORBIDDEN)


def test_no_file_of_the_port_imports_jax_or_the_jax_package():
    files = _port_files()
    assert len(files) > 10
    for path in files:
        with open(path) as fh:
            tree = ast.parse(fh.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module or ""]
            else:
                continue
            assert not any(_forbidden(m) for m in mods), (path, mods)


def test_importing_the_checker_loads_no_jax():
    code = ("import sys, jepsen_tpu_torch.checker.wgl, "
            "jepsen_tpu_torch.resilience, jepsen_tpu_torch.interop; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}]; print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    h = simulate_register_history(20, seed=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        check_history_gpu(h, CASRegister())
    from jepsen_tpu_torch.checker.wgl import linearizable
    with pytest.raises(RuntimeError, match="CUDA"):
        linearizable(CASRegister()).check({}, h)


def test_a_cuda_request_without_a_library_raises(monkeypatch):
    """A wrapper handed CUDA tensors goes to the kernel library; when that
    cannot be built it raises, and the plain version never runs."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    def no_nvcc():
        raise build.BuildError("nvcc not found")

    monkeypatch.setattr(build, "nvcc", no_nvcc)
    monkeypatch.setattr(build, "_lib", None)
    monkeypatch.setattr(build, "library_path",
                        lambda: os.path.join(build.BUILD_DIR, "absent.so"))
    called = []
    monkeypatch.setattr(K, "sort_rows_plain",
                        lambda *a: called.append(a))
    shape = K.LevelShape(C=32, W=32, E=4, n=64, CR=8)
    before = dict(K.launches)
    with FakeTensorMode():
        scratch = empty_scratch(shape, "cuda")
        scal = torch.zeros(K.NSCAL, dtype=torch.int32, device="cuda")
        assert scratch.rows.is_cuda
        with pytest.raises(build.BuildError):
            K.sort_rows(scratch.rows, scal, shape)
    assert called == [] and K.launches == before


def test_mixed_devices_are_refused():
    shape = K.LevelShape(C=32, W=32, E=4, n=64, CR=8)
    rows = torch.zeros(shape.RP, shape.NK, dtype=torch.int32)
    scal = torch.zeros(K.NSCAL, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        K.sort_rows(rows, scal, shape)
    with pytest.raises(TypeError):
        K.sort_rows(rows.to(torch.int64), scal, shape)
