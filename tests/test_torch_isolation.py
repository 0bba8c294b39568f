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

# one intra-op thread: the tier-1 run puts six workers on eight cores
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "jepsen_tpu")


def _port_files():
    files = [os.path.join(ROOT, "chip_smoke.py"),
             os.path.join(ROOT, "tools", "profile_torch_headline.py"),
             os.path.join(ROOT, "tools", "profile_torch_keyed.py"),
             os.path.join(ROOT, "tools", "profile_torch_gang.py"),
             os.path.join(ROOT, "tools", "probe_torch_models.py"),
             os.path.join(ROOT, "tools", "time_torch.py"),
             os.path.join(ROOT, "tools", "profile_torch_stream_close.py"),
             os.path.join(ROOT, "tools", "time_torch_watchdog.py"),
             os.path.join(ROOT, "tools", "profile_torch_cold.py"),
             os.path.join(ROOT, "tools", "torch_runner_windows.py"),
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
            "jepsen_tpu_torch.resilience, jepsen_tpu_torch.interop, "
            "jepsen_tpu_torch.independent, jepsen_tpu_torch.models, "
            "jepsen_tpu_torch.testing, jepsen_tpu_torch.serve, "
            "jepsen_tpu_torch.journal, jepsen_tpu_torch.checker.plan, "
            "jepsen_tpu_torch.accel, jepsen_tpu_torch.obs.devices, "
            "jepsen_tpu_torch.analysis.plan_lint, "
            "jepsen_tpu_torch.core, jepsen_tpu_torch.generator, "
            "jepsen_tpu_torch.control.util, jepsen_tpu_torch.control.net, "
            "jepsen_tpu_torch.nemesis, jepsen_tpu_torch.store, "
            "jepsen_tpu_torch.repl, jepsen_tpu_torch.checker.perf, "
            "jepsen_tpu_torch.suites.localkv, "
            "jepsen_tpu_torch.suites.sqlitedb, "
            "jepsen_tpu_torch.suites.workloads, "
            "jepsen_tpu_torch.checker.basic, "
            "jepsen_tpu_torch.checker.timeline, "
            "jepsen_tpu_torch.explain, "
            "jepsen_tpu_torch.analysis.contention, "
            "jepsen_tpu_torch.__main__; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}]; print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_the_native_engine_loads_from_the_port():
    """The host engine the facade's ``auto`` takes is built from the
    port's own ``native/wgl_engine.cc`` into ``jepsen_tpu_torch/_build``;
    loading it imports nothing of JAX or the JAX package, and maps no
    library of the JAX package's ``native/``."""
    code = ("import sys; from jepsen_tpu_torch.checker import native; "
            "ok = native.available(); print(native.library_path()); "
            "maps = open('/proc/self/maps').read(); "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}]; "
            "sys.exit(1 if bad or not ok or 'jepsen_tpu/native' in maps "
            "else 0)")
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    path = os.path.realpath(proc.stdout.strip())
    assert path.startswith(os.path.join(ROOT, "jepsen_tpu_torch", "_build")
                           + os.sep), path
    assert os.path.exists(path)


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    h = simulate_register_history(20, seed=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        check_history_gpu(h, CASRegister())
    from jepsen_tpu_torch.checker.wgl import linearizable
    with pytest.raises(RuntimeError, match="CUDA"):
        linearizable(CASRegister()).check({}, h)


def test_keyed_entry_points_default_to_cuda():
    """The keyed batch and the independent checker over it run on the
    GPU unless asked otherwise; without one they raise rather than fall
    back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    from jepsen_tpu_torch import independent
    from jepsen_tpu_torch.checker.gpu import check_keyed_gpu
    from jepsen_tpu_torch.checker.wgl import linearizable
    h = simulate_register_history(20, seed=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        check_keyed_gpu({"a": h}, CASRegister())
    keyed = [o.replace(value=independent.KV("a", o.value)) for o in h]
    with pytest.raises(RuntimeError, match="CUDA"):
        independent.checker(linearizable(CASRegister())).check({}, keyed)


def test_the_serve_slice_defaults_to_cuda(tmp_path):
    """The gang search, the engine's warm-up, the daemon and its CLI run
    on the GPU unless asked otherwise; without one they raise rather than
    fall back to the CPU. The admission footprint prices the CUDA
    ladder's first rung."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    from jepsen_tpu_torch import serve
    from jepsen_tpu_torch.__main__ import main
    from jepsen_tpu_torch.checker import plan
    from jepsen_tpu_torch.checker.engine import Engine
    from jepsen_tpu_torch.checker.gpu import check_packed_gang_gpu
    from jepsen_tpu_torch.ops.encode import pack_with_init
    p, kernel = pack_with_init(simulate_register_history(20, seed=1),
                               CASRegister())
    with pytest.raises(RuntimeError, match="CUDA"):
        check_packed_gang_gpu([p], kernel)
    with pytest.raises(RuntimeError, match="CUDA"):
        Engine().warm(p, kernel)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.CheckDaemon(serve.ServeConfig(root=str(tmp_path / "a")))
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.run_daemon(serve.ServeConfig(root=str(tmp_path / "b")),
                         port=0)
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["serve", "--check-daemon", "--port", "0",
              "--serve-dir", str(tmp_path / "c")])
    dims = plan.PlanDims.from_packed(p)
    assert plan.request_footprint(dims) == plan.request_footprint(
        dims, "cuda") != plan.request_footprint(dims, "cpu")
    assert plan.plan_bytes_limit() is None


def test_the_runner_defaults_to_cuda(tmp_path, capsys):
    """``run``, ``analyze`` and ``recover`` check on the GPU unless asked
    otherwise; without one they refuse (exit 255) before any work: no
    daemon booted, no store written, a dead run left as it was. The
    local-kv suites' checker is the GPU's, and raises without one."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    import json
    from jepsen_tpu_torch import store
    from jepsen_tpu_torch.__main__ import main
    from jepsen_tpu_torch.suites import registry
    root = tmp_path / "store"
    assert main(["run", "--suite", "local-kv", "--time-limit", "1",
                 "--store-root", str(root)]) == 255
    assert not root.exists()
    assert "CUDA" in capsys.readouterr().err
    h = simulate_register_history(20, seed=1)
    test = {"name": "r", "store-root": str(root), "history": h,
            "results": {"valid": True}}
    store.save_1(test)
    store.write_state(test["store-dir"], "running")
    state = os.path.join(test["store-dir"], store.RUN_STATE)
    with open(state) as f:
        doc = json.load(f)
    doc["pid"] = 2 ** 22 + 1        # past the kernel's pid range: dead
    with open(state, "w") as f:
        json.dump(doc, f)
    assert main(["analyze", "--store", test["store-dir"]]) == 255
    assert main(["recover", "--store-root", str(root)]) == 255
    assert store.run_status(test["store-dir"]) == "dead"
    assert not os.path.exists(os.path.join(test["store-dir"],
                                           "results.json"))
    checked = 0
    for name, ctor in registry().items():
        linear = ctor({})["checker"].checkers.get("linear")
        if linear is None:      # a suite with no linearizability check
            continue
        checked += 1
        assert (linear.backend, linear.device) == ("gpu", None), name
        with pytest.raises(RuntimeError, match="CUDA"):
            linear.check({}, h)
    assert checked == 4     # local-kv, -unsafe, sqlite-register, -toctou


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
        scal = torch.zeros(1, K.NSCAL, dtype=torch.int32, device="cuda")
        assert scratch.rows.is_cuda
        with pytest.raises(build.BuildError):
            K.sort_rows(scratch.rows, scal, shape)
    assert called == [] and K.launches == before


def test_mixed_devices_are_refused():
    shape = K.LevelShape(C=32, W=32, E=4, n=64, CR=8)
    rows = torch.zeros(1, shape.RP, shape.NK, dtype=torch.int32)
    scal = torch.zeros(1, K.NSCAL, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        K.sort_rows(rows, scal, shape)
    with pytest.raises(TypeError):
        K.sort_rows(rows.to(torch.int64), scal, shape)


def test_the_plan_gate_plans_for_cuda(capsys):
    """The plan's entry points plan the CUDA ladder unless asked for the
    CPU's, and without a card they check no byte budget."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    from jepsen_tpu_torch.__main__ import main
    from jepsen_tpu_torch.checker import plan
    from jepsen_tpu_torch.obs import devices
    dims = plan.PlanDims(n_required=150, n_crashed=3, window_needed=5)

    def labels(**kw):
        return [c.label() for c in plan.enumerate_candidates(dims, **kw)]

    assert labels() == labels(device="cuda") != labels(device="cpu")
    assert labels()[0] == "single 128/32/8 @256+8"
    rep = plan.analyze(dims)
    assert rep["selected"] == "single 128/32/8 @256+8"
    assert rep["bytes-limit"] is None and plan.plan_bytes_limit() is None
    assert devices.poll() == [] and devices.headroom_ratio() is None
    assert main(["plan", "--dims", "150,3,5"]) == 0
    out = capsys.readouterr().out
    assert "# plan: selected single 128/32/8 @256+8" in out
    assert main(["plan", "--dims", "150,3,5", "--device", "cpu"]) == 0
    assert "selected single 32/32/4" in capsys.readouterr().out
