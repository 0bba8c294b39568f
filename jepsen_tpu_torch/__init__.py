"""jepsen_tpu_torch: the linearizability checker on PyTorch and CUDA.

The port of ``jepsen_tpu`` to an NVIDIA Hopper GPU. It imports torch and
numpy, never JAX and nothing of ``jepsen_tpu``; host modules it needs are
its own copies. It checks histories of every model family of the
reference (CAS register, mutex, no-op, set, unordered and FIFO queue),
one at a time or as a keyed batch::

    from jepsen_tpu_torch.checker.wgl import linearizable
    from jepsen_tpu_torch.models import CASRegister, Mutex
    linearizable(CASRegister()).check({}, history)   # on the GPU
    linearizable(Mutex()).check({}, lock_history)

    from jepsen_tpu_torch import independent
    independent.checker(linearizable(CASRegister())).check({}, kv_history)

The device search's kernels are in ``csrc/search.cu``, built with nvcc at
first use (``kernels/build.py``). On the host, behind the same facade,
the reference's engines: the C++ WGL engine (``native/wgl_engine.cc``,
built with g++ at first use), the Python WGL, ``:linear`` and their
race, chosen by ``linearizable(..., algorithm=, max_configs=)``::

    linearizable(CASRegister(), backend="cpu").check({}, history)
"""
