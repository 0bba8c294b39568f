"""jepsen_tpu_torch: the linearizability checker on PyTorch and CUDA.

The port of ``jepsen_tpu`` to an NVIDIA Hopper GPU. It imports torch and
numpy, never JAX and nothing of ``jepsen_tpu``; host modules it needs are
its own copies. This slice checks single CAS-register histories::

    from jepsen_tpu_torch.checker.wgl import linearizable
    from jepsen_tpu_torch.models import CASRegister
    linearizable(CASRegister()).check({}, history)   # on the GPU

The device search's kernels are in ``csrc/search.cu``, built with nvcc at
first use (``kernels/build.py``).
"""
