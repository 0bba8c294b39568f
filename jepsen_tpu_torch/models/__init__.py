"""Datatype models for linearizability checking (this slice: the CAS
register). See :mod:`jepsen_tpu_torch.models.core`."""

from jepsen_tpu_torch.models.core import (  # noqa: F401
    CAS_REGISTER_KERNEL,
    CASRegister,
    F_CAS,
    F_READ,
    F_WRITE,
    Inconsistent,
    KernelSpec,
    Model,
    NIL_ID,
    cas_register,
    cas_register_step,
    cas_register_step_torch,
    inconsistent,
    kernel_spec_for,
    register,
)
