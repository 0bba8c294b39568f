"""Stepped-datatype models and their integer kernels.

A model is an immutable value with ``step(op) -> model'``; stepping with an
operation the datatype cannot have performed yields :class:`Inconsistent`.
Models whose state fits in a machine word also carry a :class:`KernelSpec`:
a branchless integer transition ``step(state, f, v1, v2) -> (state', ok)``.
This slice ports the CAS register; its step exists twice, once over numpy
(the host search) and once over torch tensors (the device search's plain
version, and the reference the CUDA ``cas_step`` device function mirrors).
Counterpart of ``jepsen_tpu.models.core``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional

import numpy as np
import torch

from jepsen_tpu_torch.history import Op


class Model:
    """Immutable stepped model. Subclasses implement step()."""

    def step(self, op: Op) -> "Model":
        raise NotImplementedError

    def __eq__(self, other):
        return type(self) is type(other) and self.__dict__ == other.__dict__

    def __hash__(self):
        return hash((type(self), tuple(sorted(self.__dict__.items(),
                                              key=lambda kv: kv[0]))))


class Inconsistent(Model):
    """Terminal model state: the op sequence is not consistent with the
    datatype."""

    def __init__(self, msg: str):
        self.msg = msg

    def step(self, op: Op) -> "Model":
        return self

    def __repr__(self):
        return f"Inconsistent({self.msg!r})"

    def __eq__(self, other):
        return isinstance(other, Inconsistent)

    def __hash__(self):
        return hash(Inconsistent)


def inconsistent(msg: str) -> Inconsistent:
    return Inconsistent(msg)


class CASRegister(Model):
    """A register supporting read / write / cas.

    - write v     -> value := v
    - cas (o, n)  -> if value == o then value := n else inconsistent
    - read v      -> consistent iff v is None (don't-care) or v == value
    """

    __slots__ = ("value",)

    def __init__(self, value: Any = None):
        self.value = value

    def step(self, op: Op) -> Model:
        f, v = op.f, op.value
        if f == "write":
            return CASRegister(v)
        if f == "cas":
            if v is None:
                return inconsistent("cas with nil value")
            old, new = v
            if self.value == old:
                return CASRegister(new)
            return inconsistent(f"can't CAS {self.value} from {old} to {new}")
        if f == "read":
            if v is None or v == self.value:
                return self
            return inconsistent(f"can't read {v} from register {self.value}")
        return inconsistent(f"unknown op f={f}")

    def __eq__(self, other):
        return isinstance(other, CASRegister) and self.value == other.value

    def __hash__(self):
        return hash(("CASRegister", self.value))

    def __repr__(self):
        return f"CASRegister({self.value!r})"


def cas_register(value: Any = None) -> CASRegister:
    return CASRegister(value)


def register(value: Any = None) -> CASRegister:
    return CASRegister(value)


# f-codes shared by the encoder and the kernels.
F_READ = 0
F_WRITE = 1
F_CAS = 2

#: Interned id for None / "don't care" values.
NIL_ID = -1


@dataclass(frozen=True)
class KernelSpec:
    """Branchless integer semantics of a model.

    ``step`` takes numpy scalars or arrays, ``step_torch`` tensors; both
    return (state', ok), with state' unspecified where ok is False.
    """

    name: str
    init_state: int
    step: Callable          # numpy (state, f, v1, v2) -> (state', ok)
    step_torch: Callable    # torch (state, f, v1, v2) -> (state', ok)
    f_codes: dict           # op.f -> int code
    #: Map a model instance to its packed initial state, given an
    #: interner fn (value -> id).
    pack_init: Optional[Callable] = None
    #: Host predicate (f_code, v1, v2) -> bool: True iff the op can never
    #: change the state where it succeeds (drives the pure-op closure).
    readonly: Optional[Callable] = None
    #: (state, value_table) -> str, for counterexample reports.
    describe_state: Optional[Callable] = None


def cas_register_step(state, f, v1, v2):
    """The register step over numpy values."""
    state, f, v1, v2 = (np.asarray(x) for x in (state, f, v1, v2))
    is_write = f == F_WRITE
    cas_ok = state == v1
    take_cas = (f == F_CAS) & cas_ok
    ok = ((f == F_READ) & ((v1 == NIL_ID) | cas_ok)) | is_write | take_cas
    return np.where(take_cas, v2, np.where(is_write, v1, state)), ok


def cas_register_step_torch(state, f, v1, v2):
    """The register step over int32 tensors (broadcasting)."""
    is_write = f == F_WRITE
    cas_ok = state == v1
    take_cas = (f == F_CAS) & cas_ok
    ok = ((f == F_READ) & ((v1 == NIL_ID) | cas_ok)) | is_write | take_cas
    return torch.where(take_cas, v2, torch.where(is_write, v1, state)), ok


def _register_describe(state, values):
    if state == NIL_ID:
        return "nil"
    return repr(values[state]) if 0 <= state < len(values) else str(state)


CAS_REGISTER_KERNEL = KernelSpec(
    name="cas-register",
    init_state=NIL_ID,
    step=cas_register_step,
    step_torch=cas_register_step_torch,
    f_codes={"read": F_READ, "write": F_WRITE, "cas": F_CAS},
    pack_init=lambda m, intern: (NIL_ID if m.value is None
                                 else intern(m.value)),
    readonly=lambda f, v1, v2: (f == F_READ
                                or (f == F_CAS and v1 == v2)),
    describe_state=_register_describe,
)


def kernel_spec_for(model: Model) -> Optional[KernelSpec]:
    """The integer KernelSpec for a model instance, or None when this
    slice has no kernel for it."""
    if isinstance(model, CASRegister):
        return CAS_REGISTER_KERNEL
    return None
