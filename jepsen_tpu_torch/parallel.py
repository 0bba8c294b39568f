"""Device meshes and multi-process helpers: the distributed data plane.

Counterpart of ``jepsen_tpu/parallel.py``. The reference lays histories
over a ``jax.sharding.Mesh`` and lets XLA insert the collectives; the
port writes the data flow out, so a mesh here is an ordered list of
devices on one named axis (:class:`Mesh`):

* ``keys``: a keyed batch's keys split over the devices
  (``check_keyed_gpu(mesh=)``), each device searching its own keys;
* ``pool``: one history's search pool split over the devices
  (``check_packed_sharded``), the shards' sorted rows merged each level.

A device may appear more than once: the shards are then logical, on one
card (or on the CPU, as the tests run them), which shows the algorithm
and the kernels but no traffic between cards.

Across processes (:func:`initialize_multihost`,
:func:`check_keyed_distributed`) each rank checks its share of the keys
on its own device and the results are gathered with
``torch.distributed`` over the gloo backend, which works on the CPU and
for ranks that share one card (NCCL refuses two ranks on one GPU).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence

import torch

#: The mesh axis of independent-key data parallelism.
KEYS_AXIS = "keys"
#: The mesh axis of one search's pool (``checker.gpu.POOL_AXIS``).
POOL_AXIS = "pool"

#: The coordinator of a multi-process run (``tcp://HOST:PORT`` or a
#: ``file://`` path), the port's counterpart of JAX_COORDINATOR_ADDRESS;
#: with it, JTPU_NUM_PROCESSES and JTPU_PROCESS_ID give the world size
#: and this process's rank.
COORDINATOR_ENV = "JTPU_COORDINATOR_ADDRESS"


@dataclass(frozen=True)
class Mesh:
    """A one-axis device mesh: ``devices`` in order (a device may repeat)
    on the axis named ``axis``."""

    devices: tuple
    axis: str = KEYS_AXIS

    @property
    def shape(self) -> Dict[str, int]:
        return {self.axis: len(self.devices)}

    @property
    def size(self) -> int:
        return len(self.devices)


def device_count() -> int:
    """The CUDA devices this process sees."""
    return torch.cuda.device_count()


def _norm(d) -> torch.device:
    """A device with its index: ``cuda`` is the current CUDA device."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


def make_mesh(n_devices: Optional[int] = None, axis: str = KEYS_AXIS,
              devices: Optional[Sequence[Any]] = None) -> Mesh:
    """A one-axis mesh over ``n_devices`` devices: the first of
    ``devices`` (default: every CUDA device), in order. ``devices`` may
    repeat a device, giving logical shards (``devices=["cpu"] * 8`` is the
    tests' eight-shard mesh, ``["cuda:0"] * 4`` four shards on one card).
    Asking for more devices than the list has raises ``ValueError``."""
    if devices is None:
        devs = [torch.device("cuda", i) for i in range(device_count())]
    else:
        devs = [_norm(d) for d in devices]
    if n_devices is not None:
        if n_devices > len(devs):
            raise ValueError(
                f"asked for {n_devices} devices, have {len(devs)}")
        devs = devs[:n_devices]
    if not devs:
        raise ValueError("a mesh needs at least one device")
    return Mesh(tuple(devs), axis)


@dataclass(frozen=True)
class Sharding:
    """Where a batch's leading dimension goes: split over the mesh's axis
    (``axis`` set) or replicated on every device (``axis`` None). A
    descriptor only, so that call sites read as the reference's."""

    mesh: Mesh
    axis: Optional[str]


def keyed_sharding(mesh: Mesh, axis: str = KEYS_AXIS) -> Sharding:
    """The key batch's leading dimension split over the mesh."""
    return Sharding(mesh, axis)


def replicated_sharding(mesh: Mesh) -> Sharding:
    return Sharding(mesh, None)


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None) -> bool:
    """Join this process to a ``torch.distributed`` group (gloo backend).

    Only an explicit coordinator opts in: ``coordinator_address`` or
    :data:`COORDINATOR_ENV` (a ``tcp://`` or ``file://`` init method),
    with the world size and rank from the arguments or
    ``JTPU_NUM_PROCESSES`` / ``JTPU_PROCESS_ID``. Returns True when this
    call joined the group, False when it did not (already joined, or no
    coordinator: single process, proceed locally)."""
    import torch.distributed as dist
    if dist.is_initialized():
        return False
    auto = coordinator_address is None
    if auto:
        coordinator_address = os.environ.get(COORDINATOR_ENV) or None
        if coordinator_address is None:
            return False
    if num_processes is None:
        num_processes = int(os.environ.get("JTPU_NUM_PROCESSES", "1"))
    if process_id is None:
        process_id = int(os.environ.get("JTPU_PROCESS_ID", "0"))
    try:
        dist.init_process_group("gloo", init_method=coordinator_address,
                                world_size=num_processes, rank=process_id)
    except (RuntimeError, ValueError):
        if not auto:
            raise
        return False  # a mis-set environment in one process: go local
    return True


def _rank_keys(keys: List[Any], rank: int, world: int) -> List[Any]:
    """A rank's keys: its contiguous share of the keys in their stable
    order (sorted by ``repr``, so every rank agrees whatever the dict's
    insertion order)."""
    order = sorted(keys, key=repr)
    per = -(-len(order) // world) if order else 0
    return order[rank * per:(rank + 1) * per]


def check_keyed_distributed(keyed, model, n_devices: Optional[int] = None,
                            device=None, **kwargs) -> Dict[str, Any]:
    """The keyed check over every process of the group and the devices of
    this one: join the group where the environment names a coordinator
    (:func:`initialize_multihost`), check this rank's share of the keys
    (:func:`_rank_keys`) with ``check_keyed_gpu`` on ``device`` (default:
    the rank's CUDA device, over a ``keys`` mesh of ``n_devices``), and
    gather every rank's results with ``all_gather_object``. Every rank
    returns the whole keyed result, whose per-key results equal a single
    process's. Without a group it is the single process's check.
    ``kwargs`` pass through to ``check_keyed_gpu``."""
    import torch.distributed as dist
    from jepsen_tpu_torch.checker import merge_valid
    from jepsen_tpu_torch.checker.gpu import check_keyed_gpu
    initialize_multihost()
    multi = dist.is_initialized() and dist.get_world_size() > 1
    rank, world = ((dist.get_rank(), dist.get_world_size()) if multi
                   else (0, 1))
    mine = _rank_keys(list(keyed), rank, world)
    mesh = None
    if device is None:
        mesh = make_mesh(n_devices)
    local = check_keyed_gpu({k: keyed[k] for k in mine}, model,
                            mesh=mesh, device=device, **kwargs)
    if not multi:
        return local
    parts: List[Optional[Dict[str, Any]]] = [None] * world
    dist.all_gather_object(parts, local)
    results: Dict[Any, Dict[str, Any]] = {}
    batches: list = []
    for part in parts:
        results.update(part["results"])
        batches += part.get("batches", [])
    return {"valid": merge_valid(r["valid"] for r in results.values()),
            "results": {k: results[k] for k in keyed if k in results},
            "backend": "gpu", "batches": batches, "ranks": world}
