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

Across processes (:func:`initialize_multihost`), as the reference's
``jax.distributed`` cluster does, a mesh spans every rank's devices in
rank order (:func:`make_mesh`): each entry carries its rank, and a rank
holds the buffers of its own entries only. ``check_packed_sharded``
exchanges the shards' sorted runs every level with a collective, and
``check_keyed_gpu(mesh=)`` gathers each rank's per-key results, so every
rank ends with one process's result. The group's backend is gloo by
default, which works on the CPU and for ranks that share one card (NCCL
refuses two ranks on one GPU); ``nccl`` is asked for by name. A failed
collective raises an error that names it (:func:`collective`), which
``resilience.classify_failure`` puts in the ``dcn`` class.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from datetime import timedelta
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

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
#: The group's backend when :func:`initialize_multihost` is not given one
#: (``gloo``, the default, or ``nccl``).
BACKEND_ENV = "JTPU_DIST_BACKEND"
#: The seconds a collective of the group waits for a peer before it
#: fails, where :func:`initialize_multihost` is not given ``timeout_s``
#: (gloo's own default is 30 minutes).
DEFAULT_TIMEOUT_S = 120.0


@dataclass(frozen=True)
class Mesh:
    """A one-axis device mesh: ``devices`` in order (a device may repeat)
    on the axis named ``axis``. On a mesh that spans processes,
    ``ranks`` gives each entry's rank (in rank order, the same count for
    each rank) and ``rank`` is this process's; a device of another rank
    names that rank's device. Without a group ``ranks`` is empty and
    every entry is this process's."""

    devices: tuple
    axis: str = KEYS_AXIS
    ranks: tuple = ()
    rank: int = 0

    @property
    def shape(self) -> Dict[str, int]:
        return {self.axis: len(self.devices)}

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def world(self) -> int:
        """The ranks the mesh spans (1 without a group)."""
        return max(self.ranks) + 1 if self.ranks else 1

    def local(self) -> List[int]:
        """The indices of this rank's entries: a contiguous run."""
        ranks = self.ranks or (0,) * len(self.devices)
        return [i for i, r in enumerate(ranks) if r == self.rank]


def check_ranks(ranks: Sequence[int], world: int) -> int:
    """The entries each rank holds on a mesh whose entries have ``ranks``
    over a group of ``world``: rank order, and the same count for every
    rank, as ``jax.local_devices()`` gives each process of the
    reference. Anything else raises ``ValueError``."""
    counts = [list(ranks).count(r) for r in range(world)]
    if list(ranks) != sorted(ranks) or len(set(counts)) != 1 \
            or not counts[0]:
        raise ValueError(
            f"a mesh over {world} ranks needs the same number of entries "
            f"from every rank, in rank order; got {counts} entries by "
            f"rank")
    return counts[0]


def device_count() -> int:
    """The CUDA devices this process sees."""
    return torch.cuda.device_count()


def _norm(d) -> torch.device:
    """A device with its index: ``cuda`` is the current CUDA device."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


def group() -> Optional[Tuple[int, int]]:
    """(rank, world) of this process's ``torch.distributed`` group when it
    has joined one of more than one process, else None."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1:
        return dist.get_rank(), dist.get_world_size()
    return None


def collective(name: str, fn: Callable, *args, **kwargs):
    """Run the ``torch.distributed`` collective ``fn`` of this process's
    group. Its failure (a lost peer, a timeout) raises ``RuntimeError``
    whose text names the collective (``name``, e.g. ``all_gather``), the
    ``dcn`` class of ``resilience.classify_failure``; nothing is
    swallowed."""
    try:
        return fn(*args, **kwargs)
    except Exception as e:  # noqa: BLE001 -- re-raised with its name
        where = group()
        ranks = (f"rank {where[0]} of {where[1]}" if where
                 else "no group")
        raise RuntimeError(f"collective {name} failed ({ranks}): "
                           f"{type(e).__name__}: {e}") from e


def all_gather_object(obj: Any, name: str = "all_gather") -> List[Any]:
    """Every rank's ``obj``, in rank order (:func:`collective`)."""
    import torch.distributed as dist
    where = group()
    if where is None:
        return [obj]
    out: List[Any] = [None] * where[1]
    collective(name, dist.all_gather_object, out, obj)
    return out


def all_gather_tensor(out: torch.Tensor, inp: torch.Tensor,
                      name: str = "all_gather") -> None:
    """Every rank's ``inp`` into ``out``, in rank order
    (:func:`collective`). torch 2.13 names this ``all_gather_single`` and
    deprecates ``all_gather_into_tensor``, the only name of earlier
    releases: the one this torch has is taken."""
    import torch.distributed as dist
    fn = getattr(dist, "all_gather_single", None) \
        or dist.all_gather_into_tensor
    collective(name, fn, out, inp)


def make_mesh(n_devices: Optional[int] = None, axis: str = KEYS_AXIS,
              devices: Optional[Sequence[Any]] = None) -> Mesh:
    """A one-axis mesh over ``n_devices`` devices: the first of
    ``devices`` (default: every CUDA device), in order. ``devices`` may
    repeat a device, giving logical shards (``devices=["cpu"] * 8`` is the
    tests' eight-shard mesh, ``["cuda:0"] * 4`` four shards on one card).
    Asking for more devices than the list has raises ``ValueError``.

    Once the process has joined a group (:func:`initialize_multihost`),
    ``devices`` is this rank's own list and the mesh spans every rank's,
    in rank order, as the reference's mesh spans ``jax.devices()``: every
    rank must call it, and every rank must give as many entries (after
    the cut to ``n_devices``), else every rank raises ``ValueError``
    before any device state is made."""
    if devices is None:
        devs = [torch.device("cuda", i) for i in range(device_count())]
    else:
        devs = [_norm(d) for d in devices]
    where = group()
    if where is None:
        if n_devices is not None:
            if n_devices > len(devs):
                raise ValueError(
                    f"asked for {n_devices} devices, have {len(devs)}")
            devs = devs[:n_devices]
        if not devs:
            raise ValueError("a mesh needs at least one device")
        return Mesh(tuple(devs), axis)
    rank, world = where
    lists = all_gather_object([str(d) for d in devs], "all_gather")
    glob = [(r, torch.device(d)) for r, lst in enumerate(lists)
            for d in lst]
    if n_devices is not None:
        if n_devices > len(glob):
            raise ValueError(
                f"asked for {n_devices} devices, have {len(glob)} over "
                f"{world} ranks")
        glob = glob[:n_devices]
    check_ranks([r for r, _ in glob], world)
    ranks = tuple(r for r, _ in glob)
    # this rank's entries are its own device objects
    mine = iter(devs)
    return Mesh(tuple(next(mine) if r == rank else d for r, d in glob),
                axis, ranks, rank)


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


def _ranks_per_host(coordinator: str, world: int) -> Optional[int]:
    """How many of the group's ranks run on this host: the launcher's
    ``LOCAL_WORLD_SIZE`` where set, else all of them when the coordinator
    is a file or a loopback address, else unknown (None)."""
    v = os.environ.get("LOCAL_WORLD_SIZE")
    if v:
        return int(v)
    host = coordinator.split("://", 1)[-1].rsplit(":", 1)[0]
    if coordinator.startswith("file://") or host in (
            "localhost", "127.0.0.1", "[::1]"):
        return world
    return None


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         backend: Optional[str] = None,
                         timeout_s: Optional[float] = None) -> bool:
    """Join this process to a ``torch.distributed`` group.

    Only an explicit coordinator opts in: ``coordinator_address`` or
    :data:`COORDINATOR_ENV` (a ``tcp://`` or ``file://`` init method),
    with the world size and rank from the arguments or
    ``JTPU_NUM_PROCESSES`` / ``JTPU_PROCESS_ID``. ``backend`` is ``gloo``
    or ``nccl`` (default :data:`BACKEND_ENV`, else gloo); nccl with more
    ranks on this host than it has cards raises ``ValueError`` before
    the group is made (NCCL refuses two ranks on one GPU): no backend is
    swapped. A collective waits ``timeout_s`` (default
    :data:`DEFAULT_TIMEOUT_S`) for a peer.
    Returns True when this call joined the group, False when it did not
    (already joined, or no coordinator: single process, proceed
    locally)."""
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
    backend = (backend or os.environ.get(BACKEND_ENV) or "gloo").lower()
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"backend must be gloo or nccl, got {backend!r}")
    if backend == "nccl":
        here = _ranks_per_host(coordinator_address, num_processes)
        cards = device_count()
        if cards == 0 or (here is not None and here > cards):
            raise ValueError(
                f"nccl: {here or num_processes} rank(s) on this host and "
                f"{cards} CUDA card(s); NCCL refuses two ranks on one GPU. "
                f"Use backend='gloo' ({BACKEND_ENV}=gloo), which stages "
                f"the exchange through host memory")
    if timeout_s is None:
        timeout_s = DEFAULT_TIMEOUT_S
    kw = {}
    if backend == "nccl":
        kw["device_id"] = torch.device("cuda",
                                       process_id % device_count())
    try:
        dist.init_process_group(backend, init_method=coordinator_address,
                                world_size=num_processes, rank=process_id,
                                timeout=timedelta(seconds=timeout_s), **kw)
    except (RuntimeError, ValueError):
        if not auto:
            raise
        return False  # a mis-set environment in one process: go local
    return True


def backend() -> Optional[str]:
    """The group's backend (``gloo``, ``nccl``), None without a group."""
    import torch.distributed as dist
    return dist.get_backend() if group() is not None else None


def check_keyed_distributed(keyed, model, n_devices: Optional[int] = None,
                            device=None, **kwargs) -> Dict[str, Any]:
    """The keyed check over every process of the group: join the group
    where the environment names a coordinator (:func:`initialize_multihost`),
    build the ``keys`` mesh over every rank's devices (``device`` on each
    rank, default its CUDA devices, ``n_devices`` of the global list) and
    run ``check_keyed_gpu(mesh=)`` on it: each rank searches the keys its
    entries own and every rank returns the whole keyed result, whose
    per-key results equal a single process's, with ``"ranks"``. Without a
    group it is the single process's check. ``kwargs`` pass through to
    ``check_keyed_gpu``."""
    from jepsen_tpu_torch.checker.gpu import check_keyed_gpu
    initialize_multihost()
    if group() is None:
        mesh = None if device is not None else make_mesh(n_devices)
        return check_keyed_gpu(keyed, model, mesh=mesh, device=device,
                               **kwargs)
    mesh = make_mesh(n_devices, devices=None if device is None
                     else [device])
    return check_keyed_gpu(keyed, model, mesh=mesh, **kwargs)
