"""The per-process cache of device state for the search.

Counterpart of the executable cache in ``jepsen_tpu/checker/engine.py``.
Where the JAX engine caches one compiled program per rung, this one holds
the loaded kernel library and, per search shape (C, W, E, n, CR) and
device, the carry and scratch buffers; per (n, CR) and device, the column
buffers. A warm check at a cached shape allocates no device memory. The
buffers serve one check at a time: callers hold :attr:`Engine.lock` while
they use them.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Optional, Tuple

import torch

from jepsen_tpu_torch.checker import gpu as G
from jepsen_tpu_torch.kernels import search as K


class Engine:
    #: shapes (and column shapes) kept before the oldest is dropped
    MAX_ENTRIES = 8

    def __init__(self):
        self.lock = threading.Lock()
        self.lib = None
        self._states: "OrderedDict[tuple, Tuple[G.Carry, G.Scratch]]" = \
            OrderedDict()
        self._cols: "OrderedDict[tuple, dict]" = OrderedDict()

    def _cached(self, cache: OrderedDict, key: tuple, build):
        hit = cache.get(key)
        if hit is not None:
            cache.move_to_end(key)
            return hit
        cache[key] = hit = build()
        while len(cache) > self.MAX_ENTRIES:
            cache.popitem(last=False)
        return hit

    def state(self, shape: K.LevelShape,
              device: torch.device) -> Tuple[G.Carry, G.Scratch]:
        """Carry and scratch buffers for one search shape. On a CUDA
        device the kernel library is built and loaded first; a failure
        raises."""
        if device.type == "cuda" and self.lib is None:
            from jepsen_tpu_torch.kernels import build
            self.lib = build.load()
        return self._cached(self._states, (shape, str(device)), lambda: (
            G.empty_carry(shape, device), G.empty_scratch(shape, device)))

    def cols(self, cols_np: dict, device: torch.device) -> dict:
        """The columns copied into this engine's buffers for their shape."""
        from jepsen_tpu_torch import interop
        key = (cols_np["f"].shape[0], cols_np["cf"].shape[0], str(device))
        bufs = self._cached(self._cols, key,
                            lambda: interop.cols_from_numpy(cols_np, device))
        return interop.cols_from_numpy(cols_np, device, out=bufs)


_DEFAULT: Optional[Engine] = None
_DEFAULT_LOCK = threading.Lock()


def default_engine() -> Engine:
    """The process-wide engine, made at first use."""
    global _DEFAULT
    with _DEFAULT_LOCK:
        if _DEFAULT is None:
            _DEFAULT = Engine()
        return _DEFAULT
