"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs a CUDA device and nvcc; without a device they skip.
On a machine with an H100: ``python -m pytest tests/test_torch_cuda.py``.
The file imports neither JAX nor the JAX package, so it runs where only
PyTorch is installed. All comparisons are exact (integer state).
"""

import random

import numpy as np
import pytest
import torch

from jepsen_tpu_torch import interop, resilience
from jepsen_tpu_torch.checker import gpu as G
from jepsen_tpu_torch.checker.gpu import check_history_gpu
from jepsen_tpu_torch.kernels import parity
from jepsen_tpu_torch.kernels import search as K
from jepsen_tpu_torch.models import CASRegister
from jepsen_tpu_torch.ops.encode import pack_with_init
from jepsen_tpu_torch.testing import (corrupt_one_read, crash_writes,
                                      simulate_register_history,
                                      wide_history)

pytestmark = pytest.mark.cuda

FIXTURES = {
    "entry": lambda: simulate_register_history(48, n_procs=4, seed=3,
                                               crash_p=0.05),
    "crashed": lambda: simulate_register_history(200, n_procs=4, n_vals=8,
                                                 seed=2, crash_p=0.05),
    "mc2": lambda: simulate_register_history(260, n_procs=6, n_vals=8,
                                             seed=3, crash_p=0.3),
    "wide48": lambda: wide_history(48, 2, seed=3),
    "wide100": lambda: crash_writes(wide_history(100, 2, seed=5), 6),
}
#: (fixture, rung): narrow rungs, BFS, and rungs whose rows span several
#: sort and scan blocks
CASES = [("entry", (32, 32, 4)), ("entry", (256, 16, None)),
         ("crashed", (128, 32, 8)), ("crashed", (32, 32, None)),
         ("mc2", (128, 32, 8)), ("mc2", (1024, 32, 64)),
         ("wide48", (128, 64, 8)), ("wide100", (512, 128, 512))]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _cols(history):
    packed, kernel = pack_with_init(history, CASRegister())
    cr = G._crash_width(packed.n - packed.n_required)
    return packed, kernel, G._split_packed(
        packed, G._bucket(packed.n_required), cr, kernel)


@pytest.mark.parametrize("name,rung", CASES)
def test_each_kernel_matches_its_plain_version(cuda, name, rung):
    _, _, cols = _cols(FIXTURES[name]())
    lv = parity.Level(cols, rung, cuda)
    walked = 0
    for _ in range(6):
        if lv.advance(3) == 0:
            break
        for stage, _, _, _, err in lv.walk():
            assert err == 0, (name, rung, stage)
        walked += 1
    assert walked > 0


@pytest.mark.parametrize("name,rung", CASES[::2])
def test_segments_match_the_plain_versions(cuda, name, rung):
    _, _, cols = _cols(FIXTURES[name]())
    carries = []
    for ops in (G.KERNELS, G.PLAIN):
        lv = parity.Level(cols, rung, cuda)
        for _ in range(2):
            G.run_segment(lv.cols, lv.carry, lv.scratch, lv.shape, lv.nr,
                          40, ops)
            carries.append(interop.carry_to_numpy(lv.carry))
    for a, b in zip(carries[:2], carries[2:]):
        for x, y in zip(a, b, strict=True):
            assert np.array_equal(x, y)


def _corrupted():
    h = simulate_register_history(100, n_procs=5, n_vals=8, seed=15)
    return corrupt_one_read(h, random.Random(15))


@pytest.mark.parametrize("history", [
    lambda: simulate_register_history(1000, n_procs=5, n_vals=8, seed=1),
    _corrupted, lambda: wide_history(100, 2, seed=5)])
def test_check_matches_the_plain_versions(cuda, history):
    h = history()
    ours = check_history_gpu(h, CASRegister(), device=cuda)
    packed, kernel, _ = _cols(h)
    ref = resilience.supervised_check_packed(packed, kernel, device=cuda,
                                             ops=G.PLAIN)
    keys = ("valid", "levels", "max-linearized-prefix", "rung", "work",
            "best-k")
    assert {k: ours.get(k) for k in keys} == {k: ref.get(k) for k in keys}
    assert ours["backend"] == "gpu"


def test_each_wrapper_counts_its_launches(cuda):
    _, _, cols = _cols(FIXTURES["crashed"]())
    lv = parity.Level(cols, (128, 32, 8), cuda)
    K.reset_launches()
    lv.advance(5)
    assert K.launches == {name: 5 for name in K.launches}
