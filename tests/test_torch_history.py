"""The port's packed-history helpers against the reference's on the same
seeded histories: ``PackedHistory.max_concurrency`` and ``pad_to``,
``ops.encode.pack_keyed_histories`` (every stacked column equal), and
the mask widths of a plan ``Candidate``."""

import numpy as np
import pytest
import torch

from jepsen_tpu.checker import plan as j_plan
from jepsen_tpu.history import History as JHistory
from jepsen_tpu.models import CASRegister as JCASRegister
from jepsen_tpu.models.core import kernel_spec_for as j_kernel_spec_for
from jepsen_tpu.ops import encode as j_encode

from jepsen_tpu_torch import testing
from jepsen_tpu_torch.checker import plan
from jepsen_tpu_torch.history import History
from jepsen_tpu_torch.models import CASRegister
from jepsen_tpu_torch.models.core import kernel_spec_for
from jepsen_tpu_torch.ops import encode

# one intra-op thread: the tier-1 run puts six workers on eight cores
torch.set_num_threads(1)

COLS = ("f", "v1", "v2", "inv", "ret", "process")


def _pair(seed, n_ops=60, crash_p=0.05):
    """The same seeded register history in both packages."""
    h = testing.simulate_register_history(n_ops, n_procs=4, n_vals=5,
                                          seed=seed, crash_p=crash_p)
    dicts = [o.to_dict() for o in h]
    return History.of(dicts), JHistory.of(dicts)


def _kernels():
    return kernel_spec_for(CASRegister()), j_kernel_spec_for(JCASRegister())


@pytest.mark.parametrize("seed", [1, 2, 3, 4])
def test_max_concurrency_and_pad_to(seed):
    h, jh = _pair(seed)
    k, jk = _kernels()
    p, jp = encode.pack_history(h, k), j_encode.pack_history(jh, jk)
    assert p.max_concurrency() == jp.max_concurrency() > 0
    for n in (p.n, p.n + 1, p.n + 9):
        a, b = p.pad_to(n), jp.pad_to(n)
        assert a.n == b.n == n
        for c in COLS:
            assert np.array_equal(getattr(a, c), getattr(b, c)), (n, c)
            assert getattr(a, c).dtype == getattr(b, c).dtype, (n, c)
        assert (a.n_required, a.init_state) == (b.n_required, b.init_state)
        assert np.all(a.inv[p.n:] == encode.RET_INF)   # never a candidate
    assert p.pad_to(p.n) is p
    with pytest.raises(ValueError):
        p.pad_to(p.n - 1)


def test_max_concurrency_of_an_empty_history():
    k, jk = _kernels()
    assert encode.pack_history(History.of([]), k).max_concurrency() == \
        j_encode.pack_history(JHistory.of([]), jk).max_concurrency() == 0


@pytest.mark.parametrize("seeds", [(5, 6, 7), (8,), ()])
def test_pack_keyed_histories(seeds):
    k, jk = _kernels()
    keyed, jkeyed = {}, {}
    for i, seed in enumerate(seeds):
        keyed[f"k{i}"], jkeyed[f"k{i}"] = _pair(seed, n_ops=20 + 15 * i)
    packed, batch = encode.pack_keyed_histories(keyed, k)
    jpacked, jbatch = j_encode.pack_keyed_histories(jkeyed, jk)
    assert set(batch) == set(jbatch)
    assert batch["keys"] == jbatch["keys"] == list(keyed)
    for c in ("f", "v1", "v2", "inv", "ret", "n_required", "init_state"):
        assert batch[c].shape == jbatch[c].shape, c
        assert batch[c].dtype == jbatch[c].dtype, c
        assert np.array_equal(batch[c], jbatch[c]), c
    assert [p.n for p in packed] == [p.n for p in jpacked]


@pytest.mark.parametrize("window,crw", [(1, 0), (32, 16), (33, 32),
                                        (64, 33), (128, 300)])
def test_candidate_mask_and_crash_words(window, crw):
    c = plan.Candidate(kind="single", capacity=128, window=window,
                       expand=8, breq=512, crw=crw)
    jc = j_plan.Candidate(kind="single", capacity=128, window=window,
                          expand=8, unroll=1, breq=512, crw=crw)
    assert (c.mask_words, c.crash_words) == (jc.mask_words, jc.crash_words)
