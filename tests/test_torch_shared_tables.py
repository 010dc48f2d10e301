"""The constant tables the kernels' wrappers share (rls_tpu_torch/kernels/
_tables.py ``shared_table``), on the CPU: each is made once per (table,
arguments, device) and equals a fresh copy, ρ and λ given as numbers are
filled on the device bit for bit as the host-to-device path makes them,
the wrappers leave every shared table as they found it, and a table
changed in place raises at its next use."""

import numpy as np
import pytest
import torch

from rls_tpu_torch.kernels import _dft_common as dft
from rls_tpu_torch.kernels import _fgp_common, _tables
from rls_tpu_torch.kernels import fista_l1_dft_fused as l1dft
from rls_tpu_torch.kernels import fista_tv_fused as tvf
from rls_tpu_torch.kernels import sense_fused as sense


@pytest.mark.parametrize("make,args", [
    (dft.twiddles, (16, np.float32)),
    (dft.twiddles, (256, np.float64)),
    (dft.bit_reverse, (64,)),
    (tvf._momentum_table, ("fista", 7, 1.0, np.float32)),
    (tvf._momentum_table, ("pogm", 5, 1.0, np.float64)),
    (_fgp_common.fgp_t2_table, (10, np.float32)),
])
def test_a_shared_table_is_made_once_and_equals_a_fresh_copy(make, args):
    first = _tables.shared_table(make, *args, device="cpu")
    assert _tables.shared_table(make, *args, device=torch.device("cpu")) is first
    assert torch.equal(first, torch.as_tensor(make(*args)))


@pytest.mark.parametrize("v", [0.9, 2e-3, 1, 0, 1e-45, 0.1 + 0.2])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_numbers_are_filled_as_the_host_copy_rounds_them(v, dtype):
    x0 = torch.zeros(3, 4, 4)
    got = tvf.problem_scalars(x0, v, v, dtype)
    want = torch.as_tensor(v, dtype=torch.from_numpy(np.zeros((), dtype)).dtype)
    assert got.shape == (3, 2) and torch.equal(got, want.expand(3, 2))


def _touched_tables():
    """Run the three wrappers that read shared tables, on small CPU
    problems; returns the tables they read."""
    rng = np.random.default_rng(3)
    mask = torch.from_numpy(rng.uniform(size=(8, 16)) < 0.5)
    x0 = torch.from_numpy(rng.normal(size=(2, 8, 16)).astype(np.float32))
    l1dft.fista_l1_dft_fused(x0, mask, 0.9, 1e-2, 3)
    coils = torch.from_numpy(rng.normal(size=(2, 2, 8, 16)).astype(np.float32))
    sense.fista_l21_sense_fused(torch.stack([x0, x0], dim=1), mask, coils[0], coils[1], 0.9,
                                1e-2, 3)
    taps = (np.array([0.25, 0.5, 0.25], np.float32),) * 2
    for method in tvf.METHODS:
        tvf.fista_tv_fused(x0, taps, 0.9, 1e-2, 3, 4, method=method)
    return dict(_tables._TABLES)


def test_the_wrappers_leave_every_shared_table_as_they_found_it():
    tables = _touched_tables()
    assert len(tables) >= 7  # twiddles, bit reversals, 3 momentum tables, the t2 table
    for (make, args, device), (table, version) in tables.items():
        assert table._version == version
        assert torch.equal(table, torch.as_tensor(make(*args)))
        assert _tables.shared_table(make, *args, device=device) is table


def test_a_table_changed_in_place_raises_at_its_next_use():
    args = (4, 1.0, np.float32)
    table = _tables.shared_table(tvf._momentum_table, "optista", *args, device="cpu")
    saved = table.clone()
    table[0, 0] += 1.0
    try:
        with pytest.raises(RuntimeError, match=r"_momentum_table\('optista', 4.*changed in place"):
            _tables.shared_table(tvf._momentum_table, "optista", *args, device="cpu")
    finally:
        del _tables._TABLES[(tvf._momentum_table, ("optista", *args), torch.device("cpu"))]
    assert not torch.equal(table, saved)
    assert torch.equal(_tables.shared_table(tvf._momentum_table, "optista", *args,
                                            device="cpu"), saved)
