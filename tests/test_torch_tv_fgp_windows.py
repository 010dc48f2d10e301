"""The TV prox kernel's windowed route (rls_tpu_torch/kernels/tv_fgp.py,
``route == "windows"``) on the CPU: its plain version
``prox_tv2d_fgp_windows_torch`` — the fori FGP on each window of rows,
each window taken for the image, the interiors stitched — against the
whole image's plain version and the JAX kernel.

Why a halo of as many rows as dual iterations is exact: a window edge
inside the image is wrong from the first dual iteration on (its last
row's mask, then the zero row above its first), and each dual iteration
carries that one row further in (xtmp reads rv one row up, q reads xtmp
one row down; the output reads p one row up). So after N dual iterations
exactly the rows within N of such an edge differ: with a halo of N every
interior row is the whole image's, bit for bit, in float32 and float64,
and with N − 1 some row differs (at λ = 1e-3 the clip at ±1 absorbs the
difference, so tightness is shown at λ = 1 and 1e3). The kernel runs the
same operations per pixel and only on the card
(tests/test_torch_cuda.py, chip_smoke.py phase 3a)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rls_tpu.kernels.tv_pallas import prox_tv2d_fgp_pallas
from rls_tpu_torch.kernels import tv_fgp
from test_torch_tv_fgp_plan import H100_RESIDENT

SHAPES = [(3, 37, 29), (2, 64, 17)]
DTYPES = {"float32": torch.float32, "float64": torch.float64}


def _inputs(shape, dtype, lam, seed=19):
    x = torch.from_numpy(np.random.default_rng(seed).normal(size=shape)).to(dtype)
    return x, torch.full((shape[0],), lam, dtype=dtype)


def _windows(shape, iterations, interior):
    plan = tv_fgp.plan_tv_fgp(*shape, H100_RESIDENT, iterations=iterations, interior=interior)
    assert (plan.route, plan.halo, plan.interior) == ("windows", iterations, interior)
    return plan


def _with_halo(plan, H, halo):
    """`plan` with another halo (and its window's rows)."""
    return dataclasses.replace(plan, halo=halo, H=tv_fgp.window_rows(H, plan.interior, halo))


@pytest.mark.parametrize("lam", [0.0, 1e-3, 1e3])
@pytest.mark.parametrize("iterations", [0, 1, 5, 10])
@pytest.mark.parametrize("interior", [4, 6, 9])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_windows_are_the_whole_image_bit_for_bit(dtype, shape, interior, iterations, lam):
    """Forced windows of 4, 6 and 9 interior rows with a halo of the dual
    iterations: the whole image's plain version, bit for bit."""
    x, lamb = _inputs(shape, DTYPES[dtype], lam)
    plan = _windows(shape, iterations, interior)
    got = tv_fgp.prox_tv2d_fgp_windows_torch(x, lamb, iterations, plan)
    assert torch.equal(got, tv_fgp.prox_tv2d_fgp_torch(x, lamb, iterations))


@pytest.mark.parametrize("iterations", [1, 5, 10])
@pytest.mark.parametrize("interior", [4, 9])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_the_halo_is_tight(dtype, shape, interior, iterations):
    """One row less of halo gives other values, within the rows the
    derivation names (those within `iterations` of a window edge inside
    the image); one row more (the halo + 1 of the first estimate) is still
    bit for bit."""
    x, lamb = _inputs(shape, DTYPES[dtype], 1.0)
    H = shape[1]
    plan = _windows(shape, iterations, interior)
    want = tv_fgp.prox_tv2d_fgp_torch(x, lamb, iterations)
    short = _with_halo(plan, H, iterations - 1)
    got = tv_fgp.prox_tv2d_fgp_windows_torch(x, lamb, iterations, short)
    rows = (got != want).any(dim=2).any(dim=0).nonzero().flatten().tolist()
    assert rows
    edges = {e for lo, _, _ in short.spans(H) for e in (lo, lo + short.H) if 0 < e < H}
    assert all(min(abs(r - e + 0.5) for e in edges) < iterations for r in rows)
    spare = _with_halo(plan, H, iterations + 1)
    assert torch.equal(tv_fgp.prox_tv2d_fgp_windows_torch(x, lamb, iterations, spare), want)


@pytest.mark.parametrize("interior", [5, 8])
def test_windows_match_the_jax_kernel(interior):
    """The windowed plain version against the TPU kernel in interpret mode
    at row 1's bar (1e-5, tests/test_torch_prox.py), λ per problem and
    λ = 0, 10 dual iterations."""
    B, H, W = 3, 37, 29
    X = np.random.default_rng(23).normal(size=(B, H * W)).astype(np.float32)
    lams = np.array([0.15, 0.0, 0.02], np.float32)
    want = np.asarray(prox_tv2d_fgp_pallas(jnp.asarray(X), jnp.asarray(lams), (H, W), 10,
                                           interpret=True))
    plan = _windows((B, H, W), 10, interior)
    assert plan.windows == -(-H // interior) and plan.H == min(H, interior + 20)
    got = tv_fgp.prox_tv2d_fgp_windows_torch(torch.from_numpy(X).view(B, H, W),
                                             torch.from_numpy(lams), 10, plan)
    np.testing.assert_allclose(got.reshape(B, -1).numpy(), want, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got[1].reshape(-1).numpy(), X[1])  # λ = 0


def test_the_planners_windows_at_1024_are_the_whole_image():
    """The planner's own windows at 1024² (10 dual iterations) on a batch of
    one, in float32: the whole image's plain version, bit for bit."""
    x, lamb = _inputs((1, 1024, 1024), torch.float32, 0.1, seed=29)
    plan = tv_fgp.plan_tv_fgp(1, 1024, 1024, H100_RESIDENT, iterations=10)
    assert plan.route == "windows"
    got = tv_fgp.prox_tv2d_fgp_windows_torch(x, lamb, 10, plan)
    assert torch.equal(got, tv_fgp.prox_tv2d_fgp_torch(x, lamb, 10))
