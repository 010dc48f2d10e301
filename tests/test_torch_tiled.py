"""The row-tiled PGM-TV path of rls_tpu_torch against rls_tpu on the same
numpy inputs: the tiled kernel's plain version against the JAX tiled
kernel (interpret mode, 8-row tiles) for every method and schedule it
takes, the window rule the CUDA kernel follows, the dispatch between the
fused and the tiled kernel, and the tiled path's rejections.

Tolerance 1e-5: both sides run the exact f32 stencil Gram on plain f32
operators (the JAX problems are built with ``compensated=False``, so the
JAX wrapper's ``A.rmv`` seed is plain f32 too); the JAX window FGP runs
its fori form in interpret mode, the port the fold form (≤ 1 ulp)."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rls_tpu_torch as rtt
from rls_tpu_torch.convert import convert
from rls_tpu_torch.kernels import _fgp_common, auto
from rls_tpu_torch.kernels import fista_tv_tiled as ttiled

from test_torch_pgm import GAUSS5, MILD, _problem

jtiled = importlib.import_module("rls_tpu.kernels.fista_tv_tiled")

# (solver class, solver kwargs, solve kwargs)
_CASES = {
    "fista": ("FISTA", {}, {}),
    "optista": ("OptISTA", {}, {}),
    "pogm": ("POGM", {}, {}),
    "fista-gradient": ("FISTA", {"restart": "gradient"}, {}),
    "pogm-gradient": ("POGM", {"restart": "gradient", "sigma_fac": 0.8}, {}),
    "fista-early-gradient_mapping": (
        "FISTA", {"restart": "gradient_mapping", "rel_tol": 0.05}, {"early_exit": True},
    ),
    "pogm-early": ("POGM", {"rel_tol": 0.05}, {"early_exit": True}),
}


@pytest.mark.parametrize("case", sorted(_CASES))
def test_tiled_plain_matches_jax_tiled(case):
    cls, skw, fkw = _CASES[case]
    solver, B = _problem(cls, n=48, taps=MILD if skw else GAUSS5, compensated=False, **skw)
    want = np.asarray(jtiled.solve_fista_tv_tiled(
        solver, jnp.asarray(B), tile_rows=8, interpret=True, **fkw))
    before = ttiled.fista_tv_tiled.launches
    got = rtt.solve_fista_tv_tiled(convert(solver, device="cpu"), torch.from_numpy(B),
                                   tile_rows=8, **fkw)
    assert ttiled.fista_tv_tiled.launches == before  # CPU: plain version
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("taps,tv_iterations,tile_rows", [
    (GAUSS5, 5, 8), (MILD, 3, 7), ((0.1, 0.5, 0.25, -0.2, 0.05, 0.3, 0.6), 2, 10),
])
def test_tile_windows_reproduce_the_whole_image(taps, tv_iterations, tile_rows):
    """One PGM iteration (stencil Gram, then the fold FGP) on each clamped
    window gives exactly the whole-image values on the window's interior
    rows when the halo is `tiled_halo`, and not when it is below the
    dependence cone (2·(k//2) + tv_iterations rows)."""
    H, W = 61, 13
    rng = np.random.default_rng(5)
    x0 = torch.from_numpy(rng.normal(size=(2, H, W)).astype(np.float32))
    lam = torch.tensor([2.0, 5.0]).view(-1, 1, 1)  # the duals rarely saturate
    t2 = torch.from_numpy(_fgp_common.fgp_t2_table(tv_iterations))

    def iteration(u):
        res = _fgp_common.sepconv_stencil_normal(u, taps, taps) - u
        return _fgp_common.fgp_fold(u - 0.9 * res, lam, t2)

    whole = iteration(x0)
    halo = _fgp_common.tiled_halo(tv_iterations, len(taps))
    cone = 2 * (len(taps) // 2) + tv_iterations
    assert halo == cone + 2
    for h, exact in ((halo, True), (cone - 1, False)):
        rows = []
        for lo, hi, i0, i1 in _fgp_common.tile_windows(H, tile_rows, h):
            rows.append(iteration(x0[:, lo:hi])[:, i0:i1])
        tiled = torch.cat(rows, dim=1)
        assert torch.equal(tiled, whole) == exact


def _rtt_solver(n, cls="FISTA", **kw):
    op = rtt.SeparableConvOperator.from_taps(GAUSS5, GAUSS5, (n, n), device="cpu")
    reg = rtt.TVRegularization(5e-4, shape=(n, n), iterations_tv=10, backend="cuda")
    return getattr(rtt, cls).create(op, reg=reg, iterations=50, rho=0.95, **kw)


@pytest.mark.parametrize("n,row", [(24, "pgm_tv"), (256, "pgm_tv"), (512, "fista_tv_tiled"),
                                   (1024, "fista_tv_tiled"), (300, "pgm_tv"), (384, "pgm_tv"),
                                   (385, "fista_tv_tiled"), (400, "fista_tv_tiled")])
def test_dispatch_sends_large_images_to_the_tiled_kernel(n, row):
    """The flagship's 256² goes to the fused kernel, and so does every image
    whose bands fit six planes in a cluster of at most 16 CTAs (up to
    384²); 385² and beyond (512², 1024²) go to the tiled row, as the JAX
    table sends 512² and 1024² there; decided by the checks alone, nothing
    is solved."""
    name, run, reasons = auto.select_fast_path(_rtt_solver(n))
    assert name == row
    if row == "fista_tv_tiled":
        assert run is ttiled.solve_fista_tv_tiled
        assert reasons == [
            "cgnr_dense: fused CGNR path requires a CGNR solver",
            f"pgm_tv: a {n}x{n} image goes to the row-tiled kernel (six planes of its "
            "bands fit no cluster of at most 16 CTAs)",
            "pgm_dense: fused dense PGM path requires a dense operator A",
        ]


def test_tiled_rejections_name_the_reason():
    with pytest.raises(ValueError, match="tiled path requires TVRegularization"):
        ttiled.check_fista_tv_tiled(rtt.FISTA.create(
            rtt.SeparableConvOperator.from_taps(GAUSS5, GAUSS5, (16, 16), device="cpu"),
            reg=rtt.L1Regularization(1e-3), rho=0.9))
    with pytest.raises(ValueError, match="gradient_mapping restart is a FISTA mode"):
        ttiled.check_fista_tv_tiled(_rtt_solver(16, "POGM", restart="gradient_mapping"))
    with pytest.raises(ValueError, match="early_exit is FISTA/POGM-only in the tiled path"):
        ttiled.check_fista_tv_tiled(_rtt_solver(16, "OptISTA", rel_tol=1e-3), early_exit=True)
    with pytest.raises(ValueError, match="early_exit needs a concrete solver.rel_tol"):
        ttiled.check_fista_tv_tiled(_rtt_solver(16), early_exit=True)
    with pytest.raises(ValueError, match="tile_rows must be positive"):
        ttiled.fista_tv_tiled(torch.zeros(1, 8, 8), (GAUSS5, GAUSS5), 0.9, 0.1, 2, 2,
                              tile_rows=0)
    assert ttiled.check_fista_tv_tiled(_rtt_solver(16, "POGM", restart="gradient")) == "pogm"
