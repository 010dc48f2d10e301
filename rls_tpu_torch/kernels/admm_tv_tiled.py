"""Row-tiled batched ADMM-TV solve: the hand-written CUDA kernel
``csrc/admm_tv_tiled.cu`` and its plain PyTorch version.

Counterpart of ``rls_tpu/kernels/admm_tv_tiled.py``: ``_kernel``
(:50-160), ``admm_tv_tiled`` (:183-251), ``check_admm_tv_tiled``
(:254-313) and ``solve_admm_tv_tiled`` (:316-363). On the TPU the tiling
fits the solve into VMEM; on an H100 it spreads one problem over many
CTAs: one CTA per (row tile, problem), `tile_rows` from
``fista_tv_tiled.pick_tile_rows`` (about one wave of CTAs on the card).

The CG needs two sums over the whole image per step, so the solve is a
sequence of launches, 2·cg_iterations + 2 per outer iteration (the
schedule is in the CUDA source). Each launch reads windows of whole planes
that earlier launches finished and writes only its tile's rows: the
stencil Gram on a window of ``matvec_halo`` extra rows a side, the TV
z-update on a window of ``fgp_halo``. Tiling adds halo recompute, not
approximation, so the plain version is the fused kernel's plain version.
Per-tile partial sums are summed in tile order (no atomics): a result is
the same from run to run.

Not carried over: the TPU's tile picker ``pick_tile_rows_admm`` and its
VMEM budget. The seed is the fused path's exact ``rmv_stencil`` (the JAX
tiled wrapper takes ``A.rmv``).
"""

from __future__ import annotations

import torch

from .admm_tv_fused import (
    admm_tv_fused_torch,
    check_admm_tv,
    check_prox,
    kernel_args,
    solver_args,
)
from .fista_tv_fused import check_cuda_input
from .fista_tv_tiled import pick_tile_rows

__all__ = [
    "admm_tv_tiled",
    "admm_tv_tiled_torch",
    "check_admm_tv_tiled",
    "solve_admm_tv_tiled",
    "matvec_halo",
    "fgp_halo",
    "launches_per_solve",
]


def matvec_halo(kh: int) -> int:
    """Halo rows of the CG matvec's window: the column pass and its adjoint
    reach kh//2 rows each."""
    return 2 * (kh // 2)


def fgp_halo(tv_iterations: int) -> int:
    """Halo rows of the z-update's window: the FGP's dependence cone
    (one row per dual iteration and the final adjoint) and one row to
    spare; the JAX kernel rounds the same count up to 8 rows."""
    return tv_iterations + 2


def launches_per_solve(iterations: int, cg_iterations: int) -> int:
    """Kernel launches of one tiled solve: per outer iteration one to start
    the CG, two per CG step, one for the z/u update."""
    return iterations * (2 * cg_iterations + 2)


def admm_tv_tiled_torch(x0hat, scal, t2tab, taps, iterations, cg_iterations, tol_inner,
                        prox="none"):
    """Plain version: the monolithic solve (the fused kernel's plain
    version). Returns ``(x, counts)``."""
    return admm_tv_fused_torch(x0hat, scal, t2tab, taps, iterations, cg_iterations,
                               tol_inner, prox)


def _launch(x0hat, scal, t2tab, taps, tile_rows, iterations, cg_iterations, tol_inner, prox):
    from .. import _build

    B, H, W = x0hat.shape
    taps_h, taps_w = taps
    tv_iterations = t2tab.shape[0]
    T = -(-H // tile_rows)
    halo = max(matvec_halo(len(taps_h)), fgp_halo(tv_iterations))
    win_rows = min(H, tile_rows + 2 * halo)
    lib = _build.load_library()
    dev = x0hat.device
    f32 = torch.float32
    taps_t = torch.tensor(list(taps_h) + list(taps_w), dtype=f32, device=dev)
    # whole planes: x (ping-pong), z, u (ping-pong), r, p (ping-pong), q;
    # x, z and u start at zero
    planes = torch.empty((9, B, H, W), dtype=f32, device=dev)
    planes[:4].zero_()
    # each CTA's window planes, per-tile partial sums (two slots) and the
    # per-problem CG scalars (two slots)
    window = torch.empty((B, T, 6, win_rows, W), dtype=f32, device=dev)
    partial = torch.empty((2, B, T, 3), dtype=torch.float64, device=dev)
    state = torch.empty((2, B, 8), dtype=f32, device=dev)
    counts = torch.zeros((B,), dtype=torch.int32, device=dev)  # set by each z-update
    with torch.cuda.device(dev):
        code = lib.admm_tv_tiled_launch(
            x0hat.data_ptr(), scal.data_ptr(), t2tab.data_ptr(), taps_t.data_ptr(),
            len(taps_h), len(taps_w), planes.data_ptr(), window.data_ptr(),
            partial.data_ptr(), state.data_ptr(), counts.data_ptr(),
            B, H, W, tile_rows, iterations, cg_iterations, tv_iterations, float(tol_inner),
            int(prox == "positive"), torch.cuda.current_stream().cuda_stream,
        )
    _build.check(code, "admm_tv_tiled_launch")
    admm_tv_tiled.launches += launches_per_solve(iterations, cg_iterations)
    return planes[iterations % 2].clone(), counts


def admm_tv_tiled(
    x0hat_b, taps, rho, lam, iterations: int, cg_iterations: int, tv_iterations: int,
    tol_inner: float, prox="none", tile_rows=None, with_counts=False,
):
    """Batched ADMM-TV on a separable conv, each problem in row tiles of
    `tile_rows` rows (default: `pick_tile_rows` for the card); arguments
    as for `admm_tv_fused`. The plain version runs for a CPU tensor, the
    CUDA kernel for a CUDA tensor. ``admm_tv_tiled.launches`` counts the
    kernel's launches, `launches_per_solve` per call."""
    check_prox(prox)
    if tile_rows is not None and int(tile_rows) < 1:
        raise ValueError(f"tile_rows must be positive, got {tile_rows}")
    scal, t2tab = kernel_args(x0hat_b, rho, lam, tv_iterations)
    args = (iterations, cg_iterations, float(tol_inner), prox)
    if x0hat_b.device.type == "cpu":
        out = admm_tv_tiled_torch(x0hat_b, scal, t2tab, taps, *args)
    else:
        check_cuda_input("admm_tv_tiled", x0hat_b, taps)
        if tile_rows is None:
            sms = torch.cuda.get_device_properties(x0hat_b.device).multi_processor_count
            tile_rows = pick_tile_rows(x0hat_b.shape[1], x0hat_b.shape[0], sms)
        out = _launch(x0hat_b.contiguous(), scal, t2tab, taps, int(tile_rows), *args)
    return out if with_counts else out[0]


admm_tv_tiled.launches = 0


def check_admm_tv_tiled(solver):
    """Validate `solver` for the tiled path (raises ValueError naming the
    first unsupported piece); the same solver requirements as the fused
    path, at any image size."""
    check_admm_tv(solver, "tiled")


def solve_admm_tv_tiled(solver, B_mat, tile_rows=None):
    """Drop-in fast path for `solve_batched_unrolled(solver, B)` at image
    sizes where one CTA per problem leaves the card idle (512²). Returns
    the n×K solution matrix like the composed driver."""
    check_admm_tv_tiled(solver)
    H, W = solver.AHA.A.im_shape
    *args, prox = solver_args(solver, B_mat)
    out = admm_tv_tiled(*args, prox=prox, tile_rows=tile_rows)
    return out.reshape(out.shape[0], H * W).T
