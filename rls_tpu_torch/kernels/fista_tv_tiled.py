"""Row-tiled PGM-TV solve: the hand-written CUDA kernel
``csrc/fista_tv_tiled.cu`` and its plain PyTorch version.

Counterpart of ``rls_tpu/kernels/fista_tv_tiled.py``: ``fista_tv_tiled``
(:704), ``check_fista_tv_tiled`` (:917-1014) and ``solve_fista_tv_tiled``
(:1017-1082). The JAX kernel tiles rows to get past the TPU's VMEM; on an
H100 tiling is how one problem spreads over many CTAs. The fused kernel
runs one CTA per problem, so a batch of 16 images of 512² would light 16
of the 132 SMs; here each problem is cut into row tiles of `tile_rows`
rows, one CTA per (tile, problem), one launch per iteration; the tile
size adapts to the batch and the card's SM count (`pick_tile_rows`).

Each CTA reads a window of ``tile_rows + 2·halo`` rows of the previous
iterate (``_fgp_common.tile_windows``, halo ``_fgp_common.tiled_halo``)
and writes only its interior rows, into the other buffer of a ping-pong
pair: the tiled solve is the monolithic function, tiling adds halo
recompute, not approximation. The plain version is therefore the fused
kernel's plain version. FISTA, OptISTA and POGM; restart, early exit and
``sigma_fac`` as the JAX function takes them. The per-problem sums of the
dynamic schedules are summed per tile and then over the tiles in a fixed
order, with no atomics, so a result does not change from run to run. The
seed x0hat is the fused kernel's exact ``rmv_stencil`` (the JAX tiled
wrapper takes ``A.rmv``). Not ported: the TPU's tile-size pickers and
VMEM models, and the ``mode`` / ``iter_loop`` variants.
"""

from __future__ import annotations

import torch

from . import _fgp_common
from .fista_tv_fused import (
    check_cuda_input,
    check_pgm_tv,
    check_schedule,
    fista_tv_fused_torch,
    kernel_args,
    prepare,
    solver_schedule,
    _codes,
)

__all__ = [
    "fista_tv_tiled",
    "fista_tv_tiled_torch",
    "pick_tile_rows",
    "check_fista_tv_tiled",
    "solve_fista_tv_tiled",
]

# the fewest rows a tile gets from `pick_tile_rows`: at 10 dual
# iterations and 9 taps (a 20-row halo) a 32-row tile recomputes its
# rows ~2.3×
MIN_TILE_ROWS = 32


def pick_tile_rows(H: int, B: int, sms: int) -> int:
    """Rows per tile such that the (tile, problem) CTAs make about one wave
    on a card with `sms` SMs: ``sms // B`` tiles per problem, and no
    fewer than `MIN_TILE_ROWS` rows. On an H100 (132 SMs) that is 128 rows
    at 256² × 64, 64 rows at 512² × 16 and 1024² × 8, the fastest of 32,
    64 and 128 rows at each (NVIDIA H100 80GB HBM3, 700 W)."""
    tiles = max(1, sms // B)
    return max(MIN_TILE_ROWS, -(-H // tiles))


def fista_tv_tiled_torch(x0hat, scal, tab, t2tab, taps, method="fista", restart="none",
                         rel_tol=None, sigma_fac=1.0):
    """Plain version: the monolithic solve (the fused kernel's plain
    version; a window loop would compute the same, only slower).
    Returns ``(x, counts)``."""
    return fista_tv_fused_torch(x0hat, scal, tab, t2tab, taps, method, restart,
                                rel_tol, sigma_fac)


def _launch(x0hat, scal, tab, t2tab, taps, tile_rows, method, restart, rel_tol, sigma_fac):
    from .. import _build

    B, H, W = x0hat.shape
    taps_h, taps_w = taps
    iterations, tv_iterations = tab.shape[0], t2tab.shape[0]
    halo = _fgp_common.tiled_halo(tv_iterations, len(taps_h))
    T = -(-H // tile_rows)
    win_rows = min(H, tile_rows + 2 * halo)
    lib = _build.load_library()
    dev = x0hat.device
    f32 = torch.float32
    taps_t = torch.tensor(list(taps_h) + list(taps_w), dtype=f32, device=dev)
    # ping-pong carries (x, x_prev | y, z, w), each CTA's window planes,
    # per-tile partial sums (two slots), the per-tile Σx0hat², and the
    # per-problem scalar state (two slots)
    carries = (x0hat * 0.0).expand(2, 4, B, H, W).contiguous()
    window = torch.empty((B, T, 9, win_rows, W), dtype=f32, device=dev)
    partial = torch.zeros((2, B, T, 3), dtype=torch.float64, device=dev)
    norm_part = torch.zeros((B, T), dtype=torch.float64, device=dev)
    state = torch.zeros((2, B, 8), dtype=f32, device=dev)
    counts = torch.empty((B, 2), dtype=torch.int32, device=dev)
    dynamic = restart != "none" or rel_tol is not None
    stream = torch.cuda.current_stream().cuda_stream
    # the last launch only settles the last iteration's counts
    with torch.cuda.device(dev):
        for it in range(iterations + int(dynamic)):
            code = lib.fista_tv_tiled_launch(
                x0hat.data_ptr(), scal.data_ptr(), tab.data_ptr(), t2tab.data_ptr(),
                taps_t.data_ptr(), len(taps_h), len(taps_w),
                carries.data_ptr(), window.data_ptr(), partial.data_ptr(),
                norm_part.data_ptr(), state.data_ptr(), counts.data_ptr(),
                B, H, W, tile_rows, halo, iterations, tv_iterations, it,
                *_codes(method, restart, rel_tol, False)[:3],
                float(rel_tol or 0.0), float(sigma_fac), stream,
            )
            _build.check(code, "fista_tv_tiled_launch")
            fista_tv_tiled.launches += 1
    if not dynamic:
        counts = torch.tensor([[0, iterations]], dtype=torch.int32, device=dev).expand(B, 2)
    return carries[iterations % 2, 0].clone(), counts


def fista_tv_tiled(
    x0hat_b, taps, rho, lam, iterations: int, tv_iterations: int, tile_rows=None,
    method="fista", restart="none", rel_tol=None, sigma_fac=1.0, with_counts=False,
):
    """Batched PGM-TV on a separable conv, each problem in row tiles of
    `tile_rows` rows (default: `pick_tile_rows` for the card); arguments
    as for
    `fista_tv_fused` (no warm_tv). The plain version runs for a CPU tensor,
    the CUDA kernel for a CUDA tensor. ``fista_tv_tiled.launches`` counts
    the kernel's launches: one per iteration, and one more that settles
    the counts of a dynamic schedule."""
    check_schedule(method, restart, rel_tol, False)
    if tile_rows is not None and int(tile_rows) < 1:
        raise ValueError(f"tile_rows must be positive, got {tile_rows}")
    scal, tab, t2tab = kernel_args(x0hat_b, rho, lam, method, iterations, tv_iterations)
    sched = (method, restart, rel_tol, sigma_fac)
    if x0hat_b.device.type == "cpu":
        out = fista_tv_tiled_torch(x0hat_b, scal, tab, t2tab, taps, *sched)
    else:
        check_cuda_input("fista_tv_tiled", x0hat_b, taps)
        if tile_rows is None:
            sms = torch.cuda.get_device_properties(x0hat_b.device).multi_processor_count
            tile_rows = pick_tile_rows(x0hat_b.shape[1], x0hat_b.shape[0], sms)
        out = _launch(x0hat_b.contiguous(), scal, tab, t2tab, taps, tile_rows, *sched)
    return out if with_counts else out[0]


fista_tv_tiled.launches = 0


def check_fista_tv_tiled(solver, early_exit: bool = False):
    """Validate `solver` for the tiled path (FISTA/OptISTA/POGM +
    SeparableConv + 2-D TV); returns the method. Raises ValueError naming
    the first unsupported piece."""
    method = check_pgm_tv(solver, "tiled")
    solver_schedule(solver, method, early_exit, path="tiled")
    return method


def solve_fista_tv_tiled(solver, B_mat, tile_rows=None, early_exit=False):
    """Drop-in fast path for `solve_batched_unrolled(solver, B)` at image
    sizes where one CTA per problem leaves the card idle (512², 1024²).
    Returns the n×K solution matrix like the composed driver.
    ``solver.restart`` and ``early_exit`` as for `solve_pgm_tv_fused`."""
    method = check_fista_tv_tiled(solver, early_exit)
    restart, rel_tol, sigma_fac = solver_schedule(solver, method, early_exit, path="tiled")
    H, W = solver.AHA.A.im_shape
    x0hat_b, lam_eff = prepare(solver, B_mat)
    out = fista_tv_tiled(
        x0hat_b, solver.AHA.A.taps_hw(), solver.rho, lam_eff, solver.iterations,
        solver.reg.iterations_tv, tile_rows=tile_rows, method=method, restart=restart,
        rel_tol=rel_tol, sigma_fac=sigma_fac,
    )
    return out.reshape(out.shape[0], H * W).T
