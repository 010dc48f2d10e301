"""Automatic fast-path dispatch for batched fixed-iteration solves.

Counterpart of ``solve_batched_fast`` (``rls_tpu/kernels/auto.py:61-98``):
each fused whole-solve kernel's *applicability check* runs in turn and the
first kernel whose check passes runs. Execution errors are NOT swallowed.
When no fused kernel applies, a warning names every rejection and the call
falls back to the composed ``solve_batched_unrolled`` driver.

The ``cgnr_dense``, ``pgm_tv``, ``pgm_dense``, ``fista_tv_tiled``,
``admm_tv`` and ``admm_tv_tiled`` rows are ported; the other rows of
``rls_tpu``'s table are named in the warning as not yet ported. The dense
rows take a ``DenseOperator`` and the TV rows a
``SeparableConvOperator``, so each check rejects the other family. The
fused OptISTA and POGM paths use an f64 momentum table, so their results
can differ from the composed path's f32 recurrence at the ~1e-3 level
over ~50 iterations.

Fused or tiled: the JAX table sends an image to its tiled kernel when the
monolithic kernel's working set exceeds the TPU's VMEM (past ~384²). The
port's fused kernel has no such limit, so the rule here is the H100's own:
the fused kernel runs one problem per CTA, which suits the batches users
run at up to 256² (64 problems of the flagship light 64 of 132 SMs); at
larger images they run batches of 16 or 8 (``tools/bench_suite.py``'s
512² and 1024² cells), which one CTA per problem would leave on 8 or 16
SMs, while the tiled kernel spreads each problem over its row tiles. The
check sees the solver and not the batch, so the rule is on the image:
more than `FUSED_MAX_PIXELS` pixels go to the tiled kernel. The ADMM-TV
rows follow the same rule (``check_admm_tv_fused`` applies it).
"""

from __future__ import annotations

import warnings

from .admm_tv_fused import check_admm_tv_fused, solve_admm_tv_fused
from .cgnr_fused import check_cgnr_fused, solve_cgnr_fused
from .admm_tv_tiled import check_admm_tv_tiled, solve_admm_tv_tiled
from .fista_tv_fused import (
    FUSED_MAX_PIXELS,
    check_fused_pixels,
    check_pgm_tv_fused,
    solve_pgm_tv_fused,
)
from .fista_tv_tiled import check_fista_tv_tiled, solve_fista_tv_tiled
from .pgm_dense_fused import check_pgm_dense_fused, solve_pgm_dense_fused

__all__ = ["solve_batched_fast", "select_fast_path", "FUSED_MAX_PIXELS"]


def _check_pgm_tv(solver):
    check_pgm_tv_fused(solver)
    check_fused_pixels(*solver.AHA.A.im_shape)


# the ported rows of rls_tpu/kernels/auto.py:42-58, in its order
_FUSED_WRAPPERS = (
    ("cgnr_dense", check_cgnr_fused, solve_cgnr_fused),
    ("pgm_tv", _check_pgm_tv, solve_pgm_tv_fused),
    ("pgm_dense", check_pgm_dense_fused, solve_pgm_dense_fused),
    ("fista_tv_tiled", check_fista_tv_tiled, solve_fista_tv_tiled),
    ("admm_tv", check_admm_tv_fused, solve_admm_tv_fused),
    ("admm_tv_tiled", check_admm_tv_tiled, solve_admm_tv_tiled),
)

# the remaining rows of rls_tpu/kernels/auto.py:42-58, in table order
_NOT_YET_PORTED = (
    "splitbregman_l1_tv",
    "fista_l1_dft",
    "fista_l21_sense",
    "pdhg",
    "kaczmarz_greedy",
    "kaczmarz_streamed",
)


def select_fast_path(solver):
    """``(name, run, reasons)``: the first row of the table whose check
    passes (``(None, None, reasons)`` if none does), with the rejection
    reasons of the rows before it."""
    reasons = []
    for name, check, run in _FUSED_WRAPPERS:
        try:
            check(solver)
        except ValueError as e:
            reasons.append(f"{name}: {e}")
            continue
        return name, run, reasons
    return None, None, reasons


def solve_batched_fast(solver, B, warn=True):
    """Batched fixed-iteration solve via the fastest applicable path.

    Tries each fused kernel's check; runs the first that applies. Falls
    back to `solve_batched_unrolled` with a `UserWarning` naming why every
    fused path was rejected (pass ``warn=False`` to silence).
    """
    _, run, reasons = select_fast_path(solver)
    if run is not None:
        return run(solver, B)
    if warn:
        reasons += [f"{name}: not yet ported" for name in _NOT_YET_PORTED]
        warnings.warn(
            "solve_batched_fast: no fused kernel applies; falling back to "
            "the composed solve_batched_unrolled path. Rejections: "
            + "; ".join(reasons),
            UserWarning,
            stacklevel=2,
        )
    from ..models.solvers.base import solve_batched_unrolled

    return solve_batched_unrolled(solver, B)
