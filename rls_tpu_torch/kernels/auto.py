"""Automatic fast-path dispatch for batched fixed-iteration solves.

Counterpart of ``solve_batched_fast`` (``rls_tpu/kernels/auto.py:61-98``):
each fused whole-solve kernel's *applicability check* runs in turn and the
first kernel whose check passes runs. Execution errors are NOT swallowed.
When no fused kernel applies, a warning names every rejection and the call
falls back to the composed ``solve_batched_unrolled`` driver.

Every row of ``rls_tpu``'s table is ported, in its order: ``cgnr_dense``,
``pgm_tv``, ``pgm_dense``, ``fista_tv_tiled``, ``admm_tv``,
``admm_tv_tiled``, ``splitbregman_l1_tv``, ``fista_l1_dft``,
``fista_l21_sense``, ``pdhg``, ``kaczmarz_greedy`` and
``kaczmarz_streamed``. The dense rows take a ``DenseOperator``, the TV rows
and ``pdhg`` a ``SeparableConvOperator``, the FFT rows a
``SubsampledDFT2RealOperator`` or ``SenseDFT2RealOperator`` and the
Kaczmarz rows a ``Kaczmarz`` solver, so each check rejects the other
families. The FFT rows take images whose
sides are powers of two (their in-kernel FFT's sizes); any other size is
rejected with that reason and falls back to the composed path. The
fused OptISTA and POGM paths use an f64 momentum table, so their results
can differ from the composed path's f32 recurrence at the ~1e-3 level
over ~50 iterations.

Fused or tiled: the JAX table sends an image to its tiled kernel when the
monolithic kernel's working set exceeds the TPU's VMEM (past ~384²). The
port's rule comes from its planners' routes, on the image alone, since
the check sees the solver and not the batch (``check_six_planes``): an
image goes to the fused PGM-TV kernel where its resident route's six
planes of a band fit a cluster (up to 384²), else to the row-tiled row,
whose planner puts each problem on a cluster with three planes of a band
in shared memory (512², the ``fista_tv_512_tiled_b16`` cell of
``tools/bench_suite.py``) or walks row tiles where even three fit no
band (1024², ``fista_tv_1024_tiled_b8``). The ADMM-TV rows keep a pixel
rule (``admm_tv_fused.FUSED_MAX_PIXELS``): more than 256² pixels go to
the tiled ADMM-TV kernel, though the fused one's planner
(``plan_admm_tv``) puts larger images on a cluster too.
The PDHG row has no size rule: its kernel's planner (``plan_pdhg``) puts
each problem on a cluster, or one CTA per problem where a row is too wide
for any band.
"""

from __future__ import annotations

import warnings

from .admm_tv_fused import FUSED_MAX_PIXELS, check_admm_tv_fused, solve_admm_tv_fused
from .cgnr_fused import check_cgnr_fused, solve_cgnr_fused
from .admm_tv_tiled import check_admm_tv_tiled, solve_admm_tv_tiled
from .fista_tv_fused import check_pgm_tv_fused, check_six_planes, solve_pgm_tv_fused
from .fista_l1_dft_fused import check_fista_l1_dft_fused, solve_fista_l1_dft_fused
from .fista_tv_tiled import check_fista_tv_tiled, solve_fista_tv_tiled
from .kaczmarz_greedy import check_kaczmarz_greedy, solve_kaczmarz_greedy
from .kaczmarz_streamed import check_kaczmarz_streamed, solve_kaczmarz_streamed
from .pdhg_fused import check_pdhg_fused, solve_pdhg_fused
from .pgm_dense_fused import check_pgm_dense_fused, solve_pgm_dense_fused
from .sense_fused import check_fista_l21_sense_fused, solve_fista_l21_sense_fused
from .splitbregman_fused import check_splitbregman_l1_tv_fused, solve_splitbregman_l1_tv_fused

__all__ = ["solve_batched_fast", "select_fast_path", "FUSED_MAX_PIXELS"]


def _check_pgm_tv(solver):
    check_pgm_tv_fused(solver)
    check_six_planes(*solver.AHA.A.im_shape)


# the rows of rls_tpu/kernels/auto.py:42-58, in its order
_FUSED_WRAPPERS = (
    ("cgnr_dense", check_cgnr_fused, solve_cgnr_fused),
    ("pgm_tv", _check_pgm_tv, solve_pgm_tv_fused),
    ("pgm_dense", check_pgm_dense_fused, solve_pgm_dense_fused),
    ("fista_tv_tiled", check_fista_tv_tiled, solve_fista_tv_tiled),
    ("admm_tv", check_admm_tv_fused, solve_admm_tv_fused),
    ("admm_tv_tiled", check_admm_tv_tiled, solve_admm_tv_tiled),
    ("splitbregman_l1_tv", check_splitbregman_l1_tv_fused, solve_splitbregman_l1_tv_fused),
    ("fista_l1_dft", check_fista_l1_dft_fused, solve_fista_l1_dft_fused),
    ("fista_l21_sense", check_fista_l21_sense_fused, solve_fista_l21_sense_fused),
    ("pdhg", check_pdhg_fused, solve_pdhg_fused),
    ("kaczmarz_greedy", check_kaczmarz_greedy, solve_kaczmarz_greedy),
    ("kaczmarz_streamed", check_kaczmarz_streamed, solve_kaczmarz_streamed),
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
        warnings.warn(
            "solve_batched_fast: no fused kernel applies; falling back to "
            "the composed solve_batched_unrolled path. Rejections: "
            + "; ".join(reasons),
            UserWarning,
            stacklevel=2,
        )
    from ..models.solvers.base import solve_batched_unrolled

    return solve_batched_unrolled(solver, B)
