"""rls_tpu_torch — the PyTorch and CUDA port of rls_tpu for NVIDIA Hopper.

Batched deblurring with a 2-D anisotropic TV prior on a separable
convolution: the PGM-TV family (FISTA, OptISTA, POGM) and ADMM with its
CG inner solve; and the dense-matrix solvers: CGNR (with its refined
solve), DirectSolver, PseudoInverse, and FISTA / OptISTA / POGM with an
L1 or L2 prox on real or complex data. Seven hand-written CUDA kernels
carry them (``csrc/tv_fgp.cu``, ``csrc/fista_tv_fused.cu``,
``csrc/fista_tv_tiled.cu``, ``csrc/admm_tv_fused.cu``,
``csrc/admm_tv_tiled.cu``, ``csrc/cgnr_fused.cu``,
``csrc/pgm_dense_fused.cu``), built with ``nvcc`` at first use.
Names follow the JAX package ``rls_tpu``, which stays the reference. This
package imports ``torch`` and never ``jax``. Operators are built on the
card unless the caller passes ``device="cpu"``.
"""

from .kernels.admm_tv_fused import solve_admm_tv_fused
from .kernels.admm_tv_tiled import solve_admm_tv_tiled
from .kernels.auto import solve_batched_fast
from .kernels.cgnr_fused import solve_cgnr_fused
from .kernels.fista_tv_fused import solve_fista_tv_fused, solve_pgm_tv_fused
from .kernels.fista_tv_tiled import solve_fista_tv_tiled
from .kernels.pgm_dense_fused import solve_pgm_dense_fused
from .models.prox import (
    L1Regularization,
    L2Regularization,
    PositiveRegularization,
    RealRegularization,
    TVRegularization,
)
from .models.solvers.admm import ADMM
from .models.solvers.base import pcg, solve, solve_batched, solve_batched_unrolled
from .models.solvers.cgnr import CGNR, solve_cgnr_refined
from .models.solvers.direct import DirectSolver, PseudoInverse
from .models.solvers.fista import FISTA
from .models.solvers.optista import OptISTA
from .models.solvers.pogm import POGM
from .ops.base import DenseOperator, IdentityOperator
from .ops.conv_direct import SeparableConvOperator
from .ops.grad import GradientOperator
from .utils.power_iterations import power_iterations

__all__ = [
    "ADMM",
    "CGNR",
    "DirectSolver",
    "PseudoInverse",
    "FISTA",
    "OptISTA",
    "POGM",
    "TVRegularization",
    "L1Regularization",
    "L2Regularization",
    "PositiveRegularization",
    "RealRegularization",
    "DenseOperator",
    "SeparableConvOperator",
    "GradientOperator",
    "IdentityOperator",
    "pcg",
    "solve",
    "solve_batched",
    "solve_batched_unrolled",
    "solve_batched_fast",
    "solve_fista_tv_fused",
    "solve_pgm_tv_fused",
    "solve_fista_tv_tiled",
    "solve_admm_tv_fused",
    "solve_admm_tv_tiled",
    "solve_cgnr_fused",
    "solve_cgnr_refined",
    "solve_pgm_dense_fused",
    "power_iterations",
]
