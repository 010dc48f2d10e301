"""rls_tpu_torch — the PyTorch and CUDA port of rls_tpu for NVIDIA Hopper.

Batched deblurring with a 2-D anisotropic TV prior on a separable
convolution: the PGM-TV family (FISTA, OptISTA, POGM) and ADMM with its
CG inner solve, carried by five hand-written CUDA kernels
(``csrc/tv_fgp.cu``, ``csrc/fista_tv_fused.cu``,
``csrc/fista_tv_tiled.cu``, ``csrc/admm_tv_fused.cu``,
``csrc/admm_tv_tiled.cu``) that are built with ``nvcc`` at first use.
Names follow the JAX package ``rls_tpu``, which stays the reference. This
package imports ``torch`` and never ``jax``. Operators are built on the
card unless the caller passes ``device="cpu"``.
"""

from .kernels.admm_tv_fused import solve_admm_tv_fused
from .kernels.admm_tv_tiled import solve_admm_tv_tiled
from .kernels.auto import solve_batched_fast
from .kernels.fista_tv_fused import solve_fista_tv_fused, solve_pgm_tv_fused
from .kernels.fista_tv_tiled import solve_fista_tv_tiled
from .models.prox import L1Regularization, TVRegularization
from .models.solvers.admm import ADMM
from .models.solvers.base import pcg, solve, solve_batched, solve_batched_unrolled
from .models.solvers.fista import FISTA
from .models.solvers.optista import OptISTA
from .models.solvers.pogm import POGM
from .ops.base import IdentityOperator
from .ops.conv_direct import SeparableConvOperator
from .ops.grad import GradientOperator
from .utils.power_iterations import power_iterations

__all__ = [
    "ADMM",
    "FISTA",
    "OptISTA",
    "POGM",
    "TVRegularization",
    "L1Regularization",
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
    "power_iterations",
]
