"""rls_tpu_torch — the PyTorch and CUDA port of rls_tpu for NVIDIA Hopper.

Batched deblurring with a 2-D anisotropic TV prior on a separable
convolution: the PGM-TV family (FISTA, OptISTA, POGM) and ADMM with its
CG inner solve; the dense-matrix solvers: CGNR (with its refined solve),
DirectSolver, PseudoInverse, and FISTA / OptISTA / POGM with an L1 or L2
prox on real or complex data; and compressed sensing and multi-coil
SENSE MRI on the split-real DFT operators (``torch.fft``): FISTA with L1
or complex L1 (``L21Regularization``) and SplitBregman with L21 + TV;
PDHG with the 8-direction or isotropic TV or L1; and the row-action
solver Kaczmarz (cyclic, shuffled, randomized, greedy) on dense, sparse
and padded-CSR operators, and the Dax row-relaxation solvers DaxKaczmarz
and DaxConstrained. Operators compose: WeightingOperator, ProdOperator
(``A @ B``), StackedOperator and SamplingOperator build weighted and
multi-coil systems; DirectConvOperator (any 2-D kernel), WaveletOperator,
RadonOperator and FunctionOperator (a torch callable, its adjoint by
``torch.func.vjp``) widen the operator set. The regularizer decorators
(FixedScaled, FixedParameter, AutoScaled, Normalized, Transformed,
Masked) wrap any term, and ProjectionRegularizationTerm takes a user
projection; the exact 1-D Condat TV (TVRegularization with an integer
``dims``), NuclearRegularization, LLRRegularization and
PlugAndPlayRegularization with its CNN denoiser (``models/denoisers.py``)
complete the regularizers. The API surface of ``rls_tpu`` is here too:
the callbacks and ``solve_with_callbacks``, ``solve_trace``, the batch
scheduler of ``solve_batched``, the solver registry
(``create_linear_solver``), the deprecated shims, checkpoints
(``save_state`` / ``load_state`` / ``resume``) and profiling (``trace``,
``time_solver``). Fourteen hand-written CUDA kernels carry them
(``csrc/tv_fgp.cu``, ``csrc/fista_tv_fused.cu``,
``csrc/fista_tv_tiled.cu``, ``csrc/admm_tv_fused.cu``,
``csrc/admm_tv_tiled.cu``, ``csrc/cgnr_fused.cu``,
``csrc/pgm_dense_fused.cu``, ``csrc/fista_l1_dft_fused.cu``,
``csrc/sense_fused.cu``, ``csrc/splitbregman_fused.cu`` (the last three on
an FFT of their own), ``csrc/pdhg_fused.cu``, ``csrc/kaczmarz.cu`` and
``csrc/kaczmarz_greedy.cu`` and ``csrc/tv_condat.cu``, the exact 1-D TV
prox), built with ``nvcc`` at first use.
Names follow the JAX package ``rls_tpu``, which stays the reference. This
package imports ``torch`` and never ``jax``. Operators are built on the
card unless the caller passes ``device="cpu"``.

Every public name of ``rls_tpu`` is bound here, less the names of
``EXCLUDED``, which the port leaves out: the split-real solver exists for
TPU runtimes without complex dtypes, and the Jacobi SVD for the TPU's bf16
matrix unit. ``parallel`` shards a batch of problems over CUDA devices
(and over processes on ``torch.distributed``) and a dense operator's rows
over devices.
"""

from . import deprecated, ops, parallel, utils
from .callbacks import CompareSolutionCallback, StoreConvergenceCallback, StoreSolutionCallback

from .kernels.admm_tv_fused import solve_admm_tv_fused
from .kernels.admm_tv_tiled import solve_admm_tv_tiled
from .kernels.auto import solve_batched_fast
from .kernels.cgnr_fused import solve_cgnr_fused
from .kernels.fista_tv_fused import solve_fista_tv_fused, solve_pgm_tv_fused
from .kernels.fista_l1_dft_fused import solve_fista_l1_dft_fused
from .kernels.fista_tv_tiled import solve_fista_tv_tiled
from .kernels.kaczmarz_greedy import solve_kaczmarz_greedy
from .kernels.kaczmarz_streamed import solve_kaczmarz_streamed
from .kernels.pdhg_fused import solve_pdhg_fused
from .kernels.pgm_dense_fused import solve_pgm_dense_fused
from .kernels.sense_fused import solve_fista_l21_sense_fused
from .kernels.splitbregman_fused import solve_splitbregman_l1_tv_fused
from .models import denoisers, prox, regularization
from .models.prox import (
    L1Regularization,
    L2Regularization,
    L21Regularization,
    LLRRegularization,
    NuclearRegularization,
    PositiveRegularization,
    ProjectionRegularizationTerm,
    RealRegularization,
    TVRegularization,
)
from .models.regularization import (
    AutoScaledRegularization,
    ClampedScalingTransform,
    FixedParameterRegularization,
    FixedScaledRegularization,
    IdentityTransform,
    MaskedRegularization,
    MeasurementBasedNormalization,
    MinMaxTransform,
    NoNormalization,
    NormalizedRegularization,
    PlugAndPlayRegularization,
    PnPRegularization,
    SystemMatrixBasedNormalization,
    TransformedRegularization,
    ZTransform,
    find_sink,
    find_sinks,
    normalization_factor,
    reg_chain,
    sink,
    sink_type,
)
from .models.solvers.admm import ADMM
from .models.solvers.base import (
    SolverRun,
    masked_vmap_scheduler,
    pcg,
    solve,
    solve_batched,
    solve_batched_unrolled,
    solve_trace,
    solve_unrolled,
    solve_with_callbacks,
    solver_convergence,
    solver_solution,
)
from .models.solvers.cgnr import CGNR, solve_cgnr_refined
from .models.solvers.dax import DaxConstrained, DaxKaczmarz
from .models.solvers.direct import DirectSolver, PseudoInverse
from .models.solvers.fista import FISTA
from .models.solvers.kaczmarz import Kaczmarz
from .models.solvers.optista import OptISTA
from .models.solvers.pdhg import PDHG, prox_tv_conj_8dir
from .models.solvers.pogm import POGM
from .models.solvers.splitbregman import SplitBregman
from .ops.base import (
    DenseOperator,
    IdentityOperator,
    NormalOperator,
    ProdOperator,
    SamplingOperator,
    StackedOperator,
    WeightingOperator,
)
from .ops.conv_direct import DirectConvOperator, SeparableConvOperator
from .ops.dft_real import SenseDFT2RealOperator, SubsampledDFT2RealOperator
from .ops.fourier import ConvolutionOperator, FFTOperator, SubsampledFFTOperator
from .ops.function_op import FunctionOperator
from .ops.grad import Grad8Operator, GradientOperator
from .ops.radon import RadonOperator
from .ops.sparse import PaddedCSROperator, SparseOperator
from .ops.wavelet import WaveletOperator, max_wavelet_levels
from .registry import (
    applicable_solver_list,
    create_linear_solver,
    deinit,
    is_applicable,
    linear_solver_list,
    linear_solver_list_real,
)
from .utils import (
    load_state,
    nrmsd,
    power_iterations,
    resume,
    save_state,
    time_solver,
    trace,
)

# the public names of rls_tpu that the port leaves out (ROADMAP.md, "What
# not to port"): the split-real solver and the Jacobi SVD
EXCLUDED = (
    "SplitRealSolver",
    "backend_supports_complex",
    "build_split_real_solver",
    "jacobi_svd",
    "jacobi_svdvals",
    "svt_jacobi",
)

__all__ = [
    "ADMM",
    "CGNR",
    "DirectSolver",
    "PseudoInverse",
    "FISTA",
    "OptISTA",
    "POGM",
    "SplitBregman",
    "PDHG",
    "Kaczmarz",
    "DaxKaczmarz",
    "DaxConstrained",
    "prox_tv_conj_8dir",
    "TVRegularization",
    "NuclearRegularization",
    "LLRRegularization",
    "PlugAndPlayRegularization",
    "PnPRegularization",
    "L1Regularization",
    "L2Regularization",
    "L21Regularization",
    "PositiveRegularization",
    "RealRegularization",
    "ProjectionRegularizationTerm",
    "FixedScaledRegularization",
    "FixedParameterRegularization",
    "AutoScaledRegularization",
    "NormalizedRegularization",
    "TransformedRegularization",
    "MaskedRegularization",
    "MinMaxTransform",
    "IdentityTransform",
    "ZTransform",
    "ClampedScalingTransform",
    "NoNormalization",
    "MeasurementBasedNormalization",
    "SystemMatrixBasedNormalization",
    "normalization_factor",
    "reg_chain",
    "sink",
    "sink_type",
    "find_sink",
    "find_sinks",
    "DenseOperator",
    "SeparableConvOperator",
    "SubsampledDFT2RealOperator",
    "SenseDFT2RealOperator",
    "FFTOperator",
    "SubsampledFFTOperator",
    "ConvolutionOperator",
    "GradientOperator",
    "Grad8Operator",
    "SparseOperator",
    "PaddedCSROperator",
    "IdentityOperator",
    "NormalOperator",
    "WeightingOperator",
    "ProdOperator",
    "StackedOperator",
    "SamplingOperator",
    "DirectConvOperator",
    "WaveletOperator",
    "max_wavelet_levels",
    "FunctionOperator",
    "RadonOperator",
    "pcg",
    "solve",
    "solve_batched",
    "solve_batched_unrolled",
    "solve_unrolled",
    "solve_batched_fast",
    "solve_fista_tv_fused",
    "solve_pgm_tv_fused",
    "solve_fista_tv_tiled",
    "solve_admm_tv_fused",
    "solve_admm_tv_tiled",
    "solve_cgnr_fused",
    "solve_cgnr_refined",
    "solve_pgm_dense_fused",
    "solve_fista_l1_dft_fused",
    "solve_fista_l21_sense_fused",
    "solve_splitbregman_l1_tv_fused",
    "solve_pdhg_fused",
    "solve_kaczmarz_streamed",
    "solve_kaczmarz_greedy",
    "power_iterations",
    "CompareSolutionCallback",
    "StoreSolutionCallback",
    "StoreConvergenceCallback",
    "SolverRun",
    "solve_trace",
    "solver_solution",
    "solver_convergence",
    "solve_with_callbacks",
    "masked_vmap_scheduler",
    "linear_solver_list",
    "linear_solver_list_real",
    "applicable_solver_list",
    "is_applicable",
    "create_linear_solver",
    "deinit",
    "save_state",
    "load_state",
    "resume",
    "trace",
    "time_solver",
    "nrmsd",
    "callbacks",
    "registry",
    "deprecated",
    "denoisers",
    "prox",
    "regularization",
    "ops",
    "parallel",
    "utils",
]
