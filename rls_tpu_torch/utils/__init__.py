"""Utilities (counterpart of rls_tpu/utils)."""

from .checkpoint import load_state, resume, save_state
from .misc import col2im_distinct, enf_pos, enf_real, im2col_distinct, nrmsd
from .power_iterations import power_iterations
from .profiling import time_solver, trace

__all__ = [
    "save_state",
    "load_state",
    "resume",
    "trace",
    "time_solver",
    "power_iterations",
    "nrmsd",
    "enf_real",
    "enf_pos",
    "im2col_distinct",
    "col2im_distinct",
]
