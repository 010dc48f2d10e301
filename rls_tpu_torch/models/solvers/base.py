"""Solver protocol and drivers.

PyTorch counterpart of ``rls_tpu/models/solvers/base.py``: the protocol,
``split_projection_terms`` and ``prepare_operators`` (:61-126); ``solve``
and ``solve_unrolled`` (:246-334); ``solve_batched_unrolled`` (:337-350);
``solve_batched`` with its active mask (:409-480); ``pcg``, the inner
solver of ADMM (:171-230).

  * solver = plain dataclass over operator modules and scalars,
  * state  = dataclass of tensors produced by ``solver.init(b)``; every
    per-problem scalar carries b's leading batch axes,
  * step   = ``state -> state`` (reference ``iterate``).

The batch is an explicit leading dimension: ``solver.init`` takes b of
shape (..., m) and every step advances all problems at once. Where
``rls_tpu`` vmaps a while-loop, ``solve_batched`` runs a host loop over
the batch with an active mask (``masked_vmap_scheduler``, :409-444):
finished problems are frozen by masked updates.
"""

from __future__ import annotations

import dataclasses

import torch

from ...ops.base import NormalOperator, as_operator
from ...utils.power_iterations import power_iterations
from ..prox import L1Regularization
from ..regularization import (
    ProjectionRegularization,
    find_sinks,
    normalization_factor,
)

__all__ = [
    "LinearSolver",
    "solve",
    "solve_batched",
    "solve_unrolled",
    "solve_batched_unrolled",
    "split_projection_terms",
    "prepare_operators",
    "create_args",
    "init_scalars",
    "effective_lam",
    "theta_next",
    "state_where",
    "pcg",
]


class LinearSolver:
    """Protocol for all solvers."""

    iterations: int

    @classmethod
    def create(cls, A=None, **kwargs) -> "LinearSolver":
        raise NotImplementedError

    def init(self, b, x0=None):
        raise NotImplementedError

    def step(self, state):
        raise NotImplementedError

    def done(self, state):
        raise NotImplementedError

    def solution(self, state):
        return state.x

    def finalize(self, state):
        """Post-loop hook."""
        return state

    @property
    def total_steps(self) -> int:
        """Number of step() calls a full fixed-iteration solve needs."""
        return self.iterations

    def convergence(self, state) -> dict:
        """Named convergence metrics (reference ``solverconvergence``)."""
        return {}


def split_projection_terms(reg):
    """Split a reg spec into (parameterized_terms, projection_terms),
    mirroring the `findsinks(AbstractProjectionRegularization, reg)` pattern
    in every solver ctor (e.g. FISTA.jl:79-87)."""
    regs = list(reg) if isinstance(reg, (list, tuple)) else [reg]
    proj_idx = set(find_sinks(ProjectionRegularization, regs))
    proj = tuple(regs[i] for i in sorted(proj_idx))
    params = [r for i, r in enumerate(regs) if i not in proj_idx]
    return params, proj


def prepare_operators(A, AHA):
    """Normalize (A, AHA) inputs: accept raw matrices, default AHA = AᴴA."""
    A_op = as_operator(A) if A is not None else None
    if AHA is None:
        if A_op is None:
            raise ValueError("either A or AHA must be supplied")
        AHA_op = NormalOperator(A_op)
    else:
        AHA_op = as_operator(AHA)
    return A_op, AHA_op


def theta_next(theta, c: float = 4.0):
    """``(1 + √(1 + c·θ²)) / 2`` in θ's dtype, in the reference's op order
    (c = 4 is the FISTA/OptISTA/POGM recurrence, c = 8 their last-step
    variant)."""
    return (1.0 + torch.sqrt(1.0 + c * theta * theta)) / 2.0


def init_scalars(solver, b, x0):
    """The state pieces FISTA, OptISTA and POGM share: (x0hat, x, the
    per-problem ``full`` broadcaster, norm_x0, rel_tol, λ scale)."""
    x0hat = solver.A.rmv(b) if solver.A is not None else b
    lead = x0hat.shape[:-1]
    if x0 is not None:
        x = torch.broadcast_to(x0.to(x0hat.dtype), x0hat.shape).clone()
    else:
        x = torch.zeros_like(x0hat)
    norm_x0 = torch.linalg.vector_norm(x0hat, dim=-1)
    rdt = norm_x0.dtype

    def full(v):
        return torch.as_tensor(v, dtype=rdt, device=x0hat.device).expand(lead)

    rel_tol = full(solver.rel_tol if solver.rel_tol is not None else torch.finfo(rdt).eps)
    scale = normalization_factor(solver.normalize_reg, solver.A, b).to(rdt).expand(lead)
    return x0hat, x, full, norm_x0, rel_tol, scale


def effective_lam(reg, scale, dtype):
    """The λ of `reg` (a number, or the real part of a tensor) times the
    float32 normalization `scale`, one per problem, cast to the real
    `dtype`. A Python-number λ takes the scale's float32, as it does in
    ``rls_tpu`` (a weakly typed scalar times a float32 array)."""
    lam = reg.get_lam()
    return ((lam.real if torch.is_tensor(lam) else lam) * scale).to(dtype)


def create_args(name, A, AHA, reg, rho):
    """Operators, the one parameterized term, the projections and the
    default step 0.95 / λmax(AᴴA) (the reference ctors)."""
    A_op, AHA_op = prepare_operators(A, AHA)
    if reg is None:
        reg = L1Regularization(0.0)
    params, proj = split_projection_terms(reg)
    if len(params) != 1:
        raise ValueError(
            f"{name} does not allow more additional regularization terms, "
            f"found {len(params)}"
        )
    if rho is None:
        rho = 0.95 / power_iterations(AHA_op)
    return dict(A=A_op, AHA=AHA_op, reg=params[0], proj=proj, rho=rho)


def state_where(mask, new, old):
    """Per-problem select between two states: `mask` has the batch shape,
    every field (a tensor, or a tuple of tensors, one per term) carries the
    batch axes first."""

    def sel(a, b):
        if isinstance(a, tuple):
            return tuple(sel(ai, bi) for ai, bi in zip(a, b))
        m = mask.reshape(mask.shape + (1,) * (a.ndim - mask.ndim))
        return torch.where(m, a, b)

    return dataclasses.replace(
        old,
        **{
            f.name: sel(getattr(new, f.name), getattr(old, f.name))
            for f in dataclasses.fields(old)
        },
    )


def _vdot(a, b):
    """⟨a, b⟩ = Σ conj(a)·b per problem (over the last axis)."""
    return (a.conj() * b).sum(dim=-1)


def _col(v):
    """A per-problem scalar shaped to broadcast against (..., n)."""
    return v.unsqueeze(-1)


def pcg(matvec, b, x0, maxiter: int, reltol, precon=None, unroll: bool = False):
    """Preconditioned CG on a hermitian PSD `matvec`, per problem: b and
    x0 are (..., n), the leading axes a batch of independent problems; a
    problem stops at ‖r‖ ≤ reltol·‖b‖. `precon` is a callable ``r -> z``.

    ``unroll=True`` is the masked form: exactly `maxiter` steps, and a step
    of a problem that has converged takes α = 0 and keeps p (the guards
    ``pq == 0 → 1``, ``rz == 0 → β = 0``). Otherwise the early-exit form:
    steps run while any problem is live, and a problem is frozen once it
    has converged or taken `maxiter` steps, which is what ``vmap`` of the
    JAX ``lax.while_loop`` computes."""
    P = precon if precon is not None else (lambda v: v)
    r = b - matvec(x0)
    z = P(r)
    target = reltol * torch.linalg.vector_norm(b, dim=-1)
    x, p, rz = x0, z, _vdot(r, z)

    if unroll:
        for _ in range(maxiter):
            q = matvec(p)
            pq = _vdot(p, q)
            active = torch.linalg.vector_norm(r, dim=-1) > target
            denom = torch.where(pq == 0, torch.ones_like(pq), pq)
            alpha = torch.where(active, rz / denom, torch.zeros_like(rz)).to(x.dtype)
            x = x + _col(alpha) * p
            r = r - _col(alpha) * q
            z = P(r)
            rz_new = _vdot(r, z)
            safe = torch.where(rz == 0, torch.ones_like(rz), rz)
            beta = torch.where(rz == 0, torch.zeros_like(rz), rz_new / safe)
            # freeze the search direction too: once converged, rz_new == rz
            # makes beta = 1 and p would grow by z every remaining step
            p = torch.where(_col(active), z + _col(beta) * p, p)
            rz = rz_new
        return x

    i = 0
    while True:
        live = (torch.linalg.vector_norm(r, dim=-1) > target) & (i < maxiter)
        if not bool(live.any()):
            return x
        q = matvec(p)
        alpha = rz / _vdot(p, q)
        x_new = x + _col(alpha) * p
        r_new = r - _col(alpha) * q
        z = P(r_new)
        rz_new = _vdot(r_new, z)
        p_new = z + _col(rz_new / rz) * p
        keep = _col(live)
        x = torch.where(keep, x_new, x)
        r = torch.where(keep, r_new, r)
        p = torch.where(keep, p_new, p)
        rz = torch.where(live, rz_new, rz)
        i += 1


def solve(solver: LinearSolver, b, x0=None):
    """Full solve: init → while(¬done) step → finalize → solution.
    A matrix ``b`` (m × K) dispatches to :func:`solve_batched`."""
    if b.ndim == 2:
        return solve_batched(solver, b, x0)
    state = solver.init(b, x0)
    while not bool(solver.done(state)):
        state = solver.step(state)
    state = solver.finalize(state)
    return solver.solution(state)


def solve_unrolled(solver: LinearSolver, b, x0=None):
    """Fixed-iteration solve: exactly `solver.total_steps` steps, no early
    convergence exit. `b` may carry leading batch axes."""
    state = solver.init(b, x0)
    for _ in range(solver.total_steps):
        state = solver.step(state)
    state = solver.finalize(state)
    return solver.solution(state)


def solve_batched_unrolled(solver: LinearSolver, B, x0=None):
    """`solve_unrolled` over the columns of B (m × K); returns n × K."""
    return solve_unrolled(solver, B.T, x0).T


def solve_batched(solver: LinearSolver, B, x0=None):
    """Multi-RHS solve: columns of ``B`` (m × K) are independent problems.
    Each host iteration steps every problem and keeps the new state only
    where the problem is still active; a problem stops once ``done``.
    Returns an n × K matrix (reference hcat gather)."""
    state = solver.init(B.T, x0)
    active = torch.ones(B.shape[1], dtype=torch.bool, device=B.device)
    while bool(active.any()):
        state = state_where(active, solver.step(state), state)
        active = active & ~solver.done(state)
    state = solver.finalize(state)
    return solver.solution(state).T
