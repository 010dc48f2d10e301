"""Solver protocol and drivers.

PyTorch counterpart of ``rls_tpu/models/solvers/base.py``: the protocol,
``split_projection_terms`` and ``prepare_operators`` (:61-126); ``solve``,
``solve_trace``, ``solver_solution``, ``solver_convergence`` and
``solve_unrolled`` (:246-334); ``solve_batched_unrolled`` (:337-350);
``SolverRun`` and ``solve_with_callbacks`` (:353-406);
``masked_vmap_scheduler`` and ``solve_batched`` with its ``scheduler``
(:409-480); ``pcg``, the inner solver of ADMM (:171-230);
``kaczmarz_row_update``, the row projection of Kaczmarz (:129-150).

  * solver = plain dataclass over operator modules and scalars,
  * state  = dataclass of tensors produced by ``solver.init(b)``; every
    per-problem scalar carries b's leading batch axes,
  * step   = ``state -> state`` (reference ``iterate``).

The batch is an explicit leading dimension: ``solver.init`` takes b of
shape (..., m) and every step advances all problems at once. Where
``rls_tpu`` vmaps a while-loop, the port runs a host loop over the batch
with an active mask (``masked_vmap_scheduler``): finished problems are
frozen by masked updates (``state_where``). ``solve_trace`` and
``solve_with_callbacks`` take b as ``solver.init`` does, (..., m).
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
    "SolverRun",
    "solve",
    "solve_trace",
    "solver_solution",
    "solver_convergence",
    "solve_with_callbacks",
    "masked_vmap_scheduler",
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
    "kaczmarz_row_update",
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
    batch axes first; a field that is no tensor (Kaczmarz's random
    generator) is taken from `new`."""

    def sel(a, b):
        if isinstance(a, tuple):
            return tuple(sel(ai, bi) for ai, bi in zip(a, b))
        if not torch.is_tensor(a):
            return a
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


def kaczmarz_row_update(A, x, dual, j, rhs, denom_j, eps_w_j):
    """One regularized Kaczmarz row projection for every problem at once
    (reference iterate_row_index, Kaczmarz.jl:303-308):

        τ       = a_j · x            (unconjugated, BLAS dotu semantics)
        α       = denom_j (rhs − τ − εw · dual_j)
        x      += α · conj(a_j)
        dual_j += α · εw

    x (..., n), dual (..., m), rhs / denom_j / eps_w_j one per problem.
    Routed through the operator's ``row_dot`` / ``row_axpy``, so a padded
    CSR operator pays O(nnz_row). `dual` is updated in place (the sweep
    owns its copy); returns ``(x, dual)``."""
    tau = A.row_dot(j, x)
    alpha = denom_j.to(x.dtype) * (rhs - tau - eps_w_j.to(x.dtype) * dual[..., j])
    x = A.row_axpy(x, j, alpha)
    dual[..., j] += alpha * eps_w_j.to(x.dtype)
    return x, dual


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


def _stack(seq, dim):
    """Stack a sequence of tensors (or of dicts of tensors) along `dim`."""
    if isinstance(seq[0], dict):
        return {k: _stack([d[k] for d in seq], dim) for k in seq[0]}
    return torch.stack(seq, dim=dim)


def solve_trace(solver: LinearSolver, b, x0=None, metrics: bool = True):
    """Fixed-length run over `solver.total_steps` with done-masking.

    Returns ``(x, trace)`` where trace stacks the per-iteration
    ``(solution, convergence metrics, active flag)`` (the metrics only
    where `metrics`), each along the axis after b's batch axes: the
    solutions (*batch, T, n), every metric and the flags (*batch, T). The
    counterpart of StoreSolutionCallback / StoreConvergenceCallback
    (reference Callbacks.jl) without host callbacks."""
    state = solver.init(b, x0)
    sols, mets, acts = [], [], []
    for _ in range(solver.total_steps):
        active = ~solver.done(state)
        state = state_where(active, solver.step(state), state)
        sols.append(solver.solution(state).clone())  # a step may reuse a tensor
        if metrics:
            mets.append(solver.convergence(state))
        acts.append(active)
    axis = acts[0].ndim if acts else 0
    trace = (_stack(sols, axis),)
    if metrics:
        trace += (_stack(mets, axis),)
    trace += (_stack(acts, axis),)
    state = solver.finalize(state)
    return solver.solution(state), trace


def solver_solution(solver: LinearSolver, state):
    """Reference ``solversolution`` accessor."""
    return solver.solution(state)


def solver_convergence(solver: LinearSolver, state):
    """Reference ``solverconvergence`` accessor."""
    return solver.convergence(state)


class SolverRun:
    """Host-side view passed to callbacks: `solution`, `convergence` and
    the raw `state`, like the reference's callback(solver, iteration)."""

    def __init__(self, solver: LinearSolver, state):
        self.solver = solver
        self.state = state

    @property
    def solution(self):
        return self.solver.solution(self.state)

    @property
    def convergence(self):
        return self.solver.convergence(self.state)


def solve_with_callbacks(solver: LinearSolver, b, callbacks=None, x0=None):
    """Host-loop driver with per-iteration Python callbacks, the analog of
    `solve!(solver, b; callbacks)` (reference
    RegularizedLeastSquares.jl:103-117), the iteration-0 call included. b is
    (..., m), as ``solver.init`` takes it: every problem steps until it is
    done, then stays frozen (the masking of :func:`solve_batched`), and the
    callbacks see the whole batch. A solver with ``verbose=True`` prints
    its metrics every iteration."""
    if callbacks is None:
        callbacks = []
    elif callable(callbacks):
        callbacks = [callbacks]
    verbose = bool(getattr(solver, "verbose", False))

    state = solver.init(b, x0)
    run = SolverRun(solver, state)
    for cb in callbacks:
        cb(run, 0)

    active = ~solver.done(state)
    iteration = 0
    while bool(active.any()):
        state = state_where(active, solver.step(state), state)
        active = active & ~solver.done(state)
        run.state = state
        iteration += 1
        if verbose:
            metrics = {k: v.tolist() for k, v in solver.convergence(state).items()}
            print(f"Iteration {iteration}; {metrics}")
        for cb in callbacks:
            cb(run, iteration)

    state = solver.finalize(state)
    run.state = state
    return solver.solution(state)


def masked_vmap_scheduler(solver: LinearSolver, state, active0):
    """Default `solve_batched` scheduling policy: each host iteration steps
    EVERY problem at once and keeps the new state only where the problem is
    still active; a problem stops once ``done``. The counterpart of
    ``rls_tpu``'s masked vmap in a ``lax.while_loop`` (:409-444).

    Scheduler contract (the custom-scheduling seam of the reference's
    ``solve!(solver, B; scheduler=...)``): a scheduler is
    ``f(solver, state, active0) -> state``, where ``state`` is the batched
    state of ``solver.init`` (every tensor field carries the problem axis
    first) and ``active0`` the (K,) initial liveness mask. It returns the
    state after every problem has converged or spent its budget;
    `solve_batched` applies `finalize` and `solution` afterwards. A custom
    scheduler may step the problems in any order or grouping, e.g. by
    ``state_where`` on a chunk's mask."""
    active = active0
    while bool(active.any()):
        state = state_where(active, solver.step(state), state)
        active = active & ~solver.done(state)
    return state


def solve_batched(solver: LinearSolver, B, x0=None, scheduler=None):
    """Multi-RHS solve: columns of ``B`` (m × K) are independent problems.
    ``scheduler`` (default :func:`masked_vmap_scheduler`) advances the
    batched state; see it for the contract. Returns an n × K matrix
    (reference hcat gather)."""
    if scheduler is None:
        scheduler = masked_vmap_scheduler
    state = solver.init(B.T, x0)
    active0 = torch.ones(B.shape[1], dtype=torch.bool, device=B.device)
    state = scheduler(solver, state, active0)
    state = solver.finalize(state)
    return solver.solution(state).T
