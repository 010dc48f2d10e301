"""Checkpoint / resume for solver states.

PyTorch counterpart of ``rls_tpu/utils/checkpoint.py``. A state is a
frozen dataclass of tensors, tuples of tensors, numbers and ``None``;
`save_state` writes its fields with ``torch.save`` (tensors moved to the
CPU), and `load_state` rebuilds them into a `template` state (its
structure, devices and dtypes; e.g. ``solver.init(b)``), as the JAX
package does.

A Kaczmarz or DaxKaczmarz state holds the ``torch.Generator`` of its
random rows, which ``step`` advances in place: the checkpoint keeps its
``get_state()`` at save time, and the loaded state gets a new generator of
the template's device in that state, so a resumed randomized solve draws
the rows the uninterrupted one draws.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

__all__ = ["save_state", "load_state", "resume"]


def _pack(v):
    if isinstance(v, torch.Generator):
        return {"generator_state": v.get_state()}
    if torch.is_tensor(v):
        return v.detach().cpu().clone()
    if isinstance(v, tuple):
        return tuple(_pack(u) for u in v)
    return v


def _unpack(saved, like):
    if isinstance(like, torch.Generator):
        gen = torch.Generator(device=like.device)
        gen.set_state(saved["generator_state"])
        return gen
    if torch.is_tensor(like):
        return saved.to(device=like.device, dtype=like.dtype)
    if isinstance(like, tuple):
        return tuple(_unpack(s, u) for s, u in zip(saved, like))
    return saved


def save_state(path: str, state: Any) -> None:
    """Write the solver state `state` to `path`."""
    fields = {f.name: _pack(getattr(state, f.name)) for f in dataclasses.fields(state)}
    torch.save({"type": type(state).__name__, "fields": fields}, path)


def load_state(path: str, template: Any) -> Any:
    """The state saved by `save_state` at `path`, rebuilt into `template`,
    a state of the same solver (e.g. ``solver.init(b)``)."""
    data = torch.load(path, map_location="cpu", weights_only=False)
    if data["type"] != type(template).__name__:
        raise TypeError(f"{path} holds a {data['type']}, not a {type(template).__name__}")
    saved = data["fields"]
    return dataclasses.replace(template, **{
        f.name: _unpack(saved[f.name], getattr(template, f.name))
        for f in dataclasses.fields(template) if f.init
    })


def resume(solver, state):
    """Continue iterating a (possibly checkpointed) state until every
    problem is done, with the masking of ``solve_batched``; returns
    (solution, final_state)."""
    from ..models.solvers.base import masked_vmap_scheduler

    state = masked_vmap_scheduler(solver, state, ~solver.done(state))
    state = solver.finalize(state)
    return solver.solution(state), state
