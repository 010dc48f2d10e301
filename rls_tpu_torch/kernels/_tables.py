"""Constant tables the kernels read, copied to their device once.

A table that depends only on a shape or an iteration count (the FFT's
twiddles and bit reversals, the momentum and fold-FGP tables) is computed
on the host in float64, rounded once, and copied to the device. Such a
copy waits for the work already queued on the card, so made anew at every
call it would hold each call's set-up behind the solve before it.
:func:`shared_table` makes each one once and hands the same tensor to
every later call.
"""

from __future__ import annotations

import torch

__all__ = ["shared_table"]

# (make, args, device) → (tensor, its version counter when made); never
# evicted, so no stream can still be reading memory that the allocator
# hands out again
_TABLES = {}


def shared_table(make, *args, device):
    """``torch.as_tensor(make(*args), device=device)``, made once per
    (make, args, device) and shared by every later call. The copy is a
    blocking one, so the table is whole on the device before any stream
    reads it. Callers only read it: a table changed in place raises
    RuntimeError at its next use."""
    key = (make, args, torch.device(device))
    if key not in _TABLES:
        table = torch.as_tensor(make(*args), device=device)
        _TABLES[key] = (table, table._version)
    table, version = _TABLES[key]
    if table._version != version:
        raise RuntimeError(f"the shared table {make.__name__}{args} on {device} was changed "
                           "in place")
    return table
