"""The band planning that the cluster kernels share (the TV prox, the fused
PGM-TV, ADMM-TV and PDHG kernels, and the FISTA-L1-DFT kernel's wave
rule): which cluster sizes fit a problem's bands of image rows in one
CTA's shared memory, how many waves a batch of clusters takes, and the
map from an image row to the CTA whose band holds it. Each kernel module
adds its own shared-memory count, plan fields and routes."""

from __future__ import annotations

import dataclasses

# the banded kernels' threads per CTA, and the farthest row of another band
# that a kernel reads through its DSMEM row table (rls::kHalo,
# csrc/cluster_common.cuh; half the 63 taps of the stencil kernels)
THREADS, HALO = 1024, 31
# the fewest pixels per CTA to which the planner spreads a small batch:
# four per thread and sweep. A guess, not measured: below it a sweep is
# taken to be mostly its barrier
MIN_CTA_PIXELS = 4 * THREADS


def cdiv(a, b):
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class BandPlan:
    """How a banded launch runs: `route` "resident" (a cluster of
    `clusters` CTAs per problem, bands of `rows` image rows, the last one
    possibly shorter) or "global" (one CTA per problem, `rows` = H); `ctas`
    CTAs in all and `smem` bytes of shared memory per CTA."""

    route: str
    clusters: int
    rows: int
    H: int
    ctas: int
    smem: int

    def band_rows(self, rank):
        """Image rows of CTA `rank`'s band."""
        return min(self.rows, self.H - rank * self.rows)

    def locate(self, row):
        """(rank, local row) of image row `row`: the one map by which the
        kernel finds a row of another band in distributed shared memory."""
        rank = row // self.rows
        return rank, row - rank * self.rows


def band_sizes(H, W, sizes, smem_bytes, sms, smem_max):
    """The cluster sizes c of `sizes` whose bands of ⌈H/c⌉ rows fit one
    CTA's shared memory (``smem_bytes(rows, W)`` of `smem_max` bytes) with
    no band empty and c ≤ sms."""
    out = []
    for c in sizes:
        rows = cdiv(H, c)
        if c <= sms and (c - 1) * rows < H and smem_bytes(rows, W) <= smem_max:
            out.append(c)
    return tuple(out)


def fewest_waves(B, H, W, fit, resident, wave_cost=None):
    """The cluster size of a batch of B problems of H × W among the fitting
    sizes `fit` (ascending) that the card holds, n clusters of c at once
    for each pair (c, n) of `resident`: of the smallest and each larger one
    that leaves every CTA at least ``MIN_CTA_PIXELS`` pixels, the one with
    the least waves × cost of a wave, ⌈B / held(c)⌉ · wave_cost(c); the
    cost of a wave is by default its rows per band, ⌈H/c⌉ (a wave's time
    taken to go with the pixels of its CTAs). Ties go to the smaller c.
    Where the card holds none of them, fit[0], which the caller refuses."""
    held = dict(resident)
    cost = wave_cost or (lambda c: cdiv(H, c))
    eligible = [c for c in fit if held.get(c, 0) >= 1
                and (c == fit[0] or cdiv(H, c) * W >= MIN_CTA_PIXELS)]
    return min(eligible, key=lambda c: (cdiv(B, held[c]) * cost(c), c), default=fit[0])
