"""The CGNR kernel's planner (rls_tpu_torch/kernels/cgnr_fused.py
``plan_cgnr``), on the CPU: how it cuts A's rows into slabs and the batch
into groups for an H100 (132 SMs, 232,448 bytes of shared memory per
block), that every plan covers its shape and fits the card, and that a
shape with no plan raises. The kernel itself runs only on the card
(tests/test_torch_cuda.py)."""

import pytest

from rls_tpu_torch.kernels import cgnr_fused as cg

SMS, SMEM = 132, 232_448


def _covers(plan, m, n, P, sms=SMS, smem=SMEM):
    assert (plan.slabs - 1) * plan.rows < m <= plan.slabs * plan.rows
    assert (plan.groups - 1) * plan.group_size < P <= plan.groups * plan.group_size
    assert plan.ctas <= sms
    assert plan.smem == cg.smem_bytes(n, plan.slabs, plan.rows, plan.group_size,
                                      plan.resident) <= smem


@pytest.mark.parametrize("shape,want", [
    # the two CGNR cells: 16 slabs of 64 rows × 8 groups of 8; one CTA per
    # problem with the whole 64 × 64 A and no barrier
    ((1024, 512, 64), (16, 64, 8, 8, True)),
    ((64, 64, 16), (1, 64, 16, 1, True)),
])
def test_plans_at_the_cells(shape, want):
    m, n, P = shape
    plan = cg.plan_cgnr(m, n, P, SMS, SMEM)
    _covers(plan, m, n, P)
    assert (plan.slabs, plan.rows, plan.groups, plan.group_size, plan.resident) == want


@pytest.mark.parametrize("shape,kind", [
    # the complex 256 × 512 system's split-real embedding at batch 16
    ((512, 1024, 16), "resident"),
    # 1000 = 16 slabs of 63 rows (the last 55); 61 = 8 groups of 8 (the last 5)
    ((1000, 300, 61), "remainders"),
    ((1030, 500, 70), "remainders"),
    # P = 1: the SMs share one problem's rows
    ((1024, 512, 1), "one problem"),
    # more problems than SMs; p of 40 problems no longer fits beside the
    # slab, so A and p stay in global memory
    ((1024, 512, 137), "covered"),
    ((1024, 512, 200), "global"),
    ((300, 200, 203), "resident"),
    # tall and wide A; a wide row's p (36000 doubles) exceeds the block
    ((36000, 16, 64), "resident"),
    ((16, 36000, 64), "global"),
])
def test_plans_at_the_edges(shape, kind):
    m, n, P = shape
    plan = cg.plan_cgnr(m, n, P, SMS, SMEM)
    _covers(plan, m, n, P)
    if kind == "remainders":
        assert plan.slabs > 1 and plan.groups > 1
        assert m % plan.rows and P % plan.group_size
    elif kind == "one problem":
        assert (plan.groups, plan.group_size) == (1, 1) and plan.slabs > 1
    elif kind != "covered":
        assert plan.resident == (kind == "resident")


@pytest.mark.parametrize("m", [1, 7, 64, 129, 1025, 5000])
@pytest.mark.parametrize("n", [1, 33, 512])
@pytest.mark.parametrize("P", [1, 9, 133, 250])
def test_every_plan_covers_its_shape_and_fits(m, n, P):
    _covers(cg.plan_cgnr(m, n, P, SMS, SMEM), m, n, P)


@pytest.mark.parametrize("smem", [48 * 1024, 100_000, SMEM])
def test_plans_respect_the_shared_memory_limit(smem):
    """A smaller limit still plans the 1024 × 512 cell, within it; at the
    H100's 227 KB the cell's slab of 64 rows (128 KiB) stays resident."""
    plan = cg.plan_cgnr(1024, 512, 64, SMS, smem)
    _covers(plan, 1024, 512, 64, smem=smem)
    if smem == SMEM:
        assert plan.resident and plan.rows == 64


def test_smem_bytes_counts_every_piece():
    # the 1024 × 512 cell: q 64 × 8 float64, 5 × 8 f32 scalars, 2 × 8 × 8
    # float64 reductions, 10 int64 phase clocks, 8 × 128 float64 split sums
    always = 4096 + 160 + 1024 + 80 + 8192
    assert cg.smem_bytes(512, 16, 64, 8, False) == always
    # resident: the 64 × 520 f32 slab (stride 8 mod 32), 512 × 8 float64
    # p, the owner's x, r, v (3 × 32 × 8 f32) and the group's r (512 × 8 f32)
    assert cg.slab_ld(512) == 520
    assert cg.smem_bytes(512, 16, 64, 8, True) == always + 133120 + 32768 + 3072 + 16384
    # one slab (the 64 × 64 cell, one problem): the owner's x, r, v over all
    # 64 columns and the partial v of the tile (64 × 8 float64), no staged r
    assert cg.slab_ld(64) == 72
    assert cg.smem_bytes(64, 1, 64, 1, True) == (
        4096 + 32 + 1024 + 80 + 8192 + 4 * 64 * 72 + 4096 + 6144 + 4096)
    # rows rounded up to 16, columns to 8 (p) and to slab_ld (A), problems
    # to 8, each piece aligned to 16 bytes: 3 rows × 5 columns, 3 problems
    assert cg.slab_ld(5) == 40
    assert cg.smem_bytes(5, 2, 3, 3, True) == (
        1024 + 64 + 1024 + 80 + 8192 + 4 * 16 * 40 + 512 + 288 + 160)


@pytest.mark.parametrize("shape,sms,smem", [
    ((600_000, 2, 3), SMS, SMEM),  # 4546 rows per slab: q alone needs 290 KB
    ((1024, 512, 64), SMS, 1024),  # no block holds even the reductions
    ((1024, 512, 64), 0, SMEM),  # no SM
])
def test_a_shape_without_a_plan_raises_and_names_it(shape, sms, smem):
    m, n, P = shape
    with pytest.raises(ValueError, match=f"A {m}x{n} with {P} problems"):
        cg.plan_cgnr(m, n, P, sms, smem)


def test_empty_shapes_raise():
    with pytest.raises(ValueError, match="empty"):
        cg.plan_cgnr(0, 4, 2, SMS, SMEM)


def test_the_model_prefers_the_resident_slab_and_fewer_barriers():
    """At the 1024 × 512 cell the chosen cut costs less than the
    alternatives the model also weighs: one slab per group (no barrier but
    1024 rows per CTA), 128 slabs of 8 rows (every problem in one group),
    and the same cut with A and p in global memory."""
    clocks = cg.step_clocks
    best = clocks(512, 16, 64, 8, True)
    assert best < clocks(512, 1, 1024, 8, True)
    assert best < clocks(512, 128, 8, 64, True)
    assert best < clocks(512, 16, 64, 8, False)
