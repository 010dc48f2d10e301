"""Exact 1-D TV prox of many lines at once (Condat's direct algorithm): the
hand-written CUDA kernel ``csrc/tv_condat.cu`` and its plain PyTorch
version.

No Pallas kernel is replaced: the JAX package runs the algorithm as a
vmapped ``lax.while_loop`` (``rls_tpu/models/tv_condat.py:25``), one
masked rewrite of the whole line per event. The kernel runs one thread
per line through the same state machine and writes each segment once, as
it closes; the plain version, :func:`tv_condat_lines_torch`, steps every
line's state machine at once, one event per line per step, until every
line is done. Both take the same events in the same order with the same
operations, so on the card they agree bit for bit.

The wrapper :func:`prox_tv1d_condat` takes the plain version only for a
tensor on the CPU; a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import math

import torch

__all__ = ["prox_tv1d_condat", "tv_condat_lines_torch", "prox_tv1d_condat_torch",
           "check_tv_condat"]


def _lam_groups(lam, x, axis):
    """λ as a flat tensor of x's dtype with one value per `group`
    consecutive lines of x viewed as (outer, N, inner): λ is a scalar, or
    carries a prefix of x's axes that ends before `axis` (one λ per
    problem, or per leading index)."""
    lam = torch.as_tensor(lam, dtype=x.dtype, device=x.device)
    lines = x.numel() // x.shape[axis]
    if lam.ndim == 0:
        return lam.reshape(1), lines
    if lam.ndim > axis or tuple(lam.shape) != tuple(x.shape[: lam.ndim]):
        raise ValueError(
            f"prox_tv1d_condat: λ of shape {tuple(lam.shape)} is neither a scalar nor a "
            f"prefix of x's shape {tuple(x.shape)} before axis {axis}")
    return lam.reshape(-1), lines // lam.numel()


def check_tv_condat(x, axis):
    """Raise ValueError naming why the kernel does not take `x` along
    `axis`: not a CUDA tensor, complex, neither float32 nor float64, or a
    line longer than 2³¹ − 1."""
    if x.device.type != "cuda":
        raise ValueError(f"prox_tv1d_condat: the CUDA kernel takes a CUDA tensor, not {x.device}")
    if x.is_complex():
        raise ValueError("prox_tv1d_condat: the exact 1-D TV prox takes real data")
    if x.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"prox_tv1d_condat: the kernel takes float32 or float64, not {x.dtype}")
    if x.shape[axis] >= 2**31:
        raise ValueError(f"prox_tv1d_condat: a line of {x.shape[axis]} entries is too long")


def tv_condat_lines_torch(c, lam):
    """Plain version: the exact TV prox of each row of `c` (L, N) with its
    own λ (L,), by the state machine of ``rls_tpu/models/tv_condat.py:25-117``
    stepped for every line at once, one event per line per step, until
    every line is done. A segment is written where it starts (its end is
    the next one's start), and the rows are filled forward at the end: a
    segment never covers an entry the machine reads later."""
    L, N = c.shape
    if N == 1:
        return c.clone()
    dt, dev = c.dtype, c.device
    rows = torch.arange(L, device=dev)
    last = N - 1
    val = torch.zeros((L, N + 1), dtype=dt, device=dev)  # column N takes no write
    start = torch.zeros((L, N + 1), dtype=torch.bool, device=dev)
    k = torch.zeros(L, dtype=torch.int64, device=dev)
    k0, km, kp = k.clone(), k.clone(), k.clone()
    vmin, vmax = c[:, 0] - lam, c[:, 0] + lam
    umin, umax = lam.clone(), -lam
    two_l, neg_l = 2 * lam, -lam
    live = torch.ones(L, dtype=torch.bool, device=dev)

    def at(idx):
        return c[rows, torch.clamp(idx, max=last)]

    # the loop's exit reads the card once every `check` steps: a finished
    # line takes no more events, so extra steps change nothing
    check = 1
    while True:
        for _ in range(check):
            bnd = k == last
            cnext = at(k + 1)
            umin_n = (umin + cnext) - vmin
            umax_n = (umax + cnext) - vmax
            # the six events: boundary (neg, pos, done) and main (neg, pos, advance)
            b_neg = bnd & (umin < 0)
            b_pos = bnd & ~b_neg & (umax > 0)
            fin = bnd & ~b_neg & ~b_pos & live
            m_neg = ~bnd & (umin_n < neg_l)
            m_pos = ~bnd & ~m_neg & (umax_n > lam)
            adv = ~bnd & ~m_neg & ~m_pos & live
            neg = (b_neg | m_neg) & live
            pos = (b_pos | m_pos) & live
            b_neg, b_pos, m_neg, m_pos = b_neg & live, b_pos & live, m_neg & live, m_pos & live
            # the segment that closes: [k0, km] at vmin, [k0, kp] at vmax, or
            # [k0, N - 1] at vmin + umin / (k - k0 + 1)
            v_fin = vmin + umin / (k - k0 + 1).to(dt)
            wrote = neg | pos | fin
            col = torch.where(wrote, k0, N)
            val[rows, col] = torch.where(neg, vmin, torch.where(pos, vmax, v_fin))
            start[rows, col] = True
            # the new state
            kn_neg = torch.clamp(km + 1, max=last)
            kn_pos = torch.clamp(kp + 1, max=last)
            c_neg, c_pos = at(kn_neg), at(kn_pos)
            kn_adv = k + 1
            do_min = umin_n >= lam
            do_max = umax_n <= neg_l
            km_adv = torch.where(do_min, kn_adv, km)
            kp_adv = torch.where(do_max, kn_adv, kp)
            vmin_adv = torch.where(do_min, vmin + (umin_n - lam) / (km_adv - k0 + 1).to(dt), vmin)
            vmax_adv = torch.where(do_max, vmax + (umax_n + lam) / (kp_adv - k0 + 1).to(dt), vmax)
            umin_adv = torch.where(do_min, lam, umin_n)
            umax_adv = torch.where(do_max, neg_l, umax_n)

            kn = torch.where(neg, kn_neg, kn_pos)
            k_new = torch.where(neg | pos, kn, torch.where(adv, kn_adv, k))
            km_new = torch.where(neg | m_pos, kn, torch.where(adv, km_adv, km))
            kp_new = torch.where(pos | m_neg, kn, torch.where(adv, kp_adv, kp))
            vmin_new = torch.where(
                neg, c_neg, torch.where(m_pos, c_pos - two_l, torch.where(
                    adv, vmin_adv, torch.where(fin, v_fin, vmin))))
            vmax_new = torch.where(
                pos, c_pos, torch.where(m_neg, c_neg + two_l, torch.where(adv, vmax_adv, vmax)))
            umin_new = torch.where(
                m_neg | m_pos | b_neg, lam, torch.where(
                    b_pos, (c_pos + neg_l) - vmin, torch.where(adv, umin_adv, umin)))
            umax_new = torch.where(
                m_neg | m_pos | b_pos, neg_l, torch.where(
                    b_neg, (c_neg + lam) - vmax, torch.where(adv, umax_adv, umax)))
            k0 = torch.where(neg | pos, kn, k0)
            k, km, kp = k_new, km_new, kp_new
            vmin, vmax, umin, umax = vmin_new, vmax_new, umin_new, umax_new
            live = live & ~fin
        if not bool(live.any()):
            break
        check = min(2 * check, 256)
    idx = torch.where(start[:, :N], torch.arange(N, device=dev), 0).cummax(dim=1).values
    return val.gather(1, idx)


def _as_lines(x, axis):
    """(outer, N, inner) of x along `axis`."""
    N = x.shape[axis]
    inner = math.prod(x.shape[axis + 1:])
    return x.numel() // (N * inner) if N * inner else 0, N, inner


def prox_tv1d_condat_torch(x, lam, axis: int):
    """Plain version of :func:`prox_tv1d_condat`."""
    axis = axis % x.ndim
    lam_g, group = _lam_groups(lam, x, axis)
    moved = x.movedim(axis, -1)
    lines = moved.reshape(-1, x.shape[axis])
    # the lines of moved are ordered (outer, inner), as the kernel's
    lam_l = lam_g.repeat_interleave(group) if lam_g.numel() > 1 else lam_g.expand(lines.shape[0])
    out = tv_condat_lines_torch(lines, lam_l.contiguous())
    return out.reshape(moved.shape).movedim(-1, axis)


def prox_tv1d_condat(x, lam, axis: int):
    """Exact TV prox of every line of the real tensor `x` along `axis`,
    argmin_u ½‖u − c‖² + λ TV(u) for each line c. λ is a scalar or carries a
    prefix of x's axes before `axis` (one λ per problem). On a CUDA tensor
    one launch of ``csrc/tv_condat.cu`` (float32 or float64); on a CPU
    tensor the plain version. ``prox_tv1d_condat.launches`` counts the
    kernel's launches."""
    axis = axis % x.ndim
    if x.device.type == "cpu":
        return prox_tv1d_condat_torch(x, lam, axis)
    check_tv_condat(x, axis)
    from .. import _build

    xc = x.contiguous()
    lam_g, group = _lam_groups(lam, xc, axis)
    lam_g = lam_g.contiguous()
    outer, N, inner = _as_lines(xc, axis)
    out = torch.empty_like(xc)
    if xc.numel() == 0:
        return out
    lib = _build.load_library()
    with torch.cuda.device(xc.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.tv_condat_launch(xc.data_ptr(), lam_g.data_ptr(), out.data_ptr(), outer, N,
                                    inner, group, int(xc.dtype == torch.float64), stream)
    _build.check(code, f"prox_tv1d_condat ({tuple(x.shape)} along axis {axis})")
    prox_tv1d_condat.launches += 1
    return out


prox_tv1d_condat.launches = 0
