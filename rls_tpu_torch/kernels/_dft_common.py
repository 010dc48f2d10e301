"""Plain PyTorch versions of the 2-D DFT and SENSE pieces the three FFT
kernels share (``csrc/dft_common.cuh``, ``csrc/fft_mixed.cuh``).

Counterparts of ``make_split_dft`` / ``make_split_dft3`` /
``make_sense_normal`` (``rls_tpu/kernels/_fgp_common.py:128-300``). The
TPU kernels evaluate the unitary DFT as dense matrix sandwiches with bf16
hi/lo compensation, because that runtime had neither FFT nor complex
dtypes and its matrix unit rounds its inputs to bf16. The H100 kernels
compute it as a mixed-radix FFT of their own, and these functions repeat
that FFT stage by stage, on (re, im) pairs of real tensors and with the
same separately rounded operations, so that a kernel and its plain version
can agree bit for bit:

  * an n-point axis is factored n = p₁·…·p_k·2ᵃ, the odd primes first, in
    ascending order (``odd_primes``);
  * the forward transform is decimation in frequency (natural order in,
    digit-reversed out, ``digit_reverse``): an odd stage of radix p on
    blocks of n' points takes, for each k < n'/p, the p-point DFT of the
    points k + j·n'/p directly (output s is x₀ + Σ_{j≥1} x_j·ω_p^{js}, summed
    in j order), times ω_{n'}^{ks} for s ≥ 1; after the odd stages each line
    is r = n/2ᵃ runs of 2ᵃ points, which the radix-2 stages take, one per
    halving of the butterfly span;
  * the inverse is decimation in time on the conjugate twiddles
    (digit-reversed in, natural out), unnormalized: the radix-2 stages,
    then the odd stages in reverse order, each one multiplying its points
    by the conjugate twiddles first and then taking the conjugate p-point
    DFT;
  * a normal op ``Fᴴ M F`` runs the rows, then the columns forward,
    multiplies by the mask in digit-reversed order (``spectral_weights``,
    which also carries the unitary scale 1/(H·W)), and runs the columns,
    then the rows back. No permutation is ever applied;
  * the twiddles ``exp(−2πik/n)`` are computed in float64 on the host and
    rounded once (``twiddles``): k < n/2 at a power of two, k ≤ n/2
    otherwise, an entry k > n/2 read as the conjugate of entry n − k (an
    exact negation). The p-point constants ω_p^e are the table's entries
    e·n/p. Kernel and plain version read the same table.

At a power of two there is no odd stage and every function here computes
what the radix-2 FFT computed before the odd stages existed, bit for bit.

A complex product is ``(ar·br − ai·bi, ar·bi + ai·br)`` with every product
and sum rounded on its own (the kernels use ``__fmul_rn`` & co., so that
nvcc does not contract them into FMAs). Sizes are every n from ``MIN_FFT``
to ``MAX_FFT`` per axis, whatever their prime factors
(``check_fft_shape``); the kernels stage up to 4096 points of a plane
through shared memory at a time.

The checks and the seeding the three kernels' wrappers share live here
too (``check_fft_normal``, ``check_fista_schedule``,
``check_dft_cuda_input``, ``seed_and_lam``, ``twiddle_tensor``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.regularization import normalization_factor
from ..models.solvers.base import effective_lam
from ..ops.base import NormalOperator
from ._tables import shared_table

__all__ = [
    "MIN_FFT",
    "MAX_FFT",
    "check_fft_shape",
    "twiddle_count",
    "twiddle_floats",
    "twiddles",
    "odd_primes",
    "digit_reverse",
    "fft_dif",
    "ifft_dit",
    "dft_tables",
    "masked_normal",
    "real_normal",
    "sense_normal",
    "dsum_sq",
    "dsum_dot",
    "twiddle_tensor",
    "check_dft_cuda_input",
    "check_fft_normal",
    "check_fista_schedule",
    "seed_and_lam",
]

MIN_FFT = 2
MAX_FFT = 1024


def _is_pow2(n: int) -> bool:
    return n >= 1 and n & (n - 1) == 0


def check_fft_shape(H: int, W: int) -> None:
    """The sizes the in-kernel FFT takes; raises ValueError otherwise."""
    for n in (H, W):
        if not MIN_FFT <= n <= MAX_FFT:
            raise ValueError(
                f"the in-kernel FFT takes H and W from {MIN_FFT} to {MAX_FFT}, got {H}x{W}; "
                "use the composed solve path"
            )


def twiddle_count(n: int) -> int:
    """Entries of ``twiddles(n)`` per plane: n/2 at a power of two (the
    radix-2 stages read k < n/2), ⌊n/2⌋ + 1 otherwise (the odd stages read
    every k < n, those past n/2 as conjugates)."""
    return n // 2 if _is_pow2(n) else n // 2 + 1


def twiddle_floats(H: int, W: int) -> int:
    """Floats of the kernels' twiddle argument (``twiddle_tensor``): H + W
    at powers of two (``twiddle_floats`` in csrc/fft_mixed.cuh)."""
    return 2 * (twiddle_count(H) + twiddle_count(W))


def split_part(n, parts, j):
    """[start, end) of part j when a side of n points is split over `parts`
    parts as evenly as possible: n // parts points, one more for the first
    n % parts (csrc/split.cuh Split; the bands and blocks of rows 8, 9 and
    10's cluster routes)."""
    q, extra = divmod(n, parts)
    start = j * q + min(j, extra)
    return start, start + q + (j < extra)


def twiddles(n: int, dtype=np.float32) -> np.ndarray:
    """(2, twiddle_count(n)): [cos(2πk/n), −sin(2πk/n)], computed in float64
    and rounded once to `dtype`."""
    k = np.arange(twiddle_count(n), dtype=np.float64)
    w = np.exp(-2j * np.pi * k / n)
    return np.stack([w.real, w.imag]).astype(dtype)


def odd_primes(n: int) -> list[int]:
    """The odd prime factors of n, ascending, each as often as it divides
    n: the radices of the odd stages, in the forward transform's order."""
    r = n // (n & -n)
    out, d = [], 3
    while r > 1:
        if d * d > r:
            d = r
        if r % d == 0:
            out.append(d)
            r //= d
        else:
            d += 2
    return out


def digit_reverse(n: int) -> np.ndarray:
    """The frequency at each position of ``fft_dif``'s output: the
    mixed-radix digit reversal of range(n) over the radices p₁, …, p_k, 2,
    …, 2 (the bit reversal at a power of two). Position s₁·n/p₁ + u holds
    frequency s₁ + p₁·f(u), f the same map on n/p₁ points."""
    radices = odd_primes(n) + [2] * ((n & -n).bit_length() - 1)
    pos = np.arange(n)
    out = np.zeros(n, np.int64)
    scale, span = 1, n
    for p in radices:
        span //= p
        out += pos // span * scale
        pos = pos % span
        scale *= p
    return out


def _full_twiddles(tw, n):
    """(2, n): exp(−2πit/n) for every t < n from the stored table of a
    non-power-of-two n, an entry t > n/2 the conjugate of entry n − t."""
    t = torch.arange(n, device=tw.device)
    half = t <= n // 2
    src = torch.where(half, t, n - t)
    return torch.stack([tw[0, src], torch.where(half, tw[1, src], -tw[1, src])])


def _odd_stage(re, im, full, nb, p, inverse):
    """One odd stage of radix p on blocks of nb points along the last axis
    (span m = nb/p), as ``csrc/fft_mixed.cuh`` odd_stage computes it; `full`
    from :func:`_full_twiddles`."""
    n = re.shape[-1]
    m = nb // p
    view = (*re.shape[:-1], n // nb, p, m)
    xr, xi = re.reshape(view), im.reshape(view)
    j = torch.arange(p, device=re.device)
    e = (j[:, None] * j[None, :]) % p * (n // p)  # ω_p^{js} = ω_n^{(js mod p)·n/p}
    cr, ci = full[0, e], full[1, e]
    w = j[1:, None] * torch.arange(m, device=re.device)[None, :] * (n // nb)  # ω_nb^{ks}
    wr, wi = full[0, w], full[1, w]
    if inverse:
        ci, wi = -ci, -wi
        zr = xr[..., 1:, :] * wr - xi[..., 1:, :] * wi
        zi = xr[..., 1:, :] * wi + xi[..., 1:, :] * wr
        xr = torch.cat([xr[..., :1, :], zr], dim=-2)
        xi = torch.cat([xi[..., :1, :], zi], dim=-2)
    ar, ai = xr[..., :1, :].expand(view), xi[..., :1, :].expand(view)
    for q in range(1, p):  # the outputs along the p axis, the sum in q order
        br, bi = xr[..., q : q + 1, :], xi[..., q : q + 1, :]
        c_r, c_i = cr[q][:, None], ci[q][:, None]
        ar = ar + (br * c_r - bi * c_i)
        ai = ai + (br * c_i + bi * c_r)
    if not inverse:
        yr = ar[..., 1:, :] * wr - ai[..., 1:, :] * wi
        yi = ar[..., 1:, :] * wi + ai[..., 1:, :] * wr
        ar = torch.cat([ar[..., :1, :], yr], dim=-2)
        ai = torch.cat([ai[..., :1, :], yi], dim=-2)
    return ar.reshape(re.shape), ai.reshape(im.shape)


def _stage_view(v, m):
    """(..., n) → (..., n/(2m), 2, m): the blocks of a stage of span m."""
    n = v.shape[-1]
    return v.reshape(*v.shape[:-1], n // (2 * m), 2, m)


def _radix2_twiddles(tw, n, m):
    """ω_{2m}^k = ω_n^{k·n/(2m)}, k < m: a radix-2 stage's twiddles."""
    step = n // (2 * m)
    return tw[0, : n // 2 : step], tw[1, : n // 2 : step]


def fft_dif(re, im, tw):
    """Unnormalized forward DFT along the last axis by mixed-radix
    decimation in frequency: natural order in, digit-reversed order out
    (``digit_reverse``). `tw` is the table of ``twiddles(n)`` in re's dtype
    and device."""
    n = re.shape[-1]
    if not _is_pow2(n):
        full, nb = _full_twiddles(tw, n), n
        for p in odd_primes(n):
            re, im = _odd_stage(re, im, full, nb, p, inverse=False)
            nb //= p
    m = (n & -n) // 2
    while m >= 1:
        wr, wi = _radix2_twiddles(tw, n, m)
        a_r, b_r = _stage_view(re, m).unbind(-2)
        a_i, b_i = _stage_view(im, m).unbind(-2)
        d_r = a_r - b_r
        d_i = a_i - b_i
        re = torch.stack([a_r + b_r, d_r * wr - d_i * wi], dim=-2).reshape(re.shape)
        im = torch.stack([a_i + b_i, d_r * wi + d_i * wr], dim=-2).reshape(im.shape)
        m //= 2
    return re, im


def ifft_dit(re, im, tw):
    """Unnormalized inverse DFT along the last axis by mixed-radix
    decimation in time on the conjugate twiddles: digit-reversed order in,
    natural order out."""
    n = re.shape[-1]
    m, pow2 = 1, n & -n
    while m < pow2:
        wr, wi = _radix2_twiddles(tw, n, m)
        wi = -wi
        a_r, b_r = _stage_view(re, m).unbind(-2)
        a_i, b_i = _stage_view(im, m).unbind(-2)
        t_r = b_r * wr - b_i * wi
        t_i = b_r * wi + b_i * wr
        re = torch.stack([a_r + t_r, a_r - t_r], dim=-2).reshape(re.shape)
        im = torch.stack([a_i + t_i, a_i - t_i], dim=-2).reshape(im.shape)
        m *= 2
    if not _is_pow2(n):
        full, nb = _full_twiddles(tw, n), pow2
        for p in reversed(odd_primes(n)):
            nb *= p
            re, im = _odd_stage(re, im, full, nb, p, inverse=True)
    return re, im


def _on_cols(fn, re, im, tw):
    re, im = fn(re.transpose(-1, -2), im.transpose(-1, -2), tw)
    return re.transpose(-1, -2), im.transpose(-1, -2)


def dft_tables(mask, dtype=torch.float32):
    """(tw_h, tw_w, weights) of a normal op on `mask`'s device: the two
    twiddle tables and the spectral weights, the (H, W) mask in the
    digit-reversed order the forward passes leave the spectrum in, times
    the unitary scale 1/(H·W) (one rounding; exact at a power of two)."""
    H, W = mask.shape
    check_fft_shape(H, W)
    dev = mask.device
    np_dt = torch.empty((), dtype=dtype).numpy().dtype
    # the shape's tables are shared (read only); the weights are the mask's
    tw_h = shared_table(twiddles, H, np_dt, device=dev)
    tw_w = shared_table(twiddles, W, np_dt, device=dev)
    rh = shared_table(digit_reverse, H, device=dev)
    rw = shared_table(digit_reverse, W, device=dev)
    weights = mask.to(dtype)[rh][:, rw] * (1.0 / (H * W))
    return tw_h, tw_w, weights


def masked_normal(re, im, tables):
    """``Fᴴ M F`` of the complex planes (re, im), (..., H, W), as the
    kernels compute it: rows then columns forward, the spectral weights,
    columns then rows back."""
    tw_h, tw_w, weights = tables
    re, im = fft_dif(re, im, tw_w)
    re, im = _on_cols(fft_dif, re, im, tw_h)
    re, im = re * weights, im * weights
    re, im = _on_cols(ifft_dit, re, im, tw_h)
    return ifft_dit(re, im, tw_w)


def real_normal(x, tables):
    """``Re(Fᴴ M F x)`` of real images x (..., H, W): the transform of a
    real image with im = 0, keeping the real part of the result."""
    return masked_normal(x, torch.zeros_like(x), tables)[0]


def sense_normal(xr, xi, coils_r, coils_i, tables):
    """The SENSE normal op ``Σ_c C̄_c Fᴴ M F C_c x`` of (xr, xi), (B, H, W)
    each, with coil maps (C, H, W): every coil's transform at once, then
    the accumulation in coil order, as ``make_sense_normal`` sums
    (``_fgp_common.py:286-298``)."""
    xr, xi = xr.unsqueeze(1), xi.unsqueeze(1)
    ur = coils_r * xr - coils_i * xi
    ui = coils_r * xi + coils_i * xr
    vr, vi = masked_normal(ur, ui, tables)
    acc_r = torch.zeros_like(xr[:, 0])
    acc_i = torch.zeros_like(xr[:, 0])
    for c in range(coils_r.shape[0]):
        acc_r = acc_r + coils_r[c] * vr[:, c] + coils_i[c] * vi[:, c]
        acc_i = acc_i + coils_r[c] * vi[:, c] - coils_i[c] * vr[:, c]
    return acc_r, acc_i


def dsum_sq(*planes):
    """Per problem (leading axis), Σ v² over every plane in float64,
    rounded once to the planes' dtype: the kernels' block sums."""
    total = sum((p.double() * p.double()).flatten(1).sum(dim=1) for p in planes)
    return total.to(planes[0].dtype)


def dsum_dot(pairs):
    """Per problem, Σ a·b over the (a, b) pairs in float64, rounded once."""
    total = sum((a.double() * b.double()).flatten(1).sum(dim=1) for a, b in pairs)
    return total.to(pairs[0][0].dtype)


def twiddle_tensor(tables):
    """The kernels' twiddle argument: [Re, Im of the H table, Re, Im of the
    W table] as one float32 tensor of ``twiddle_floats(H, W)`` entries."""
    tw_h, tw_w, _ = tables
    return torch.cat([tw_h.reshape(-1), tw_w.reshape(-1)]).contiguous()


def check_dft_cuda_input(name, x0hat_b, *operands):
    """What an FFT kernel takes: float32 tensors on one card, H and W the
    FFT's sizes; raises otherwise."""
    for t in (x0hat_b, *operands):
        if t.device.type != "cuda" or t.device != x0hat_b.device:
            raise ValueError(f"{name}: unsupported device {t.device} (x0hat on {x0hat_b.device})")
        if t.dtype != torch.float32:
            raise ValueError(f"{name}: the CUDA kernel takes float32, got {t.dtype}")
    check_fft_shape(*x0hat_b.shape[-2:])


def check_fft_normal(solver, op_cls, path="fused path"):
    """The operator rules the FFT kernels share: AHA the unweighted
    NormalOperator of an `op_cls` that is solver.A itself, in float32, at
    the FFT's sizes. Returns the operator."""
    if not isinstance(solver.AHA, NormalOperator) or solver.AHA.weights is not None:
        raise ValueError(
            f"{path} requires AHA to be the NormalOperator of a {op_cls.__name__} "
            "(construct the solver from A)"
        )
    op = solver.AHA.A
    if not isinstance(op, op_cls):
        raise ValueError(f"{path} requires {op_cls.__name__}")
    if solver.A is not op:
        raise ValueError(
            f"{path} requires solver.A to be the {op_cls.__name__} itself (AHA-only solvers "
            "are not supported)"
        )
    if op.dtype != torch.float32:
        raise ValueError(f"{path} requires a float32 operator, got {op.dtype}")
    check_fft_shape(*op.im_shape)
    return op


def check_fista_schedule(solver):
    """FISTA with no projection, no restart and the default θ = 1."""
    if solver.proj:
        raise ValueError("fused path does not support projection terms")
    if solver.restart != "none":
        raise ValueError("fused path does not support restart")
    if float(solver.theta) != 1.0:
        raise ValueError("fused path requires the default theta=1 schedule")


def seed_and_lam(solver, B_mat, *regs):
    """(x0hat = Aᴴb by the operator's own adjoint, then λ_eff of each of
    `regs` per problem) of the problems in B_mat's columns."""
    op = solver.A
    op.check_device(B_mat)
    bt = B_mat.T
    scale = normalization_factor(solver.normalize_reg, op, bt)
    return (op.rmv(bt), *(effective_lam(reg, scale, torch.float32) for reg in regs))
