"""Compressed sensing: sparse image recovery from subsampled Fourier
measurements.

The torch counterpart of examples/compressed_sensing.py. The operator is
matrix-free: `SubsampledFFTOperator` forms AᴴA as FFT → mask → IFFT on
torch.fft. FISTA with a TV prior on a uniform mask, FISTA with an
L1-wavelet prior on a variable-density mask, and a dense sensing matrix
through the fused dense PGM kernel.

    PYTHONPATH=. python examples/torch/compressed_sensing.py [--device cpu]
"""

import numpy as np
import torch

import rls_tpu_torch as rtt
from _common import example_device


def rel(x, ref):
    return float(torch.linalg.norm(x - ref) / torch.linalg.norm(ref))


def main(dev):
    rng = np.random.default_rng(0)
    N = 64

    # piecewise-constant phantom
    img = np.zeros((N, N), np.float32)
    img[16:48, 16:48] = 1.0
    img[24:40, 24:40] = 2.0
    x_true = torch.from_numpy(img.reshape(-1)).to(torch.complex64).to(dev)

    # random 40% Fourier sampling
    n2 = N * N
    idx = np.sort(rng.choice(n2, size=int(0.4 * n2), replace=False))
    idx[0] = 0
    op = rtt.SubsampledFFTOperator(sample_idx=idx, im_shape=(N, N), device=dev)
    b = op.mv(x_true)

    # zero-filled reconstruction (baseline)
    print("zero-filled rel. error:", rel(op.rmv(b), x_true))

    # FISTA with a TV prior (‖AᴴA‖ = 1 for a subsampled unitary FFT)
    solver = rtt.FISTA.create(
        op, reg=rtt.TVRegularization(1e-2, shape=(N, N), iterations_tv=20), iterations=50,
        rho=0.95,
    )
    print("FISTA-TV rel. error:", rel(rtt.solve(solver, b), x_true))

    # FISTA with an L1-wavelet prior: wavelet atoms are coherent with
    # uniform random Fourier masks at coarse scales, so sample with a
    # variable density, dense at low frequencies
    ky, kx = np.meshgrid(np.fft.fftfreq(N), np.fft.fftfreq(N), indexing="ij")
    rad = np.sqrt(ky**2 + kx**2).reshape(-1)
    pdf = 1.0 / (1.0 + (rad / 0.08) ** 2)
    pdf /= pdf.sum()
    idx_vd = np.sort(rng.choice(n2, size=int(0.4 * n2), replace=False, p=pdf))
    idx_vd[0] = 0
    op_vd = rtt.SubsampledFFTOperator(sample_idx=idx_vd, im_shape=(N, N), device=dev)
    b_vd = op_vd.mv(x_true)
    wop = rtt.WaveletOperator((N, N), wavelet="haar", dtype=torch.complex64, device=dev)
    solver = rtt.FISTA.create(
        op_vd, reg=rtt.TransformedRegularization(rtt.L1Regularization(3e-3), wop),
        iterations=150, rho=0.95,
    )
    err_w = rel(rtt.solve(solver, b_vd), x_true)
    print("FISTA-L1-wavelet (variable-density mask) rel. error:", err_w)
    assert err_w < 0.01

    # a dense sensing matrix rides the fused dense PGM kernel: the whole
    # batched FISTA solve in one launch on the card (its plain PyTorch
    # version on the CPU). The raw-gradient restart stalls on a LASSO; the
    # gradient-mapping test does not
    rngd = np.random.default_rng(7)
    md, nd = 128, 256
    Ad = (rngd.normal(size=(md, nd)) / np.sqrt(md)).astype(np.float32)
    xd = (rngd.normal(size=(nd,)) * (rngd.uniform(size=(nd,)) < 0.05)).astype(np.float32)
    Ld = float(np.linalg.norm(Ad, 2) ** 2)
    sd = rtt.FISTA.create(
        rtt.DenseOperator(Ad, device=dev), reg=rtt.L1Regularization(1e-4), iterations=1000,
        rho=0.95 / Ld, restart="gradient_mapping", track_residual=False,
    )
    Bd = torch.from_numpy(Ad @ xd).to(dev)[:, None]
    Xd = rtt.solve_pgm_dense_fused(sd, Bd)
    print(f"dense CS (fused dense FISTA kernel): rel_err={rel(Xd[:, 0], torch.from_numpy(xd).to(dev)):.2e}")


if __name__ == "__main__":
    main(example_device(__doc__))
