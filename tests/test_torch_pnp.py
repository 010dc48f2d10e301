"""Plug-and-play of rls_tpu_torch against rls_tpu on the same numpy inputs:
the CNN denoiser with the JAX weights carried by ``convert_cnn_params``
(a batch in one call, one image, a flat vector), PlugAndPlayRegularization
(its λ clip and construction warning, the input transforms, complex data
with and without ``ignore_im``, ``value`` raising), ADMM with PnP against
the JAX solve at the settings of tests/test_regularization.py:163-200
(16², 10 iterations), ``convert`` refusing the JAX callable by name, and
``train_denoiser`` (torch.optim.Adam, 40 steps on the CPU), whose loss
must fall.

Tolerance: float32, 1e-5 of max|x| (F.conv2d and XLA's convolution sum
their 3 x 3 x C products in other orders)."""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rls_tpu as rt
import rls_tpu_torch as rtt
from rls_tpu.models import denoisers as jden
from rls_tpu.models import regularization as jreg
from rls_tpu_torch.convert import convert
from rls_tpu_torch.models import denoisers as tden
from rls_tpu_torch.models import regularization as treg

N = 16


def _close(got, want, tol=1e-5, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= tol * max(float(np.abs(want).max()), 1e-30), (what, err)


@pytest.fixture(scope="module")
def params():
    """The JAX CNN's He-initialised weights (6 channels) and their port."""
    jp = jden.init_cnn_params(jax.random.PRNGKey(0), channels=6)
    return jp, tden.convert_cnn_params(jp, device="cpu")


def _images(rng, batch=3):
    return rng.uniform(size=(batch, N, N)).astype(np.float32)


def test_cnn_denoise_with_converted_weights(rng, params):
    """A batch in one call, one (H, W) image and a flat square vector,
    against JAX's cnn_denoise with the same weights."""
    jp, tp = params
    X = _images(rng)
    want = np.stack([np.asarray(jden.cnn_denoise(jp, jnp.asarray(x))) for x in X])
    _close(tden.cnn_denoise(tp, torch.from_numpy(X)).detach().numpy(), want, what="batch")
    _close(tden.cnn_denoise(tp, torch.from_numpy(X[1])).detach().numpy(), want[1], what="one")
    flat = tden.cnn_denoise(tp, torch.from_numpy(X[2].reshape(-1))).detach().numpy()
    _close(flat, want[2].reshape(-1), what="flat")
    model = tden.make_pnp_model(tp)
    _close(model(torch.from_numpy(X.reshape(3, -1))).detach().numpy(), want.reshape(3, -1),
           what="flat batch")


@pytest.mark.parametrize("transform", ["MinMaxTransform", "IdentityTransform", "ZTransform"])
def test_pnp_prox_matches_jax(rng, params, transform):
    """prox of a batch, each problem with its own λ, one of them clipped."""
    jp, tp = params
    X = _images(rng).reshape(3, -1) * 2.0 - 0.5
    lams = np.array([0.3, 1.0, 1.7], np.float32)
    jr = rt.PnPRegularization(0.3, model=jden.make_pnp_model(jp), shape=(N, N),
                              input_transform=getattr(jreg, transform))
    tr = rtt.PnPRegularization(0.3, model=tden.make_pnp_model(tp), shape=(N, N),
                               input_transform=getattr(treg, transform))
    want = np.stack([np.asarray(jr.prox(jnp.asarray(x), lam)) for x, lam in zip(X, lams)])
    got = tr.prox(torch.from_numpy(X), torch.from_numpy(lams)).detach().numpy()
    _close(got, want, what=transform)
    # λ = 1.7 is clipped to 1 (one image alone: the convolution may sum in
    # another order than for the batch)
    _close(got[2], tr.prox(torch.from_numpy(X[2]), 1.0).detach().numpy(), what="clip")


def test_pnp_lambda_clip_warns_and_value_raises(params):
    """Construction with λ outside [0, 1] warns, as rls_tpu does; value
    raises; the alias is the same class."""
    _, tp = params
    with pytest.warns(UserWarning, match="clipped to the"):
        rtt.PlugAndPlayRegularization(1.5, model=tden.make_pnp_model(tp), shape=(N, N))
    with pytest.warns(UserWarning, match="clipped to the"):
        rtt.PnPRegularization(-0.1, model=tden.make_pnp_model(tp), shape=(N, N))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        r = rtt.PnPRegularization(0.5, model=tden.make_pnp_model(tp), shape=(N, N))
    assert rtt.PnPRegularization is rtt.PlugAndPlayRegularization
    with pytest.raises(NotImplementedError, match="no explicit functional value"):
        r.value(torch.zeros(N * N))


@pytest.mark.parametrize("ignore_im", [False, True])
def test_pnp_complex_matches_jax(rng, params, ignore_im):
    """Complex data: the real and imaginary planes denoised apart, or the
    real one alone under ignore_im."""
    jp, tp = params
    X = (_images(rng, 2) + 1j * _images(rng, 2)).reshape(2, -1).astype(np.complex64)
    jr = rt.PnPRegularization(0.4, model=jden.make_pnp_model(jp), shape=(N, N),
                              ignore_im=ignore_im)
    tr = rtt.PnPRegularization(0.4, model=tden.make_pnp_model(tp), shape=(N, N),
                               ignore_im=ignore_im)
    want = np.stack([np.asarray(jr.prox(jnp.asarray(x))) for x in X])
    got = tr.prox(torch.from_numpy(X)).detach().numpy()
    assert got.dtype == np.complex64
    _close(got, want, what="complex")
    if ignore_im:
        np.testing.assert_array_equal(got.imag, X.imag)


def test_admm_with_pnp_matches_jax(rng, params):
    """ADMM with PnP (λ = 0.3, the identity transform, flat images of
    square length) on a noisy 16² deblurring problem, 10 iterations of 6
    CG steps, ρ = 0.5 (tests/test_regularization.py:163-200 at 16²)
    against the JAX solve, two problems at once; convert refuses the JAX
    term with a pointer to convert_cnn_params."""
    jp, tp = params
    g = np.exp(-((np.arange(5) - 2) ** 2) / 2.0)
    kern = np.outer(g, g)
    kern /= kern.sum()
    jop = rt.SeparableConvOperator.from_kernel(kern, im_shape=(N, N), compensated=False)
    img = np.zeros((2, N, N), np.float32)
    img[:, 3:6, 2:12] = 0.7
    img[1, 8:14, 5:11] = 0.4
    B = np.asarray(jax.vmap(jop.mv)(jnp.asarray(img.reshape(2, -1))))
    B = (B + 0.02 * rng.normal(size=B.shape)).astype(np.float32)
    jpnp = rt.PnPRegularization(0.3, model=jden.make_pnp_model(jp), shape=(N * N,),
                                input_transform=jreg.IdentityTransform)
    js = rt.ADMM.create(jop, reg=jpnp, iterations=10, iterations_cg=6, rho=0.5)
    want = np.stack([np.asarray(jax.jit(rt.solve)(js, jnp.asarray(b))) for b in B])
    with pytest.raises(TypeError, match="convert_cnn_params"):
        convert(js, device="cpu")
    tpnp = rtt.PnPRegularization(0.3, model=tden.make_pnp_model(tp), shape=(N * N,),
                                 input_transform=treg.IdentityTransform)
    top = rtt.SeparableConvOperator.from_kernel(kern, im_shape=(N, N), device="cpu")
    ts = rtt.ADMM.create(top, reg=tpnp, iterations=10, iterations_cg=6, rho=0.5)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        got = rtt.solve_batched_fast(ts, torch.from_numpy(B.T)).T.detach().numpy()
    msg = " ".join(str(w.message) for w in caught)
    assert "admm_tv: fused path requires exactly one TVRegularization term" in msg
    _close(got, want, what="admm-pnp")


def test_train_denoiser_loss_falls():
    """40 Adam steps on 16² phantoms on the CPU: the loss falls, and the
    trained net denoises a held-out batch better than its start."""
    losses = []
    p = tden.train_denoiser(N, channels=4, steps=40, noise_sigma=0.1, batch=4, seed=1,
                            device="cpu", losses=losses)
    assert len(losses) == 40 and all(np.isfinite(losses))
    assert np.mean(losses[-5:]) < 0.5 * np.mean(losses[:5]), losses
    rng = np.random.default_rng(99)
    clean = tden._phantom_batch(rng, N, 4)
    noisy = torch.from_numpy(clean + rng.normal(0, 0.1, clean.shape).astype(np.float32))
    p0 = tden.init_cnn_params(torch.Generator().manual_seed(1), channels=4, device="cpu")

    def mse(q):
        return float(torch.mean((tden.cnn_denoise(q, noisy) - torch.from_numpy(clean)) ** 2))

    assert mse(p) < mse(p0)
    # the phantoms are rls_tpu's, draw for draw
    np.testing.assert_array_equal(tden._phantom_batch(np.random.default_rng(5), N, 3),
                                  jden._phantom_batch(np.random.default_rng(5), N, 3))
