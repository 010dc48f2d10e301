"""rls_tpu_torch proximal maps against rls_tpu on the same numpy inputs:
the composed FGP TV prox, the plain version of the TV-FGP kernel against
the Pallas kernel in interpret mode, L1 and the projections."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rls_tpu as rt
import rls_tpu_torch as rtt
from rls_tpu.kernels.tv_pallas import prox_tv2d_fgp_pallas
from rls_tpu.models.prox import prox_tv_fgp as jax_prox_tv_fgp
from rls_tpu_torch.convert import convert
from rls_tpu_torch.kernels import tv_fgp
from rls_tpu_torch.models import prox as tprox

SHAPE = (12, 10)
# per-problem λ, one of them 0 (the prox is then the identity)
LAMS = np.array([0.15, 0.0, 0.02], np.float32)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("float64", 1e-12)])
def test_prox_tv_fgp_matches_jax(rng, dtype, tol):
    n = SHAPE[0] * SHAPE[1]
    X = rng.normal(size=(3, n)).astype(dtype)
    lams = LAMS.astype(dtype)
    with jax.enable_x64(dtype == "float64"):
        jg = rt.GradientOperator(im_shape=SHAPE, _dtype=getattr(jnp, dtype))
        want = np.stack([
            np.asarray(jax_prox_tv_fgp(jnp.asarray(x), lam, jg, 7))
            for x, lam in zip(X, lams)
        ])
    tg = rtt.GradientOperator(im_shape=SHAPE, dtype=getattr(torch, dtype), device="cpu")
    got = tprox.prox_tv_fgp(torch.from_numpy(X), torch.from_numpy(lams), tg, 7)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)
    np.testing.assert_array_equal(got[1].numpy(), X[1])  # λ = 0


@pytest.mark.parametrize("shape", [SHAPE, (16, 16)])
def test_tv_fgp_kernel_plain_matches_pallas(rng, shape):
    """Kernel 1's plain version (what the wrapper runs on CPU tensors)
    against the TPU kernel in interpret mode, λ per problem and λ = 0;
    atol 1e-5 is the bar of tests/test_kernels.py."""
    n = shape[0] * shape[1]
    X = rng.normal(size=(3, n)).astype(np.float32)
    want = np.asarray(
        prox_tv2d_fgp_pallas(jnp.asarray(X), jnp.asarray(LAMS), shape, 10, interpret=True)
    )
    before = tv_fgp.prox_tv2d_fgp.launches
    got = tv_fgp.prox_tv2d_fgp(torch.from_numpy(X), torch.from_numpy(LAMS), shape, 10)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    # a CPU tensor takes the plain version: no kernel launch
    assert tv_fgp.prox_tv2d_fgp.launches == before
    # scalar λ and an unbatched x
    got1 = tv_fgp.prox_tv2d_fgp(torch.from_numpy(X[0]), 0.15, shape, 10)
    np.testing.assert_allclose(got1.numpy(), want[0], rtol=0, atol=1e-5)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_tv_regularization_matches_jax(rng, backend):
    n = SHAPE[0] * SHAPE[1]
    x = rng.normal(size=(n,)).astype(np.float32)
    jreg = rt.TVRegularization(0.1, shape=SHAPE, iterations_tv=6, backend=backend)
    treg = convert(jreg, device="cpu")
    assert treg.backend == {"xla": "torch", "pallas": "cuda"}[backend]
    want = np.asarray(jreg.prox(jnp.asarray(x)))
    got = treg.prox(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(
        float(treg.value(torch.from_numpy(x))), float(jreg.value(jnp.asarray(x))), rtol=1e-5
    )
    # an integer dims is the exact 1-D Condat prox along that axis
    j1 = rt.TVRegularization(0.1, shape=SHAPE, dims=0)
    t1 = convert(j1, device="cpu")
    assert t1.dims == 0
    np.testing.assert_allclose(t1.prox(torch.from_numpy(x)).numpy(),
                               np.asarray(j1.prox(jnp.asarray(x))), rtol=0, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "complex64"])
def test_l1_and_projections_match_jax(rng, dtype):
    x = rng.normal(size=(2, 40)).astype(np.float32)
    if dtype == "complex64":
        x = (x + 1j * rng.normal(size=x.shape)).astype(np.complex64)
    lams = np.array([0.3, 0.05], np.float32)
    jreg = rt.L1Regularization(0.3)
    treg = convert(jreg, device="cpu")
    xt = torch.from_numpy(x)
    for i, lam in enumerate(lams):
        np.testing.assert_allclose(
            treg.prox(xt, torch.from_numpy(lams))[i].numpy(),
            np.asarray(jreg.prox(jnp.asarray(x[i]), lam)), rtol=0, atol=1e-6,
        )
    np.testing.assert_allclose(
        treg.value(xt)[0].item(), float(jreg.value(jnp.asarray(x[0]))), rtol=1e-5
    )
    for name in ("PositiveRegularization", "RealRegularization"):
        jp = getattr(rt, name)()
        np.testing.assert_array_equal(
            convert(jp, device="cpu").prox(xt).numpy(),
            np.stack([np.asarray(jp.prox(jnp.asarray(v))) for v in x]),
        )
