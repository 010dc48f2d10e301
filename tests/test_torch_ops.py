"""rls_tpu_torch operators against rls_tpu on the same numpy inputs:
SeparableConvOperator (mv, rmv, normal, rmv_stencil, taps) and
GradientOperator, in float32 and float64 (JAX x64, scoped); and the
device every operator defaults to."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rls_tpu as rt
import rls_tpu_torch as rtt
from rls_tpu_torch.convert import convert
from rls_tpu_torch.ops.base import DenseOperator, IdentityOperator, NormalOperator, as_operator

SHAPE = (24, 20)  # not square: a swapped axis shows
TAPS = {
    "symmetric": (np.exp(-((np.arange(5) - 2) ** 2) / 2.0), np.exp(-((np.arange(3) - 1) ** 2) / 2.0)),
    "asymmetric": (np.array([0.1, 0.5, 0.25, -0.2, 0.05]), np.array([0.3, 0.6, 0.1])),
}
# f32: plain f32 banded products on both sides, summed in different orders;
# f64: both exact to f64 roundoff
TOL = {"float32": 1e-5, "float64": 1e-12}


def _ops(taps, dtype):
    th, tw = TAPS[taps]
    jop = rt.SeparableConvOperator.from_taps(
        th, tw, SHAPE, dtype=getattr(jnp, dtype), compensated=False
    )
    return jop, rtt.SeparableConvOperator.from_taps(
        th, tw, SHAPE, dtype=getattr(torch, dtype), device="cpu")


@pytest.mark.parametrize("taps", sorted(TAPS))
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_sepconv_matches_jax(rng, taps, dtype):
    n = SHAPE[0] * SHAPE[1]
    X = rng.normal(size=(3, n)).astype(dtype)
    with jax.enable_x64(dtype == "float64"):
        jop, top = _ops(taps, dtype)
        assert top.taps_hw() == jop.taps_hw()
        Xt = torch.from_numpy(X)
        for name in ("mv", "rmv", "normal", "rmv_stencil"):
            want = np.stack([np.asarray(getattr(jop, name)(jnp.asarray(x))) for x in X])
            got = getattr(top, name)(Xt).numpy()
            assert got.dtype == X.dtype
            np.testing.assert_allclose(got, want, rtol=0, atol=TOL[dtype], err_msg=name)
        # the converted JAX operator is the same operator
        conv = convert(jop, device="cpu")
        np.testing.assert_array_equal(conv.normal(Xt).numpy(), top.normal(Xt).numpy())
        assert conv.taps_hw() == top.taps_hw()


@pytest.mark.parametrize("taps", sorted(TAPS))
def test_sepconv_adjoint_identity(rng, taps):
    top = rtt.SeparableConvOperator.from_taps(*TAPS[taps], SHAPE, dtype=torch.float64,
                                              device="cpu")
    n = top.in_size
    x = torch.from_numpy(rng.normal(size=(n,)))
    y = torch.from_numpy(rng.normal(size=(n,)))
    lhs = torch.dot(top.mv(x), y)
    for adj in (top.rmv, top.rmv_stencil):
        np.testing.assert_allclose(float(torch.dot(x, adj(y))), float(lhs), rtol=1e-12)
    np.testing.assert_allclose(
        top.normal(x).numpy(), top.rmv(top.mv(x)).numpy(), rtol=0, atol=1e-12
    )


def test_sepconv_from_kernel_and_device_check():
    g = np.exp(-((np.arange(9) - 4) ** 2) / 8.0)
    kern = np.outer(g, g) / np.outer(g, g).sum()
    jop = rt.SeparableConvOperator.from_kernel(kern, im_shape=(16, 16))
    top = rtt.SeparableConvOperator.from_kernel(kern, im_shape=(16, 16), device="cpu")
    assert top.taps_hw() == jop.taps_hw()
    np.testing.assert_array_equal(top.ah.numpy(), np.asarray(jop.ah))
    with pytest.raises(ValueError, match="not separable"):
        rtt.SeparableConvOperator.from_kernel(np.eye(3), im_shape=(8, 8), device="cpu")
    # an operator never copies its input across devices
    with pytest.raises(ValueError, match="lives on cpu"):
        top.rmv_stencil(torch.empty(256, device="meta"))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("dims", [None, (1,), (0,)])
def test_gradient_operator_matches_jax(rng, dtype, dims):
    shape = (7, 9)
    with jax.enable_x64(dtype == "float64"):
        jg = rt.GradientOperator(im_shape=shape, dims=dims, _dtype=getattr(jnp, dtype))
        tg = rtt.GradientOperator(im_shape=shape, dims=dims, dtype=getattr(torch, dtype),
                                  device="cpu")
        assert (tg.in_size, tg.out_size) == (jg.in_size, jg.out_size)
        X = rng.normal(size=(2, jg.in_size)).astype(dtype)
        Y = rng.normal(size=(2, jg.out_size)).astype(dtype)
        for name, V in (("mv", X), ("rmv", Y)):
            want = np.stack([np.asarray(getattr(jg, name)(jnp.asarray(v))) for v in V])
            got = getattr(tg, name)(torch.from_numpy(V)).numpy()
            np.testing.assert_allclose(got, want, rtol=0, atol=TOL[dtype], err_msg=name)
        lhs = (tg.mv(torch.from_numpy(X)) * torch.from_numpy(Y)).sum()
        rhs = (torch.from_numpy(X) * tg.rmv(torch.from_numpy(Y))).sum()
        np.testing.assert_allclose(float(lhs), float(rhs), rtol=1e-5)


def test_operators_default_to_the_card():
    """Built without ``device=``, an operator lives on the card; on a
    machine without one, torch's own error comes through uncaught."""
    g = np.exp(-((np.arange(5) - 2) ** 2) / 2.0)
    builders = (
        lambda: rtt.SeparableConvOperator.from_taps(g, g, (8, 8)),
        lambda: DenseOperator(np.eye(3, dtype=np.float32)),
        lambda: as_operator(np.eye(3, dtype=np.float32)),
        lambda: NormalOperator(IdentityOperator(3), weights=np.ones(3, np.float32)),
        lambda: IdentityOperator(3).row_norms_sq(),
    )
    for build in builders:
        if torch.cuda.is_available():
            out = build()
            assert out.device.type == "cuda"
        else:
            with pytest.raises((RuntimeError, AssertionError)):
                build()
    assert rtt.GradientOperator((4, 4)).device == torch.device("cuda")
    cpu = IdentityOperator(3, torch.float32, device="cpu")
    assert cpu.device.type == "cpu" and cpu.row_norms_sq().device.type == "cpu"
