"""The gradients of ``repro_torch._xla_math``'s XLA:CPU-exact functions
(``exp_xla_f32``, ``sum_f32``, ``sum_rows_f32``, ``cumsum_f32``) against
``jax.grad`` of ``jnp.exp``, ``jnp.sum`` and ``jnp.cumsum`` on the CPU.

``exp``'s gradient is the upstream gradient times the output: equal to
the reference's bit for bit, at the clamp (±88.8 and past it) and at
``-inf`` as inside. The sums' gradients are the upstream gradient
broadcast (exact); the cumulative sum's the reverse cumulative sum of
the upstream gradient, within float32 rounding of the reference's. The
forward gives the same bits with and without a gradient, and a call
without one builds no graph.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch._xla_math import cumsum_f32, exp_xla_f32, sum_f32, \
    sum_rows_f32

EDGES = np.array([-np.inf, -100.0, -89.0, -88.8, -88.7, -87.0, -20.0, -1e-3,
                  0.0, 1e-3, 20.0, 87.0, 88.7, 88.8, 89.0, 90.0, 100.0],
                 np.float32)


def _grad(fn, x, w):
    """``d sum(w * fn(x)) / dx`` by autograd and the value."""
    xt = torch.from_numpy(x.copy()).requires_grad_(True)
    y = fn(xt)
    (y * torch.from_numpy(w)).sum().backward()
    return xt.grad.numpy(), y.detach().numpy()


def test_exp_gradient_at_the_edges():
    w = np.random.default_rng(0).normal(size=EDGES.shape).astype(np.float32)
    want = np.asarray(jax.jit(jax.grad(
        lambda z: jnp.sum(w * jnp.exp(z))))(EDGES))
    got, y = _grad(exp_xla_f32, EDGES, w)
    np.testing.assert_array_equal(y, np.asarray(jnp.exp(EDGES)))
    np.testing.assert_array_equal(got, want)
    assert got[0] == 0 and got[1] == 0          # -inf, and flushed to 0


def test_exp_gradient_on_a_range():
    x = np.linspace(-30, 30, 4001, dtype=np.float32)
    w = np.random.default_rng(1).normal(size=x.shape).astype(np.float32)
    want = np.asarray(jax.jit(jax.grad(
        lambda z: jnp.sum(w * jnp.exp(z))))(x))
    got, _ = _grad(exp_xla_f32, x, w)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", [15, 16, 17, 31, 32, 33, 100])
def test_sum_gradients(n):
    rng = np.random.default_rng(n)
    x = rng.normal(size=(3, n)).astype(np.float32)
    w = rng.normal(size=3).astype(np.float32)
    want = np.asarray(jax.grad(
        lambda z: jnp.sum(w * jnp.sum(z, axis=-1)))(x))
    got, y = _grad(sum_rows_f32, x, w)
    np.testing.assert_array_equal(y, np.asarray(jnp.sum(x, axis=-1)))
    np.testing.assert_array_equal(got, want)
    xt = torch.from_numpy(x[0].copy()).requires_grad_(True)
    (sum_f32(xt) * 3.0).backward()
    np.testing.assert_array_equal(xt.grad.numpy(), np.full(n, 3.0,
                                                           np.float32))


@pytest.mark.parametrize("n", [15, 16, 17, 31, 32, 33, 300])
@pytest.mark.parametrize("axis", [0, -1])
def test_cumsum_gradients(n, axis):
    rng = np.random.default_rng(n)
    shape = (n, 3) if axis == 0 else (3, n)
    x = rng.normal(size=shape).astype(np.float32)
    w = rng.normal(size=shape).astype(np.float32)
    want = np.asarray(jax.jit(jax.grad(
        lambda z: jnp.sum(w * jnp.cumsum(z, axis=axis))))(x))
    got, y = _grad(lambda t: cumsum_f32(t, axis), x, w)
    np.testing.assert_array_equal(y, np.asarray(jax.jit(
        lambda z: jnp.cumsum(z, axis=axis))(x)))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=4e-7 * np.abs(w).sum(axis=axis).max())


@pytest.mark.parametrize("fn", [exp_xla_f32, sum_f32, sum_rows_f32,
                                cumsum_f32])
def test_same_bits_and_no_graph_without_grad(fn):
    x = torch.from_numpy(np.random.default_rng(2).normal(
        size=(4, 40)).astype(np.float32))
    plain = fn(x)
    assert plain.grad_fn is None
    with torch.no_grad():
        assert fn(x.clone().requires_grad_(True)).grad_fn is None
    traced = fn(x.clone().requires_grad_(True))
    assert torch.equal(plain, traced.detach())
    # one node: the Function's backward, straight to the leaf
    (nxt,) = [f for f, _ in traced.grad_fn.next_functions if f is not None]
    assert type(nxt).__name__ == "AccumulateGrad"
