"""Port parity: SSM training (mamba2 reduced) against
``jax.value_and_grad`` of the reference on the CPU
(``tests/train_parity.py``), and the SSD pieces' gradients.

Bars: the loss within 2e-2, every parameter with a gradient (``A_log``,
``D``, ``dt_bias``, ``conv_b`` and ``norm_scale`` included), each leaf's
relative L2 error within 2e-2. ``-rP`` prints the errors.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as JS

from repro_torch.models import ssm as S
from train_parity import GRAD_REL, compare, family_batch, pair


@pytest.mark.parametrize("seq", [64, 40])
def test_loss_and_grads_match_jax(seq):
    """S 64 (two chunks of 32) and S 40 (the last chunk padded with
    ``dt = 0`` positions)."""
    _, _, cfg, _ = pair("mamba2-370m")
    errs, summary, _, _ = compare("mamba2-370m",
                                  batch=family_batch(cfg, s=seq))
    print(f"S {seq}: {summary}")
    assert max(errs.values()) <= GRAD_REL, errs


def test_segsum_decay_gradient():
    """``exp(segsum(x))`` weighted and summed, as the chunk step uses it:
    the ``-inf`` entries above the diagonal give a zero gradient (no
    NaN), and the gradient equals ``jax.grad`` of the reference's
    ``_segsum`` within float32 rounding."""
    rng = np.random.default_rng(4)
    x = -np.abs(rng.normal(size=(2, 3, 20))).astype(np.float32) * 0.3
    w = rng.normal(size=(2, 3, 20, 20)).astype(np.float32)

    def f(z):
        return jnp.sum(jnp.exp(JS._segsum(z)) * w)
    want = np.asarray(jax.grad(f)(x))
    xt = torch.from_numpy(x.copy()).requires_grad_(True)
    from repro_torch._xla_math import exp_xla_f32
    L = exp_xla_f32(S._segsum(xt))
    assert not L.detach().triu(1).any()
    (L * torch.from_numpy(w)).sum().backward()
    assert torch.isfinite(xt.grad).all()
    np.testing.assert_allclose(xt.grad.numpy(), want, rtol=0,
                               atol=2e-5 * np.abs(want).max())


def test_ssm_train_layer_grads_match_jax():
    """One SSM mixer (``ssm_train``) on a bf16 input of S 40: the
    gradients of a weighted sum of its output with respect to the input
    and each of its leaves, against ``jax.grad``."""
    jcfg, jp, cfg, tree = pair("mamba2-370m")
    jm = jax.tree_util.tree_map(lambda a: a[0],
                                jp["layers"]["block0"]["mixer"])
    rng = np.random.default_rng(5)
    x = np.array(jnp.asarray(rng.normal(size=(2, 40, cfg.d_model)),
                             jnp.bfloat16).astype(jnp.float32))
    w = rng.normal(size=x.shape).astype(np.float32)

    def jloss(p, xb):
        y = JS.ssm_train(p, jcfg, xb.astype(jnp.bfloat16))
        return jnp.sum(y.astype(jnp.float32) * w)
    jg, jx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jm, x)
    layer = S.init_ssm(cfg, device=torch.device("cpu"))
    with torch.no_grad():
        for name, p in layer.named_parameters():
            node = jm[name]
            node = node["w"] if isinstance(node, dict) else node
            p.copy_(torch.from_numpy(np.array(node, np.float32)))
    layer.requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    y = S.ssm_train(layer, cfg, xt.to(torch.bfloat16))
    torch.sum(y.float() * torch.from_numpy(w)).backward()
    errs = {"x": float(np.linalg.norm(xt.grad.numpy() - np.asarray(jx))
                       / np.linalg.norm(np.asarray(jx)))}
    for name, p in layer.named_parameters():
        want = jg[name]
        want = np.asarray(want["w"] if isinstance(want, dict) else want)
        errs[name] = float(np.linalg.norm(p.grad.numpy() - want)
                           / np.linalg.norm(want))
    print(f"ssm_train S 40: gradient errors {errs}")
    assert max(errs.values()) <= GRAD_REL, errs
