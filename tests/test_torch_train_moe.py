"""Port parity: MoE training (deepseek-moe and mixtral reduced) against
``jax.value_and_grad`` of the reference on the CPU
(``tests/train_parity.py``).

Bars (``tests/test_torch_train_model.py``'s): the loss within 2e-2,
every parameter with a gradient, each leaf's relative L2 error within
2e-2. Top-k routing is discontinuous, so the expert choices of both
runs are recorded and compared: 0 flips at this seed. ``-rP`` prints
the errors.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as JMoE

from repro_torch.models import moe as MoE
from train_parity import GRAD_REL, compare, pair

ARCHS = ("deepseek-moe-16b", "mixtral-8x22b")


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_grads_and_routing_match_jax(arch):
    errs, summary, _, _ = compare(arch, routes=True)
    print(summary)
    assert max(errs.values()) <= GRAD_REL, errs


def test_moe_mlp_grads_with_dropped_pairs():
    """One MoE layer of reduced deepseek at T 1024 with inputs leaning
    towards experts 0 and 1 (``tests/test_torch_models_moe.py``), so
    that capacity drops pairs: the gradients of a weighted sum of its
    output and aux loss with respect to the input and every weight,
    against ``jax.grad`` of the reference's ``moe_mlp``."""
    jcfg, jp, cfg, tree = pair("deepseek-moe-16b")
    jb = jax.tree_util.tree_map(lambda a: a[0], jp["layers"]["block0"]["ffn"])
    rng = np.random.default_rng(1)
    lean = np.asarray(jb["router"]["w"])[:, :2].sum(1)
    x = rng.normal(size=(4, 256, cfg.d_model)) + 2 * lean / np.linalg.norm(
        lean) * np.sqrt(cfg.d_model) * 0.3
    x = np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    w = rng.normal(size=x.shape).astype(np.float32)

    def jloss(p, xb):
        y, aux = JMoE.moe_mlp(p, jcfg, xb.astype(jnp.bfloat16))
        return jnp.sum(y.astype(jnp.float32) * w) + aux

    jg, jx = jax.jit(jax.grad(jloss, argnums=(0, 1))).lower(
        jb, x).compile(compiler_options={"xla_allow_excess_precision":
                                         False})(jb, x)
    layer = MoE.init_moe(cfg, device=torch.device("cpu"))
    with torch.no_grad():
        for name, p in layer.named_parameters():
            node = jb
            for k in name.split("."):
                node = node[k]
            node = node["w"] if isinstance(node, dict) else node
            p.copy_(torch.from_numpy(np.array(node, np.float32)))
    layer.requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    y, aux = MoE.moe_mlp(layer, cfg, xt.to(torch.bfloat16))
    (torch.sum(y.float() * torch.from_numpy(w)) + aux).backward()
    _, keep = MoE.dispatch(cfg, MoE.route(layer, cfg, xt.reshape(
        -1, cfg.d_model).to(torch.bfloat16))[2], MoE.capacity(cfg, 1024))[3:5]
    assert int((~keep).sum()) > 0
    errs = {"x": float(np.linalg.norm(xt.grad.numpy() - np.asarray(jx))
                       / np.linalg.norm(np.asarray(jx)))}
    for name, p in layer.named_parameters():
        node = jg
        for k in name.split("."):
            node = node[k]
        want = np.asarray(node["w"] if isinstance(node, dict) else node)
        errs[name] = float(np.linalg.norm(p.grad.numpy() - want)
                           / np.linalg.norm(want))
    print(f"moe_mlp with {int((~keep).sum())} dropped pairs: gradient "
          f"errors {errs}")
    assert max(errs.values()) <= GRAD_REL, errs


def test_router_softmax_gradient_is_jaxs_rule():
    """The router's softmax: forward bits of ``exp_xla_f32`` / sums, and
    the gradient of ``jax.nn.softmax`` (its custom JVP) within float32
    rounding."""
    rng = np.random.default_rng(3)
    logits = rng.normal(size=(64, 8)).astype(np.float32) * 3
    g = rng.normal(size=(64, 8)).astype(np.float32)
    want_y, vjp = jax.vjp(lambda z: jax.nn.softmax(z, axis=-1), logits)
    (want_g,) = vjp(g)
    lt = torch.from_numpy(logits).requires_grad_(True)
    y = MoE._Softmax.apply(lt)
    y.backward(torch.from_numpy(g))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want_y),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(lt.grad.numpy(), np.asarray(want_g),
                               rtol=0, atol=1e-6)
    # the max carries no gradient: a uniform shift gets none
    assert abs(float(lt.grad.sum(-1).abs().max())) <= 1e-6
