"""Port parity: the dense models' training loss and gradients, on the CPU.

``forward_train`` and its ``backward()`` against
``jax.value_and_grad(repro.models.model.forward_train)`` for the four
dense reduced configs, from the JAX weights (``params_from_jax``) and
numpy tokens. Bars: the loss within ``LOGIT_REL`` 2e-2 of the
reference's (``tests/test_torch_models.py``), each parameter's gradient
within ``‖g_port − g_jax‖₂ / ‖g_jax‖₂ ≤ 2e-2`` (the model's bf16 bar:
a second bf16 implementation rounds some products the other way), and
every parameter has a gradient. ``-rP`` prints the largest errors.

The reference is compiled with XLA's excess precision off
(``xla_allow_excess_precision=False``, as in
``tests/test_torch_models_hybrid.py``): by default XLA:CPU keeps some
bf16 intermediates in float32 inside its fusions, and reduced qwen3's
``q_norm`` gradient then moves 2.2e-2 away from the reference's own
op-by-op run (``jax.disable_jit``), which the compilation without
excess precision equals exactly.
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import model as JM

from repro_torch import configs
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.launch.steps import make_train_step
from repro_torch.models import model as M
from repro_torch.optim import OptConfig, init_opt_state

LOSS_REL = 2e-2
GRAD_REL = 2e-2
DENSE = ("qwen3-4b", "llama3-405b", "phi4-mini-3.8b", "nemotron-4-15b")
NO_EXCESS = {"xla_allow_excess_precision": False}


@functools.lru_cache(maxsize=None)
def _pair(arch):
    jcfg, cfg = jconfigs.get_reduced(arch), configs.get_reduced(arch)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(lambda a: np.array(a, np.float32), jp)
    return jcfg, jp, cfg, tree


def _tokens(cfg, b=2, s=64, seed=1):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


def _jax_value_and_grad(jcfg, jp, batch, loss_chunk=16_384):
    f = jax.jit(jax.value_and_grad(
        functools.partial(JM.forward_train, loss_chunk=loss_chunk),
        has_aux=True), static_argnums=1)
    return f.lower(jp, jcfg, batch).compile(compiler_options=NO_EXCESS)(
        jp, batch)


def _port_value_and_grad(cfg, tree, batch, loss_chunk=16_384):
    model = M.params_from_jax(tree, cfg, device="cpu").requires_grad_(True)
    loss, metrics = M.forward_train(
        model, cfg, {k: torch.from_numpy(v) for k, v in batch.items()},
        loss_chunk=loss_chunk)
    loss.backward()
    return model, loss.detach(), metrics


def _leaf_errors(got_tree, want_tree):
    errs = jax.tree_util.tree_map(
        lambda g, w: float(np.linalg.norm(g - np.asarray(w))
                           / np.linalg.norm(np.asarray(w))),
        got_tree, want_tree)
    return {jax.tree_util.keystr(k): e
            for k, e in jax.tree_util.tree_leaves_with_path(errs)}


@pytest.mark.parametrize("arch", DENSE)
def test_loss_and_grads_match_jax(arch):
    jcfg, jp, cfg, tree = _pair(arch)
    batch = {"tokens": _tokens(cfg)}
    (jloss, jmet), jgrads = _jax_value_and_grad(jcfg, jp, batch)
    model, loss, metrics = _port_value_and_grad(cfg, tree, batch)
    missing = [n for n, p in model.named_parameters() if p.grad is None]
    assert not missing, missing
    loss_err = abs(float(loss) - float(jloss)) / abs(float(jloss))
    assert loss_err <= LOSS_REL
    assert float(metrics["tokens"]) == float(jmet["tokens"])
    grads = M.params_to_numpy(
        model, {n: p.grad for n, p in model.named_parameters()})
    errs = _leaf_errors(grads, jgrads)
    worst = max(errs, key=errs.get)
    print(f"{arch}: loss {float(loss):.6f} vs {float(jloss):.6f} (rel "
          f"{loss_err:.2e}); largest gradient error {errs[worst]:.2e} at "
          f"{worst}")
    assert errs[worst] <= GRAD_REL, errs


def test_chunked_ce_with_padding():
    """Loss chunks that do not divide the tokens (the last chunk padded
    and masked), against the reference with the same chunk and the
    port's own single-chunk loss."""
    jcfg, jp, cfg, tree = _pair("qwen3-4b")
    batch = {"tokens": _tokens(cfg, b=3, s=40)}
    (jloss, _), jgrads = _jax_value_and_grad(jcfg, jp, batch, loss_chunk=48)
    model, loss, _ = _port_value_and_grad(cfg, tree, batch, loss_chunk=48)
    _, whole, _ = _port_value_and_grad(cfg, tree, batch)
    assert abs(float(loss) - float(jloss)) <= LOSS_REL * abs(float(jloss))
    assert abs(float(loss) - float(whole)) <= 1e-5 * abs(float(whole))
    grads = M.params_to_numpy(
        model, {n: p.grad for n, p in model.named_parameters()})
    assert max(_leaf_errors(grads, jgrads).values()) <= GRAD_REL


def test_loss_without_grad_has_no_graph():
    """Under ``torch.no_grad`` nothing is checkpointed and the loss is
    the same."""
    _, _, cfg, tree = _pair("qwen3-4b")
    batch = {"tokens": torch.from_numpy(_tokens(cfg))}
    model = M.params_from_jax(tree, cfg, device="cpu").requires_grad_(True)
    with torch.no_grad():
        plain, _ = M.forward_train(model, cfg, batch)
    traced, _ = M.forward_train(model, cfg, batch)
    assert plain.grad_fn is None and traced.grad_fn is not None
    assert torch.equal(plain, traced.detach())


@pytest.mark.parametrize("arch", ("qwen3-4b", "deepseek-moe-16b",
                                  "mamba2-370m", "jamba-v0.1-52b",
                                  "internvl2-26b", "seamless-m4t-large-v2"))
def test_train_step_every_family(arch):
    """``make_train_step`` takes a step of each family (dense, MoE, SSM,
    hybrid, VLM, audio enc-dec) on its pipeline batch: a finite loss,
    every parameter moved, the moments written."""
    cfg = configs.get_reduced(arch)
    model = M.init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    opt_cfg = OptConfig(warmup_steps=1, total_steps=1)
    opt = init_opt_state(dict(model.named_parameters()), opt_cfg)
    model, opt, metrics = make_train_step(cfg, opt_cfg)(
        model, opt, TokenPipeline(cfg, 2, 32).batch_at(0))
    assert np.isfinite(float(metrics["loss"]))
    assert np.isfinite(float(metrics["grad_norm"]))
    still = [n for n, p in model.named_parameters()
             if torch.equal(p.detach(), before[n])]
    assert not still, still


def test_sliding_window_grads_match_jax():
    """The dense path with a sliding window (the mask the kernel's
    backward also takes): qwen3 reduced with ``sliding_window=16``."""
    jcfg, jp, cfg, tree = _pair("qwen3-4b")
    jcfg = dataclasses.replace(jcfg, sliding_window=16)
    cfg = dataclasses.replace(cfg, sliding_window=16)
    batch = {"tokens": _tokens(cfg)}
    (jloss, _), jgrads = _jax_value_and_grad(jcfg, jp, batch)
    model, loss, _ = _port_value_and_grad(cfg, tree, batch)
    assert abs(float(loss) - float(jloss)) <= LOSS_REL * abs(float(jloss))
    grads = M.params_to_numpy(
        model, {n: p.grad for n, p in model.named_parameters()})
    errs = _leaf_errors(grads, jgrads)
    print(f"window 16: largest gradient error {max(errs.values()):.2e}")
    assert max(errs.values()) <= GRAD_REL
