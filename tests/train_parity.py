"""Shared helpers of the training parity tests of the families beyond the
dense one (``tests/test_torch_train_{moe,ssm,hybrid,multimodal}.py``).

One weight set (the JAX package's, carried by ``params_from_jax``) and
one numpy batch made from a seed go through ``jax.value_and_grad`` of
``repro.models.model.forward_train``, compiled with XLA's excess
precision off (``tests/test_torch_train_model.py``), and through the
port's ``forward_train(...).backward()``.

With ``routes``, each MoE layer's expert choices are recorded on both
sides, in call order: the reference's by a ``jax.debug.callback`` in a
wrapped ``moe_mlp`` (the top-k of the router's softmax, the statements
of ``moe_mlp``), from the very program whose gradients are compared;
the port's from ``moe.route``. Under the checkpointed superlayers both
route every MoE layer twice (the forward and the backward's
recompute).
"""
import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import configs as jconfigs
from repro.models import model as JM
from repro.models import moe as JMoE

from repro_torch import configs
from repro_torch.models import model as M
from repro_torch.models import moe as MoE

LOSS_REL = 2e-2
GRAD_REL = 2e-2
NO_EXCESS = {"xla_allow_excess_precision": False}


@functools.lru_cache(maxsize=None)
def pair(arch):
    """(reference config, its params, the port's config, numpy tree)."""
    jcfg, cfg = jconfigs.get_reduced(arch), configs.get_reduced(arch)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(lambda a: np.array(a, np.float32), jp)
    return jcfg, jp, cfg, tree


def family_batch(cfg, b=2, s=64, seed=1) -> dict:
    """The family's training batch in ``launch.steps.batch_specs``'
    shapes, numpy from ``seed``: tokens [B, S]; the VLM's tokens [B, S -
    P] after patches [B, P, D]; the enc-dec's frames [B, S, D] and
    decoder tokens [B, S]."""
    rng = np.random.default_rng(seed)

    def toks(n):
        return rng.integers(0, cfg.vocab_size, (b, n)).astype(np.int32)
    if cfg.is_encdec:
        frames = rng.normal(size=(b, s, cfg.d_model)).astype(np.float32)
        return {"frames": frames, "dec_tokens": toks(s)}
    if cfg.frontend == "vision":
        p = cfg.frontend_tokens
        patches = rng.normal(size=(b, p, cfg.d_model)).astype(np.float32)
        return {"tokens": toks(s - p), "patches": patches}
    return {"tokens": toks(s)}


@contextlib.contextmanager
def jax_routes(store):
    """The reference's ``moe_mlp`` wrapped: each call appends its expert
    ids ``[T, k]`` to ``store`` when the compiled program runs."""
    orig = JMoE.moe_mlp

    def recorded(params, cfg, x):
        t = x.shape[0] * x.shape[1]
        logits = jnp.einsum("td,de->te", x.reshape(t, -1).astype(jnp.float32),
                            params["router"]["w"].astype(jnp.float32))
        _, idx = jax.lax.top_k(jax.nn.softmax(logits, axis=-1),
                               cfg.moe_top_k)
        jax.debug.callback(lambda i: store.append(np.asarray(i)), idx)
        return orig(params, cfg, x)
    JMoE.moe_mlp = recorded
    try:
        yield
    finally:
        JMoE.moe_mlp = orig


@contextlib.contextmanager
def port_routes(store):
    """``moe.route`` wrapped: each call appends its expert ids."""
    orig = MoE.route

    def recorded(p, cfg, xf):
        out = orig(p, cfg, xf)
        store.append(out[2].numpy())
        return out
    MoE.route = recorded
    try:
        yield
    finally:
        MoE.route = orig


def jax_value_and_grad(jcfg, jp, batch, routes=None):
    """``((loss, metrics), grads)`` of the reference, and its compiled
    function (to call again on other parameters)."""
    f = jax.jit(jax.value_and_grad(JM.forward_train, has_aux=True),
                static_argnums=1)
    with jax_routes(routes) if routes is not None else \
            contextlib.nullcontext():
        run = f.lower(jp, jcfg, batch).compile(compiler_options=NO_EXCESS)
        out = run(jp, batch)
        jax.effects_barrier()
    return out, run


def port_value_and_grad(cfg, tree, batch, routes=None):
    """``(model, loss, metrics)`` of the port on the CPU after
    ``backward()``."""
    model = M.params_from_jax(tree, cfg, device="cpu").requires_grad_(True)
    with port_routes(routes) if routes is not None else \
            contextlib.nullcontext():
        loss, metrics = M.forward_train(
            model, cfg, {k: torch.from_numpy(v) for k, v in batch.items()})
        loss.backward()
    return model, loss.detach(), metrics


def leaf_errors(got_tree, want_tree) -> dict:
    """Relative L2 error of each leaf, keyed by its path."""
    errs = jax.tree_util.tree_map(
        lambda g, w: float(np.linalg.norm(g - np.asarray(w))
                           / np.linalg.norm(np.asarray(w))),
        got_tree, want_tree)
    return {jax.tree_util.keystr(k): e
            for k, e in jax.tree_util.tree_leaves_with_path(errs)}


def expert_flips(port, ref) -> int:
    """Tokens whose expert sets differ between two runs' records."""
    assert len(port) == len(ref), (len(port), len(ref))
    return sum(int((np.sort(a, -1) != np.sort(b, -1)).any(-1).sum())
               for a, b in zip(port, ref))


def compare(arch, batch=None, routes=False):
    """Port vs reference on ``arch``'s reduced config: the loss within
    ``LOSS_REL``, every parameter with a gradient, the token counts
    equal; with ``routes``, the expert choices of both (0 flips
    asserted). Returns (per-leaf gradient errors, a printable summary,
    the reference's compiled function, its gradients)."""
    jcfg, jp, cfg, tree = pair(arch)
    batch = family_batch(cfg) if batch is None else batch
    jr, pr = ([], []) if routes else (None, None)
    ((jloss, jmet), jgrads), run = jax_value_and_grad(jcfg, jp, batch, jr)
    model, loss, metrics = port_value_and_grad(cfg, tree, batch, pr)
    missing = [n for n, p in model.named_parameters() if p.grad is None]
    assert not missing, missing
    loss_err = abs(float(loss) - float(jloss)) / abs(float(jloss))
    assert loss_err <= LOSS_REL, (float(loss), float(jloss))
    assert float(metrics["tokens"]) == float(jmet["tokens"])
    note = ""
    if routes:
        flips = expert_flips(pr, jr)
        note = (f", {len(pr)} routings ({sum(len(r) for r in pr)} tokens), "
                f"{flips} flips")
        assert pr and flips == 0, note
    grads = M.params_to_numpy(
        model, {n: p.grad for n, p in model.named_parameters()})
    errs = leaf_errors(grads, jgrads)
    worst = max(errs, key=errs.get)
    summary = (f"{arch}: loss {float(loss):.6f} vs {float(jloss):.6f} (rel "
               f"{loss_err:.2e}){note}; largest gradient error "
               f"{errs[worst]:.2e} at {worst}")
    return errs, summary, run, jgrads
