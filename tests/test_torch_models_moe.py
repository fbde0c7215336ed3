"""Port parity: the MoE family (``repro_torch.models.moe`` and the
deepseek / mixtral models) vs ``repro.models``, on the CPU.

Weights are the JAX package's, carried across by ``params_from_jax``;
inputs are made with numpy from a seed and handed to both packages.

Tolerances:
  * ``moe_mlp`` on the same bf16 input: within one bf16 ulp at the
    output's scale (its largest magnitude); the aux loss within 1e-6 of
    its value;
  * the integer routing state (expert ids, each pair's dispatch slot,
    ``keep``, the ``[E, C]`` dispatch table): bit-identical wherever the
    k-th / (k+1)-th probability margin exceeds 1e-6 (a smaller margin
    is within the float32 rounding of two router products summed in
    other orders);
  * the whole model (``prefill``, ``decode_step``) on each reduced
    config: logits within 2e-2 of the logit scale, cache K and V as in
    ``tests/test_torch_models.py`` (layer 0 within one bf16 ulp, every
    layer within 2e-2 of its scale).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import model as JM
from repro.models import moe as JMoE

from repro_torch.models import model as M
from repro_torch.models import moe as MoE
from test_torch_models import (KV_TOL, _bf16, _cache_close, _f32,
                               _logits_close, _pair, _t, _within_scale_ulp)

ARCHS = ("deepseek-moe-16b", "mixtral-8x22b")
MARGIN = 1e-6


@functools.lru_cache(maxsize=None)
def _jitted(jcfg):
    return (jax.jit(JM.prefill, static_argnums=(1, 3)),
            jax.jit(JM.decode_step, static_argnums=(1,)),
            jax.jit(JMoE.moe_mlp, static_argnums=(1,)))


def _moe_block(arch, **over):
    jcfg, jp, cfg, model = _pair(arch, **over)
    jb = jax.tree_util.tree_map(lambda a: a[0], jp["layers"]["block0"])
    return jcfg, jb["ffn"], cfg, model.layers[0]["block0"].ffn


def _jax_routing(p, cfg, xf):
    """The reference's routing and dispatch (``moe_mlp``'s statements up
    to the dispatch table), for its integer state."""
    t, e, k = xf.shape[0], cfg.moe_num_experts, cfg.moe_top_k
    cap = int(max((t * k * cfg.moe_capacity_factor) // e, min(t, 256), 1))
    logits = jnp.einsum("td,de->te", xf.astype(jnp.float32),
                        p["router"]["w"].astype(jnp.float32))
    probs = jax.nn.softmax(logits, axis=-1)
    _, idx = jax.lax.top_k(probs, k)
    e_flat = idx.reshape(-1)
    order = jnp.argsort(e_flat, stable=True)
    e_sorted = e_flat[order]
    counts = jnp.bincount(e_flat, length=e)
    starts = jnp.cumsum(counts) - counts
    slot = jnp.arange(t * k) - starts[e_sorted]
    tok_sorted = jnp.repeat(jnp.arange(t), k)[order]
    disp = jnp.full((e, cap), t, jnp.int32).at[e_sorted, slot].set(
        tok_sorted, mode="drop")
    return tuple(np.asarray(a) for a in (probs, idx, slot, slot < cap, disp))


def _layers_close(got, want):
    """Stacked [R, ...] cache leaves, each layer within 2e-2 of its
    scale."""
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape
    for g, w in zip(got, want):
        assert np.abs(g - w).max() <= KV_TOL * np.abs(w).max()


def _sure(probs, k):
    """Tokens whose k-th / (k+1)-th probability margin exceeds 1e-6."""
    top = np.sort(probs, axis=-1)[:, ::-1]
    return top[:, k - 1] - top[:, k] > MARGIN


def _check_moe(arch, x, **over):
    jcfg, jp, cfg, tp = _moe_block(arch, **over)
    jy, jaux = _jitted(jcfg)[2](jp, jcfg, jnp.asarray(x))
    ty, taux = MoE.moe_mlp(tp, cfg, _t(x))
    assert ty.dtype == torch.bfloat16 and ty.shape == x.shape
    _within_scale_ulp(ty, jy)
    assert abs(float(taux) - float(jaux)) <= 1e-6 * abs(float(jaux))

    xf = x.reshape(-1, x.shape[-1])
    probs, jidx, jslot, jkeep, jdisp = _jax_routing(jp, jcfg, jnp.asarray(xf))
    _, _, tidx = MoE.route(tp, cfg, _t(xf))
    sure = _sure(probs, cfg.moe_top_k)
    np.testing.assert_array_equal(tidx.numpy()[sure], jidx[sure])
    if sure.all():
        cap = MoE.capacity(cfg, xf.shape[0])
        _, _, _, slot, keep, disp = MoE.dispatch(cfg, tidx, cap)
        np.testing.assert_array_equal(slot.numpy(), jslot)
        np.testing.assert_array_equal(keep.numpy(), jkeep)
        np.testing.assert_array_equal(disp.numpy(), jdisp)
        return int((~jkeep).sum())
    return None


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_mlp_matches_jax(arch):
    _, _, cfg, _ = _pair(arch)
    x = _bf16(np.random.default_rng(0).normal(size=(2, 32, cfg.d_model)))
    assert _check_moe(arch, x) == 0          # T 64: capacity admits all


def test_moe_mlp_capacity_drops_pairs():
    """T 1024 (B 4 x S 256) on reduced deepseek (E 8, k 2): capacity 320
    a expert, and inputs that lean towards experts 0 and 1 send more
    pairs than that to them, so the drop path runs; output and routing
    state as above."""
    _, _, cfg, tp = _moe_block("deepseek-moe-16b")
    rng = np.random.default_rng(1)
    lean = tp.router.numpy()[:, :2].sum(1)
    x = rng.normal(size=(4, 256, cfg.d_model)) + 2 * lean / np.linalg.norm(
        lean) * np.sqrt(cfg.d_model) * 0.3
    dropped = _check_moe("deepseek-moe-16b", _bf16(x))
    assert MoE.capacity(cfg, 1024) == 320
    assert dropped is not None and dropped > 0, dropped


def test_topk_ties_take_the_lower_index():
    """A zero router gives every expert the same probability: ``lax.top_k``
    and the port both pick experts 0..k-1, in that order."""
    jcfg, jp, cfg, _ = _moe_block("deepseek-moe-16b")
    jp = dict(jp, router={"w": jnp.zeros_like(jp["router"]["w"])})
    tp = MoE.init_moe(cfg, device=torch.device("cpu"))
    with torch.no_grad():
        tp.router.zero_()
    x = _bf16(np.random.default_rng(2).normal(size=(16, cfg.d_model)))
    _, jidx, *_ = _jax_routing(jp, jcfg, jnp.asarray(x))
    _, gate, tidx = MoE.route(tp, cfg, _t(x))
    want = np.broadcast_to(np.arange(cfg.moe_top_k), jidx.shape)
    np.testing.assert_array_equal(jidx, want)
    np.testing.assert_array_equal(tidx.numpy(), want)
    np.testing.assert_array_equal(gate.numpy(), 1 / cfg.moe_top_k)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(arch):
    """Prefill at B 2 (logits, the padded cache and deepseek's prefix
    entry), then two decode steps against the cache each package
    built. Without a prefix, layer 0's K and V come from the embedding
    (one bf16 ulp); after deepseek's prefix, every MoE layer's are held
    to 2e-2 of their scale."""
    jcfg, jp, cfg, model = _pair(arch)
    pre, dec, _ = _jitted(jcfg)
    s = 48
    toks = np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, s + 2)).astype(np.int32)
    jl, jc = pre(jp, jcfg, {"tokens": jnp.asarray(toks[:, :s])}, s + 2)
    tl, tc = M.prefill(model, cfg, {"tokens": _t(toks[:, :s])},
                       cache_len=s + 2)
    _logits_close(tl, jl)
    for kv in ("k", "v"):
        got, want = tc["layers"]["block0"][kv], jc["layers"]["block0"][kv]
        if cfg.first_dense_ff:
            # the prefix is fed the embedding, the MoE layers its output
            _cache_close(tc["prefix"][kv][None], jc["prefix"][kv][None])
            _layers_close(got, want)
        else:
            _cache_close(got, want)
    for i in range(2):
        nxt = toks[:, s + i:s + i + 1]
        jl, jc = dec(jp, jcfg, jnp.asarray(nxt), jc, s + i)
        tl, tc = M.decode_step(model, cfg, _t(nxt), tc, s + i)
        _logits_close(tl, jl)
    assert _f32(tc["prefix"]["k"] if cfg.first_dense_ff else
                tc["layers"]["block0"]["k"]).any()
