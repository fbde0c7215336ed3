"""Port parity: the encoder-decoder (seamless: audio frames through the
stub frontend, a bidirectional encoder, cross attention in every
decoder block) and the VLM (internvl2: patch embeddings before the
text) vs ``repro.models``, on the CPU.

Weights are the JAX package's, carried across by ``params_from_jax``;
inputs are made with numpy from a seed and handed to both packages.

Tolerances:
  * ``attention_encoder``, ``attention_cross`` (Sq 24 against an
    encoder memory of 40) and ``attention_cross_decode`` on the same
    bf16 inputs: within one bf16 ulp at the output's scale;
  * the encoder memory's cross K and V (``cache["memory_kv"]``, from
    the encoder stack's output): every layer within 2e-2 of its scale;
    the VLM's cache K and V as in ``tests/test_torch_models.py``;
  * the whole model (``prefill``, ``decode_step``) on each reduced
    config: logits within 2e-2 of the logit scale.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.models import attention as JA
from repro.models import model as JM

from repro_torch.models import attention as A
from repro_torch.models import model as M
from test_torch_models import (KV_TOL, _bf16, _cache_close, _f32,
                               _logits_close, _pair, _t, _within_scale_ulp)

ENCDEC = "seamless-m4t-large-v2"
VLM = "internvl2-26b"


@functools.lru_cache(maxsize=None)
def _jitted(jcfg):
    return (jax.jit(JM.prefill, static_argnums=(1, 3)),
            jax.jit(JM.decode_step, static_argnums=(1,)))


def _cross_block(r=0):
    jcfg, jp, cfg, model = _pair(ENCDEC)
    jb = jax.tree_util.tree_map(lambda a: a[r], jp["layers"]["block0"])
    return jcfg, jb, cfg, model.layers[r]["block0"]


def test_encoder_and_cross_attention_match_jax():
    jcfg, jb, cfg, tb = _cross_block()
    rng = np.random.default_rng(0)
    x = _bf16(rng.normal(size=(2, 40, cfg.d_model)))
    pos = np.arange(40)[None]
    _within_scale_ulp(
        A.attention_encoder(tb.mixer, cfg, _t(x), _t(pos)),
        JA.attention_encoder(jb["mixer"], jcfg, jnp.asarray(x),
                             jnp.asarray(pos)))
    shape = (2, 40, cfg.num_kv_heads, cfg.head_dim)
    mk, mv = _bf16(rng.normal(size=shape)), _bf16(rng.normal(size=shape))
    xq = _bf16(rng.normal(size=(2, 24, cfg.d_model)))
    qpos = np.arange(24)[None]
    _within_scale_ulp(
        A.attention_cross(tb.cross, cfg, _t(xq), (_t(mk), _t(mv)),
                          _t(qpos)),
        JA.attention_cross(jb["cross"], jcfg, jnp.asarray(xq),
                           (jnp.asarray(mk), jnp.asarray(mv)),
                           jnp.asarray(qpos)))
    _within_scale_ulp(
        A.attention_cross_decode(tb.cross, cfg, _t(xq[:, :1]),
                                 (_t(mk), _t(mv)), 24),
        JA.attention_cross_decode(jb["cross"], jcfg, jnp.asarray(xq[:, :1]),
                                  (jnp.asarray(mk), jnp.asarray(mv)), 24))


def test_encdec_prefill_and_decode_match_jax():
    """Frames [B 2, 40, D] and a decoder prompt of 24: logits, the
    memory's cross K and V, the decoder's own K and V; then two decode
    steps against the cache each package built."""
    jcfg, jp, cfg, model = _pair(ENCDEC)
    pre, dec = _jitted(jcfg)
    rng = np.random.default_rng(1)
    frames = rng.normal(size=(2, 40, cfg.d_model)).astype(np.float32)
    toks = rng.integers(0, cfg.vocab_size, (2, 26)).astype(np.int32)
    s = 24
    jl, jc = pre(jp, jcfg, {"frames": jnp.asarray(frames),
                            "dec_tokens": jnp.asarray(toks[:, :s])}, s + 2)
    tl, tc = M.prefill(model, cfg, {"frames": _t(frames),
                                    "dec_tokens": _t(toks[:, :s])},
                       cache_len=s + 2)
    _logits_close(tl, jl)
    for got, want in zip(tc["memory_kv"], jc["memory_kv"]):
        got, want = _f32(got), _f32(want)
        assert got.shape == want.shape
        for g, w in zip(got, want):
            assert np.abs(g - w).max() <= KV_TOL * np.abs(w).max()
    for kv in ("k", "v"):
        _cache_close(tc["layers"]["block0"][kv], jc["layers"]["block0"][kv])
    for i in range(2):
        nxt = toks[:, s + i:s + i + 1]
        jl, jc = dec(jp, jcfg, jnp.asarray(nxt), jc, s + i)
        tl, tc = M.decode_step(model, cfg, _t(nxt), tc, s + i)
        _logits_close(tl, jl)


@pytest.mark.parametrize("with_patches", [True, False])
def test_vlm_prefill_and_decode_match_jax(with_patches):
    """Patches [B 2, 16, D] before 24 text tokens (positions over 40),
    or text alone; then two decode steps."""
    jcfg, jp, cfg, model = _pair(VLM)
    pre, dec = _jitted(jcfg)
    rng = np.random.default_rng(2)
    toks = rng.integers(0, cfg.vocab_size, (2, 26)).astype(np.int32)
    s, p = 24, cfg.frontend_tokens if with_patches else 0
    jb, tb = {"tokens": jnp.asarray(toks[:, :s])}, {"tokens": _t(toks[:, :s])}
    if with_patches:
        patches = _bf16(rng.normal(size=(2, p, cfg.d_model)))
        jb["patches"], tb["patches"] = jnp.asarray(patches), _t(patches)
    jl, jc = pre(jp, jcfg, jb, p + s + 2)
    tl, tc = M.prefill(model, cfg, tb, cache_len=p + s + 2)
    _logits_close(tl, jl)
    for kv in ("k", "v"):
        _cache_close(tc["layers"]["block0"][kv], jc["layers"]["block0"][kv])
    for i in range(2):
        nxt = toks[:, s + i:s + i + 1]
        jl, jc = dec(jp, jcfg, jnp.asarray(nxt), jc, p + s + i)
        tl, tc = M.decode_step(model, cfg, _t(nxt), tc, p + s + i)
        _logits_close(tl, jl)
