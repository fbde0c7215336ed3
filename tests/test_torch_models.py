"""Port parity: the dense serving model vs ``repro.models``, on the CPU.

Weights are the JAX package's, carried across by
``repro_torch.models.model.params_from_jax``; inputs are made with
numpy and handed to both packages.

Tolerances:
  * layers fed the same inputs: ``rmsnorm``, ``head_rmsnorm`` and
    ``apply_rope`` on float32 inputs within 1e-6 of the output's scale
    (the transcendental functions and reduction orders of XLA:CPU and
    PyTorch differ in the last float32 bit); ``dense`` within one bf16
    ulp of each value, or 2e-5 where that ulp is finer (one rounding of
    a float32 sum taken in another order); ``mlp``, ``attention_train``
    and ``attention_decode``, which round intermediate bf16 values,
    within one bf16 ulp at the output's scale (its largest magnitude);
  * the whole model (``prefill``, ``decode_step``, the greedy steps):
    logits within 2e-2 of the logit scale, max |port - JAX| / max
    |JAX| — the reference's own bar between its prefill and decode
    paths (``tests/test_serving.py``). A tighter bar is below the noise
    floor of any second bf16 implementation: one bf16 ulp added to one
    embedded element moves the reference's own last logits by several
    thousandths of their scale (:func:`test_one_ulp_moves_the_logits`),
    and the port, which rounds some values the other way, lands about
    1e-2 from JAX. Cache K and V: the first layer's (computed from the
    identical embedding) within one bf16 ulp, or 2e-5 where that ulp is
    finer; every layer's within 2e-2 of that layer's scale (later layers
    carry the residual stream's noise: about 1e-2 of their scale, a few
    bf16 ulps, where an elementwise ``rtol=atol=2e-2`` fails on a few
    small entries). Greedy tokens must agree wherever JAX's top-2 margin
    exceeds 1e-2 of the logit scale
    (``tests/test_torch_models_steps.py``).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import attention as JA
from repro.models import layers as JL
from repro.models import model as JM

from repro_torch import configs
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import model as M

LOGIT_REL = 2e-2
KV_TOL = 2e-2
ARCHS = ("qwen3-4b", "phi4-mini-3.8b", "nemotron-4-15b")


@functools.lru_cache(maxsize=None)
def _pair(arch, seed=0, **over):
    jcfg, cfg = jconfigs.get_reduced(arch), configs.get_reduced(arch)
    if over:
        jcfg = dataclasses.replace(jcfg, **over)
        cfg = dataclasses.replace(cfg, **over)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(seed))
    tree = jax.tree_util.tree_map(lambda a: np.array(a, np.float32), jp)
    return jcfg, jp, cfg, M.params_from_jax(tree, cfg, device="cpu")


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _bf16(a):
    """numpy values rounded to bf16 once (in JAX), for both packages."""
    return np.asarray(jnp.asarray(a, jnp.bfloat16))


def _t(a):
    if a.dtype == np.float32 or a.dtype.kind == "i":
        return torch.from_numpy(np.ascontiguousarray(a))
    return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)


def _ulp(x):
    mag = np.maximum(np.abs(x), np.finfo(np.float32).tiny)
    return np.exp2(np.floor(np.log2(mag)) - 7)


def _within_ulp(got, want):
    """One bf16 ulp of each value, or 2e-5 where that ulp is finer (a
    sum that cancels to near zero carries the float32 rounding of its
    terms, not of itself; the decode kernel's rule)."""
    got, want = _f32(got), _f32(want)
    assert np.all(np.abs(got - want) <= np.maximum(_ulp(want), 2e-5))


def _within_scale_ulp(got, want):
    got, want = _f32(got), _f32(want)
    assert np.abs(got - want).max() <= _ulp(np.abs(want).max())


def _cache_close(got, want):
    """Stacked [R, B, L, Hkv, Dh] K or V: layer 0 within one bf16 ulp,
    each layer within 2e-2 of its scale."""
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape
    _within_ulp(got[0], want[0])
    for g, w in zip(got, want):
        assert np.abs(g - w).max() <= KV_TOL * np.abs(w).max()


def _logits_close(got, want):
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / (np.abs(want).max() + 1e-6)
    print(f"relative logit error {err:.4f}")      # shown by pytest -rP
    assert err < LOGIT_REL, err


def _block(jp, model, r=0):
    return (jax.tree_util.tree_map(lambda a: a[r], jp["layers"]["block0"]),
            model.layers[r]["block0"])


# -- layers ------------------------------------------------------------------

def test_norms_and_rope_float32():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 40, 4, 16)).astype(np.float32)
    scale = rng.normal(size=16).astype(np.float32)
    pos = np.arange(40)[None]
    pairs = [
        (JL.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x), 1e-5),
         L.rmsnorm(_t(scale), _t(x), 1e-5)),
        (JL.head_rmsnorm(jnp.asarray(scale), jnp.asarray(x), 1e-6),
         L.head_rmsnorm(_t(scale), _t(x), 1e-6))]
    for theta in (1e4, 1e6):
        pairs.append((JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta),
                      L.apply_rope(_t(x), _t(pos), theta)))
        np.testing.assert_array_equal(
            np.asarray(JL.rope_frequencies(16, theta)),
            L.rope_frequencies(16, theta).numpy())
    for want, got in pairs:
        want, got = _f32(want), _f32(got)
        assert got.dtype == want.dtype
        assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


def test_dense_embed_unembed():
    rng = np.random.default_rng(1)
    x = _bf16(rng.normal(size=(2, 33, 64)))
    w = (rng.normal(size=(64, 96)) * 0.125).astype(np.float32)
    got = L.dense(_t(w), _t(x))
    assert got.dtype == torch.bfloat16 and got.shape == (2, 33, 96)
    _within_ulp(got, JL.dense({"w": jnp.asarray(w)}, jnp.asarray(x)))
    table = rng.normal(size=(50, 64)).astype(np.float32)
    ids = rng.integers(0, 50, (2, 7)).astype(np.int32)
    np.testing.assert_array_equal(
        _f32(L.embed(_t(table), _t(ids))),
        _f32(JL.embed({"table": jnp.asarray(table)}, jnp.asarray(ids))))
    np.testing.assert_allclose(
        L.unembed(_t(table), _t(x)).numpy(),
        np.asarray(JL.unembed({"table": jnp.asarray(table)}, jnp.asarray(x))),
        rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("act", ["swiglu", "relu2", "gelu"])
def test_activation_and_mlp(act):
    rng = np.random.default_rng(2)
    x = _bf16(rng.normal(size=(2, 33, 64)) * 2)
    np.testing.assert_array_equal(
        _f32(L.activation(act)(_t(x))),
        _f32(JL.activation(act)(jnp.asarray(x))))
    jparams = JL.init_mlp(jax.random.PRNGKey(3), 64, 128, act)
    mlp = L.init_mlp(64, 128, act, device="cpu")
    for name, p in mlp.named_parameters():
        p.copy_(_t(np.array(jparams[name]["w"])))
    _within_scale_ulp(L.mlp(mlp, _t(x), act),
                      JL.mlp(jparams, jnp.asarray(x), act))


@pytest.mark.parametrize("arch", ARCHS)
def test_attention_train_and_decode(arch):
    jcfg, jp, cfg, model = _pair(arch)
    jb, tb = _block(jp, model)
    rng = np.random.default_rng(4)
    x = _bf16(rng.normal(size=(2, 64, cfg.d_model)))
    pos = np.arange(64)[None]
    jy, jk, jv = JA.attention_train(jb["mixer"], jcfg, jnp.asarray(x),
                                    jnp.asarray(pos))
    ty, tk, tv = A.attention_train(tb.mixer, cfg, _t(x), _t(pos))
    _within_scale_ulp(ty, jy)
    _within_ulp(tk, jk)
    _within_ulp(tv, jv)

    shape = (2, 40, cfg.num_kv_heads, cfg.head_dim)
    ck, cv = _bf16(rng.normal(size=shape)), _bf16(rng.normal(size=shape))
    jd, jck, jcv = JA.attention_decode(jb["mixer"], jcfg,
                                       jnp.asarray(x[:, :1]), jnp.asarray(ck),
                                       jnp.asarray(cv), 30)
    tck, tcv = _t(ck), _t(cv)
    td, tck2, tcv2 = A.attention_decode(tb.mixer, cfg, _t(x[:, :1]), tck,
                                        tcv, 30)
    assert tck2 is tck and tcv2 is tcv          # written in place
    _within_scale_ulp(td, jd)
    np.testing.assert_array_equal(_f32(tck), _f32(jck))
    np.testing.assert_array_equal(_f32(tcv), _f32(jcv))


# -- the model ---------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("s", [32, 256])
def test_prefill_and_decode_match_jax(arch, s):
    """Prefill at B 2 (logits and the padded cache), then two decode
    steps against the cache each package built."""
    jcfg, jp, cfg, model = _pair(arch)
    rng = np.random.default_rng(s)
    toks = rng.integers(0, cfg.vocab_size, (2, s + 2)).astype(np.int32)
    jl, jc = JM.prefill(jp, jcfg, {"tokens": jnp.asarray(toks[:, :s])},
                        cache_len=s + 2)
    tl, tc = M.prefill(model, cfg, {"tokens": _t(toks[:, :s])},
                       cache_len=s + 2)
    _logits_close(tl, jl)
    for kv in ("k", "v"):
        got, want = tc["layers"]["block0"][kv], jc["layers"]["block0"][kv]
        assert got.dtype == torch.bfloat16
        _cache_close(got, want)
        assert not got[:, :, s:].any()          # padding stays zero
    for i in range(2):
        nxt = toks[:, s + i:s + i + 1]
        jl, jc = JM.decode_step(jp, jcfg, jnp.asarray(nxt), jc, s + i)
        tl, tc = M.decode_step(model, cfg, _t(nxt), tc, s + i)
        _logits_close(tl, jl)


def test_one_ulp_moves_the_logits():
    """The noise floor behind the model tolerance: in the reference
    itself, one bf16 ulp added to one embedded element moves the last
    position's logits by more than 1e-3 of their scale, so two bf16
    implementations that round a few values differently cannot be held
    to much under 1e-2."""
    jcfg, jp, _, _ = _pair("qwen3-4b", 1)
    toks = jnp.asarray(np.random.default_rng(1).integers(
        0, jcfg.vocab_size, (2, 256)).astype(np.int32))
    pos = jnp.arange(256)[None]

    def logits(bump):
        x = JL.embed(jp["embed"], toks)
        if bump is not None:
            v = x[bump]
            x = x.at[bump].set(jnp.nextafter(v, jnp.asarray(10, v.dtype)))
        x, _, _ = JM._scan_train(jp, jcfg, x, pos)
        x = JL.rmsnorm(jp["final_norm"], x, jcfg.norm_eps)
        return np.asarray(JL.unembed(jp["unembed"], x[:, -1:]))

    base = logits(None)
    moves = [np.abs(logits(b) - base).max() / np.abs(base).max()
             for b in ((0, 0, 0), (0, 100, 5), (0, 255, 3), (1, 200, 7),
                       (1, 255, 60))]
    print("one bf16 ulp moves the last logits by " + ", ".join(
        f"{m:.4f}" for m in moves) + " of their scale")   # pytest -rP
    assert min(moves) > 1e-3, moves


def _attention_decode_f32(params, cfg, x, cache_k, cache_v, pos):
    """The port's ``attention_decode`` (no sliding window) with q·scale
    and p kept in float32, as the prefill computes them."""
    b, skv = x.shape[0], cache_k.shape[1]
    at = torch.full((b, 1), pos, dtype=torch.int32)
    q = A._project_q(params, cfg, x, at)
    k_new, v_new = A._project_kv(params, cfg, x, at)
    cache_k[:, pos % skv] = k_new[:, 0].to(cache_k.dtype)
    cache_v[:, pos % skv] = v_new[:, 0].to(cache_v.dtype)
    qh = q[:, 0].reshape(b, cfg.num_kv_heads, -1, cfg.head_dim).float()
    sc = torch.einsum("bhgd,bshd->bhgs", qh * cfg.head_dim ** -0.5,
                      cache_k.float())
    sc = torch.where(torch.arange(skv) <= pos, sc, -1e30)
    out = torch.einsum("bhgs,bshd->bhgd", torch.softmax(sc, -1),
                       cache_v.float())
    return L.dense(params.wo, out.reshape(b, 1, -1).to(x.dtype)), \
        cache_k, cache_v


def test_decode_gap_at_depth(monkeypatch):
    """Decode against a fresh prefill of the longer prompt at qwen3-4b's
    depth (36 layers, reduced width; B 1, 96 + 2 tokens). The reference
    departs from its own prefill by 1e-2 to 2e-2 of the logit scale
    there: its decode rounds q·scale and the softmax weights to bf16,
    its prefill does not, and 36 bf16 layers amplify each value that
    rounds the other way. The port's gap is of the same size, and
    shrinks when decode's attention keeps both in float32 (what is
    left is float32 summation order, amplified the same way)."""
    jcfg, jp, cfg, model = _pair("qwen3-4b", num_layers=36)
    p = 96
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                             (1, p + 2)).astype(np.int32)

    def gaps(jax_side):
        pre = JM.prefill if jax_side else M.prefill
        step = JM.decode_step if jax_side else M.decode_step
        args = (jp, jcfg) if jax_side else (model, cfg)
        mk = jnp.asarray if jax_side else _t
        _, cache = pre(*args, {"tokens": mk(toks[:, :p])}, cache_len=p + 2)
        out = []
        for i in range(2):
            ld, cache = step(*args[:1], args[1],
                             mk(toks[:, p + i:p + i + 1]), cache, p + i)
            lf, _ = pre(*args, {"tokens": mk(toks[:, :p + i + 1])})
            ld, lf = _f32(ld)[:, -1], _f32(lf)[:, -1]
            out.append(float(np.abs(ld - lf).max() / np.abs(lf).max()))
        return out

    ref, port = gaps(True), gaps(False)
    monkeypatch.setattr(A, "attention_decode", _attention_decode_f32)
    f32 = gaps(False)
    print(f"decode vs re-prefill at 36 layers: reference {ref}, port "
          f"{port}, port with float32 decode attention {f32}")  # pytest -rP
    assert max(port) < 2 * max(ref), (port, ref)
    assert max(f32) < max(port), (f32, port)


def test_port_vs_jax_at_depth():
    """Port against JAX at qwen3-4b's depth (36 layers, reduced width; B
    1, 96 tokens, the setting of :func:`test_decode_gap_at_depth`):
    prefill logits from each package's own prefill, then two decode
    steps from the JAX prefill's cache, fed to both packages'
    ``decode_step``, so decode is measured on the same cache, apart from
    the prefill. Both within the model bar. (Where the difference comes
    from: ``examples/torch_depth_parity.py``.)"""
    jcfg, jp, cfg, model = _pair("qwen3-4b", num_layers=36)
    p = 96
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                             (1, p + 2)).astype(np.int32)

    def rel(got, want):
        got, want = _f32(got)[:, -1], _f32(want)[:, -1]
        return float(np.abs(got - want).max() / np.abs(want).max())
    jl, jc = JM.prefill(jp, jcfg, {"tokens": jnp.asarray(toks[:, :p])},
                        cache_len=p + 2)
    tl, _ = M.prefill(model, cfg, {"tokens": _t(toks[:, :p])},
                      cache_len=p + 2)
    prefill = rel(tl, jl)
    tc = jax.tree_util.tree_map(lambda a: _t(np.asarray(a)), jc)
    decode = []
    for i in range(2):
        nxt = toks[:, p + i:p + i + 1]
        jl, jc = JM.decode_step(jp, jcfg, jnp.asarray(nxt), jc, p + i)
        tl, tc = M.decode_step(model, cfg, _t(nxt), tc, p + i)
        decode.append(rel(tl, jl))
    print(f"port vs JAX at 36 layers: prefill logits {prefill:.4e}, "
          f"decode logits from the JAX cache "
          f"{', '.join(f'{e:.4e}' for e in decode)}")     # pytest -rP
    assert prefill < LOGIT_REL and max(decode) < LOGIT_REL, (prefill,
                                                             decode)
