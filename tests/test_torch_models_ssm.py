"""Port parity: the SSM family (``repro_torch.models.ssm`` and the
mamba2 model) vs ``repro.models``, on the CPU.

Weights are the JAX package's, carried across by ``params_from_jax``;
inputs are made with numpy from a seed and handed to both packages.

Tolerances:
  * ``ssm_train`` and ``ssm_decode`` on the same bf16 input: the output
    within one bf16 ulp at its scale (its largest magnitude);
  * the carried SSM state (``ssd``, and the ``conv`` window): float32
    within 1e-5 of its scale (the chunk products sum in other orders);
  * the deterministic init leaves (``A_log``, ``D``, ``dt_bias``,
    ``conv_b``, ``norm_scale``): within 1e-6 of their values;
  * the whole model (``prefill``, ``decode_step``) on the reduced
    config: logits within 2e-2 of the logit scale. At depth the
    reference is chaotic (``examples/torch_ssm_depth_gap.py``).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import model as JM
from repro.models import ssm as JS

from repro_torch.models import model as M
from repro_torch.models import ssm as S
from test_torch_models import (_bf16, _f32, _logits_close, _pair, _t,
                               _within_scale_ulp)

ARCH = "mamba2-370m"
STATE_TOL = 1e-5


@functools.lru_cache(maxsize=None)
def _jitted(jcfg):
    return (jax.jit(JM.prefill, static_argnums=(1, 3)),
            jax.jit(JM.decode_step, static_argnums=(1,)),
            jax.jit(JS.ssm_train, static_argnums=(1, 3)),
            jax.jit(JS.ssm_decode, static_argnums=(1,)))


def _mixer(r=0):
    jcfg, jp, cfg, model = _pair(ARCH)
    jb = jax.tree_util.tree_map(lambda a: a[r], jp["layers"]["block0"])
    return jcfg, jb["mixer"], cfg, model.layers[r]["block0"].mixer


def _state_close(got, want):
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert np.abs(got - want).max() <= STATE_TOL * np.abs(want).max()


def test_init_values_match_jax():
    jcfg, jm, cfg, _ = _mixer()
    fresh = S.init_ssm(cfg, torch.Generator().manual_seed(0),
                       torch.device("cpu"))
    ref = JS.init_ssm(jax.random.PRNGKey(0), jcfg)
    for name in ("A_log", "D", "dt_bias", "conv_b", "norm_scale"):
        got, want = getattr(fresh, name).numpy(), np.asarray(ref[name])
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert fresh.conv_w.shape == ref["conv_w"].shape
    assert fresh.in_proj.shape == ref["in_proj"]["w"].shape


def test_segsum_masks_without_nan():
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(2, 3, 16)).astype(np.float32))
    L = torch.exp(S._segsum(x))
    want = np.exp(np.asarray(JS._segsum(jnp.asarray(x.numpy()))))
    assert torch.isfinite(L).all()
    assert not L.triu(1).any()
    np.testing.assert_allclose(L.numpy(), want, rtol=1e-5, atol=0)


@pytest.mark.parametrize("s", [3, 32, 50, 64])
def test_ssm_train_matches_jax(s):
    """One chunk (S 32), a padded chunk (S 50: dt 0 on the pad), two
    chunks (S 64) and a prompt shorter than the conv window (S 3): the
    output and the returned state."""
    jcfg, jm, cfg, tm = _mixer()
    x = _bf16(np.random.default_rng(s).normal(size=(2, s, cfg.d_model)))
    jy, jst = _jitted(jcfg)[2](jm, jcfg, jnp.asarray(x), True)
    ty, tst = S.ssm_train(tm, cfg, _t(x), return_state=True)
    assert ty.dtype == torch.bfloat16 and ty.shape == x.shape
    _within_scale_ulp(ty, jy)
    for name in ("conv", "ssd"):
        _state_close(tst[name], jst[name])
    _within_scale_ulp(S.ssm_train(tm, cfg, _t(x)), jy)


def test_ssm_decode_matches_jax():
    """One recurrent step from a random float32 state: output, the
    shifted conv window and the new SSD state."""
    jcfg, jm, cfg, tm = _mixer(1)
    rng = np.random.default_rng(5)
    x = _bf16(rng.normal(size=(2, 1, cfg.d_model)))
    cache = {k: rng.normal(size=a.shape).astype(np.float32)
             for k, a in JS.init_ssm_cache(jcfg, 2).items()}
    jy, jc = _jitted(jcfg)[3](jm, jcfg, jnp.asarray(x),
                              {k: jnp.asarray(a) for k, a in cache.items()})
    ty, tc = S.ssm_decode(tm, cfg, _t(x), {k: _t(a) for k, a in
                                           cache.items()})
    _within_scale_ulp(ty, jy)
    for name in ("conv", "ssd"):
        _state_close(tc[name], jc[name])


def test_cache_layout_matches_jax():
    """The SSM entries stay float32 whatever dtype the cache has, as the
    reference's; shapes and dtypes of every leaf equal ``init_cache``'s."""
    jcfg, _, cfg, _ = _pair(ARCH)
    want = JM.init_cache(jcfg, 3, 40, jnp.bfloat16)
    got = M.init_cache(cfg, 3, 40, torch.bfloat16)
    assert set(got) == set(want) == {"layers"}
    for name, entry in want["layers"].items():
        for k, a in entry.items():
            t = got["layers"][name][k]
            assert tuple(t.shape) == a.shape
            assert t.dtype == torch.float32 and a.dtype == jnp.float32


@pytest.mark.parametrize("s", [40, 64])
def test_prefill_and_decode_match_jax(s):
    """Prefill at B 2 (logits and both state leaves of every layer),
    then two decode steps against the cache each package built."""
    jcfg, jp, cfg, model = _pair(ARCH)
    pre, dec, _, _ = _jitted(jcfg)
    toks = np.random.default_rng(s).integers(
        0, cfg.vocab_size, (2, s + 2)).astype(np.int32)
    jl, jc = pre(jp, jcfg, {"tokens": jnp.asarray(toks[:, :s])}, s + 2)
    tl, tc = M.prefill(model, cfg, {"tokens": _t(toks[:, :s])},
                       cache_len=s + 2)
    _logits_close(tl, jl)
    _state_close(tc["layers"]["block0"]["ssd"][0],
                 jc["layers"]["block0"]["ssd"][0])
    for name in ("conv", "ssd"):
        got, want = (_f32(c["layers"]["block0"][name]) for c in (tc, jc))
        assert got.shape == want.shape
        for g, w in zip(got, want):      # later layers: the model bar
            assert np.abs(g - w).max() <= 2e-2 * np.abs(w).max()
    for i in range(2):
        nxt = toks[:, s + i:s + i + 1]
        jl, jc = dec(jp, jcfg, jnp.asarray(nxt), jc, s + i)
        tl, tc = M.decode_step(model, cfg, _t(nxt), tc, s + i)
        _logits_close(tl, jl)

