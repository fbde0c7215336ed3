"""Port parity: the hybrid family (jamba: seven SSM blocks and one
attention block a superlayer, MoE on every second block) vs
``repro.models``, on the CPU.

Weights are the JAX package's, carried across by ``params_from_jax``;
inputs are made with numpy from a seed and handed to both packages.

The reference here is compiled with XLA's ``xla_allow_excess_precision``
off: then XLA rounds every bf16 operation to bf16, as the jaxpr says and
as the port does, instead of keeping fused bf16 intermediates in
float32. On this model the default compilation is itself 2.2e-2 to
2.4e-2 of the logit scale from that rounding (reduced jamba, S 40 and
64, B 2; printed by the tests, ``pytest -rP``), which is the size of
the model bar, while the port is 2e-3 to 1e-2 from it.

Tolerances:
  * one superlayer (``superlayer_train``) on the same bf16 input: the
    output within 2e-2 of its scale (eight blocks, each within one bf16
    ulp of its own output's scale, compound) and so the aux loss (the
    four MoE blocks' sum), block 0's carried SSM state (fed the
    identical input) within 1e-5 of its scale, every other cache entry
    within 2e-2 of its scale;
  * the whole model (``prefill``, ``decode_step``) on the reduced
    config: logits within 2e-2 of the logit scale; the attention
    block's K and V (``block7``, fed seven blocks' output) and every SSM
    state within 2e-2 of each layer's scale.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.models import blocks as JB
from repro.models import model as JM

from repro_torch.models import blocks as B
from repro_torch.models import model as M
from test_torch_models import KV_TOL, _bf16, _f32, _logits_close, _pair, _t

ARCH = "jamba-v0.1-52b"
STATE_TOL = 1e-5


def _exact(fn, static, *args):
    """``fn`` compiled for ``args`` with excess precision off; returns
    the compiled call on the non-static arguments."""
    return jax.jit(fn, static_argnums=static).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})


def _rel(got, want) -> float:
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_pattern_is_seven_ssm_one_attention():
    _, _, cfg, model = _pair(ARCH)
    kinds = [type(model.layers[0][f"block{i}"].mixer).__name__
             for i in range(8)]
    ffns = [type(model.layers[0][f"block{i}"].ffn).__name__
            for i in range(8)]
    assert kinds == ["SSM"] * 7 + ["Attention"]
    assert ffns == ["MLP", "MoE"] * 4


def test_superlayer_matches_jax():
    jcfg, jp, cfg, model = _pair(ARCH)
    jl = jax.tree_util.tree_map(lambda a: a[0], jp["layers"])
    x = _bf16(np.random.default_rng(0).normal(size=(2, 40, cfg.d_model)))
    pos = np.arange(40)[None]
    args = (jl, jcfg, jnp.asarray(x), jnp.asarray(pos), True)
    jy, jaux, jc = _exact(JB.superlayer_train, (1, 4), *args)(*args[:1],
                                                              *args[2:4])
    ty, taux, tc = B.superlayer_train(model.layers[0], cfg, _t(x), _t(pos),
                                      collect_cache=True)
    assert _rel(ty, jy) < KV_TOL
    assert abs(float(taux) - float(jaux)) <= KV_TOL * abs(float(jaux))
    assert set(tc) == set(jc)
    for name in ("conv", "ssd"):
        assert _rel(tc["block0"][name], jc["block0"][name]) <= STATE_TOL
    for blk, entry in jc.items():
        for name, a in entry.items():
            assert _rel(tc[blk][name], a) < KV_TOL, (blk, name)


@pytest.mark.parametrize("s", [40, 64])
def test_prefill_and_decode_match_jax(s):
    """Prefill at B 2 (S 40 pads the SSM's last chunk of 32), then two
    decode steps against the cache each package built."""
    jcfg, jp, cfg, model = _pair(ARCH)
    toks = np.random.default_rng(s).integers(
        0, cfg.vocab_size, (2, s + 2)).astype(np.int32)
    batch = {"tokens": jnp.asarray(toks[:, :s])}
    jl, jc = _exact(JM.prefill, (1, 3), jp, jcfg, batch, s + 2)(jp, batch)
    tl, tc = M.prefill(model, cfg, {"tokens": _t(toks[:, :s])},
                       cache_len=s + 2)
    default, _ = jax.jit(JM.prefill, static_argnums=(1, 3))(jp, jcfg, batch,
                                                           s + 2)
    print(f"reference, default compilation vs excess precision off: "
          f"{_rel(default, jl):.4f} of the logit scale")   # pytest -rP
    _logits_close(tl, jl)
    for blk, entry in jc["layers"].items():
        for name, a in entry.items():
            got = tc["layers"][blk][name]
            assert tuple(got.shape) == a.shape
            for g, w in zip(_f32(got), _f32(a)):
                assert np.abs(g - w).max() <= KV_TOL * np.abs(w).max()
    assert not _f32(tc["layers"]["block7"]["k"])[:, :, s:].any()
    step = None
    for i in range(2):
        nxt, pos = jnp.asarray(toks[:, s + i:s + i + 1]), jnp.int32(s + i)
        step = step or _exact(JM.decode_step, (1,), jp, jcfg, nxt, jc, pos)
        jl, jc = step(jp, nxt, jc, pos)
        tl, tc = M.decode_step(model, cfg, _t(toks[:, s + i:s + i + 1]), tc,
                               s + i)
        _logits_close(tl, jl)
