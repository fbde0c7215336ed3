"""Port parity with bf16 weights: every model family's prefill on
parameters cast to bfloat16 by the reference dry-run's ``--bf16-params``
rule (every float32 leaf to bfloat16; ``repro.launch.dryrun.run_cell``)
vs the reference's ``make_prefill_step`` on the same cast leaves, on the
CPU.

Weights are the JAX package's, carried by ``params_from_jax`` and then
cast on both sides (``repro_torch.models.model.cast_params`` in the
port, ``astype(bfloat16)`` of each float32 leaf in the reference);
inputs are made with numpy from a seed and handed to both packages.

JAX promotes a float32 activation times a bfloat16 leaf to float32 and
keeps a bfloat16 leaf's own arithmetic in bfloat16; PyTorch's
elementwise promotion is the same, and every product with a weight goes
through ``dense`` / ``dense_f32`` / ``unembed``, which cast both
operands. The one site that differed was the SSM's ``A = -exp(A_log)``,
which the reference keeps in ``A_log``'s dtype.

Tolerances:
  * the whole model on each reduced config (dense qwen3, MoE deepseek,
    SSM mamba2 here; hybrid jamba, VLM internvl2 and enc-dec seamless in
    tests/test_torch_bf16_params_families.py): the last
    position's logits within 2e-2 of the logit scale (the model bar of
    tests/test_torch_models.py) and the same next tokens; one decode step
    after it for dense and MoE. Jamba's reference is compiled with
    excess precision off, as in tests/test_torch_models_hybrid.py;
  * the SSM's ``A``: bfloat16 and bit-identical to the reference's
    ``-jnp.exp`` of the cast leaf. The mixer's output within one bf16
    ulp at its scale and its carried float32 state within 5e-5 of its
    scale: the chunk products sum in other orders (1e-5 with float32
    leaves, up to 2.2e-5 with bf16 leaves at S 64, where the coarser
    decay rates cancel more), while an ``A`` left in float32 moves the
    state by 1.7e-4 to 3.8e-4 of its scale.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch import steps as JST
from repro.models import model as JM
from repro.models import ssm as JS

from repro_torch.launch import steps as ST
from repro_torch.models import model as M
from repro_torch.models import ssm as S
from test_torch_models import (_bf16, _f32, _logits_close, _pair, _t,
                               _within_scale_ulp)

FAMILIES = ("qwen3-4b", "deepseek-moe-16b", "mamba2-370m",
            "jamba-v0.1-52b", "internvl2-26b", "seamless-m4t-large-v2")
EXACT = {"jamba-v0.1-52b"}
DECODE = {"qwen3-4b", "deepseek-moe-16b"}
SSM_STATE_TOL = 5e-5


def _cast_jax(tree):
    """The reference dry-run's cast: every float32 leaf to bfloat16."""
    return jax.tree_util.tree_map(
        lambda a: a.astype(jnp.bfloat16) if a.dtype == jnp.float32 else a,
        tree)


@functools.lru_cache(maxsize=None)
def _cast_pair(arch):
    """(jcfg, the reference's cast tree, cfg, the port's cast model),
    the model a fresh one (``_pair``'s is shared with other tests)."""
    jcfg, jp, cfg, _ = _pair(arch)
    tree = jax.tree_util.tree_map(lambda a: np.array(a, np.float32), jp)
    model = M.cast_params(M.params_from_jax(tree, cfg, device="cpu"))
    return jcfg, _cast_jax(jp), cfg, model


def _reference_prefill(jcfg, jp, jbatch, clen, exact):
    """The reference's ``make_prefill_step`` next tokens and its
    ``prefill`` logits and cache, in one program; with ``exact``,
    compiled with XLA's excess precision off."""
    step = JST.make_prefill_step(jcfg, clen)

    def both(params, batch):
        return step(params, batch)[0], JM.prefill(params, jcfg, batch,
                                                  cache_len=clen)
    lowered = jax.jit(both).lower(jp, jbatch)
    opts = {"xla_allow_excess_precision": False} if exact else None
    return lowered.compile(compiler_options=opts)(jp, jbatch)


def _tokens_agree(got, want, logits):
    """Greedy tokens agree wherever the reference's top-2 margin exceeds
    1e-2 of the logit scale (tests/test_torch_models_steps.py's rule)."""
    last = _f32(logits)[:, -1]
    top2 = np.sort(last, axis=-1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > 1e-2 * np.abs(last).max()
    assert clear.any()
    np.testing.assert_array_equal(np.asarray(got)[clear],
                                  np.asarray(want)[clear])


def _batch(cfg, s, rng):
    """(reference batch, port batch, positions the prompt fills)."""
    if cfg.is_encdec:
        frames = rng.normal(size=(2, 24, cfg.d_model)).astype(np.float32)
        toks = rng.integers(0, cfg.vocab_size, (2, s)).astype(np.int32)
        return ({"frames": jnp.asarray(frames),
                 "dec_tokens": jnp.asarray(toks)},
                {"frames": _t(frames), "dec_tokens": _t(toks)}, s)
    toks = rng.integers(0, cfg.vocab_size, (2, s)).astype(np.int32)
    jb, tb = {"tokens": jnp.asarray(toks)}, {"tokens": _t(toks)}
    if cfg.frontend == "vision":
        p = cfg.frontend_tokens
        patches = _bf16(rng.normal(size=(2, p, cfg.d_model)))
        jb["patches"], tb["patches"] = jnp.asarray(patches), _t(patches)
        s += p
    return jb, tb, s


def test_cast_follows_the_reference_rule():
    """Every parameter becomes bfloat16 and holds the reference's cast
    leaf's values; the model's byte count halves."""
    jcfg, jb, cfg, model = _cast_pair("mamba2-370m")
    fresh = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    before = sum(p.numel() * p.element_size() for p in fresh.parameters())
    M.cast_params(fresh)
    after = sum(p.numel() * p.element_size() for p in fresh.parameters())
    assert after * 2 == before
    assert {p.dtype for p in model.parameters()} == {torch.bfloat16}
    got = M.params_to_numpy(model)
    want = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), jb)
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(want)
    for g, w in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(g, w)


def check_prefill(arch):
    """The prefill step (``make_prefill_step``: last logits and greedy
    next tokens) on B 2 x 40 (the VLM's 16 patches in front; the
    enc-dec's 24 frames), and for dense and MoE one decode step after
    it."""
    jcfg, jp, cfg, model = _cast_pair(arch)
    rng = np.random.default_rng(7)
    jbatch, tbatch, s = _batch(cfg, 40, rng)
    clen = s + 1
    jtok, (jl, jc) = _reference_prefill(jcfg, jp, jbatch, clen,
                                        arch in EXACT)
    with torch.no_grad():
        ttok, _ = ST.make_prefill_step(cfg, clen)(model, tbatch)
        tl, tc = M.prefill(model, cfg, tbatch, cache_len=clen)
    _logits_close(tl, jl)
    _tokens_agree(ttok, jtok, jl)
    if arch in DECODE:
        nxt = np.asarray(jtok)[:, None]
        jl, _ = jax.jit(JM.decode_step, static_argnums=(1,))(
            jp, jcfg, jnp.asarray(nxt), jc, s)
        with torch.no_grad():
            tl, _ = M.decode_step(model, cfg, _t(nxt), tc, s)
        _logits_close(tl, jl)


@pytest.mark.parametrize("arch", FAMILIES[:3])
def test_prefill_on_bf16_leaves_matches_reference(arch):
    """Dense, MoE and SSM (the other three families:
    tests/test_torch_bf16_params_families.py)."""
    check_prefill(arch)


def test_ssm_decay_rates_stay_bf16():
    """``A = -exp(A_log)`` of the cast leaf is bfloat16, with the
    reference's bits; the float32 leaf still gives float32."""
    _, jp, _, model = _cast_pair("mamba2-370m")
    mixer = model.layers[0]["block0"].mixer
    a = S._decay_rates(mixer.A_log)
    want = -jnp.exp(jp["layers"]["block0"]["mixer"]["A_log"][0])
    assert a.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_array_equal(_f32(a), _f32(want))
    assert S._decay_rates(mixer.A_log.float()).dtype == torch.float32


@pytest.mark.parametrize("s", [40, 64])
def test_ssm_mixer_on_bf16_leaves_matches_reference(s):
    """``ssm_train`` (a padded chunk at S 40, two chunks at S 64) and one
    ``ssm_decode`` step on the cast leaves: outputs and carried state."""
    jcfg, jp, cfg, model = _cast_pair("mamba2-370m")
    jm = jax.tree_util.tree_map(lambda a: a[0],
                                jp["layers"]["block0"])["mixer"]
    tm = model.layers[0]["block0"].mixer
    rng = np.random.default_rng(s)
    x = _bf16(rng.normal(size=(2, s, cfg.d_model)))
    jy, jst = jax.jit(JS.ssm_train, static_argnums=(1, 3))(
        jm, jcfg, jnp.asarray(x), True)
    with torch.no_grad():
        ty, tst = S.ssm_train(tm, cfg, _t(x), return_state=True)
    _within_scale_ulp(ty, jy)
    for name in ("conv", "ssd"):
        got, want = _f32(tst[name]), _f32(jst[name])
        assert np.abs(got - want).max() <= SSM_STATE_TOL * \
            np.abs(want).max(), name
    x1 = _bf16(rng.normal(size=(2, 1, cfg.d_model)))
    jy, jc = jax.jit(JS.ssm_decode, static_argnums=(1,))(
        jm, jcfg, jnp.asarray(x1), jst)
    with torch.no_grad():
        ty, tc = S.ssm_decode(tm, cfg, _t(x1), tst)
    _within_scale_ulp(ty, jy)
    got, want = _f32(tc["ssd"]), _f32(jc["ssd"])
    assert np.abs(got - want).max() <= SSM_STATE_TOL * np.abs(want).max()
