"""Port parity: AdamW, int8 gradient compression, the token pipeline and
the parameter tree, on the CPU.

Given the same numpy parameters, gradients and state, ``apply_updates``,
``schedule``, ``clip_by_global_norm`` and bf16 moments match
``repro.optim`` to float32 ulps of each tensor's largest magnitude
(bf16 moments to one bf16 ulp of theirs): the same operations in the
same order, with two exceptions. XLA:CPU sums each leaf of the global
norm in another order than ``torch.sum`` (several ulps of the norm for
bf16 gradients), so with the clip active every update moves with the
scale: ``CLIP_ULPS`` there, ``ULPS`` with the clip inactive (scale 1 in
both). An element-wise count of ulps would also count the cancellation
in ``b1 * m + (1 - b1) * g`` near zero, hence the tensor's scale.
``-rP`` prints the largest distances. The int8 quantizer and error
feedback (``torch.round`` and ``jnp.round`` both round half to even),
and ``TokenPipeline.batch_at``, match bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.data.pipeline import TokenPipeline as JPipeline
from repro.models import model as JM
from repro import optim as J

from repro_torch import configs
from repro_torch import optim as T
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.models import model as M

SHAPES = {"a_embed": (64, 16), "b_norm": (16,), "c_w": (3, 16, 24),
          "d_bias": (5,)}
ULPS = 4           # float32 ulps of each tensor's largest magnitude
CLIP_ULPS = 64     # the same with the clip active
NORM_ULPS = 16     # the global norm itself


def _ulps(got, want, dtype=torch.float32) -> float:
    """max |got - want| in ulps of ``dtype`` at max |want|."""
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(jnp.asarray(want, jnp.float32), np.float64)
    bits = 23 if dtype == torch.float32 else 7
    unit = 2.0 ** (np.floor(np.log2(max(np.abs(want).max(), 1e-30))) - bits)
    return float(np.abs(got - want).max() / unit)


def _arrays(rng, scale=1.0):
    return {n: (scale * rng.normal(size=s)).astype(np.float32)
            for n, s in SHAPES.items()}


@pytest.mark.parametrize("clip", (0.5, 1e6), ids=("clip", "noclip"))
@pytest.mark.parametrize("moment_dtype,grad_dtype", [
    ("float32", None), ("bfloat16", None), ("float32", "bfloat16")])
def test_apply_updates_matches_reference(moment_dtype, grad_dtype, clip):
    cfg = J.OptConfig(lr=1e-2, warmup_steps=2, total_steps=6, grad_clip=clip,
                      moment_dtype=moment_dtype)
    rng = np.random.default_rng(0)
    params = _arrays(rng)
    jp = {n: jnp.asarray(a) for n, a in params.items()}
    tp = {n: torch.from_numpy(a.copy()) for n, a in params.items()}
    jopt, topt = J.init_opt_state(jp, cfg), T.init_opt_state(tp, cfg)
    worst = worst_m = worst_n = 0.0
    for _ in range(6):
        grads = _arrays(rng, 0.3)
        jg = {n: jnp.asarray(a) for n, a in grads.items()}
        tg = {n: torch.from_numpy(a) for n, a in grads.items()}
        if grad_dtype:
            jg = {n: g.astype(jnp.bfloat16) for n, g in jg.items()}
            tg = {n: g.to(torch.bfloat16) for n, g in tg.items()}
        jp, jopt, js = J.apply_updates(jp, jg, jopt, cfg)
        tp, topt, ts = T.apply_updates(tp, tg, topt, cfg)
        assert int(topt["step"]) == int(jopt["step"])
        assert topt["step"].dtype == torch.int32
        mdt = topt["m"]["a_embed"].dtype
        assert str(mdt) == f"torch.{moment_dtype}"
        for n in SHAPES:
            worst = max(worst, _ulps(tp[n], jp[n]))
            worst_m = max(worst_m, _ulps(topt["m"][n], jopt["m"][n], mdt),
                          _ulps(topt["v"][n], jopt["v"][n], mdt))
        worst_n = max(worst_n, _ulps(ts["grad_norm"], js["grad_norm"]))
        assert _ulps(ts["lr"], js["lr"]) == 0
    print(f"{moment_dtype} moments, {grad_dtype or 'float32'} grads, clip "
          f"{clip}: parameters within {worst} float32 ulps, moments within "
          f"{worst_m} {moment_dtype} ulps, the norm within {worst_n}")
    bound = ULPS if clip > 1 else CLIP_ULPS
    assert worst <= bound and worst_n <= NORM_ULPS
    assert worst_m <= (bound if mdt == torch.float32 else 1)


def test_schedule_matches_reference():
    cfg = J.OptConfig(lr=3e-4, warmup_steps=10, total_steps=100)
    worst = max(_ulps(T.schedule(cfg, torch.tensor(s, dtype=torch.int32)),
                      J.schedule(cfg, jnp.int32(s))) for s in range(0, 120, 3))
    print(f"schedule: largest distance {worst} float32 ulps")
    assert worst <= ULPS
    cfg = T.OptConfig(lr=1.0, warmup_steps=10, total_steps=100,
                      min_lr_ratio=0.1)
    assert float(T.schedule(cfg, torch.tensor(5))) == pytest.approx(0.5)
    assert float(T.schedule(cfg, torch.tensor(100))) == pytest.approx(0.1)


def test_clip_by_global_norm_matches_reference():
    grads = _arrays(np.random.default_rng(1))
    jc, jn = J.clip_by_global_norm({n: jnp.asarray(a)
                                    for n, a in grads.items()}, 1.0)
    tc, tn = T.clip_by_global_norm({n: torch.from_numpy(a)
                                    for n, a in grads.items()}, 1.0)
    assert _ulps(tn, jn) <= NORM_ULPS
    assert max(_ulps(tc[n], jc[n]) for n in grads) <= CLIP_ULPS
    assert float(T.global_norm(tc)) == pytest.approx(1.0, rel=1e-5)


def test_apply_updates_raises_on_a_missing_gradient():
    cfg = T.OptConfig()
    p = {"w": torch.zeros(3), "u": torch.zeros(2)}
    with pytest.raises(ValueError, match="u"):
        T.apply_updates(p, {"w": torch.ones(3), "u": None},
                        T.init_opt_state(p, cfg), cfg)


def test_quadratic_convergence():
    cfg = T.OptConfig(lr=0.1, weight_decay=0.0, warmup_steps=1,
                      total_steps=200)
    params = {"w": torch.tensor([5.0, -3.0])}
    opt = T.init_opt_state(params, cfg)
    for _ in range(150):
        params, opt, _ = T.apply_updates(params, {"w": 2 * params["w"]},
                                         opt, cfg)
    assert float(params["w"].abs().max()) < 0.2


@pytest.mark.parametrize("shape", [(16, 64), (3, 5, 7), (33,), ()])
def test_int8_quantizer_bit_for_bit(shape):
    x = np.asarray(np.random.default_rng(2).normal(size=shape) * 3,
                   np.float32)
    jq, js = J.quantize_int8(jnp.asarray(x))
    tq, ts = T.quantize_int8(torch.from_numpy(x))
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        T.dequantize_int8(tq, ts, shape).numpy(),
        np.asarray(J.dequantize_int8(jq, js, shape)))


def test_int8_rounds_half_to_even():
    # 127 / 127 = 1 a step: halves land exactly between two integers
    x = torch.tensor([[127.0, 0.5, 1.5, 2.5, -0.5, -2.5]])
    q, _ = T.quantize_int8(x)
    assert q.tolist() == [[127, 0, 2, 2, 0, -2]]
    jq, _ = J.quantize_int8(jnp.asarray(x.numpy()))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))


def test_error_feedback_bit_for_bit():
    rng = np.random.default_rng(3)
    first = {n: a * 1e-3 for n, a in _arrays(rng).items()}
    je = J.init_error_buf({n: jnp.asarray(a) for n, a in first.items()})
    te = T.init_error_buf({n: torch.from_numpy(a) for n, a in first.items()})
    for _ in range(5):
        g = {n: a * 1e-3 for n, a in _arrays(rng).items()}
        jd, je = J.ef_compress_update({n: jnp.asarray(a)
                                       for n, a in g.items()}, je)
        td, te = T.ef_compress_update({n: torch.from_numpy(a)
                                       for n, a in g.items()}, te)
        for n in g:
            np.testing.assert_array_equal(td[n].numpy(), np.asarray(jd[n]))
            np.testing.assert_array_equal(te[n].numpy(), np.asarray(je[n]))


@pytest.mark.parametrize("arch", ("qwen3-4b", "internvl2-26b",
                                  "seamless-m4t-large-v2"))
def test_token_pipeline_bit_for_bit(arch):
    for process_index in (0, 1):
        kw = dict(seed=3, process_index=process_index, process_count=2)
        jpipe = JPipeline(jconfigs.get_reduced(arch), 4, 40, **kw)
        tpipe = TokenPipeline(configs.get_reduced(arch), 4, 40, **kw)
        for step in (0, 7, 1000):
            want, got = jpipe.batch_at(step), tpipe.batch_at(step)
            assert want.keys() == got.keys()
            for k in want:
                assert got[k].dtype == want[k].dtype
                np.testing.assert_array_equal(got[k], want[k])


def test_token_pipeline_prefetch_thread():
    p = TokenPipeline(configs.get_reduced("qwen3-4b"), 2, 8, seed=0).start(
        step=5)
    s, batch = p.next()
    assert s == 5 and batch["tokens"].shape == (2, 8)
    np.testing.assert_array_equal(batch["tokens"], p.batch_at(5)["tokens"])
    p.stop()


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_params_to_numpy_inverts_params_from_jax(arch):
    """The reference's pytree back, leaf for leaf and bit for bit, for
    every config (dense, MoE, SSM, hybrid, VLM, enc-dec): its shapes from
    ``jax.eval_shape``, its values random."""
    jcfg = jconfigs.get_reduced(arch)
    rng = np.random.default_rng(4)
    tree = jax.tree_util.tree_map(
        lambda s: rng.normal(size=s.shape).astype(np.float32),
        jax.eval_shape(lambda: JM.init_params(jcfg, jax.random.PRNGKey(0))))
    back = M.params_to_numpy(
        M.params_from_jax(tree, configs.get_reduced(arch), device="cpu"))
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(tree))
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(tree)):
        np.testing.assert_array_equal(a, b)
