"""Port parity: the dense serving model's ring cache, greedy steps and
configuration copies vs ``repro.models``, on the CPU.

The helpers and tolerances are those of ``tests/test_torch_models.py``
(weights carried by ``params_from_jax``; logits within 2e-2 of their
scale; cache K and V as there), which also holds the test of the noise
floor behind them.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch import steps as jsteps
from repro.models import model as JM
from repro.models.config import SHAPES as JSHAPES

from repro_torch import configs
from repro_torch.launch import steps
from repro_torch.models import model as M
from repro_torch.models.config import SHAPES
from test_torch_models import _cache_close, _pair, _t

MARGIN = 1e-2          # of the logit scale; greedy tokens are compared past it


def test_sliding_window_ring_cache():
    """Reduced qwen3 with a 32-token window: decoding against a ring
    cache of window size matches decoding against the full cache (as
    ``tests/test_serving.py`` checks the reference), and the ring
    prefill's rolled cache matches the JAX package's."""
    jcfg, jp, cfg, model = _pair("qwen3-4b", 3, sliding_window=32)
    b, p, extra = 1, 48, 4
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size,
                                            (b, p + extra)).astype(np.int32)
    _, full = M.prefill(model, cfg, {"tokens": _t(toks[:, :p])},
                        cache_len=p + extra)
    _, ring = M.prefill(model, cfg, {"tokens": _t(toks[:, :p])},
                        cache_len=cfg.sliding_window)
    _, jring = JM.prefill(jp, jcfg, {"tokens": jnp.asarray(toks[:, :p])},
                          cache_len=jcfg.sliding_window)
    for kv in ("k", "v"):
        _cache_close(ring["layers"]["block0"][kv],
                     jring["layers"]["block0"][kv])
        # the ring holds the full cache's last window, rolled to p % 32
        want = torch.roll(full["layers"]["block0"][kv][:, :, p - 32:p],
                          p % 32, dims=2)
        assert torch.equal(ring["layers"]["block0"][kv], want)
    for i in range(extra):
        pos = p + i
        lf, full = M.decode_step(model, cfg, _t(toks[:, pos:pos + 1]), full,
                                 pos)
        lr, ring = M.decode_step(model, cfg, _t(toks[:, pos:pos + 1]), ring,
                                 pos)
        scale = float(lf.abs().max()) + 1e-6
        assert float((lf - lr).abs().max()) / scale < 2e-2, i


def test_greedy_steps_match_jax():
    """``make_prefill_step`` then three ``make_decode_step`` steps, each
    package feeding back its own greedy tokens; a token must equal JAX's
    wherever JAX's top-2 margin exceeds 1e-2 of the logit scale (then
    the fed-back tokens agree too)."""
    jcfg, jp, cfg, model = _pair("qwen3-4b", 5)
    s, n = 40, 3
    toks = np.random.default_rng(6).integers(0, cfg.vocab_size,
                                            (8, s)).astype(np.int32)
    jpre = jsteps.make_prefill_step(jcfg, s + n)
    jdec = jsteps.make_decode_step(jcfg)
    tpre = steps.make_prefill_step(cfg, s + n)
    tdec = steps.make_decode_step(cfg)
    jt, jc = jpre(jp, {"tokens": jnp.asarray(toks)})
    tt, tc = tpre(model, {"tokens": _t(toks)})
    jl, _ = JM.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)})
    checked = 0
    for i in range(n + 1):
        assert tt.dtype == torch.int32
        jl = np.asarray(jl)[:, -1]
        top2 = np.sort(jl, axis=-1)[:, -2:]
        sure = (top2[:, 1] - top2[:, 0]) > MARGIN * np.abs(jl).max()
        np.testing.assert_array_equal(tt.reshape(-1).numpy()[sure],
                                      np.asarray(jt).reshape(-1)[sure])
        checked += int(sure.sum())
        if not sure.all() or i == n:
            break
        jcache_before = jc
        jt, jc = jdec(jp, jc, jnp.asarray(jt).reshape(-1, 1), s + i)
        tt, tc = tdec(model, tc, tt.reshape(-1, 1), s + i)
        jl, _ = JM.decode_step(jp, jcfg, jnp.asarray(np.asarray(
            jl.argmax(-1), np.int32)).reshape(-1, 1), jcache_before, s + i)
    assert checked >= 4


def test_cache_len_for():
    full = configs.get_reduced("qwen3-4b")
    jfull = jconfigs.get_reduced("qwen3-4b")
    for over in ({}, dict(sliding_window=32)):
        cfg = dataclasses.replace(full, **over)
        jcfg = dataclasses.replace(jfull, **over)
        for name, shape in SHAPES.items():
            assert steps.cache_len_for(cfg, shape) == \
                jsteps.cache_len_for(jcfg, JSHAPES[name])


def test_configs_are_the_reference_configs():
    assert configs.ARCH_IDS == jconfigs.ARCH_IDS
    for arch in configs.ARCH_IDS:
        for get, jget in ((configs.get, jconfigs.get),
                          (configs.get_reduced, jconfigs.get_reduced)):
            c, j = get(arch), jget(arch)
            assert dataclasses.asdict(c) == dataclasses.asdict(j), arch
            assert c.param_counts() == j.param_counts()
            assert [dataclasses.asdict(b) for b in c.layer_pattern()] == \
                [dataclasses.asdict(b) for b in j.layer_pattern()]


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_every_config_initialises(arch):
    """Every config in ``configs/`` builds in the port: the reduced one
    with weights drawn on the CPU (finite, float32, no gradient), the
    full one on the meta device (shapes only). Each parameter count
    equals the number of elements in the JAX package's tree
    (``jax.eval_shape`` of its ``init_params``, nothing allocated)."""
    for get, jget in ((configs.get_reduced, jconfigs.get_reduced),
                      (configs.get, jconfigs.get)):
        cfg, jcfg = get(arch), jget(arch)
        want = sum(int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(
            jax.eval_shape(lambda k: JM.init_params(jcfg, k),
                           jax.random.PRNGKey(0))))
        if get is configs.get_reduced:
            model = M.init_params(cfg, torch.Generator().manual_seed(0),
                                  device="cpu")
            assert all(torch.isfinite(p).all() and not p.requires_grad
                       and p.dtype == torch.float32
                       for p in model.parameters())
        else:
            model = M.Model(cfg, None, torch.device("meta"))
        assert sum(p.numel() for p in model.parameters()) == want, arch


def test_init_params_shapes_and_count():
    cfg = configs.get_reduced("qwen3-4b")
    model = M.init_params(cfg, torch.Generator().manual_seed(0),
                          device="cpu")
    n = sum(p.numel() for p in model.parameters())
    assert n == cfg.param_counts()[0] + 2 * cfg.d_model * cfg.num_layers \
        + cfg.d_model + 2 * cfg.head_dim * cfg.num_layers
    w = model.layers[0]["block0"].mixer.wq
    assert w.shape == (cfg.d_model, cfg.num_heads * cfg.head_dim)
    assert float(w.abs().max()) <= 2 * cfg.d_model ** -0.5
    assert not any(p.requires_grad for p in model.parameters())
    again = M.init_params(cfg, torch.Generator().manual_seed(0),
                          device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(model.parameters(),
                                                 again.parameters()))
