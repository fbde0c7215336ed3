"""Port parity: serve's page bank from one prefill of the reduced model
(``repro_torch.launch.serve.kv_page_bank``) vs ``repro.launch.serve``,
on the CPU.

With the JAX package's weights (``params_from_jax``) and the port's
token ids on both sides, the port's pages equal the reference's: for
the dense family within one bf16 ulp, or 2e-5 where that ulp is finer
(they are the first attention layer's K and V, computed from the
identical embedding, ``tests/test_torch_models.py``); for MoE
(mixtral, deepseek) and the hybrid (jamba) within 2e-2 of their scale
(``KV_TOL``: deepseek's and jamba's first attention layer is fed the
prefix's or seven SSM blocks' output, not the raw embedding). Enc-dec
and vision take the gaussian branch in both packages, equal draws; an
attention-free model (mamba2) raises in both. The manager only moves
bytes, so ``serve.main``'s statistics with the prefill branch equal a
run on gaussian pages.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.kvcache import TwoTierConfig as JConfig
from repro.launch import serve as jserve
from repro.launch.serve import kv_page_bank as jax_bank
from repro.models import model as JM

from repro_torch import configs
from repro_torch.kvcache import TwoTierConfig, TwoTierKVManager
from repro_torch.launch import serve
from repro_torch.models import model as M
from repro_torch.traces.generators import SessionSpec, generate_sessions
from test_torch_models import KV_TOL


def _kv_cfgs(cfg, page_size=16):
    hkv, d = serve.kv_geometry(cfg)
    kw = dict(page_size=page_size, hbm_pages=16, num_kv_heads=hkv,
              head_dim=d, num_layers=1, dtype="float32")
    return JConfig(**kw), TwoTierConfig(**kw)


_REF_PREFILL = JM.prefill


def _exact_prefill(params, cfg, batch, cache_len=None):
    """The reference's prefill compiled with XLA's excess precision off
    (every bf16 operation rounded as the jaxpr says, as the port does;
    ``tests/test_torch_models_hybrid.py``)."""
    return jax.jit(_REF_PREFILL, static_argnums=(1, 3)).lower(
        params, cfg, batch, cache_len).compile(compiler_options={
            "xla_allow_excess_precision": False})(params, batch)


def _banks(arch, seed, monkeypatch, bank=8, exact=False):
    """The reference's and the port's banks from the same weights and
    token ids. JAX's ``PRNGKey`` token stream cannot be drawn without
    JAX, so the reference's bank is built from the port's token ids
    (uniform from a ``torch.Generator`` seeded ``seed + 1``), handed to
    its ``jax.random.randint`` call; with ``exact``, its prefill is
    :func:`_exact_prefill`."""
    jcfg, cfg = jconfigs.get_reduced(arch), configs.get_reduced(arch)
    jkv, tkv = _kv_cfgs(cfg)
    toks = torch.randint(0, cfg.vocab_size, (1, bank * tkv.page_size),
                         generator=torch.Generator().manual_seed(seed + 1))
    with monkeypatch.context() as m:
        m.setattr(jax.random, "randint", lambda key, shape, lo, hi:
                  jnp.asarray(toks.numpy(), jnp.int32))
        if exact:
            m.setattr(jserve.M, "prefill", _exact_prefill)
        jk, jv = jax_bank(jcfg, jkv, bank, seed)
    tree = jax.tree_util.tree_map(
        lambda a: np.array(a, np.float32),
        JM.init_params(jcfg, jax.random.PRNGKey(seed)))
    tk, tv = serve.kv_page_bank(cfg, tkv, bank, seed,
                                params=M.params_from_jax(tree, cfg, "cpu"))
    for got, want in ((tk, jk), (tv, jv)):
        assert got.dtype == torch.float32
        assert got.shape == want.shape == (bank, 1, tkv.page_size,
                                           *serve.kv_geometry(cfg))
    return ((tk.numpy(), jk), (tv.numpy(), jv))


@pytest.mark.parametrize("arch,seed", [("qwen3-4b", 0), ("phi4-mini-3.8b", 3),
                                       ("nemotron-4-15b", 1)])
def test_prefill_bank_matches_jax(arch, seed, monkeypatch):
    for got, want in _banks(arch, seed, monkeypatch):
        mag = np.maximum(np.abs(want), np.finfo(np.float32).tiny)
        ulp = np.exp2(np.floor(np.log2(mag)) - 7)
        assert np.all(np.abs(got - want) <= np.maximum(ulp, 2e-5))


@pytest.mark.parametrize("arch,seed", [("deepseek-moe-16b", 0),
                                       ("jamba-v0.1-52b", 2)])
def test_family_prefill_bank_matches_jax(arch, seed, monkeypatch):
    """deepseek's bank is its first MoE layer's (superlayer 0, not the
    prefix), jamba's its ``block7``'s, each as the reference picks it.
    The reference's prefill has excess precision off; how far its own
    bank moves with it on is printed (``pytest -rP``)."""
    exact = _banks(arch, seed, monkeypatch, exact=True)
    default = _banks(arch, seed, monkeypatch)
    moves = [float(np.abs(d[1] - e[1]).max() / np.abs(e[1]).max())
             for d, e in zip(default, exact)]
    print(f"{arch}: the reference's K, V bank under its default "
          f"compilation moves by {moves[0]:.4f}, {moves[1]:.4f} of its "
          f"scale")                                     # pytest -rP
    for got, want in exact:
        assert np.abs(got - want).max() <= KV_TOL * np.abs(want).max()


def test_default_bank_is_seeded_and_device_free():
    cfg = configs.get_reduced("qwen3-4b")
    _, tkv = _kv_cfgs(cfg, page_size=8)
    a = serve.kv_page_bank(cfg, tkv, 4, 5, device="cpu")
    b = serve.kv_page_bank(cfg, tkv, 4, 5, device="cpu")
    c = serve.kv_page_bank(cfg, tkv, 4, 6, device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0])
    assert torch.isfinite(a[0]).all() and a[0].abs().max() > 0
    assert not torch.equal(a[0], a[1])               # real K and V
    model = M.init_params(cfg, torch.Generator().manual_seed(5), "cpu")
    d = serve.kv_page_bank(cfg, tkv, 4, 5, params=model)
    assert all(torch.equal(x, y) for x, y in zip(a, d))
    with pytest.raises(ValueError, match="not both"):
        serve.kv_page_bank(cfg, tkv, 4, 5, params=model, device="cpu")


@pytest.mark.parametrize("arch", ["seamless-m4t-large-v2", "mamba2-370m",
                                  "mixtral-8x22b", "internvl2-26b"])
def test_gaussian_branch_matches_jax(arch, monkeypatch):
    """Each package takes the same branch: enc-dec and vision the
    gaussian one, with equal draws; MoE the prefill (mixtral's bank
    equals the reference's within 2e-2 of its scale and is no gaussian
    draw); SSM has no attention cache and raises in both."""
    jcfg, cfg = jconfigs.get_reduced(arch), configs.get_reduced(arch)
    jkv, tkv = _kv_cfgs(cfg)
    want = np.random.default_rng(2).normal(
        size=(8, 1, 16, *serve.kv_geometry(cfg))).astype(np.float32)
    if cfg.attention_free:
        with pytest.raises(AssertionError, match="no attention cache"):
            jax_bank(jcfg, jkv, 8, 2)
        with pytest.raises(AssertionError, match="no attention cache"):
            serve.kv_page_bank(cfg, tkv, 8, 2, device="cpu")
    elif cfg.is_encdec or cfg.frontend == "vision":
        k, v = serve.kv_page_bank(cfg, tkv, 8, 2, device="cpu")
        assert k is v
        np.testing.assert_array_equal(k.numpy(), want)
        jk, _ = jax_bank(jcfg, jkv, 8, 2)
        np.testing.assert_array_equal(k.numpy(), jk)
    else:
        for got, ref in _banks(arch, 2, monkeypatch, exact=True):
            assert np.abs(got - ref).max() <= KV_TOL * np.abs(ref).max()
            assert not np.array_equal(got, want)


def test_serve_main_prefill_stats_equal_a_gaussian_run():
    argv = ["--events", "600", "--live", "20", "--hbm-pages", "16",
            "--decode-every", "6", "--device", "cpu", "--seed", "3"]
    stats = serve.main(argv)
    cfg = configs.get_reduced("qwen3-4b")
    _, tkv = _kv_cfgs(cfg)
    mgr = TwoTierKVManager(tkv, 4, device="cpu")
    trace = generate_sessions(SessionSpec(num_tenants=4, target_live=20,
                                          max_pages=6), 600, seed=3)
    kb, vb = serve.gaussian_pages(tkv, 8, 3)
    serve.run_events(mgr, trace, kb, vb, decode_every=6, seed=3)
    assert stats == mgr.stats.as_dict()
    assert stats["activations"] > 0
