"""Port parity: serve's page bank from one prefill of the reduced model
(``repro_torch.launch.serve.kv_page_bank``) vs ``repro.launch.serve``,
on the CPU.

With the JAX package's weights (``params_from_jax``) and the port's
token ids on both sides, the port's pages equal the reference's within
one bf16 ulp, or 2e-5 where that ulp is finer: they are the first
attention layer's K and V, computed from the identical embedding
(``tests/test_torch_models.py``). Families
the port does not serve yet take the gaussian branch, equal to the
reference's draws. The manager only moves bytes, so ``serve.main``'s
statistics with the prefill branch equal a run on gaussian pages.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.kvcache import TwoTierConfig as JConfig
from repro.launch.serve import kv_page_bank as jax_bank
from repro.models import model as JM

from repro_torch import configs
from repro_torch.kvcache import TwoTierConfig, TwoTierKVManager
from repro_torch.launch import serve
from repro_torch.models import model as M
from repro_torch.traces.generators import SessionSpec, generate_sessions


def _kv_cfgs(cfg, page_size=16):
    hkv, d = serve.kv_geometry(cfg)
    kw = dict(page_size=page_size, hbm_pages=16, num_kv_heads=hkv,
              head_dim=d, num_layers=1, dtype="float32")
    return JConfig(**kw), TwoTierConfig(**kw)


@pytest.mark.parametrize("arch,seed", [("qwen3-4b", 0), ("phi4-mini-3.8b", 3),
                                       ("nemotron-4-15b", 1)])
def test_prefill_bank_matches_jax(arch, seed, monkeypatch):
    """JAX's ``PRNGKey`` token stream cannot be drawn without JAX, so the
    reference's bank is built here from the port's token ids (uniform
    from a ``torch.Generator`` seeded ``seed + 1``), handed to its
    ``jax.random.randint`` call."""
    jcfg, cfg = jconfigs.get_reduced(arch), configs.get_reduced(arch)
    jkv, tkv = _kv_cfgs(cfg)
    bank, ps = 8, tkv.page_size
    toks = torch.randint(0, cfg.vocab_size, (1, bank * ps),
                         generator=torch.Generator().manual_seed(seed + 1))
    with monkeypatch.context() as m:
        m.setattr(jax.random, "randint", lambda key, shape, lo, hi:
                  jnp.asarray(toks.numpy(), jnp.int32))
        jk, jv = jax_bank(jcfg, jkv, bank, seed)
    tree = jax.tree_util.tree_map(
        lambda a: np.array(a, np.float32),
        JM.init_params(jcfg, jax.random.PRNGKey(seed)))
    tk, tv = serve.kv_page_bank(cfg, tkv, bank, seed,
                                params=M.params_from_jax(tree, cfg, "cpu"))
    for got, want in ((tk, jk), (tv, jv)):
        assert got.dtype == torch.float32
        assert got.shape == want.shape == (bank, 1, ps, *serve.kv_geometry(
            cfg))
        mag = np.maximum(np.abs(want), np.finfo(np.float32).tiny)
        ulp = np.exp2(np.floor(np.log2(mag)) - 7)
        assert np.all(np.abs(got.numpy() - want) <= np.maximum(ulp, 2e-5))


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
                                  "mixtral-8x22b"])
def test_gaussian_branch_matches_jax(arch):
    """enc-dec takes the gaussian branch in both packages; SSM and MoE
    in the port only (the page contents, not the statistics, differ
    from the reference there)."""
    jcfg, cfg = jconfigs.get_reduced(arch), configs.get_reduced(arch)
    jkv, tkv = _kv_cfgs(cfg)
    k, v = serve.kv_page_bank(cfg, tkv, 8, 2, device="cpu")
    assert k is v
    want = np.random.default_rng(2).normal(
        size=(8, 1, 16, *serve.kv_geometry(cfg))).astype(np.float32)
    np.testing.assert_array_equal(k.numpy(), want)
    if jcfg.is_encdec:
        jk, _ = jax_bank(jcfg, jkv, 8, 2)
        np.testing.assert_array_equal(k.numpy(), jk)


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
