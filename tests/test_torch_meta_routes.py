"""The ``meta`` routes that let the dry-run trace a step without data:
the attention kernels' wrappers on ``meta`` tensors, the MoE's
fixed-length expert count, ``_xla_math`` on ``meta``, and every config's
reduced train step under ``torch.utils.flop_counter.FlopCounterMode``.

Each wrapper on ``meta`` returns outputs of the right shapes and dtypes
and registers the kernel's FLOPs (forward: 4 per kept (row, key) pair
and head dim; backward: 10; paged decode: 4 per table slot); on the CPU
the wrappers still take their plain versions, bit for bit. The card
route's launches are checked in ``tests/test_torch_cuda.py``.
"""
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import _xla_math, configs
from repro_torch.kernels.decode_attention import ops as dops
from repro_torch.kernels.flash_attention import ops as fops
from repro_torch.launch import steps as ST
from repro_torch.models import moe
from repro_torch.models.config import ShapeSpec
from repro_torch.optim import OptConfig

META = torch.device("meta")


def _counted(fn):
    with FlopCounterMode(display=False) as fc:
        out = fn()
    return out, {str(k): v for k, v in
                 fc.get_flop_counts().get("Global", {}).items()}


def _qkv(b, h, hkv, sq, skv, d, dtype, device=META):
    return (torch.empty(b, h, sq, d, dtype=dtype, device=device),
            torch.empty(b, hkv, skv, d, dtype=dtype, device=device),
            torch.empty(b, hkv, skv, d, dtype=dtype, device=device))


@pytest.mark.parametrize("sq,skv,causal,window,q_offset", [
    (7, 7, True, 0, 0), (8, 16, True, 0, 8), (16, 16, True, 5, 0),
    (6, 10, False, 0, 0), (9, 12, False, 4, 3), (1, 20, True, 0, 19)])
def test_kept_pairs_counts_the_mask(sq, skv, causal, window, q_offset):
    want = int(fops._mask(sq, skv, causal=causal, window=window,
                          q_offset=q_offset).sum())
    assert fops.kept_pairs(sq, skv, causal=causal, window=window,
                           q_offset=q_offset) == want


@pytest.mark.parametrize("dtype,d,stats", [(torch.bfloat16, 64, True),
                                           (torch.float32, 64, False),
                                           (torch.bfloat16, 40, False)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_meta_route(dtype, d, stats, causal):
    b, h, hkv, s = 2, 8, 2, 256
    q, k, v = _qkv(b, h, hkv, s, s, d, dtype)
    (out, st), counts = _counted(lambda: fops.flash_attention(
        q, k, v, causal=causal, return_stats=True))
    assert out.device == META and out.shape == q.shape
    assert out.dtype == dtype
    if stats:       # the wgmma route's statistics
        assert st.shape == (2, b, h, s) and st.dtype == torch.float32
    else:
        assert st is None
    pairs = s * (s + 1) // 2 if causal else s * s
    assert counts == {"repro_torch.flash_attention": 4 * b * h * d * pairs}
    assert fops.flash_attention(q, k, v, causal=causal).shape == q.shape
    grads, counts = _counted(lambda: fops.flash_attention_bwd(
        q, k, v, out, out, causal=causal))
    assert [g.shape for g in grads] == [q.shape, k.shape, v.shape]
    assert all(g.dtype == dtype and g.device == META for g in grads)
    assert counts == {"repro_torch.flash_attention_bwd":
                      10 * b * h * d * pairs}


def test_flash_attention_meta_autograd_and_window():
    """The model's ``attention`` (the autograd Function) forward and
    backward on ``meta``: one forward and one backward, each counted,
    with a sliding window and a query offset."""
    b, h, hkv, sq, skv, d = 1, 4, 2, 64, 128, 32
    q = torch.empty(b, sq, h, d, dtype=torch.bfloat16, device=META,
                    requires_grad=True)
    k = torch.empty(b, skv, hkv, d, dtype=torch.bfloat16, device=META,
                    requires_grad=True)
    v = torch.empty_like(k, requires_grad=True)

    def step():
        out = fops.attention(q, k, v, causal=True, window=16, q_offset=64)
        out.float().sum().backward()
        return out
    out, counts = _counted(step)
    assert out.shape == q.shape and q.grad.shape == q.shape
    assert k.grad.shape == k.shape and v.grad.dtype == torch.bfloat16
    pairs = fops.kept_pairs(sq, skv, causal=True, window=16, q_offset=64)
    assert pairs == sq * 16
    assert counts["repro_torch.flash_attention"] == 4 * b * h * d * pairs
    assert counts["repro_torch.flash_attention_bwd"] == 10 * b * h * d * pairs


def test_flash_attention_cpu_route_unchanged():
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((1, 4, 32, 16), (1, 2, 32, 16), (1, 2, 32, 16)))
    got = fops.flash_attention(q, k, v, causal=True)
    assert torch.equal(got, fops.flash_attention_plain(q, k, v, causal=True))
    do = torch.from_numpy(rng.standard_normal((1, 4, 32, 16))
                          .astype(np.float32))
    for a, b in zip(fops.flash_attention_bwd(q, k, v, got, do),
                    fops.flash_attention_bwd_plain(q, k, v, got, do)):
        assert torch.equal(a, b)
    with pytest.raises(RuntimeError):      # the custom op runs on meta only
        torch.ops.repro_torch.flash_attention(q, k, v, True, 0, 0)


def test_paged_decode_meta_route():
    b, h, hkv, d, pool, ps, n_pages = 3, 8, 2, 64, 10, 16, 4
    q = torch.empty(b, h, d, dtype=torch.float32, device=META)
    kp = torch.empty(pool, ps, hkv, d, dtype=torch.bfloat16, device=META)
    table = torch.empty(b, n_pages, dtype=torch.int32, device=META)
    lens = torch.empty(b, dtype=torch.int32, device=META)
    out, counts = _counted(lambda: dops.paged_decode_attention(
        q, kp, kp, table, lens))
    assert out.shape == q.shape and out.dtype == q.dtype
    assert out.device == META
    assert counts == {"repro_torch.paged_decode_attention":
                      4 * b * h * d * n_pages * ps}


def test_expert_counts_equal_bincount():
    """The fixed-length count the MoE uses in place of ``bincount``:
    the same int64 counts, and a shape that ``meta`` can trace."""
    rng = np.random.default_rng(3)
    for e, n in ((4, 0), (8, 100), (64, 4096), (3, 7)):
        ids = torch.from_numpy(rng.integers(0, e, n))
        got = moe._expert_counts(ids, e)
        want = torch.bincount(ids, minlength=e)
        assert got.dtype == want.dtype and torch.equal(got, want)
        strided = torch.from_numpy(rng.integers(0, e, (n, 2)))[:, 0]
        assert torch.equal(moe._expert_counts(strided, e),
                           torch.bincount(strided, minlength=e))
    m = moe._expert_counts(torch.empty(50, dtype=torch.int64, device=META), 6)
    assert m.shape == (6,) and m.device == META


def test_xla_math_on_meta():
    x = torch.empty(4, 70, device=META, requires_grad=True)
    assert _xla_math.exp_xla_f32(x).shape == x.shape
    assert _xla_math.sum_rows_f32(x).shape == (4,)
    assert _xla_math.sum_f32(x.reshape(-1)).shape == ()
    y = _xla_math.cumsum_f32(x, 1)
    assert y.shape == x.shape and y.dtype == torch.float32
    y.sum().backward()
    assert x.grad.shape == x.shape


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_reduced_train_step_traces_on_meta(arch):
    """Every config's reduced train step on ``meta`` under the FLOP
    counter: matrix products and, where the config attends, both
    attention kernels are counted; nothing is allocated."""
    cfg = configs.get_reduced(arch)
    specs = ST.input_specs(cfg, ShapeSpec("t", 64, 2, "train"))
    step = ST.make_train_step(cfg, OptConfig())
    (params, opt, metrics), counts = _counted(lambda: step(
        specs["params"], specs["opt_state"], specs["batch"]))
    assert metrics["loss"].device == META
    assert all(p.device == META for p in params.parameters())
    assert counts.get("aten.mm", 0) > 0
    attends = not cfg.attention_free
    assert ("repro_torch.flash_attention_bwd" in counts) == attends
