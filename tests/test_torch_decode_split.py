"""The split plan and split-and-merge arithmetic of the paged decode kernel
(``src/repro_torch/csrc/decode_attention.cu``), on the CPU.

The kernel runs only on a card (``tests/test_torch_cuda.py`` holds it to
its plain version there). Here its plan is checked from shapes alone,
and its arithmetic is transcribed in float32 torch: each (sequence, KV
head) split into the plan's CTAs, each CTA's page range worked out from
the row's length, the range staged ``step`` tokens at a time, token ``t``
of a step scored by token group ``t % tg`` with its own online softmax
(q scaled first, the step's max, ``alpha = exp(m_prev - m_new)``, ``p @
V`` in float32), the groups' states merged in group order and the
splits' in split order by rescaling to their common max, and ``acc /
max(l, 1e-30)``. The
transcription must equal the JAX oracle ``paged_decode_ref`` within the
JAX test's ``atol=2e-5``, on the card tests' cases: a row of 4,096
tokens among rows of 1, lengths on a page boundary and one past it,
lengths past the table, length 0 under a split table, G 1, 4 and 16, D
64, 128 and 256, PS 8, 16 and 64. A wrong neutral partial or merge order
shows here without a card.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention.ref import paged_decode_ref

from repro_torch.kernels.decode_attention import ops

ATOL = 2e-5
H100_SMS = 132
SOURCE = (Path(__file__).resolve().parents[1]
          / "src/repro_torch/csrc/decode_attention.cu")


def _constant(name: str) -> int:
    m = re.search(rf"constexpr \w+ {name} = (\d+)", SOURCE.read_text())
    return int(m.group(1))


def test_plan_constants_match_the_kernel():
    """The wrapper plans with the kernel's own limits."""
    assert _constant("kVec") == ops.VEC
    assert _constant("kStageBytes") == ops.STAGE_BYTES
    assert _constant("kMaxTok") == ops.MAX_TOK
    assert _constant("kMaxSplits") == ops.MAX_SPLITS
    assert _constant("kMaxGroups") == ops.MAX_GROUPS
    assert _constant("kMaxStep") == ops.MAX_STEP
    assert _constant("kMaxLanes") * ops.VEC == ops.MAX_HEAD_DIM


PLAN_SHAPES = [  # b, hkv, groups, d, ps, n_pages, itemsize
    (1, 8, 1, 128, 16, 6, 2),          # the serving path
    (64, 8, 4, 128, 16, 256, 2),       # qwen3-4b batched decode
    (4, 2, 4, 128, 16, 256, 2), (3, 2, 16, 64, 8, 512, 4),
    (2, 1, 1, 256, 64, 64, 4), (5, 4, 4, 32, 64, 3, 2),
    (1, 1, 16, 256, 16, 300, 2), (2, 3, 3, 40, 16, 20, 4)]


@pytest.mark.parametrize("b,hkv,groups,d,ps,n_pages,item", PLAN_SHAPES)
def test_plan_is_within_the_kernel_limits(b, hkv, groups, d, ps, n_pages,
                                          item):
    p = ops.decode_plan(b, hkv, groups, d, ps, n_pages, item, H100_SMS)
    assert p.lanes & (p.lanes - 1) == 0 and p.lanes * ops.VEC >= d
    assert p.lanes <= 32 and p.threads % 32 == 0 and p.threads <= 512
    assert p.threads >= p.lanes * groups * p.tg
    assert 2 * p.step * p.lanes * ops.VEC * item <= ops.STAGE_BYTES
    assert -(-p.step // p.tg) <= ops.MAX_TOK and p.step <= ops.MAX_STEP
    assert -(-p.step // p.threads) <= _constant("kRowsAThread")
    assert 1 <= p.splits <= ops.MAX_SPLITS
    assert p.async_copy == (d * item % 16 == 0)


def test_plan_splits_where_it_pays():
    """One CTA a (sequence, KV head) at the serving shape; the batched
    qwen3-4b shape and a lone long row are split."""
    assert ops.decode_plan(1, 8, 1, 128, 16, 6, 2, H100_SMS).splits == 1
    assert ops.decode_plan(64, 8, 4, 128, 16, 256, 2, H100_SMS).splits > 1
    assert ops.decode_plan(1, 8, 4, 128, 16, 256, 2, H100_SMS).splits == 8


@pytest.mark.parametrize("b,hkv,groups,d,ps,n_pages,item", PLAN_SHAPES)
def test_split_ranges_cover_each_row_once_in_order(b, hkv, groups, d, ps,
                                                   n_pages, item):
    splits = ops.decode_plan(b, hkv, groups, d, ps, n_pages, item,
                             H100_SMS).splits
    slots = n_pages * ps
    for length in [-3, 0, 1, ps - 1, ps, ps + 1, slots - 1, slots,
                   slots + 1, 10 * slots, *range(1, slots + 2, 7)]:
        n_visit = ops.visit_pages(length, ps, n_pages)
        if length <= 0 or length >= slots:
            assert n_visit == n_pages
        else:
            assert (n_visit - 1) * ps < length <= n_visit * ps
        pages = []
        for sp in range(splits):
            p0, p1 = ops.split_range(n_visit, sp, splits)
            assert p0 <= p1
            pages += range(p0, p1)
        assert pages == list(range(n_visit))


def transcribe(q, kp, vp, pt, lengths, plan):
    """The kernel's arithmetic in float32 torch (see the module doc).
    Returns float32."""
    b, h, d = q.shape
    pool, ps, hkv, _ = kp.shape
    n_pages = pt.shape[1]
    groups = h // hkv
    neg = torch.tensor(ops.NEG_INF, dtype=torch.float32)
    idx = pt.long()
    idx = torch.where(idx < 0, idx + pool, idx).clamp(0, pool - 1)
    scale = torch.tensor(d ** -0.5, dtype=torch.float32)
    qs = q.float().reshape(b, hkv, groups, d) * scale
    out = torch.empty(b, hkv, groups, d)
    for bi in range(b):
        length = int(lengths[bi])
        n_visit = ops.visit_pages(length, ps, n_pages)
        for hi in range(hkv):
            parts = []
            for sp in range(plan.splits):
                p0, p1 = ops.split_range(n_visit, sp, plan.splits)
                m = torch.full((plan.tg, groups), ops.NEG_INF)
                lsum = torch.zeros(plan.tg, groups)
                acc = torch.zeros(plan.tg, groups, d)
                for tok0 in range(p0 * ps, p1 * ps, plan.step):
                    toks = torch.arange(tok0, min(tok0 + plan.step, p1 * ps))
                    rows = idx[bi, toks // ps] * ps + toks % ps
                    k = kp.reshape(-1, hkv, d)[rows, hi].float()
                    v = vp.reshape(-1, hkv, d)[rows, hi].float()
                    s = qs[bi, hi] @ k.T                     # [G, n]
                    s = torch.where(toks[None, :] < length, s, neg)
                    for g in range(plan.tg):
                        sel = torch.arange(g, len(toks), plan.tg)
                        if not len(sel):
                            continue
                        sg = s[:, sel]
                        m_new = torch.maximum(m[g], sg.max(dim=1).values)
                        alpha = torch.exp(m[g] - m_new)
                        p = torch.exp(sg - m_new[:, None])
                        lsum[g] = lsum[g] * alpha + p.sum(dim=1)
                        acc[g] = acc[g] * alpha[:, None] + p @ v[sel]
                        m[g] = m_new
                mx = m.max(dim=0).values                     # group order
                w = torch.exp(m - mx)
                parts.append((mx, (lsum * w).sum(dim=0),
                              (acc * w[:, :, None]).sum(dim=0)))
            mx = torch.stack([p[0] for p in parts]).max(dim=0).values
            ls = torch.zeros(groups)
            a = torch.zeros(groups, d)
            for pm, pl, pa in parts:                         # split order
                w = torch.exp(pm - mx)
                ls = ls + pl * w
                a = a + pa * w[:, None]
            out[bi, hi] = a / ls.clamp(min=1e-30)[:, None]
    return out.reshape(b, h, d)


CASES = {  # b, h, hkv, d, pool, ps, n_pages, lengths
    "long row among rows of 1": (4, 8, 2, 128, 300, 16, 256,
                                 [4096, 1, 1, 1]),
    "page boundary and one past": (3, 16, 4, 64, 100, 8, 80,
                                   [64, 65, 8]),
    "later splits past the length": (2, 4, 1, 128, 80, 16, 64, [20, 17]),
    "lengths past the table": (2, 4, 4, 32, 40, 64, 12, [2000, 769]),
    "length 0 under a split table": (3, 16, 1, 256, 50, 16, 48,
                                     [0, 700, -5]),
    "G 16, D 64": (2, 32, 2, 64, 80, 16, 40, [640, 33]),
    "the serving shape": (1, 8, 8, 128, 64, 16, 6, [96]),
}


DTYPES = {  # q, pages
    "float32": (torch.float32, torch.float32),
    "bf16 pages": (torch.float32, torch.bfloat16),
    "bf16": (torch.bfloat16, torch.bfloat16),
}


@pytest.mark.parametrize("dtypes", list(DTYPES))
@pytest.mark.parametrize("case", list(CASES))
def test_transcription_equals_jax_reference(case, dtypes):
    """float32 results (before the cast to q's dtype) within 2e-5 of the
    reference on the same (bf16-valued where bf16) inputs, over the plan
    each pool's item size gives."""
    b, h, hkv, d, pool, ps, n_pages, lengths = CASES[case]
    q_dtype, pool_dtype = DTYPES[dtypes]
    rng = np.random.default_rng(len(case))
    q = torch.from_numpy(rng.normal(size=(b, h, d)).astype(np.float32))
    kp = rng.normal(size=(pool, ps, hkv, d)).astype(np.float32)
    vp = rng.normal(size=(pool, ps, hkv, d)).astype(np.float32)
    pt = rng.integers(-pool - 2, pool + 2, (b, n_pages)).astype(np.int32)
    ln = np.asarray(lengths, np.int32)
    q = q.to(q_dtype)
    kt = torch.from_numpy(kp).to(pool_dtype)
    vt = torch.from_numpy(vp).to(pool_dtype)
    item = kt.element_size()
    plan = ops.decode_plan(b, hkv, h // hkv, d, ps, n_pages, item, H100_SMS)
    got = transcribe(q, kt, vt, torch.from_numpy(pt), torch.from_numpy(ln),
                     plan)
    # the reference gathers page ids as the kernel reads them
    pj = np.where(pt < 0, pt + pool, pt).clip(0, pool - 1)
    want = np.asarray(paged_decode_ref(
        jnp.asarray(q.float().numpy()), jnp.asarray(kt.float().numpy()),
        jnp.asarray(vt.float().numpy()), jnp.asarray(pj), jnp.asarray(ln)))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    if case != "the serving shape":
        assert plan.splits > 1, plan


@pytest.mark.parametrize("item", [4, 2])
def test_transcription_all_masked_row_is_the_mean_of_v(item):
    """Length 0 under a split: every split's partial is all-masked, so
    the merge must weigh them equally (exp(0)), and empty splits not at
    all; the result is the mean of V over every slot of the table."""
    b, h, hkv, d, pool, ps, n_pages = 1, 4, 4, 64, 40, 16, 40
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.normal(size=(b, h, d)).astype(np.float32))
    kp = torch.from_numpy(rng.normal(size=(pool, ps, hkv, d)).astype(
        np.float32))
    vp = torch.from_numpy(rng.normal(size=(pool, ps, hkv, d)).astype(
        np.float32))
    pt = torch.from_numpy(rng.permutation(pool)[:n_pages][None].astype(
        np.int32))
    plan = ops.decode_plan(b, hkv, 1, d, ps, n_pages, item, H100_SMS)
    assert plan.splits > 1
    got = transcribe(q, kp, vp, pt, torch.tensor([0], dtype=torch.int32),
                     plan)
    mean_v = vp[pt[0].long()].reshape(-1, hkv, d).mean(0)
    np.testing.assert_allclose(got[0].numpy(), mean_v.numpy(), atol=ATOL)
