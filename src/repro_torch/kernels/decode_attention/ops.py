"""Paged decode attention over the two-tier KV pool: the kernel's wrapper
and its plain PyTorch version.

``q`` is ``[B, H, D]``; ``k_pages``/``v_pages`` are the pool ``[NP, PS,
Hkv, D]``; ``page_table`` int32 ``[B, n_pages]`` names the pool page of
each logical page (an id outside ``[0, NP)`` reads as JAX's gather reads
it: negative from the end of the pool, then clamped into it);
``lengths`` int32 ``[B]`` counts each sequence's valid tokens. Query head ``h`` reads KV head ``h // (H / Hkv)``. q and the
pages are float32 or bfloat16; the output is ``[B, H, D]`` in q's dtype.

CUDA tensors go through the ``paged_decode_attention`` kernel
(``csrc/decode_attention.cu``), which reads each page through the page
table itself; CPU tensors through :func:`paged_decode_attention_plain`,
a direct transcription of ``repro.kernels.decode_attention.ref``. The
wrapper checks operands and plans the launch (:func:`launch_plan`) from
shapes and pointers alone, without reading ``lengths`` or the page table
on the host, so a call never waits for the device. Tensors on the
``meta`` device (shapes without data) get an empty output from the
custom op ``repro_torch::paged_decode_attention``, which has no kernel
for any other device and registers the FLOPs of a full table with
``torch.utils.flop_counter`` (4 per slot, query head and head dim: the
lengths are data, so every slot of the table counts).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch import kernels

NEG_INF = -1e30
VEC = 8                # head_dim values a kernel thread holds
MAX_HEAD_DIM = 256     # VEC x 32 lanes
MAX_GROUPS = 16        # query heads per KV head
STAGE_BYTES = 32768    # one step's K and V rows in shared memory
MAX_TOK = 16           # tokens a thread scores in one step
MAX_STEP = 256         # tokens a step
CTA_THREADS = 256      # threads of a CTA, when one token group fits
MAX_SPLITS = 8         # CTAs of a (sequence, KV head): a portable cluster
SPLIT_TOKENS = 256     # table slots a split takes, at least
SPLIT_CTAS = 4         # CTAs an SM to aim for when splitting
_DTYPES = (torch.float32, torch.bfloat16)


def _next_pow2(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


class DecodePlan(NamedTuple):
    """How ``csrc/decode_attention.cu`` covers one call: ``lanes``
    threads hold a head row (VEC values each), ``tg`` groups of ``lanes *
    groups`` threads take a step's ``step`` tokens in turn (token ``t`` of
    a step goes to group ``t % tg``), ``threads`` a CTA; ``splits`` CTAs
    a (sequence, KV head), each taking a share of the row's pages
    (:func:`split_range`); ``async_copy``: K and V rows staged by 16-byte
    ``cp.async``, else element by element."""
    lanes: int
    tg: int
    threads: int
    step: int
    splits: int
    async_copy: bool


def decode_plan(b: int, hkv: int, groups: int, d: int, ps: int,
                n_pages: int, kv_itemsize: int, sms: int) -> DecodePlan:
    """The launch plan, from shapes alone. Rows are split while the
    (B, Hkv) pairs leave SMs short of ``SPLIT_CTAS`` CTAs each, into at
    most ``MAX_SPLITS`` shares of at least ``SPLIT_TOKENS`` table slots; a
    table shorter than that (the serving path's 6 pages of 16) takes one
    CTA, where a split would only add the merge. Rows of a multiple of 16
    bytes are staged by ``cp.async``."""
    want = -(-(SPLIT_CTAS * sms) // max(b * hkv, 1))
    splits = max(1, min(MAX_SPLITS, want, n_pages * ps // SPLIT_TOKENS))
    lanes = min(32, _next_pow2(-(-d // VEC)))
    tg = max(1, CTA_THREADS // (lanes * groups))
    threads = -(-(lanes * groups * tg) // 32) * 32
    step = min(STAGE_BYTES // (2 * lanes * VEC * kv_itemsize), tg * MAX_TOK,
               MAX_STEP)
    return DecodePlan(lanes, tg, threads, step, splits,
                      d * kv_itemsize % 16 == 0)


def launch_plan(q, k_pages, v_pages, page_table) -> DecodePlan:
    """The plan the wrapper launches with on these operands:
    :func:`decode_plan` of their shapes, staged by ``cp.async`` only where
    both pools start on 16 bytes."""
    b, h, d = q.shape
    _, ps, hkv, _ = k_pages.shape
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    plan = decode_plan(b, hkv, h // hkv, d, ps, page_table.shape[1],
                       k_pages.element_size(), sms)
    aligned = k_pages.data_ptr() % 16 == 0 and v_pages.data_ptr() % 16 == 0
    return plan._replace(async_copy=plan.async_copy and aligned)


def visit_pages(length: int, ps: int, n_pages: int) -> int:
    """Pages a row's CTAs read: those holding its first ``length``
    tokens, or every page of the table when ``length <= 0`` (all scores
    masked: the mean of V over every slot)."""
    if length <= 0:
        return n_pages
    return min(n_pages, -(-length // ps))


def split_range(n_visit: int, split: int, splits: int) -> tuple[int, int]:
    """Pages ``[p0, p1)`` that CTA ``split`` of ``splits`` reads of a
    row that needs ``n_visit`` pages (as the kernel computes it on the
    device from the row's length); empty past the row's share."""
    per = -(-n_visit // splits)
    p0 = min(split * per, n_visit)
    return p0, min(p0 + per, n_visit)


@torch.library.custom_op("repro_torch::paged_decode_attention",
                         mutates_args=())
def _meta_decode(q: torch.Tensor, k_pages: torch.Tensor,
                 v_pages: torch.Tensor, page_table: torch.Tensor,
                 lengths: torch.Tensor) -> torch.Tensor:
    raise RuntimeError("repro_torch::paged_decode_attention runs on meta "
                       "tensors only: use paged_decode_attention()")


@_meta_decode.register_fake
def _(q, k_pages, v_pages, page_table, lengths):
    return torch.empty_like(q)


@register_flop_formula(torch.ops.repro_torch.paged_decode_attention)
def _decode_flops(q, k_pages, v_pages, page_table, lengths, *,
                  out_shape=None, **kwargs) -> int:
    b, h, d = q
    return 4 * b * h * d * page_table[1] * k_pages[1]


def paged_decode_attention(q, k_pages, v_pages, page_table, lengths):
    if q.device.type == "cpu":
        return paged_decode_attention_plain(q, k_pages, v_pages, page_table,
                                            lengths)
    if q.device.type == "meta":
        return torch.ops.repro_torch.paged_decode_attention(
            q, k_pages, v_pages, page_table, lengths)
    dev = q.device
    b, h, d = q.shape
    pool, ps, hkv, _ = k_pages.shape
    n_pages = page_table.shape[1]
    if q.dtype not in _DTYPES or k_pages.dtype not in _DTYPES:
        raise TypeError(f"q {q.dtype} and pages {k_pages.dtype} must be "
                        "float32 or bfloat16")
    if hkv == 0 or h % hkv:
        raise ValueError(f"{h} query heads do not group over {hkv} KV heads")
    if d > MAX_HEAD_DIM or h // hkv > MAX_GROUPS:
        raise ValueError(f"head_dim {d} > {MAX_HEAD_DIM} or {h // hkv} "
                         f"query heads per KV head > {MAX_GROUPS}")
    kernels.check(q, "q", q.dtype, (b, h, d), dev)
    kernels.check(k_pages, "k_pages", k_pages.dtype, (pool, ps, hkv, d), dev)
    kernels.check(v_pages, "v_pages", k_pages.dtype, (pool, ps, hkv, d), dev)
    kernels.check(page_table, "page_table", torch.int32, (b, n_pages), dev)
    kernels.check(lengths, "lengths", torch.int32, (b,), dev)
    out = torch.empty_like(q)
    if b and h and d:
        plan = launch_plan(q, k_pages, v_pages, page_table)
        ptrs = [x.data_ptr() for x in (q, k_pages, v_pages, page_table,
                                       lengths, out)]
        kernels.launch("paged_decode_attention", *ptrs, b, pool, ps, hkv, d,
                       h // hkv, n_pages, d ** -0.5,
                       int(q.dtype == torch.bfloat16),
                       int(k_pages.dtype == torch.bfloat16),
                       *map(int, plan))
    return out


def paged_decode_attention_plain(q, k_pages, v_pages, page_table, lengths):
    """Gather the pages, then one masked softmax over every slot of the
    table (``repro.kernels.decode_attention.ref.paged_decode_ref``). A
    page id outside ``[0, NP)`` is read as JAX's gather reads it, and as
    the kernel does: a negative id counts from the end of the pool, and
    the result is clamped into it."""
    b, h, d = q.shape
    pool, ps, hkv, _ = k_pages.shape
    n_pages = page_table.shape[1]
    groups = h // hkv
    idx = page_table.long()
    idx = torch.where(idx < 0, idx + pool, idx).clamp(0, pool - 1)
    k = k_pages[idx].reshape(b, n_pages * ps, hkv, d)
    v = v_pages[idx].reshape(b, n_pages * ps, hkv, d)
    qh = q.reshape(b, hkv, groups, d).float() * (d ** -0.5)
    s = torch.einsum("bhgd,bkhd->bhgk", qh, k.float())
    pos = torch.arange(n_pages * ps, device=q.device)[None, None, None, :]
    s = torch.where(pos < lengths[:, None, None, None], s, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True).clamp(min=1e-30)
    out = torch.einsum("bhgk,bkhd->bhgd", p, v.float())
    return out.reshape(b, h, d).to(q.dtype)


def decode_attention(q, kv_pool, page_table, lengths):
    """``kv_pool`` is ``(k_pages, v_pages)``, each ``[NP, PS, Hkv, D]``."""
    k_pages, v_pages = kv_pool
    return paged_decode_attention(q, k_pages, v_pages, page_table, lengths)
