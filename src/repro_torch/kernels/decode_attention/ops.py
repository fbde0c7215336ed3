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
wrapper checks operands without reading ``lengths`` or the page table on
the host, so a call never waits for the device.
"""
from __future__ import annotations

import torch

from repro_torch import kernels

NEG_INF = -1e30
MAX_HEAD_DIM = 256     # the kernel keeps two head_dim columns per thread
MAX_GROUPS = 16        # query heads per KV head
_DTYPES = (torch.float32, torch.bfloat16)


def paged_decode_attention(q, k_pages, v_pages, page_table, lengths):
    if q.device.type == "cpu":
        return paged_decode_attention_plain(q, k_pages, v_pages, page_table,
                                            lengths)
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
        ptrs = [x.data_ptr() for x in (q, k_pages, v_pages, page_table,
                                       lengths, out)]
        kernels.launch("paged_decode_attention", *ptrs, b, pool, ps, hkv, d,
                       h // hkv, n_pages, d ** -0.5,
                       int(q.dtype == torch.bfloat16),
                       int(k_pages.dtype == torch.bfloat16))
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
