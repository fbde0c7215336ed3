"""``count_between``: the kernel's wrapper and its plain PyTorch version.

For ``[V, N]`` rows (``prev``/``nt`` int32, ``touch`` bool)::

    count[v, i] = #{ j : prev[v, i] < j < i, touch[v, j], nt[v, j] >= i }

the number of distinct blocks touched between an access and the
previous touch of its block (each qualifying j is the last touch of its
address before i). CUDA tensors go through the ``count_between`` kernel
(``csrc/count_between.cu``); CPU tensors through
:func:`count_between_plain`. Counts are int32 and exact either way.
"""
from __future__ import annotations

import torch

from repro_torch import kernels

_PLAIN_ELEMS = 1 << 24   # pair-mask elements per plain-version chunk


def count_between(prev: torch.Tensor, touch: torch.Tensor,
                  nt: torch.Tensor) -> torch.Tensor:
    if prev.device.type == "cpu":
        return count_between_plain(prev, touch, nt)
    dev = prev.device
    v, n = prev.shape
    kernels.check(prev, "prev", torch.int32, (v, n), dev)
    kernels.check(touch, "touch", torch.bool, (v, n), dev)
    kernels.check(nt, "nt", torch.int32, (v, n), dev)
    out = torch.empty((v, n), dtype=torch.int32, device=dev)
    if v and n:
        ptrs = [x.data_ptr() for x in (prev, touch, nt, out)]
        kernels.launch("count_between", *ptrs, v, n)
    return out


def count_between_plain(prev: torch.Tensor, touch: torch.Tensor,
                        nt: torch.Tensor) -> torch.Tensor:
    """The pairwise definition, evaluated in row blocks of the ``[V, i,
    j]`` mask so memory stays bounded."""
    v, n = prev.shape
    dev = prev.device
    j = torch.arange(n, dtype=torch.int32, device=dev)
    out = torch.empty((v, n), dtype=torch.int32, device=dev)
    rows = max(1, _PLAIN_ELEMS // max(v * n, 1))
    tj = touch[:, None, :]
    ntj = nt[:, None, :]
    for lo in range(0, n, rows):
        i = j[lo:lo + rows]
        p = prev[:, lo:lo + rows]
        m = ((j[None, None, :] > p[:, :, None])
             & (j[None, None, :] < i[None, :, None])
             & tj & (ntj >= i[None, :, None]))
        out[:, lo:lo + rows] = m.sum(dim=2, dtype=torch.int32)
    return out
