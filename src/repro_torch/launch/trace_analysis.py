"""Device time of one step by kernel group, from a ``torch.profiler``
trace: the Hopper counterpart of :mod:`repro.launch.hlo_analysis`.

The reference parses compiled HLO for its dot FLOPs, bytes and
collectives. A PyTorch program has no HLO: its FLOPs come from
``torch.utils.flop_counter`` on the ``meta`` device
(:mod:`repro_torch.launch.dryrun`), and what the card did comes from
the profiler's device events, which :func:`grouped_profile` sums into
groups by kernel name (:func:`kernel_group`): the port's hand kernels
by name, cuBLAS products, copies and fills, and the rest (element-wise
kernels and reductions).
"""
from __future__ import annotations

import re

# the hand kernels' CUDA symbols (csrc/), by the wrapper that launches them
HAND_KERNELS = (
    ("flash_attention (forward and recompute)", ("flash_sm90",
                                                 "flash_kernel")),
    ("flash_attention_bwd", ("row_stats", "kv_pass", "q_pass", "bwd_prep")),
    ("paged_decode_attention", ("paged_decode_kernel",)),
    ("count_between", ("count_between_kernel",)),
    ("evict_scatter", ("evict_kernel",)),
    ("promote_scatter", ("promote_kernel",)),
    ("clean_scatter", ("clean_kernel",)),
    ("popularity", ("popularity_kernel", "popularity_runs_kernel")),
    ("run_sums", ("run_sums_kernel",)),
    ("row merge (tiled route)", ("merge_round_kernel", "run_heads_kernel",
                                 "run_write_kernel", "tile_bases_kernel")),
    ("two_level", ("two_level_kernel", "two_level_classified_kernel")),
    ("single_level", ("single_level_kernel",
                      "single_level_classified_kernel")),
)
CUBLAS = "cuBLAS products"
COPIES = "copies and fills"
ELEMENTWISE = "elementwise and reductions"


def kernel_group(name: str) -> str:
    """The group a device event belongs to, by its kernel's name."""
    for group, marks in HAND_KERNELS:
        if any(m in name for m in marks):
            return group
    if re.search(r"gemm|nvjet|xmma|cutlass|cublas", name, re.I):
        return CUBLAS
    if re.search(r"memcpy|memset|copy_kernel|fill_kernel|Memcpy|Memset",
                 name):
        return COPIES
    return ELEMENTWISE


def grouped_profile(fn, warm=True) -> tuple[float | None, float, dict]:
    """``(device ms, device events, {kernel group: ms})`` of one call of
    ``fn`` from a ``torch.profiler`` trace (after one call outside it,
    unless not ``warm``); ``None`` ms when the trace shows no device
    time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    if warm:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    total, events, groups = 0.0, 0, {}
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA and not getattr(
                ev, "is_user_annotation", False):
            ms = float(getattr(ev, "self_device_time_total",
                               getattr(ev, "self_cuda_time_total",
                                       0.0))) / 1e3
            total += ms
            events += ev.count
            g = kernel_group(ev.key)
            groups[g] = groups.get(g, 0.0) + ms
    return (total if total > 0 else None), events, groups
