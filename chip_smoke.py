#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

Run from the repository root on a machine with an NVIDIA H100 and the
CUDA toolkit::

    python3 chip_smoke.py

It builds the CUDA kernels from ``src/repro_torch/csrc`` (into
``build/``), then:

1. prints the card, the device count and ``nvidia-smi``'s name and
   power limit;
2. holds every kernel against its plain PyTorch version on the card at
   the main path's shapes (exact equality) and times kernel, plain
   version and, where one exists, a one-call PyTorch equivalent (calls
   back to back, host included; each kernel, and ``index_add_``, also as
   device time alone, replaying a CUDA graph of the calls;
   ``torch.isin`` from a profiler trace); runs the fused maintenance
   interval, with and without the cleaner, and one serving maintenance
   interval under ``torch.cuda.set_sync_debug_mode("error")``; holds
   ``paged_decode_attention`` to its plain version (float32 outputs
   within 2e-5, bf16 within one bf16 ulp or 2e-5) at the serving path's
   shape (a random length, then pinned lengths of 1, 3 and 6 pages, each
   timed) and at qwen3-4b batched decode (B 64, H 32, Hkv 8, D 128, 4096
   tokens, a 1 GiB bf16 pool), with poisoned tokens past each length and
   a zero-length row, beside ``scaled_dot_product_attention`` over
   gathered pages, printing the launch plan (splits) chosen at each; holds ``popularity`` to its plain version, exactly,
   at the staged path's shape (the 12-VM and 1024-VM first blocks, a
   cache size per VM) and at the Pallas benchmark's (N 8192, 1024
   blocks, cs 64), beside ``torch.exp`` + ``index_add_``; holds
   ``run_sums`` (the maintenance window's compaction) to its plain
   version on the fused-interval check's windows and on the first
   window of the 12-VM and 1024-VM runs, beside ``torch.sort(stable)``
   + ``index_add_`` and the global-sort chain it replaced (device time
   and device events); gives both kernels' longest run ``L_max`` and
   its chain bound (``L_max`` dependent float32 adds, priced by
   ``chain_probe.cu``); holds both at the shared-memory row limit
   (``kernels.ROW_MAX`` entries), on one key for a whole row and on an
   empty row, and checks that a wider row is refused; and
   ``promote_scatter``'s dedupe branch on queues that hold every address
   twice, with its device events a call (one: the kernel writes its
   outputs itself); ``evict_scatter`` and ``count_between`` with the
   plans their wrappers chose (``evict_plan``: CTAs a VM and threads;
   ``count_plan``: lanes a row, rows a CTA, threads) and their device
   events a call (one each, asserted: ``kernel_events``); holds ``two_level`` and ``single_level`` (one CTA a VM walking
   each cache set's requests in order, ``csrc/set_walk.cuh``) to their
   plain versions at the 12-VM and 1024-VM blocks and at the set walk's
   other shapes: V = 1 (a VM's own block, 64 x 64; FAST's and L2ARC's
   windows, 256 x 64), 64 DRAM / 48 SSD sets, one set taking every
   request, rows of 9,000 (two tiles) and rows of 96–128 ways, each
   beside its longest same-set chain and chain bound and the earlier
   one-chain kernel's recorded times (``RECORDED_MS``), with ptxas's
   registers and spills (and those of the decode kernel's routes, of
   ``promote_scatter``, ``evict_scatter`` and ``count_between``); holds ``flash_attention`` to its plain version (the same
   tolerance as decode) at tests/test_kernels.py's shapes in float32 (the
   ``cuda_cores`` route) and bf16 (the ``wgmma`` route) and at the
   prefill shape (B 4, H 32, Hkv 8, S 4096, D 128); prints what ptxas
   said of ``flash_attention_sm90.cu`` (registers, spills), its shared
   memory and the SASS count of ``HGMMA`` instructions;
3. runs the paper's §5.1 deployment (12 VMs x 20,000 requests, 64 x 64
   geometry) through ``EticaCache.run`` on the card and again on the
   CPU; per-VM stats and allocation histories must be identical;
4. runs the fig15 consolidation configuration at 128 and 1024 VMs the
   same way (card == CPU);
5. runs the same 12-VM deployment under the paper's endurance
   comparison: ETICA with the background cleaner (``clean_quota=4``)
   and ECI-Cache (``make_eci_cache``) at the same total capacity, each
   card == CPU, and prints requests/s, SSD writes and the ETICA/ECI
   write reduction;
6. runs ``benchmarks/fig14_endurance.py``'s three controllers on its
   own mix, card == CPU, and holds the per-VM SSD writes and cleaner
   counts and the totals to the JAX package's CPU values (hard-coded
   below), with the exporter round trip;
7. runs ECI-Cache at the fig15 1024-VM configuration, card == CPU;
8. runs two-tier KV serving on ``benchmarks/serving_two_tier.py``'s FULL
   churn trace (20,000 events, 1,358 sessions, 4 tenants, 512 pool
   pages) through ``repro_torch.launch.serve.run_events``: the ETICA
   manager, its host-dict oracle and global LRU, controller only, card
   == CPU and equal to ``BENCH_serving.json``; ETICA with the cleaner,
   card == CPU; then ETICA at qwen3-4b's KV width (8 KV heads, head_dim
   128, bf16 pool) with a paged decode every 8th activation, every
   decode held to its plain version on the card, with the pages each
   decode's rows read;
9. runs the oracle ladder on the card: the 12-VM deployment in the
   staged (``fused_maintenance=False``) and sequential (``batched=False``)
   modes, without and with the cleaner, each equal to phase 3's or phase
   5's fused card run (stats, allocation histories, interval logs, final
   DRAM and SSD states); ECI-Cache sequential equal to phase 5's batched
   run (the logs' demands, allocations and policies included); FAST and
   L2ARC over the same mix as one stream (256 x 64), equal to the JAX
   package's CPU values (hard-coded below); requests/s of every mode;
   then every ``promote_scatter`` call of an L2ARC run (dedupe on,
   [1, 256, 64], the window's DRAM evictions) held to its plain version
   and replayed in one CUDA graph for its device time against its
   bounds, and every ``count_between`` call of the sequential 12-VM run
   the same way;
10. serves qwen3-4b at full width and depth (36 layers, d_model 2560,
   4.41 B float32 parameters drawn from a seeded generator on the
   card): ``flash_attention`` against its plain version on layer 0's
   real q, k, v of the prompt, with its times beside
   ``scaled_dot_product_attention``, the bound, TFLOP/s and the first
   version's time on float32 copies; ``make_prefill_step`` over 4 x
   4096 random tokens (exactly 36 ``flash_attention`` launches, all on
   the ``wgmma`` route) and 32
   greedy ``make_decode_step`` steps (none), prefill and decode
   tokens/s, peak memory and where a decode step's time goes; decode
   equal to a fresh prefill of the longer prompt at B 1 within 2e-2 of
   the logit scale (tests/test_serving.py's bar), and the same gap with
   the plain version in place of the kernel, with decode's attention in
   float32, beside the move of one bf16 ulp (the model's noise floor);
   the reduced model on the card against the CPU (logits within 1e-2,
   greedy tokens equal past a 1e-2 margin); ``serve.main --arch
   qwen3-4b``, whose page bank comes from one prefill of the reduced
   model (2 launches, both on the ``wgmma`` route), with statistics
   equal to a run on gaussian pages, and the
   kernel against its plain version at that prefill's shape and on its
   layer-0 activations.

Each card run of phases 3 to 10 sets the launch counts to 0 just before
and reads them just after; exactly the kernels of that path's own set
must have launched (``popularity`` only on the staged paths). Phase 2
holds the kernels against their plain versions at the shapes of both
the 12-VM and the 1024-VM runs.

The line before the last is ``{"kernels": [...]}`` (one entry per
kernel, ``launches`` from its own path: the 12-VM paths, the full-width
serving run for ``paged_decode_attention``, the staged 12-VM run for
``popularity`` and the full-width prefill for ``flash_attention``); the
last is ``{"ok": true, "device": {...}}``. Any
failed phase raises and the exit code is nonzero. Without a CUDA device
it exits 2 and prints no result.
"""
from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3 (NVIDIA data sheet)
SCALAR_OPS_PER_S = 67e12      # H100 SXM non-tensor fp32 rate, used as the
#                               peak for scalar integer work as well
BF16_TENSOR_FLOPS = 989e12    # H100 SXM dense bf16 tensor-core rate
DECODE_ATOL = 2e-5            # tests/test_kernels.py's paged decode atol
QWEN3_PREFILL = (4, 32, 8, 4096, 128)   # B, H, Hkv, S, D of phase 10
QWEN3_DECODE_STEPS = 32

PAPER_VMS = ("hm_1", "proj_0", "stg_1", "usr_0", "ts_0", "wdev_0", "web_3",
             "usr_0", "mds_0", "src2_0", "rsrch_0", "mds_1")
FIG15_WORKLOADS = ["hm_1", "proj_0", "stg_1", "usr_0", "ts_0", "wdev_0",
                   "web_3", "src2_0"] * 2
FIG15_JAX_CPU_AVG_HIT_1024 = 0.271   # benchmarks/BENCH_sharding.json

# benchmarks/fig14_endurance.py on the JAX package, CPU (its
# BENCH_endurance.json): per VM (etica_writes, eci_writes) and the clean
# run's (flushes, evict_flushes, dirty_resident); then the totals
FIG14_VMS = ("web_3", "stg_1", "src2_0", "rsrch_0", "hm_1", "usr_0")
FIG14_JAX_CPU_WRITES = {"web_3": (207, 6258), "stg_1": (4337, 6315),
                        "src2_0": (4473, 4819), "rsrch_0": (5024, 5631),
                        "hm_1": (447, 1059), "usr_0": (5878, 6387)}
FIG14_JAX_CPU_CLEAN = {"web_3": (82, 0, 4), "stg_1": (92, 0, 58),
                       "src2_0": (92, 0, 60), "rsrch_0": (92, 2, 52),
                       "hm_1": (92, 0, 13), "usr_0": (92, 0, 33)}
FIG14_JAX_CPU_REDUCTION = "0.332"     # avg_ssd_write_reduction, 3 digits
FIG14_JAX_CPU_CLEAN_FLUSHES = 542
FIG14_JAX_CPU_PEAK_DIRTY = 222
FIG14_JAX_CPU_FINAL_DIRTY = 220
CLEAN_QUOTA = 4                       # fig14_endurance.py CLEAN_QUOTA

# benchmarks/serving_two_tier.py FULL on the JAX package, CPU (its
# BENCH_serving.json): trace shape, then (dma_write, dma_read, hit ratio)
SERVING_TENANTS = 4
BENCH_SERVING = {"sessions": 1358, "max_live": 1024,
                 "etica": (10360832, 13723648, "0.862"),
                 "lru": (21604352, 5136384, "0.953")}

# FAST and L2ARC on the paper 12-VM mix as one stream, 256 x 64 sets x
# ways, the JAX package on the CPU:
#   PYTHONPATH=src JAX_PLATFORMS=cpu python -c "
#   from repro.core import baselines, interleave, Geometry
#   from repro.traces import make
#   vms = ('hm_1', 'proj_0', 'stg_1', 'usr_0', 'ts_0', 'wdev_0', 'web_3',
#          'usr_0', 'mds_0', 'src2_0', 'rsrch_0', 'mds_1')
#   trace = interleave([make(n, 20_000, seed=i, addr_offset=i * 10_000_000,
#                            scale=1.0) for i, n in enumerate(vms)], seed=42)
#   for f in (baselines.make_fast, baselines.make_l2arc):
#       print(f(8192, 16384, geometry=Geometry(256, 64)).run(trace).stats)"
FAST_JAX_CPU = {
    "reads": 136093.0, "writes": 103907.0, "read_hits_l1": 44357.0,
    "read_hits_l2": 36625.0, "write_hits_l2": 94435.0,
    "cache_writes_l2": 103917.0, "disk_reads": 55111.0, "disk_writes": 0.0,
    "latency_sum": 276.98324209451675, "bypassed": 0.0, "pop_drops": 0.0,
    "flushes": 0.0, "dirty_resident": 0.0}
L2ARC_JAX_CPU = {
    "reads": 136093.0, "writes": 103907.0, "read_hits_l1": 44357.0,
    "read_hits_l2": 34489.0, "write_hits_l2": 89363.0,
    "cache_writes_l2": 105747.0, "disk_reads": 57247.0,
    "disk_writes": 14544.0, "latency_sum": 294.7682449221611,
    "bypassed": 0.0, "pop_drops": 0.0, "flushes": 0.0, "dirty_resident": 0.0}

# the kernels each path must launch
ETICA_KERNELS = ("count_between", "evict_scatter", "promote_scatter",
                 "two_level", "run_sums")
CLEAN_KERNELS = ETICA_KERNELS + ("clean_scatter",)
ECI_KERNELS = ("count_between", "single_level")
STAGED_KERNELS = ("count_between", "promote_scatter", "two_level",
                  "popularity")     # + evict_scatter where a queue formed
SEQ_KERNELS = ("count_between", "two_level")
GLOBAL_KERNELS = ("two_level", "promote_scatter")
SERVING_KERNELS = ("count_between", "run_sums")
SERVING_DECODE_KERNELS = SERVING_KERNELS + ("paged_decode_attention",)


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean milliseconds per call, CUDA events around ``reps`` calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int = 20, replays: int = 5) -> float:
    """Mean device milliseconds per call without the host's share:
    ``reps`` calls captured in one CUDA graph, replayed ``replays`` times
    between CUDA events. What a wrapper puts on the device (operand
    copies, zeroed outputs, the kernel) stays in; its Python, operand
    checks and ``ctypes`` call do not."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                               # warm-up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (reps * replays)


def device_profile(fn, reps: int, top: list | None = None,
                   by_name: dict | None = None
                   ) -> tuple[float | None, float]:
    """``(device ms, device events)`` per call from a ``torch.profiler``
    trace of ``reps`` calls: the kernels and copies on the card, summed
    as the profiler's own table sums them (an operator's row repeats the
    time of the kernels it launched, so only the device's events count);
    ``None`` ms when the trace shows no device time. ``top`` receives
    ``(ms per call, events per call, name)`` of the five device events
    that take the most time; ``by_name`` receives every device event's
    name and count per call."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total_us, events, rows = 0.0, 0, []
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA and not getattr(
                ev, "is_user_annotation", False):
            us = float(getattr(ev, "self_device_time_total",
                               getattr(ev, "self_cuda_time_total", 0.0)))
            total_us += us
            events += ev.count
            rows.append((us / 1e3 / reps, ev.count / reps, ev.key[:60]))
            if by_name is not None:
                by_name[ev.key] = by_name.get(ev.key, 0) + ev.count / reps
    if top is not None:
        top.extend(sorted(rows, reverse=True)[:5])
    ms = total_us / 1e3 / reps if total_us > 0 else None
    return ms, events / reps


def fmt_ms(x) -> str:
    return "not measured" if x is None else f"{x:.4f} ms"


def max_abs_err(got, want) -> float:
    """Max |got - want| over matching tensors; raises unless every
    output is identical (float32 compared bit for bit)."""
    import torch
    err = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        if g.dtype != w.dtype or g.shape != w.shape:
            raise AssertionError(f"output {i}: {g.dtype}{tuple(g.shape)} vs "
                                 f"{w.dtype}{tuple(w.shape)}")
        if g.dtype == torch.float32:
            same = torch.equal(g.view(torch.int32), w.view(torch.int32))
        else:
            same = torch.equal(g, w)
        if not same:
            raise AssertionError(f"output {i} differs from the plain version")
        if g.numel():
            err = max(err, float((g.double() - w.double()).abs().max()))
    return err


def bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / SCALAR_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def trace_mix(names, reqs, scale):
    from repro_torch.core.trace import interleave
    from repro_torch.traces.generators import make
    return interleave([make(n, reqs, seed=i, addr_offset=i * 10_000_000,
                            scale=scale) for i, n in enumerate(names)],
                      seed=42)


def first_blocks(trace, num_vms, window, chunk, count):
    """The first ``count`` ``[V, chunk]`` numpy blocks and the window's
    per-VM sub-traces, as the controller cuts them."""
    from repro_torch.core.trace import pad_batch, split_by_vm
    subs = split_by_vm(trace[:window], num_vms)
    lists = [list(s.intervals(chunk)) for s in subs]
    out = []
    for k in range(count):
        kth = [c[k] if k < len(c) else None for c in lists]
        out.append(pad_batch(kth, chunk))
    return subs, out


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def pod_rows(dev, subs):
    """``(prev, touch, nt)`` of the POD(WBWO) sizing rows of the window's
    per-VM sub-traces, as the controller pads them."""
    import torch
    from repro_torch.core import reuse
    addrs = [np.asarray(s.addr) for s in subs]
    writes = [np.asarray(s.is_write) for s in subs]
    lens = [len(a) for a in addrs]
    amat, wmat = reuse._pad_rows(addrs, writes, list(range(len(subs))), lens)
    a = torch.from_numpy(amat).to(dev)
    w = torch.from_numpy(wmat).to(dev)
    served = ~w & (reuse._prev_same(a, w) >= 0)          # POD(WBWO)
    touch = (w | served).contiguous()
    return reuse._prev_same(a, touch), touch, reuse._next_same(a, touch)


def check_count_between(dev, subs, label):
    from repro_torch.kernels.reuse_distance import ops
    prev, touch, nt = pod_rows(dev, subs)
    got = ops.count_between(prev, touch, nt)
    want = ops.count_between_plain(prev, touch, nt)
    err = max_abs_err([got], [want])
    ms = cuda_ms(lambda: ops.count_between(prev, touch, nt), 50)
    dev_ms = graph_ms(lambda: ops.count_between(prev, touch, nt))
    plain_ms = cuda_ms(lambda: ops.count_between_plain(prev, touch, nt), 3)
    v, n = prev.shape
    b, by = count_bound(prev)
    plan = ops.count_plan(v, n, sm_count(dev))
    events = kernel_events(lambda: ops.count_between(prev, touch, nt),
                           "count_between_kernel")
    log(f"count_between {label} [{v},{n}]: exact, plan (lanes, rows, "
        f"threads) {plan}, kernel {ms:.4f} ms (device {dev_ms:.4f} ms, "
        f"{events} device events a call), plain {plain_ms:.4f} ms, bound "
        f"{b:.5f} ms ({by})")
    return dict(max_abs_err=err, ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                bound_ms=b, bound_by=by, library_ms=None, plan=plan,
                events_per_call=events)


def count_bound(prev) -> tuple[float, str]:
    """``count_between``'s bound on these rows: 13 bytes an element
    against two integer operations a pair of this run's windows."""
    import torch
    v, n = prev.shape
    i = torch.arange(n, device=prev.device)[None, :]
    pairs = float((i - prev.long() - 1).clamp(min=0).sum())
    return bound_ms(13.0 * v * n, 2.0 * pairs)


def sm_count(dev) -> int:
    import torch
    return torch.cuda.get_device_properties(dev).multi_processor_count


def chain_step_ns(dev) -> float:
    """Nanoseconds of one dependent on-chip load, from ``chain_probe``:
    one thread chasing a 4 KB cyclic permutation (L1-resident); the
    difference of two step counts removes the launch overhead."""
    import ctypes
    import torch
    from repro_torch import kernels
    perm = np.random.default_rng(7).permutation(1024)
    nxt = np.empty(1024, np.int32)
    nxt[perm] = np.roll(perm, -1)            # one cycle through all slots
    nxt_t = torch.from_numpy(nxt).to(dev)
    out = torch.empty(1, dtype=torch.int32, device=dev)
    lib = kernels.library()

    def run(steps):
        err = lib.etica_chain_probe(
            ctypes.c_void_p(nxt_t.data_ptr()), steps,
            ctypes.c_void_p(out.data_ptr()),
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
        if err:
            raise RuntimeError(f"chain_probe failed to launch ({err})")

    lo, hi = 1 << 18, 1 << 19
    t_lo = min(cuda_ms(lambda: run(lo), 1) for _ in range(3))
    t_hi = min(cuda_ms(lambda: run(hi), 1) for _ in range(3))
    return (t_hi - t_lo) * 1e6 / (hi - lo)


def fadd_step_ns(dev) -> float:
    """Nanoseconds of one dependent float32 ``__fadd_rn``, from
    ``chain_probe.cu``'s ``fadd_probe``: one thread adding to a running
    sum; the difference of two step counts removes the launch overhead."""
    import ctypes
    import torch
    from repro_torch import kernels
    out = torch.empty(1, dtype=torch.float32, device=dev)
    lib = kernels.library()

    def run(steps):
        err = lib.etica_fadd_probe(
            1e-3, steps, ctypes.c_void_p(out.data_ptr()),
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
        if err:
            raise RuntimeError(f"fadd_probe failed to launch ({err})")

    lo, hi = 1 << 20, 1 << 21
    t_lo = min(cuda_ms(lambda: run(lo), 1) for _ in range(3))
    t_hi = min(cuda_ms(lambda: run(hi), 1) for _ in range(3))
    return (t_hi - t_lo) * 1e6 / (hi - lo)


def longest_run(keys, keep) -> int:
    """Most kept entries that share one key in a row of ``keys`` (``[V,
    N]``): the longest in-order sum a row-sorting kernel must add."""
    import torch
    v = keys.shape[0]
    k = (torch.arange(v, device=keys.device)[:, None] * 2**32
         + keys.long())[keep]
    return int(torch.unique(k, return_counts=True)[1].max()) \
        if k.numel() else 0


def longest_set_chain(a, sets) -> int:
    """Most valid requests that any (VM, set) receives in block ``a``:
    those requests must run one after another."""
    import torch
    v = a.shape[0]
    valid = a >= 0
    key = (torch.arange(v, device=a.device)[:, None] * sets
           + a.clamp(min=0) % sets)[valid]
    return int(torch.bincount(key, minlength=1).max()) if key.numel() else 0


def datapath_timing(label, call, plain, a, geo, nbytes, ops_count, step_ns,
                    time_plain):
    """Times ``call`` (calls back to back, and device time from a CUDA
    graph) and, with ``time_plain``, the plain version; the bound and the
    chain bound: the longest same-set chain of each walk (one walk when
    the levels' set counts are equal) times one dependent on-chip load."""
    ms = cuda_ms(call, 20)
    dev_ms = graph_ms(call, 10)
    plain_ms = cuda_ms(plain, 1, warmup=0) if time_plain else None
    sets = sorted({s for s, _ in geo})
    chain = sum(longest_set_chain(a, s) for s in sets)
    chain_b = chain * step_ns * 1e-6
    b, by = bound_ms(nbytes, ops_count)
    old = RECORDED_MS.get(label)
    was = (f"; the earlier one-chain kernel {old[0]:.4f} ms (device "
           f"{old[1]:.4f} ms)" if old else "")
    v, n = a.shape
    log(f"{label} [{v},{n}] {' / '.join(f'{s}x{w}' for s, w in geo)}: "
        f"kernel {ms:.4f} ms (device {dev_ms:.4f} ms), plain "
        f"{fmt_ms(plain_ms)}, bound {b:.5f} ms ({by}), "
        f"{float((a >= 0).sum()):.0f} valid requests, longest same-set "
        f"chain {chain} x {step_ns:.2f} ns = chain bound {chain_b:.5f} ms, "
        f"device / chain bound {dev_ms / max(chain_b, 1e-9):.1f}x{was}")
    return dict(ms=ms, device_ms=dev_ms, plain_ms=plain_ms, bound_ms=b,
                bound_by=by, library_ms=None, chain=chain,
                chain_bound_ms=chain_b)


def check_datapath(dev, blocks, geo, ways, mode, label, step_ns,
                   time_plain=True):
    """``two_level`` against its plain version over chained blocks;
    ``geo`` is ((sets, ways) of the DRAM, of the SSD); times the fullest
    block."""
    import torch
    from repro_torch.core.simulator import make_cache_batch
    from repro_torch.kernels.datapath import ops
    (sd, wmd), (ss, wms) = geo
    v = blocks[0][0].shape[0]
    wd = torch.as_tensor(ways[0], dtype=torch.int32, device=dev)
    ws = torch.as_tensor(ways[1], dtype=torch.int32, device=dev)
    npe = mode == "npe"
    kstate = rstate = (*make_cache_batch(v, sd, wmd, dev),
                       *make_cache_batch(v, ss, wms, dev))
    kt = rt = torch.zeros(v, dtype=torch.int32, device=dev)
    err, timed = 0.0, None
    for a_np, w_np in blocks:
        a = torch.from_numpy(a_np).to(dev)
        w = torch.from_numpy(w_np).to(dev)
        args = (a, w, *kstate, wd, ws, kt)
        if timed is None or (a >= 0).sum() > (timed[0] >= 0).sum():
            timed = args               # time the fullest block, as run
        kout = ops.two_level(a, w, *kstate, wd, ws, kt, npe=npe)
        rout = ops.two_level_plain(a, w, *rstate, wd, ws, rt, npe=npe)
        err = max(err, max_abs_err(kout, rout))
        kstate, kt = kout[:6], kout[8]
        rstate, rt = rout[:6], rout[8]
    a, n = timed[0], timed[0].shape[1]
    state_bytes = 2 * 9.0 * v * (sd * wmd + ss * wms)
    row = datapath_timing(
        f"two_level {label} {mode}",
        lambda: ops.two_level(*timed, npe=npe),
        lambda: ops.two_level_plain(*timed, npe=npe), a, geo,
        5.0 * v * n + state_bytes + 40.0 * v,
        float((a >= 0).sum()) * 2 * (wmd + wms), step_ns, time_plain)
    log(f"two_level {label} {mode}: exact over {len(blocks)} blocks")
    return dict(max_abs_err=err, **row)


def check_single_level(dev, rng, blocks, sets, ways_max, label, step_ns,
                       time_plain=True):
    """``single_level`` against its plain version over chained blocks,
    every VM under a random one of the five policies (each present when
    there are five VMs or more)."""
    import torch
    from repro_torch.core.policies import T_SSD, Policy
    from repro_torch.core.simulator import make_cache_batch, policy_flags
    from repro_torch.kernels.datapath import ops
    v = blocks[0][0].shape[0]
    pols = (list(Policy) + [Policy(p) for p in rng.choice(
        [p.value for p in Policy], max(v - len(Policy), 0))])[:v]
    flags = policy_flags(pols, dev)
    ways = torch.as_tensor(rng.integers(0, ways_max + 1, v),
                           dtype=torch.int32, device=dev)
    kstate = rstate = make_cache_batch(v, sets, ways_max, dev)
    kt = rt = torch.zeros(v, dtype=torch.int32, device=dev)
    kw = dict(t_cache=T_SSD)
    err, timed = 0.0, None
    for a_np, w_np in blocks:
        a = torch.from_numpy(a_np).to(dev)
        w = torch.from_numpy(w_np).to(dev)
        args = (a, w, *kstate, ways, *flags, kt)
        if timed is None or (a >= 0).sum() > (timed[0] >= 0).sum():
            timed = args               # time the fullest block, as run
        kout = ops.single_level(*args, **kw)
        rout = ops.single_level_plain(a, w, *rstate, ways, *flags, rt, **kw)
        err = max(err, max_abs_err(kout, rout))
        kstate, kt = kout[:3], kout[5]
        rstate, rt = rout[:3], rout[5]
    a, n = timed[0], timed[0].shape[1]
    row = datapath_timing(
        f"single_level {label}", lambda: ops.single_level(*timed, **kw),
        lambda: ops.single_level_plain(*timed, **kw), a,
        ((sets, ways_max),),
        5.0 * v * n + 2 * 9.0 * v * sets * ways_max + 52.0 * v,
        float((a >= 0).sum()) * 2 * ways_max, step_ns, time_plain)
    log(f"single_level {label}: exact over {len(blocks)} blocks "
        f"({', '.join(p.value for p in pols[:8])}"
        f"{', ...' if v > 8 else ''})")
    return dict(max_abs_err=err, **row)


def stream_blocks(trace, width, count):
    """``count`` consecutive ``[1, width]`` blocks of one stream (FAST's
    and L2ARC's windows)."""
    a = np.asarray(trace.addr[:width * count], np.int32)
    w = np.asarray(trace.is_write[:width * count], bool)
    return [(a[k * width:(k + 1) * width][None],
             w[k * width:(k + 1) * width][None]) for k in range(count)]


def one_set(blocks, sets):
    """The blocks with every valid address moved to set 0 (a -> a * S mod
    2^31, for S a power of two): each row becomes one same-set chain, the
    set walk's worst case."""
    return [(np.where(a >= 0, a.astype(np.int64) * sets % 2**31,
                      -1).astype(np.int32), w) for a, w in blocks]


def check_set_walk(dev, rng, paper, blocks12, ways12, step_ns):
    """The datapath kernels at the other shapes the set walk must take:
    the V = 1 blocks of the sequential modes (a VM's own 1,000-request
    block, 64 x 64) and of FAST / L2ARC (the stream's 1,000-request
    windows, 256 x 64); DRAM and SSD of different set counts; every
    request of a row in one set (the longest chain); rows of 9,000
    requests (two tiles of the kernel's 8,192); rows wider than 64 ways
    (held in memory, not registers). Returns ``{label: row}``."""
    from repro_torch.core.simulator import capacity_to_ways
    out = {}
    g64, g256 = ((64, 64), (64, 64)), ((256, 64), (256, 64))
    vm0 = [(a[:1], w[:1]) for a, w in blocks12]
    w0 = (ways12[0][:1], ways12[1][:1])
    out["seq V=1"] = check_datapath(dev, vm0, g64, w0, "full",
                                    "V=1 -seq", step_ns, time_plain=False)
    win = stream_blocks(paper, 1_000, 2)
    gw = ([int(capacity_to_ways(8192, 256, 64))],
          [int(capacity_to_ways(16384, 256, 64))])
    for mode, name in (("full", "L2ARC"), ("npe", "FAST")):
        out[f"{name} V=1"] = check_datapath(dev, win, g256, gw, mode,
                                            f"V=1 {name}", step_ns,
                                            time_plain=False)
    out["sets differ"] = check_datapath(
        dev, blocks12, ((64, 64), (48, 64)), ways12, "npe",
        "12-VM, 64 DRAM / 48 SSD sets", step_ns, time_plain=False)
    out["one set"] = check_datapath(dev, one_set(blocks12, 64), g64, ways12,
                                    "npe", "12-VM, one set", step_ns,
                                    time_plain=False)
    two = stream_blocks(paper, 9_000, 2)
    two = [(np.concatenate([a for a, _ in two]),
            np.concatenate([w for _, w in two]))]
    out["two tiles"] = check_datapath(dev, two, g64, ([64, 40], [64, 64]),
                                      "npe", "rows of 9,000", step_ns,
                                      time_plain=False)
    out["wide rows"] = check_datapath(
        dev, blocks12, ((32, 128), (32, 96)),
        (rng.integers(8, 129, 12), rng.integers(8, 97, 12)), "full",
        "12-VM, 128 / 96 ways", step_ns, time_plain=False)
    single = {}
    single["seq V=1"] = check_single_level(dev, rng, vm0, 64, 64,
                                           "V=1 -eci-seq", step_ns,
                                           time_plain=False)
    single["one set"] = check_single_level(dev, rng, one_set(blocks12, 64),
                                           64, 64, "12-VM, one set", step_ns,
                                           time_plain=False)
    single["two tiles"] = check_single_level(dev, rng, two, 64, 64,
                                             "rows of 9,000", step_ns,
                                             time_plain=False)
    single["wide rows"] = check_single_level(dev, rng, blocks12, 32, 128,
                                             "12-VM, 128 ways", step_ns,
                                             time_plain=False)
    return out, single


def random_state(rng, v, s, w, fill=0.75):
    """Set-consistent stacked state (tag % S == s), as the datapath
    leaves it; blocks come from a 4*S*W address space per VM."""
    tags = np.full((v, s, w), -1, np.int32)
    for i in range(v):
        base = rng.integers(0, 4 * w, (s, w)) * s + np.arange(s)[:, None]
        keep = rng.random((s, w)) < fill
        for j in range(s):
            u = np.unique(base[j][keep[j]])
            tags[i, j, :u.size] = rng.permutation(u)
    lru = np.where(tags >= 0, rng.integers(0, 10_000, tags.shape), -1)
    dirty = (rng.random(tags.shape) < 0.3) & (tags >= 0)
    return tags, lru.astype(np.int32), dirty


def evict_queue(rng, tags, q):
    """The fused path's ``[V, Q]`` eviction queue: the bottom 5% of each
    VM's residents (``evict_frac``), at least one, then ``-1`` padding."""
    out = np.full((tags.shape[0], q), -1, np.int32)
    for i in range(tags.shape[0]):
        res = tags[i][tags[i] >= 0]
        k = max(int(np.ceil(0.05 * res.size)), 1)
        out[i, :k] = rng.choice(res, k, replace=False)
    return out


def check_scatters(dev, rng, v, s, w):
    import torch
    from repro_torch.kernels.maintenance import ops
    q = 1 << (s * w - 1).bit_length()        # next_pow2(S*W), as on the path
    tags, lru, dirty = random_state(rng, v, s, w)
    ways = rng.integers(8, w + 1, v).astype(np.int32)
    t = rng.integers(10_000, 20_000, v).astype(np.int32)
    equeue = evict_queue(rng, tags, q)
    pqueue = np.full((v, q), -1, np.int32)
    for i in range(v):
        res = tags[i][tags[i] >= 0]
        fresh = np.setdiff1d(np.arange(4 * w * s), res)
        m = min(q - 64, fresh.size)
        pq = np.concatenate([rng.choice(fresh, m, replace=False),
                             rng.choice(res, 64, replace=False)])
        pqueue[i, :pq.size] = rng.permutation(pq)
    st = [torch.from_numpy(x).to(dev) for x in (tags, lru, dirty)]
    eq = torch.from_numpy(equeue).to(dev)
    pq = torch.from_numpy(pqueue).to(dev)
    ways_t = torch.from_numpy(ways).to(dev)
    t_t = torch.from_numpy(t).to(dev)

    out = {}
    got = ops.evict_scatter(*st, eq)
    want = ops.evict_scatter_plain(*st, eq)
    err = max_abs_err(got, want)
    ms = cuda_ms(lambda: ops.evict_scatter(*st, eq), 50)
    dev_ms = graph_ms(lambda: ops.evict_scatter(*st, eq))
    plain_ms = cuda_ms(lambda: ops.evict_scatter_plain(*st, eq), 10)
    vm = torch.arange(v, device=dev, dtype=torch.int64)
    tk = (st[0].long() + (vm << 32)[:, None, None]).reshape(-1)
    qk = (eq.long() + (vm << 32)[:, None]).reshape(-1)
    lib_ms = cuda_ms(lambda: torch.isin(tk, qk), 50)
    lib_dev_ms = device_profile(lambda: torch.isin(tk, qk), 20)[0]
    b, by = bound_ms(2 * 9.0 * v * s * w + 4.0 * v * q + 4.0 * v,
                     2.0 * (v * s * w + v * q))
    plan = ops.evict_plan(v, s * w, sm_count(dev))
    events = kernel_events(lambda: ops.evict_scatter(*st, eq),
                           "evict_kernel")
    log(f"evict_scatter [{v},{s},{w}] Q={q}: exact, flushed "
        f"{int(got[3].sum())}, plan (parts, threads) {plan}, live entries "
        f"{int((eq >= 0).sum())}, kernel {ms:.4f} ms (device {dev_ms:.4f} "
        f"ms, {events} device events a call), plain {plain_ms:.4f} ms, "
        f"torch.isin {lib_ms:.4f} ms (device {fmt_ms(lib_dev_ms)} from a "
        f"profiler trace: it cannot be captured in a CUDA graph), bound "
        f"{b:.5f} ms ({by})")
    out["evict_scatter"] = dict(max_abs_err=err, ms=ms, device_ms=dev_ms,
                                plain_ms=plain_ms, bound_ms=b, bound_by=by,
                                library_ms=lib_ms,
                                library_device_ms=lib_dev_ms, plan=plan,
                                events_per_call=events)

    # the fused path's contract: unique queues, dedupe off
    args = (*st, pq, ways_t, t_t)
    got = ops.promote_scatter(*args, dedupe=False)
    want = ops.promote_scatter_plain(*args, dedupe=False)
    err = max_abs_err(got, want)
    ms = cuda_ms(lambda: ops.promote_scatter(*args, dedupe=False), 50)
    dev_ms = graph_ms(lambda: ops.promote_scatter(*args, dedupe=False))
    plain_ms = cuda_ms(
        lambda: ops.promote_scatter_plain(*args, dedupe=False), 10)
    b, by = bound_ms(2 * 9.0 * v * s * w + 4.0 * v * q + 12.0 * v,
                     2.0 * (v * s * w + v * q))
    events = kernel_events(lambda: ops.promote_scatter(*args, dedupe=False),
                           "promote_kernel")
    log(f"promote_scatter [{v},{s},{w}] Q={q}: exact, promoted "
        f"{int(got[3].sum())}, kernel {ms:.4f} ms (device {dev_ms:.4f} ms, "
        f"{events} device events a call), plain {plain_ms:.4f} ms, bound "
        f"{b:.5f} ms ({by})")
    # the dedupe branch (staged path, FAST, L2ARC): every address of the
    # queue's first half twice, in random order
    dq = np.stack([rng.permutation(np.concatenate([r[:q // 2], r[:q // 2]]))
                   for r in pqueue])
    dargs = (*st, torch.from_numpy(dq).to(dev), ways_t, t_t)
    got = ops.promote_scatter(*dargs)
    err = max(err, max_abs_err(got, ops.promote_scatter_plain(*dargs)))
    # slots whose tag the dedupe changes (a second copy takes no way)
    moved = int((ops.promote_scatter(*dargs, dedupe=False)[0]
                 != got[0]).sum())
    d_ms = cuda_ms(lambda: ops.promote_scatter(*dargs), 50)
    d_dev_ms = graph_ms(lambda: ops.promote_scatter(*dargs))
    d_plain_ms = cuda_ms(lambda: ops.promote_scatter_plain(*dargs), 10)
    log(f"promote_scatter dedupe [{v},{s},{w}] Q={q}, each address twice: "
        f"exact, promoted {int(got[3].sum())} ({moved} slots hold another "
        f"tag without the dedupe), kernel {d_ms:.4f} ms (device "
        f"{d_dev_ms:.4f} ms), plain {d_plain_ms:.4f} ms")
    out["promote_scatter"] = dict(max_abs_err=err, ms=ms, device_ms=dev_ms,
                                  plain_ms=plain_ms, bound_ms=b, bound_by=by,
                                  library_ms=None, events_per_call=events,
                                  dedupe_ms=d_ms,
                                  dedupe_device_ms=d_dev_ms,
                                  dedupe_plain_ms=d_plain_ms)
    return out


def kernel_events(call, name: str, want: int | None = 1) -> float | None:
    """Device events a launch of the kernel ``name`` (a substring of its
    CUDA function's name) puts on the card: the device events of a
    profiler trace of 20 calls over the kernel's (the ratio stands where
    the trace drops events); None when the trace holds no such kernel.
    A kernel that writes its outputs itself must put ``want`` (1): no
    copy or fill beside it."""
    names = {}
    _, events = device_profile(call, 20, by_name=names)
    kernel = sum(n for k, n in names.items() if name in k)
    if not kernel:
        return None
    events /= kernel
    if want is not None and events != want:
        raise AssertionError(f"{name}: {events} device events a launch, "
                             f"expected {want}")
    return events


# call / device ms of the earlier global-sort designs (a stable torch.sort
# of the segment ids or of the window, then one kernel), recorded on an
# H100 80GB HBM3 at 700 W by an earlier run of this script (PERF.md §6).
# Quoted in the log beside this run's times, never in the kernels line.
# The same for the datapaths' one-chain design (one warp walked a VM's
# requests in order).
RECORDED_MS = {"popularity 12-VM staged": (0.1537, 0.0720),
              "popularity 1024-VM staged": (0.2819, 0.0679),
              "popularity Pallas bench": (0.2213, 0.0594),
              "run_sums 12-VM": (0.0440, 0.0042),
              "run_sums 1024-VM": (0.0436, 0.0048),
              "two_level 12-VM full": (0.6619, 0.6510),
              "two_level 1024-VM full": (1.1227, 1.1106),
              "single_level 12-VM": (0.5903, 0.5842),
              "single_level 1024-VM": (1.1084, 1.0976)}


def check_popularity(dev, rng, blocks, label, fadd_ns):
    """``popularity`` against its plain version, exactly: (a) the staged
    path's shape, the TRD channels of the window's first ``[V, chunk]``
    block as ``_maintain_staged`` forms them, with a cache size per VM;
    (b) the Pallas benchmark's shape (N 8192, 1024 blocks, cs 64,
    benchmarks/kernels_bench.py). Times the kernel (call and CUDA-graph
    device time), its plain version, and the library pair ``torch.exp`` +
    ``index_add_`` (in atomics' order, not bit-exact); gives the longest
    segment ``L_max`` and its chain bound, ``L_max`` dependent adds."""
    import torch
    from repro_torch.kernels.popularity import ops
    waddr, dist, served, lens = paper_window(dev, blocks)
    v = waddr.shape[0]
    cs = torch.from_numpy((rng.integers(8, 65, v) * 64).astype(
        np.float32)).to(dev)
    vm = torch.arange(v, dtype=torch.int64, device=dev)[:, None]
    key = torch.where(waddr >= 0, (vm << 31) + waddr.long(), ops._NO_BLOCK)
    uniq, inv = torch.unique(key.reshape(-1), return_inverse=True)
    nb = int((uniq < ops._NO_BLOCK).sum())
    seg = inv.reshape(waddr.shape).to(torch.int32)
    n_b = 8192
    bench = (torch.from_numpy(rng.integers(-1, 300, n_b).astype(
                 np.int32)).to(dev)[None],
             torch.from_numpy(rng.random(n_b) < 0.5).to(dev)[None],
             torch.from_numpy(rng.integers(0, 1024, n_b).astype(
                 np.int32)).to(dev)[None], 1024,
             torch.full((1,), 64.0, device=dev))
    batch = [x for x in ops.block_popularity_batch(waddr, dist, served, cs)
             if x is not None]
    if (len(batch) != int((lens > 0).sum())
            or sum(len(x[0]) for x in batch) != nb):
        raise AssertionError("popularity: the batch form's segments differ "
                             "from the grouping checked here")
    row = None
    for name, args in ((label, (dist, served, seg, nb, cs)),
                       ("Pallas bench", bench)):
        d, sv, sg, k, c = args
        got = ops.popularity_rows(*args)
        err = max_abs_err([got], [ops.popularity_rows_plain(*args)])
        ms = cuda_ms(lambda: ops.popularity_rows(*args), 50)
        dev_ms = graph_ms(lambda: ops.popularity_rows(*args))
        plain_ms = cuda_ms(lambda: ops.popularity_rows_plain(*args), 3)
        flat = sg.reshape(-1).long()

        def library():
            c_ = torch.where(sv & (d >= 0),
                             torch.exp(-d.float() / c.clamp(min=1)[:, None]),
                             0.0)
            return torch.zeros(k + 1, device=dev).index_add_(
                0, flat, c_.reshape(-1))
        lib_ms = cuda_ms(library, 50)
        lib_dev_ms = graph_ms(library)
        # dist, served and the segment ids read once, each row's cache
        # size, the scores written; ~30 operations per contributing access
        live = float((sv & (d >= 0) & (sg < k)).sum())
        b, by = bound_ms(9.0 * d.numel() + 4.0 * c.numel() + 4.0 * k,
                         30.0 * live)
        l_max = longest_run(sg, (sg >= 0) & (sg < k))
        chain_b = l_max * fadd_ns * 1e-6
        old_ms, old_dev_ms = RECORDED_MS[f"popularity {name}"]
        log(f"popularity {name} [{d.shape[0]},{d.shape[1]}] {k} blocks: "
            f"exact, kernel {ms:.4f} ms (device {dev_ms:.4f} ms; the "
            f"global-sort design as recorded in PERF.md {old_ms:.4f} ms, "
            f"device {old_dev_ms:.4f} ms), plain {plain_ms:.4f} ms, "
            f"torch.exp + index_add_ "
            f"{lib_ms:.4f} ms (device {lib_dev_ms:.4f} ms), bound {b:.6f} ms "
            f"({by}), {live:.0f} contributing accesses, longest segment "
            f"L_max {l_max} x {fadd_ns:.3f} ns = chain bound {chain_b:.5f} "
            f"ms")
        stats = dict(max_abs_err=err, ms=ms, device_ms=dev_ms,
                     plain_ms=plain_ms, bound_ms=b, bound_by=by,
                     library_ms=lib_ms, library_device_ms=lib_dev_ms,
                     l_max=l_max, chain_bound_ms=chain_b)
        if row is None:
            row = stats
        else:
            row["pallas_bench"] = stats
    return row


def check_row_limits(dev, rng):
    """``popularity`` and ``run_sums`` against their plain versions at the
    edges of the shared-memory row sort: rows of ``kernels.ROW_MAX``
    entries (heavy ties), the worst chain (one key for every entry of a
    row) and an all-padding row; a row one entry wider must raise."""
    import torch
    from repro_torch import kernels
    from repro_torch.core import popularity as pop
    from repro_torch.kernels.popularity import ops
    err = 0.0
    for n in (kernels.ROW_MAX, 1000):
        v = 3
        addr = rng.integers(0, 48, (v, n)).astype(np.int32)
        addr[1] = 7                              # the worst chain
        wa = torch.from_numpy(addr).to(dev)
        wc = torch.rand((v, n), device=dev)
        nv = torch.tensor([n, n, 0], dtype=torch.int32, device=dev)
        got = pop.window_runs(wa, wc, nv)
        err = max(err, max_abs_err(got, pop.window_runs_plain(wa, wc, nv)))
        seg = (wa + 48 * torch.arange(v, device=dev)[:, None]).to(
            torch.int32)
        seg[2] = 3 * 48                          # all padding
        args = (torch.from_numpy(rng.integers(-1, 300, (v, n)).astype(
                    np.int32)).to(dev),
                torch.from_numpy(rng.random((v, n)) < 0.7).to(dev), seg,
                3 * 48, torch.full((v,), 64.0, device=dev))
        err = max(err, max_abs_err([ops.popularity_rows(*args)],
                                   [ops.popularity_rows_plain(*args)]))
        log(f"row limits [{v},{n}]: run_sums and popularity exact (heavy "
            f"ties, one key for a whole row, an empty row)")
    wide = torch.zeros((1, kernels.ROW_MAX + 1), dtype=torch.int32,
                       device=dev)
    for fn in (lambda: pop.window_runs(wide, wide.float(), wide[:, 0]),
               lambda: ops.popularity_rows(wide, wide > 0, wide, 1,
                                           wide[:, 0].float())):
        try:
            fn()
        except ValueError as e:
            log(f"row of {kernels.ROW_MAX + 1}: refused ({e})")
        else:
            raise AssertionError("a row past the limit was not refused")
    return err


def check_clean(dev, rng, v, s, w):
    """``clean_scatter`` against its plain version, with random ways,
    random quotas and the cutoffs ``_clean_cutoffs`` gives them."""
    import torch
    from repro_torch.kernels.maintenance import ops
    tags, lru, dirty = random_state(rng, v, s, w)
    lru = np.where(tags >= 0, rng.integers(0, 64, tags.shape), -1)  # ties
    ways = torch.as_tensor(rng.integers(0, w + 1, v), dtype=torch.int32,
                           device=dev)
    quota = torch.as_tensor(rng.integers(0, 2 * s * w // 3, v),
                            dtype=torch.int32, device=dev)
    d = torch.from_numpy(dirty).to(dev)
    l = torch.from_numpy(lru.astype(np.int32)).to(dev)
    lcut, icut, take, _ = ops._clean_cutoffs(d, l, ways, quota)
    args = (d, l, ways, lcut, icut)
    got = ops.clean_scatter(*args)
    err = max_abs_err(got, ops.clean_scatter_plain(*args))
    if not torch.equal(got[1], take):
        raise AssertionError("clean_scatter flushed other than the quota")
    ms = cuda_ms(lambda: ops.clean_scatter(*args), 50)
    dev_ms = graph_ms(lambda: ops.clean_scatter(*args))
    plain_ms = cuda_ms(lambda: ops.clean_scatter_plain(*args), 10)
    cut_ms = cuda_ms(lambda: ops._clean_cutoffs(d, l, ways, quota), 10)
    b, by = bound_ms(6.0 * v * s * w + 16.0 * v, 4.0 * v * s * w)
    log(f"clean_scatter [{v},{s},{w}]: exact, flushed {int(got[1].sum())}, "
        f"kernel {ms:.4f} ms (device {dev_ms:.4f} ms), plain "
        f"{plain_ms:.4f} ms, bound {b:.5f} ms ({by}); _clean_cutoffs (two "
        f"stable sorts, plain torch) {cut_ms:.4f} ms")
    return dict(max_abs_err=err, ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                bound_ms=b, bound_by=by, library_ms=None)


def check_maintenance(dev, rng, v, s, w, lens_range, label):
    """The fused interval on the card (kernels, no host sync allowed)
    against the same interval on the CPU (plain versions), without and
    with the cleaner, and ``run_sums`` (the window compaction) on the
    first merge's window against its plain version, for ``v`` VMs whose
    windows hold ``lens_range`` requests. Returns the compaction's
    ``max_abs_err``."""
    import torch
    from repro_torch.core import popularity as pop
    from repro_torch.core import reuse
    from repro_torch.core.policies import Policy
    from repro_torch.core.simulator import CacheState
    from repro_torch.kernels.maintenance import ops
    tags, lru, dirty = random_state(rng, v, s, w, fill=0.9)
    ways = np.full(v, w, np.int32)
    ways[:3] = (w // 4, w * 5 // 8, 0)
    t = np.full(v, 30_000, np.int32)
    lens = rng.integers(*lens_range, v).astype(np.int32)
    lens[5] = 0
    # odd VMs re-read residents, even VMs re-read a small pool of mostly
    # absent blocks (served re-accesses, so the table learns promotions)
    addrs = [rng.choice(tags[i][tags[i] >= 0] if i % 2 else
                        rng.integers(0, 4 * s * w, lens[i] // 4 + 1),
                        lens[i]).astype(np.int32) for i in range(v)]
    writes = [rng.random(k) < 0.4 for k in lens]
    amat, wmat = reuse._pad_rows(addrs, writes, list(range(v)),
                                 [int(k) for k in lens])

    for quota in (0, CLEAN_QUOTA):
        results = []
        for d in (dev, torch.device("cpu")):
            a = torch.from_numpy(amat).to(d)
            dist, served, _ = reuse.decompose(
                a, torch.from_numpy(wmat).to(d), Policy.WB,
                sizing_reads_only=False)
            ssd = CacheState(*[torch.from_numpy(x).to(d)
                               for x in (tags, lru, dirty)])
            table = pop.table_init(v, 8192, d)
            args = [torch.from_numpy(x).to(d) for x in (lens, ways, t)]
            if d.type == "cuda":
                torch.cuda.synchronize()
                torch.cuda.set_sync_debug_mode("error")
            try:
                counts = []          # 7 count vectors per interval
                for _ in range(3):   # three intervals: merges + decay
                    out = ops.maintenance_interval(
                        ssd, table, dist, served, a, *args, evict_frac=0.05,
                        decay=0.5, clean_quota=quota)
                    ssd, table = out[0], out[1]
                    counts.extend(out[2:])
            finally:
                if d.type == "cuda":
                    torch.cuda.set_sync_debug_mode("default")
            results.append([x.cpu() for x in (*ssd, *table, *counts)])
        max_abs_err(*results)
        promoted = sum(int(x.sum()) for x in results[0][6::7])
        cleaned = sum(int(x.sum()) for x in results[0][10::7])
        if promoted == 0 or (quota and cleaned == 0):
            raise AssertionError("maintenance check promoted or cleaned "
                                 "nothing")
        log(f"maintenance_interval [{v},{s},{w}] K=8192 clean_quota={quota} "
            f"x3 intervals: card == CPU, no host sync; promoted {promoted}, "
            f"cleaned {cleaned}")

    # run_sums on the first merge's window: the whole compaction from the
    # unsorted window, against its plain version (timed in
    # check_window_runs)
    a = torch.from_numpy(amat)
    c = torch.rand(a.shape)
    nv = torch.from_numpy(lens)
    err = max_abs_err([x.cpu() for x in pop.window_runs(
                           a.to(dev), c.to(dev), nv.to(dev))],
                      pop.window_runs_plain(a, c, nv))
    log(f"run_sums {label} random windows {list(a.shape)}: exact")
    return err


def check_run_sums(dev, a, c, nv, label, recorded, fadd_ns):
    """``run_sums`` (``pop.window_runs``, the window compaction of
    ``table_update``) on ``[V, N]`` addresses ``a``, contributions ``c``
    and valid lengths ``nv`` against its plain version, exactly; times it
    (call, CUDA-graph device time, device events a call) beside the
    global-sort chain it replaced and the library pair
    ``torch.sort(stable)`` + ``index_add_``; gives the longest run
    ``L_max`` and its chain bound. ``recorded`` names the earlier
    kernel's recorded times in ``RECORDED_MS``, quoted in the log."""
    import torch
    from repro_torch.core import popularity as pop
    got = pop.window_runs(a, c, nv)
    cpu = [x.cpu() for x in (a, c, nv)]
    want = [x.to(dev) for x in pop.window_runs_plain(*cpu)]
    err = max_abs_err(got, want)
    ms = cuda_ms(lambda: pop.window_runs(a, c, nv), 50)
    dev_ms = graph_ms(lambda: pop.window_runs(a, c, nv))
    _, events = device_profile(lambda: pop.window_runs(a, c, nv), 20)
    plain_ms = cuda_ms(lambda: pop.window_runs_plain(*cpu), 3)
    v, n = a.shape
    valid = torch.arange(n, device=dev)[None, :] < nv[:, None]
    wa = torch.where(valid, a, pop.TABLE_EMPTY)
    wc = torch.where(valid, c, 0.0)
    rows = torch.arange(v, device=dev)[:, None]

    def old_chain():
        # the earlier design's chain: the window sort, two gathers, run
        # heads and slots, the address scatter and a zero fill, then the
        # per-run sums (index_add_ in the earlier kernel's place)
        order = torch.sort(wa, dim=1, stable=True).indices
        sa, sc = wa.gather(1, order), wc.gather(1, order)
        head = torch.ones_like(sa, dtype=torch.bool)
        head[:, 1:] = sa[:, 1:] != sa[:, :-1]
        seg = head.long().cumsum(dim=1) - 1
        caddr = torch.full_like(sa, pop.TABLE_EMPTY).scatter_(1, seg, sa)
        cval = torch.zeros(v * n, device=dev).index_add_(
            0, (seg + rows * n).reshape(-1), sc.reshape(-1)).view(v, n)
        return caddr, torch.where(caddr == pop.TABLE_EMPTY, 0.0, cval)
    chain_dev_ms = graph_ms(old_chain)
    _, chain_events = device_profile(old_chain, 20)
    # the same compaction as a library pair, in atomics' order: the stable
    # sort that groups the window, index_add_ into each entry's run slot
    key = (rows * 2**32 + wa.long()).reshape(-1)
    slot = torch.unique(key, return_inverse=True)[1]
    vals = wc.reshape(-1)

    def library():
        torch.sort(key, stable=True)
        return torch.zeros(v * n, device=dev).index_add_(0, slot, vals)
    lib_ms = cuda_ms(library, 50)
    lib_dev_ms = graph_ms(library)
    # addresses, contributions and lengths read once, both outputs written
    b, by = bound_ms(16.0 * a.numel() + 4.0 * v, 2.0 * float(valid.sum()))
    l_max = longest_run(a, valid)
    chain_b = l_max * fadd_ns * 1e-6
    stats = dict(max_abs_err=err, ms=ms, device_ms=dev_ms,
                 plain_ms=plain_ms, bound_ms=b, bound_by=by,
                 library_ms=lib_ms, library_device_ms=lib_dev_ms,
                 device_events=events, l_max=l_max, chain_bound_ms=chain_b,
                 old_chain_device_ms=chain_dev_ms,
                 old_chain_device_events=chain_events)
    old_ms, old_dev_ms = RECORDED_MS[recorded]
    before = (f"; the earlier run_sums kernel alone as recorded in PERF.md "
              f"{old_ms} ms (device {old_dev_ms} ms)")
    log(f"run_sums {label} {list(a.shape)}: exact, kernel {ms:.4f} ms "
        f"(device {dev_ms:.4f} ms, {events:.0f} device events a call); the "
        f"global-sort chain it replaces (index_add_ in its kernel's place) "
        f"device {chain_dev_ms:.4f} ms in {chain_events:.0f} device events"
        f"{before}; plain (CPU) {plain_ms:.4f} ms, torch.sort(stable) + "
        f"index_add_ {lib_ms:.4f} ms (device {lib_dev_ms:.4f} ms), bound "
        f"{b:.5f} ms ({by}), longest run L_max {l_max} x {fadd_ns:.3f} ns "
        f"= chain bound {chain_b:.5f} ms")
    return stats


def paper_window(dev, blocks):
    """The TRD channels of a window's first ``[V, chunk]`` block as the
    maintenance modes form them: ``(addresses, dist, served, lengths)``,
    addresses past each VM's length ``-1``."""
    import torch
    from repro_torch.core import controller
    a_np, w_np = blocks[0]
    a = torch.from_numpy(a_np).to(dev)
    w = torch.from_numpy(w_np).to(dev)
    lens = (a >= 0).sum(dim=1).to(torch.int32)
    amat, dist, served = controller._trd_rows(a, w, lens, int(lens.max()))
    col = torch.arange(amat.shape[1], device=dev)[None, :]
    return torch.where(col < lens[:, None], amat, -1), dist, served, lens


def check_window_runs(dev, rng, blocks, label, fadd_ns):
    """``run_sums`` on the window of the fused interval's first merge in
    the run itself: the first block's addresses, valid lengths and Eq. 1
    contributions at a cache size per VM (as ``maintenance_interval``
    forms them)."""
    import torch
    from repro_torch.core import popularity as pop
    waddr, dist, served, lens = paper_window(dev, blocks)
    cs = torch.from_numpy((rng.integers(8, 65, waddr.shape[0]) * 64).astype(
        np.float32)).to(dev)
    contrib = pop.contributions(dist, served, cs[:, None])
    return check_run_sums(dev, waddr, contrib, lens, f"{label} first window",
                          f"run_sums {label}", fadd_ns)


def decode_tolerance_err(got, want) -> tuple[float, int, int]:
    """``(max |got - want|, elements over tolerance, elements more than
    one bf16 ulp off)`` of a decode output against its plain version:
    float32 outputs within 2e-5 (the JAX test's atol); bf16 outputs
    within one bf16 ulp of the plain value, or 2e-5 where that ulp is
    finer (an output that cancels to near zero carries the float32
    rounding of its terms, not of itself)."""
    import torch
    g, w = got.float(), want.float()
    err = (g - w).abs()
    tol = torch.full_like(w, DECODE_ATOL)
    over_ulp = 0
    if got.dtype == torch.bfloat16:
        ulp = torch.exp2(torch.floor(torch.log2(w.abs().clamp(
            min=2.0**-126))) - 7)
        tol = torch.maximum(tol, ulp)
        over_ulp = int((err > ulp).sum())
    return float(err.max()), int((err > tol).sum()), over_ulp


def decode_inputs(dev, rng, b, h, hkv, d, pool, ps, n_pages, q_dtype,
                  kv_dtype, lengths):
    """Seeded decode operands on the card; the page table draws distinct
    pool pages for the whole batch (a random permutation) when the pool
    is large enough."""
    import torch
    q = torch.from_numpy(rng.normal(size=(b, h, d)).astype(np.float32))
    kp = torch.from_numpy(rng.standard_normal(
        (pool, ps, hkv, d), dtype=np.float32))
    vp = torch.from_numpy(rng.standard_normal(
        (pool, ps, hkv, d), dtype=np.float32))
    if b * n_pages <= pool:
        pt = rng.permutation(pool)[:b * n_pages].reshape(b, n_pages)
    else:
        pt = rng.integers(0, pool, (b, n_pages))
    return (q.to(dev, q_dtype), kp.to(dev, kv_dtype), vp.to(dev, kv_dtype),
            torch.from_numpy(pt.astype(np.int32)).to(dev),
            torch.from_numpy(np.asarray(lengths, np.int32)).to(dev))


def decode_bound(args) -> tuple[float, str]:
    """Least time for one decode call: K and V rows of the tokens each
    row needs (its length; every slot of its table when the length is 0
    or past the table) plus q, the output, the lengths and the table
    entries read, over the HBM rate; against 4 * tokens * H * D
    operations at the scalar rate."""
    q, kp, _, pt, ln = args
    b, h, d = q.shape
    _, ps, hkv, _ = kp.shape
    slots = pt.shape[1] * ps
    lens = ln.long().cpu()
    tok = float(torch_where_len(lens, slots).sum())
    pages = float(((torch_where_len(lens, slots) + ps - 1) // ps).sum())
    nbytes = (2 * tok * hkv * d * kp.element_size()
              + 2 * q.numel() * q.element_size() + 4 * b + 4 * pages)
    return bound_ms(nbytes, 4.0 * tok * h * d)


def torch_where_len(lens, slots):
    import torch
    return torch.where((lens <= 0) | (lens > slots), slots, lens)


def sdpa_ms(args):
    """One library call for the same function, timed only: gather each
    row's pages into ``[B, Hkv, S, D]`` (timed on its own), then
    ``scaled_dot_product_attention`` with a length mask and grouped
    query heads. Returns ``(gather_ms, sdpa_ms)``."""
    import torch
    import torch.nn.functional as F
    q, kp, vp, pt, ln = args
    b, h, d = q.shape
    _, ps, hkv, _ = kp.shape
    s = pt.shape[1] * ps
    idx = pt.long()

    def gather():
        return tuple(x[idx].reshape(b, s, hkv, d).transpose(1, 2)
                     .contiguous() for x in (kp, vp))
    k, v = gather()
    qq = q.to(kp.dtype).reshape(b, h, 1, d)
    mask = (torch.arange(s, device=q.device)[None, :]
            < ln[:, None])[:, None, None, :]

    def sdpa():
        try:
            return F.scaled_dot_product_attention(qq, k, v, attn_mask=mask,
                                                  enable_gqa=True)
        except TypeError:             # a PyTorch without enable_gqa
            g = h // hkv
            return F.scaled_dot_product_attention(
                qq, k.repeat_interleave(g, 1), v.repeat_interleave(g, 1),
                attn_mask=mask)
    return cuda_ms(gather, 10), cuda_ms(sdpa, 10)


QWEN3_DECODE = (64, 32, 8, 128, 16384, 16, 256)   # B, H, Hkv, D, NP, PS, pages


def check_decode(dev, rng, big=QWEN3_DECODE):
    """``paged_decode_attention`` against its plain version: (a) the
    serving path's shape (B 1, H = Hkv = 8, D 128, PS 16, 6 pages of a
    512-page pool) in float32, with bf16 pages (as serving runs it) and
    all bf16, at a random length, then at pinned lengths
    (:func:`decode_pinned`); (b) qwen3-4b batched decode (B 64, H 32, Hkv 8, D 128, PS
    16, 256 pages per row, a 16,384-page bf16 pool under a permutation
    table, lengths in [1, 4096] with one row at 1 and one at 4096); (c)
    (b) with every token past each length poisoned with 999; (d) (b)
    with one row of length 0. Returns the JSON row (shape (a) with bf16
    pages at 6 pages) with the random-length run and (b)'s numbers, and
    the launch plans chosen at (a) and (b), beside it."""
    import torch
    from repro_torch.kernels.decode_attention import ops
    f32, bf16 = torch.float32, torch.bfloat16
    row, worst = None, 0.0
    for q_dt, kv_dt in ((f32, f32), (f32, bf16), (bf16, bf16)):
        args = decode_inputs(dev, rng, 1, 8, 8, 128, 512, 16, 6, q_dt, kv_dt,
                             [int(rng.integers(1, 97))])
        err, bad, _ = decode_tolerance_err(
            ops.paged_decode_attention(*args),
            ops.paged_decode_attention_plain(*args))
        if bad:
            raise AssertionError(f"decode (a) {q_dt}/{kv_dt}: {bad} elements "
                                 f"out of tolerance (max err {err:.3e})")
        worst = max(worst, err)
        ms = cuda_ms(lambda: ops.paged_decode_attention(*args), 50)
        dev_ms = graph_ms(lambda: ops.paged_decode_attention(*args))
        plain_ms = cuda_ms(lambda: ops.paged_decode_attention_plain(*args),
                           20)
        gather_ms, lib_ms = sdpa_ms(args)
        b, by = decode_bound(args)
        log(f"paged_decode_attention (a) [1,8,128] 6x16 tokens "
            f"{str(q_dt)[6:]}/{str(kv_dt)[6:]} len {int(args[4][0])}: max "
            f"err {err:.3e} (in tolerance), kernel {ms:.4f} ms (device "
            f"{dev_ms:.4f} ms), plain {plain_ms:.4f} ms, gather {gather_ms:.4f}"
            f" ms + sdpa {lib_ms:.4f} ms, bound {b:.6f} ms ({by})")
        if (q_dt, kv_dt) == (f32, bf16):
            random_len = dict(length=int(args[4][0]), ms=ms, device_ms=dev_ms,
                              plain_ms=plain_ms, bound_ms=b, bound_by=by,
                              library_ms=lib_ms, library_gather_ms=gather_ms)
    row, worst_p = decode_pinned(dev)
    row.update(random_length=random_len)
    worst = max(worst, worst_p)

    b_, h_, hkv, d, pool, ps, n_pages = big
    slots = n_pages * ps
    lens = rng.integers(1, slots + 1, b_)
    lens[:2] = (1, slots)
    args = decode_inputs(dev, rng, *big, bf16, bf16, lens)
    got = ops.paged_decode_attention(*args)
    err, bad, over_ulp = decode_tolerance_err(
        got, ops.paged_decode_attention_plain(*args))
    worst_b = err
    if bad:
        raise AssertionError(f"decode (b): {bad} elements out of tolerance")
    ms = cuda_ms(lambda: ops.paged_decode_attention(*args), 20)
    dev_ms = graph_ms(lambda: ops.paged_decode_attention(*args), 10)
    plain_ms = cuda_ms(lambda: ops.paged_decode_attention_plain(*args), 3)
    gather_ms, lib_ms = sdpa_ms(args)
    b, by = decode_bound(args)
    toks = int(torch_where_len(args[4].long().cpu(), slots).sum())
    plan_b = ops.launch_plan(*args[:4])   # the plan the wrapper launched
    if plan_b.splits < 2 or not plan_b.async_copy:
        raise AssertionError(f"decode (b): expected a split cp.async plan, "
                             f"the wrapper launched {plan_b}")
    log(f"paged_decode_attention (b) qwen3-4b [{b_},{h_},{d}] Hkv {hkv}, "
        f"{n_pages}x{ps} tokens, pool {pool} bf16, {toks} tokens, "
        f"{plan_b}: max err "
        f"{err:.3e} (in tolerance; {over_ulp} of {got.numel()} outputs "
        f"more than one bf16 ulp off), kernel {ms:.4f} ms (device {dev_ms:.4f} ms), plain "
        f"{plain_ms:.4f} ms, gather {gather_ms:.4f} ms + sdpa {lib_ms:.4f} "
        f"ms, bound {b:.5f} ms ({by})")

    # (c) poison every token past each row's length
    q, kp, vp, pt, ln = args
    pos = (torch.arange(n_pages, device=dev)[None, :, None] * ps
           + torch.arange(ps, device=dev)[None, None, :])
    dead = (pos >= ln.long()[:, None, None]).reshape(-1)   # [B*pages*PS]
    flat = pt.long().reshape(-1)
    kp2, vp2 = kp.clone(), vp.clone()
    for src, dst in ((kp, kp2), (vp, vp2)):
        rows = src[flat].reshape(-1, hkv, d)
        dst[flat] = torch.where(dead[:, None, None], 999.0, rows).reshape(
            -1, ps, hkv, d).to(src.dtype)
    poisoned = ops.paged_decode_attention(q, kp2, vp2, pt, ln)
    if not torch.equal(poisoned, got):
        raise AssertionError("decode (c): poisoned tokens changed the output")
    err_c, bad, _ = decode_tolerance_err(
        poisoned, ops.paged_decode_attention_plain(q, kp2, vp2, pt, ln))
    if bad:
        raise AssertionError(f"decode (c): {bad} elements out of tolerance")
    log(f"paged_decode_attention (c) poisoned past each length "
        f"({int(dead.sum())} tokens = 999): output identical, max err "
        f"{err_c:.3e} against the plain version")
    del kp2, vp2

    # (d) one row of length 0: the mean of V over the row's whole table
    ln0 = ln.clone()
    ln0[5] = 0
    got0 = ops.paged_decode_attention(q, kp, vp, pt, ln0)
    err_d, bad, _ = decode_tolerance_err(
        got0, ops.paged_decode_attention_plain(q, kp, vp, pt, ln0))
    mean_v = vp[pt[5].long()].float().reshape(-1, hkv, d).mean(0)
    err_mean = float((got0[5].float().reshape(hkv, h_ // hkv, d)
                      - mean_v[:, None, :]).abs().max())
    if bad or err_mean > 2.0**-7:
        raise AssertionError(f"decode (d): {bad} out of tolerance, mean of V "
                             f"off by {err_mean:.3e}")
    log(f"paged_decode_attention (d) length 0 row: max err {err_d:.3e}, "
        f"row 5 = mean of V over its {slots} slots within {err_mean:.3e}")
    row.update(max_abs_err=max(worst, worst_b, err_c, err_d),
               qwen3_batched=dict(ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                                  bound_ms=b, bound_by=by, library_ms=lib_ms,
                                  library_gather_ms=gather_ms,
                                  max_abs_err=worst_b, tokens=toks,
                                  over_ulp=over_ulp,
                                  plan=plan_b._asdict()))
    return row


DECODE_PINNED = (16, 48, 96)     # tokens: 1, 3 and 6 pages of 16


def decode_pinned(dev):
    """Shape (a), the serving path's (B 1, H = Hkv = 8, D 128, float32 q,
    bf16 pages, 6 pages of 16 of a 512-page pool), at pinned lengths of
    1, 3 and 6 pages, from a generator of its own so that the inputs do
    not depend on earlier phases: each within tolerance, its call and
    device times, bound and SDPA beside it. Returns the JSON row (6
    pages) with the others under ``pinned``, and the largest error."""
    import torch
    from repro_torch.kernels.decode_attention import ops
    rng = np.random.default_rng(19)
    pinned, worst = {}, 0.0
    for n_tok in DECODE_PINNED:
        args = decode_inputs(dev, rng, 1, 8, 8, 128, 512, 16, 6,
                             torch.float32, torch.bfloat16, [n_tok])
        plan = ops.launch_plan(*args[:4])   # the plan the wrapper launches
        if plan.splits != 1 or not plan.async_copy:
            raise AssertionError(f"decode (a): expected one cp.async CTA a "
                                 f"(sequence, KV head), the wrapper "
                                 f"launches {plan}")
        err, bad, _ = decode_tolerance_err(
            ops.paged_decode_attention(*args),
            ops.paged_decode_attention_plain(*args))
        if bad:
            raise AssertionError(f"decode (a) at {n_tok} tokens: {bad} "
                                 f"elements out of tolerance")
        worst = max(worst, err)
        ms = cuda_ms(lambda: ops.paged_decode_attention(*args), 50)
        dev_ms = graph_ms(lambda: ops.paged_decode_attention(*args))
        plain_ms = cuda_ms(lambda: ops.paged_decode_attention_plain(*args),
                           20)
        gather_ms, lib_ms = sdpa_ms(args)
        b, by = decode_bound(args)
        pinned[n_tok] = dict(ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                             bound_ms=b, bound_by=by, library_ms=lib_ms,
                             library_gather_ms=gather_ms, max_abs_err=err)
        log(f"paged_decode_attention (a) pinned {n_tok} tokens "
            f"({n_tok // 16} pages) float32/bfloat16, {plan}: max err "
            f"{err:.3e}, kernel {ms:.4f} ms (device {dev_ms:.4f} ms), plain "
            f"{plain_ms:.4f} ms, gather {gather_ms:.4f} ms + sdpa "
            f"{lib_ms:.4f} ms, bound {b:.6f} ms ({by})")
    row = dict(pinned[DECODE_PINNED[-1]], pinned=pinned,
               plan=plan._asdict())
    return row, worst


# ---------------------------------------------------------------------------
# phases 3 to 7: the controllers' paths
# ---------------------------------------------------------------------------

def etica(cfg, num_vms):
    """A builder ``(device, telemetry=None) -> EticaCache``."""
    import dataclasses
    from repro_torch.core.controller import EticaCache

    def build(device, telemetry=None):
        return EticaCache(dataclasses.replace(cfg, telemetry=telemetry),
                          num_vms, device=device)
    return build


def eci(capacity, num_vms, **kw):
    """A builder ``(device, telemetry=None)`` of ``make_eci_cache``."""
    from repro_torch.core.baselines import make_eci_cache

    def build(device, telemetry=None):
        return make_eci_cache(capacity, num_vms, device=device,
                              telemetry=telemetry, **kw)
    return build


def run_controller(build, trace, device, telemetry=None):
    import torch
    cache = build(device, telemetry)
    if device != "cpu":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = cache.run(trace)
    if device != "cpu":
        torch.cuda.synchronize()
    return cache, res, time.perf_counter() - t0


def span_breakdown(build, trace, label, repeats=1):
    """``repeats`` more card runs with span timing on: CUDA-event time of
    the sizing, datapath and maintenance spans (each span waits for its
    work, so these runs are slower than the untimed one and their results
    are not reported as the cell's speed)."""
    from repro_torch.runtime.telemetry import TelemetryRecorder
    for _ in range(repeats):
        rec = TelemetryRecorder(span_timing=True)
        _, _, wall = run_controller(build, trace, "cuda", rec)
        spans = {k: (s.n, s.total) for k, s in rec.spans.items()}
        inside = sum(t for _, t in spans.values())
        log(f"{label} span breakdown (timed run {wall:.3f} s): " + ", ".join(
            f"{k} {n} spans {t:.3f} s" for k, (n, t) in spans.items())
            + f", outside spans {wall - inside:.3f} s")


def assert_same(res_a, res_b, label):
    for v, (a, b) in enumerate(zip(res_a, res_b)):
        if a.stats != b.stats:
            raise AssertionError(f"{label}: VM {v} stats differ:\n"
                                 f"  card {a.stats}\n  cpu  {b.stats}")
        if not np.array_equal(a.alloc_history, b.alloc_history):
            raise AssertionError(f"{label}: VM {v} alloc_history differs")


def fig15_config(active, total):
    from repro_torch.core.controller import EticaConfig, Geometry
    geo = Geometry(num_sets=16, max_ways=32)
    return EticaConfig(dram_capacity=12 * active, ssd_capacity=25 * active,
                       geometry_dram=geo, geometry_ssd=geo,
                       resize_interval=max(500, total // 3),
                       promo_interval=max(125, total // 12))


def drive(build, trace, label, expect):
    """One card run of the controller's ``run`` with the launch counts
    set to 0 just before and read just after (exactly the kernels in
    ``expect`` must have launched), then the same run on the CPU, which
    must give identical results. Returns ``(launches, cache, results,
    requests/s)`` of the card run."""
    import torch
    from repro_torch import kernels
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    cache, res_card, wall = run_controller(build, trace, "cuda")
    launches = serving_launches(label, expect, only=True)
    peak = torch.cuda.max_memory_allocated()
    log(f"{label} ({len(trace)} requests): card {wall:.3f} s, "
        f"{len(trace) / wall:.0f} requests/s, peak device memory "
        f"{peak / 2**20:.1f} MiB, launches {launches}")
    _, res_cpu, wall_cpu = run_controller(build, trace, "cpu")
    assert_same(res_card, res_cpu, label)
    hit = float(np.mean([r.hit_ratio for r in res_card]))
    log(f"{label}: card == CPU (CPU plain path {wall_cpu:.1f} s); avg_hit "
        f"{hit:.4f}, ssd_writes {sum(r.ssd_writes for r in res_card):.0f}")
    return launches, cache, res_card, len(trace) / wall


def clean_totals(cache) -> tuple[int, int, int]:
    """(clean flushes, peak dirty, final dirty) from the cleaner's logs,
    as fig14_endurance.py reports them."""
    occ = np.stack(cache.dirty_log).sum(axis=1)
    return (int(np.stack(cache.clean_log).sum()), int(occ.max()),
            int(occ[-1]))


def endurance(label, etica_res, eci_res, clean_cache):
    """Log SSD writes per controller and the ETICA/ECI reduction."""
    tot_e = sum(r.ssd_writes for r in etica_res)
    tot_c = sum(r.ssd_writes for r in eci_res)
    red = 1 - tot_e / max(tot_c, 1)
    flushes, peak, final = clean_totals(clean_cache)
    log(f"{label}: ssd_writes ETICA {tot_e:.0f}, ECI-Cache {tot_c:.0f}, "
        f"reduction {red:.4f}; clean flushes {flushes}, peak dirty {peak}, "
        f"final dirty {final}")
    return red


def check_fig14(launches, scale_reqs=8000):
    """fig14_endurance.py's mix and three controllers, card == CPU, held
    to the JAX package's CPU values; the exporter round trip."""
    import dataclasses
    from repro_torch.core.controller import EticaConfig, Geometry
    from repro_torch.runtime import metrics
    trace = trace_mix(FIG14_VMS, scale_reqs, 0.25)
    geo = Geometry(num_sets=16, max_ways=32)
    cfg = EticaConfig(dram_capacity=400, ssd_capacity=800,
                      geometry_dram=geo, geometry_ssd=geo,
                      resize_interval=2_000, promo_interval=500)
    n = len(FIG14_VMS)
    launches["fig14-etica"], _, e_res, _ = drive(
        etica(cfg, n), trace, "fig14 ETICA", ETICA_KERNELS)
    launches["fig14-eci"], _, c_res, _ = drive(
        eci(1200, n, geometry=geo, resize_interval=2_000), trace,
        "fig14 ECI-Cache", ECI_KERNELS)
    ccfg = dataclasses.replace(cfg, clean_quota=CLEAN_QUOTA)
    launches["fig14-etica-clean"], clean, cl_res, _ = drive(
        etica(ccfg, n), trace, "fig14 ETICA clean_quota=4", CLEAN_KERNELS)
    red = endurance("fig14", e_res, c_res, clean)
    got = {vm: (int(a.ssd_writes), int(b.ssd_writes))
           for vm, a, b in zip(FIG14_VMS, e_res, c_res)}
    got_clean = {vm: (int(r.stats["flushes"]), int(r.stats["evict_flushes"]),
                      int(r.stats["dirty_resident"]))
                 for vm, r in zip(FIG14_VMS, cl_res)}
    totals = (f"{red:.3f}", *clean_totals(clean))
    want = (FIG14_JAX_CPU_REDUCTION, FIG14_JAX_CPU_CLEAN_FLUSHES,
            FIG14_JAX_CPU_PEAK_DIRTY, FIG14_JAX_CPU_FINAL_DIRTY)
    if (got, got_clean, totals) != (FIG14_JAX_CPU_WRITES, FIG14_JAX_CPU_CLEAN,
                                    want):
        raise AssertionError(f"fig14 differs from the JAX CPU values:\n"
                             f"  {got}\n  {got_clean}\n  {totals}")
    for a, b in zip(e_res, cl_res):    # cleaning moves write-back only
        for k in ("reads", "writes", "read_hits_l1", "read_hits_l2",
                  "write_hits_l2"):
            if a.stats[k] != b.stats[k]:
                raise AssertionError(f"fig14: cleaning changed {k}")
    fams = metrics.parse_exposition(metrics.render_cache(clean))
    for v, r in enumerate(cl_res):
        if fams["etica_flushes_total"]["samples"][(("vm", str(v)),)] != \
                r.stats["flushes"]:
            raise AssertionError("fig14: exporter flush count differs")
    log(f"fig14: per-VM writes and cleaner counts equal the JAX CPU values; "
        f"reduction {totals[0]}, clean flushes {totals[1]}, peak dirty "
        f"{totals[2]}, final dirty {totals[3]}; exporter round trip exact "
        f"({len(fams)} families)")


# ---------------------------------------------------------------------------
# phase 8: two-tier KV serving
# ---------------------------------------------------------------------------

def serving_trace():
    """benchmarks/serving_two_tier.py's FULL churn trace (seed 1)."""
    from repro_torch.traces.generators import SessionSpec, generate_sessions
    spec = SessionSpec(num_tenants=SERVING_TENANTS, target_live=1024,
                       max_pages=6)
    return generate_sessions(spec, 20_000, seed=1)


def serving_cfg(**kw):
    """The FULL configuration's manager (``_mk_cfg``: PS 16, Hkv 2, D 8,
    float32, controller only), with ``kw`` replaced."""
    from repro_torch.kvcache import TwoTierConfig
    return TwoTierConfig(**(dict(
        page_size=16, hbm_pages=512, num_kv_heads=2, head_dim=8,
        num_layers=1, dtype="float32", maintenance_interval=64,
        resize_interval=512, pop_capacity=2048, materialize=False) | kw))


def run_serving(kind, cfg, trace, device, decode_every=0, telemetry=None):
    """One replay of ``trace`` through ``run_events`` (bank seed 7, as the
    benchmark); returns ``(manager, wall seconds)``."""
    import dataclasses
    import torch
    from repro_torch.kvcache import GlobalLRUManager, TwoTierKVManager
    from repro_torch.launch.serve import gaussian_pages, run_events
    cfg = dataclasses.replace(cfg, telemetry=telemetry)
    if kind == "lru":
        mgr = GlobalLRUManager(cfg, SERVING_TENANTS, device=device)
    else:
        mgr = TwoTierKVManager(cfg, SERVING_TENANTS,
                               batched=kind == "etica", device=device)
    kb, vb = gaussian_pages(cfg, 8, 7, pin=device == "cuda")
    if device == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    run_events(mgr, trace, kb, vb, decode_every=decode_every, seed=1)
    if device == "cuda":
        torch.cuda.synchronize()
    return mgr, time.perf_counter() - t0


def placements(mgr):
    return (dict(mgr.slot_owner), tuple(mgr.free),
            tuple(int(q) for q in mgr.tenant_quota),
            tuple(int(u) for u in mgr.tenant_used))


def serving_launches(label, expect, only=False):
    """Check one card run's launch counts (read just after it): every
    kernel in ``expect`` launched; with ``only``, no other did."""
    from repro_torch import kernels
    n = kernels.launch_counts()
    missing = [k for k in expect if n[k] == 0]
    extra = [k for k in kernels.KERNELS if k not in expect and n[k]]
    if missing or (only and extra):
        raise AssertionError(f"{label}: kernels not launched {missing}, "
                             f"launched off the path {extra}: {n}")
    return n


def serving_spans(kind, cfg, trace, label, decode_every=0, repeats=1):
    """``repeats`` span-timed card runs: CUDA-event time of the
    maintenance and sizing dispatches (each span waits for its work, so
    these runs are not the cell's speed)."""
    from repro_torch.runtime.telemetry import TelemetryRecorder
    for _ in range(repeats):
        rec = TelemetryRecorder(span_timing=True)
        _, wall = run_serving(kind, cfg, trace, "cuda", decode_every, rec)
        spans = {k: (v.n, v.total) for k, v in rec.spans.items()}
        inside = sum(t for _, t in spans.values())
        log(f"{label} span breakdown (timed run {wall:.3f} s): " + ", ".join(
            f"{k} {n} spans {t:.3f} s" for k, (n, t) in spans.items())
            + f", outside spans {wall - inside:.3f} s")


def check_serving(launches):
    """(i) The FULL configuration controller-only: etica, etica-seq and
    lru on the card and on the CPU (Stats and placements identical),
    etica == etica-seq, and the numbers of BENCH_serving.json; etica with
    the cleaner card == CPU. (ii) The same trace at qwen3-4b's KV width
    (Hkv 8, D 128, bf16 pool, materialized) with a decode every 8th
    activation: a timed run (launch counts, events/s, decode time, peak
    memory), then a run that holds every decode output against the plain
    version on the card; Stats are (i)'s page counts x 65,536 bytes."""
    import dataclasses
    from collections import Counter
    import torch
    from repro_torch import kernels
    from repro_torch.kernels.decode_attention import ops
    from repro_torch.launch import serve as serve_mod
    trace = serving_trace()
    if (trace.num_sessions, trace.max_live) != (BENCH_SERVING["sessions"],
                                                BENCH_SERVING["max_live"]):
        raise AssertionError(f"serving trace: {trace.num_sessions} sessions, "
                             f"max live {trace.max_live}")
    cfg = serving_cfg()
    card = {}
    for kind, expect in (("etica", SERVING_KERNELS),
                         ("etica-seq", ("count_between",)), ("lru", ())):
        label = f"serving-{kind}"
        kernels.reset_launch_counts()
        mgr, wall = run_serving(kind, cfg, trace, "cuda")
        launches[label] = serving_launches(label, expect, only=True)
        cpu, wall_cpu = run_serving(kind, cfg, trace, "cpu")
        if mgr.stats != cpu.stats or placements(mgr) != placements(cpu):
            raise AssertionError(f"{label}: card != CPU\n  {mgr.stats}\n"
                                 f"  {cpu.stats}")
        card[kind] = mgr
        s = mgr.stats
        log(f"{label} ({len(trace)} events): card {wall:.3f} s, "
            f"{len(trace) / wall:.0f} events/s; card == CPU (CPU plain path "
            f"{wall_cpu:.1f} s); hit {s.hits / s.activations:.4f}, "
            f"dma_write {s.dma_write_bytes}, dma_read {s.dma_read_bytes}, "
            f"pop_drops {s.pop_drops}, launches {launches[label]}")
    e, q = card["etica"], card["etica-seq"]
    if e.stats != q.stats or placements(e) != placements(q):
        raise AssertionError("serving: batched controller != host-dict oracle")
    for kind in ("etica", "lru"):
        s = card[kind].stats
        got = (s.dma_write_bytes, s.dma_read_bytes,
               f"{s.hits / s.activations:.3f}")
        if got != BENCH_SERVING[kind] or s.pop_drops:
            raise AssertionError(f"serving {kind}: {got}, pop_drops "
                                 f"{s.pop_drops} != BENCH_serving.json "
                                 f"{BENCH_SERVING[kind]}")
    if e.stats.dma_write_bytes != e.stats.appends * cfg.page_bytes:
        raise AssertionError("serving: WBWO bound not exact")
    red = 1 - e.stats.dma_write_bytes / card["lru"].stats.dma_write_bytes
    log(f"serving: BENCH_serving.json reproduced on the card (sessions "
        f"{trace.num_sessions}, max live {trace.max_live}, ETICA "
        f"{BENCH_SERVING['etica']}, LRU {BENCH_SERVING['lru']}); batched == "
        f"oracle; DMA-write reduction vs LRU {red:.3f}")
    serving_spans("etica", cfg, trace, "serving-etica", repeats=3)

    ccfg = dataclasses.replace(cfg, clean_quota=CLEAN_QUOTA)
    kernels.reset_launch_counts()
    mgr, wall = run_serving("etica", ccfg, trace, "cuda")
    launches["serving-etica-clean"] = serving_launches(
        "serving-etica-clean", SERVING_KERNELS, only=True)
    cpu, _ = run_serving("etica", ccfg, trace, "cpu")
    if mgr.stats != cpu.stats or placements(mgr) != placements(cpu):
        raise AssertionError("serving-etica-clean: card != CPU")
    log(f"serving-etica-clean (clean_quota={CLEAN_QUOTA}): card {wall:.3f} s, "
        f"card == CPU; flushes {mgr.stats.flushes}, evict_flushes "
        f"{mgr.stats.evict_flushes}, dirty_dropped {mgr.stats.dirty_dropped},"
        f" dma_write {mgr.stats.dma_write_bytes}")

    # (ii) qwen3-4b's KV width, materialized, decoding
    wcfg = serving_cfg(num_kv_heads=8, head_dim=128, dtype="bfloat16",
                       materialize=True)
    scale = wcfg.page_bytes // cfg.page_bytes
    want = (e.stats.dma_write_bytes * scale, e.stats.dma_read_bytes * scale)
    real = serve_mod.decode_attention
    events = []

    def timed(q, kv, pt, ln):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = real(q, kv, pt, ln)
        end.record()
        events.append((start, end))
        return out

    errs, shapes, rows_pages = [], set(), []

    def checked(q, kv, pt, ln):
        out = real(q, kv, pt, ln)
        plain = ops.paged_decode_attention_plain(q, *kv, pt, ln)
        errs.append((out.float() - plain.float()).abs().max())
        shapes.add(tuple(pt.shape))
        ps = kv[0].shape[1]
        need = torch.where(ln > 0, (ln + ps - 1) // ps, pt.shape[1])
        rows_pages.append(need.clamp(max=pt.shape[1]).tolist())
        return out

    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    serve_mod.decode_attention = timed
    try:
        mgr, wall = run_serving("etica", wcfg, trace, "cuda", decode_every=8)
    finally:
        serve_mod.decode_attention = real
    launches["serving-full-width"] = serving_launches(
        "serving-full-width", SERVING_DECODE_KERNELS, only=True)
    peak = torch.cuda.max_memory_allocated()
    dec_ms = float(np.mean([a.elapsed_time(b) for a, b in events]))
    got = (mgr.stats.dma_write_bytes, mgr.stats.dma_read_bytes)
    if got != want or (mgr.stats.activations, mgr.stats.hits) != (
            e.stats.activations, e.stats.hits):
        raise AssertionError(f"serving-full-width: {got} != {want}")
    log(f"serving-full-width (qwen3-4b KV: Hkv 8, D 128, bf16, page_bytes "
        f"{wcfg.page_bytes}): card {wall:.3f} s, {len(trace) / wall:.0f} "
        f"events/s, {len(events)} decodes, mean decode {dec_ms:.4f} ms "
        f"(CUDA events around the call), peak device memory "
        f"{peak / 2**20:.1f} MiB, dma_write {got[0]}, dma_read {got[1]} "
        f"(= controller-only x {scale}), launches "
        f"{launches['serving-full-width']}")
    serve_mod.decode_attention = checked
    try:
        mgr2, _ = run_serving("etica", wcfg, trace, "cuda", decode_every=8)
    finally:
        serve_mod.decode_attention = real
    err = float(torch.stack(errs).max())
    if mgr2.stats != mgr.stats or err > DECODE_ATOL or \
            len(errs) != len(events):
        raise AssertionError(f"serving-full-width decode: max err {err:.3e} "
                             f"over {len(errs)} decodes")
    pages = [p for r in rows_pages for p in r]
    log(f"serving-full-width: all {len(errs)} decode outputs within "
        f"{DECODE_ATOL} of the plain version on the card (max err "
        f"{err:.3e}; float32 out from bf16 pages; page-table widths "
        f"{sorted(s[1] for s in shapes)}); rows a decode "
        f"{np.mean([len(r) for r in rows_pages]):.3f}, pages a row read: "
        f"mean {np.mean(pages):.3f}, histogram "
        f"{dict(sorted(Counter(pages).items()))}")
    serving_spans("etica", wcfg, trace, "serving-full-width", decode_every=8)
    return dict(decode_ms=dec_ms, decodes=len(events), max_abs_err=err,
                mean_pages=float(np.mean(pages)),
                pages_histogram=dict(sorted(Counter(pages).items())))


def check_serving_sync(dev, rng):
    """One ``serving_maintenance`` interval at the FULL configuration's
    widths (4 tenants, a 512-entry window, K 2048) on inputs already on
    the card, under ``set_sync_debug_mode("error")``, with and without
    the cleaner; card == CPU; its time per call."""
    import torch
    from repro_torch.core import popularity as pop
    from repro_torch.core import reuse
    from repro_torch.core.policies import Policy
    from repro_torch.kernels.maintenance.ops import serving_maintenance
    t_axis, n, k, smax, dmax = SERVING_TENANTS, 512, 2048, 300, 40
    sids = rng.integers(0, 1400, n).astype(np.int32)
    ten = (sids % t_axis).astype(np.int32)
    wr = rng.random(n) < 0.3
    cand = np.full((t_axis, smax), -1, np.int32)
    pages = np.zeros((t_axis, smax), np.int32)
    for t in range(t_axis):
        c = rng.permutation(np.arange(t, 1400, t_axis))[:smax - 20 * t]
        cand[t, :c.size] = c
        pages[t, :c.size] = rng.integers(1, 7, c.size)
    over = rng.integers(-20, 60, t_axis).astype(np.int32)
    dage = np.where(rng.random((t_axis, dmax)) < 0.8,
                    rng.permutation(4 * t_axis * dmax)[:t_axis * dmax]
                    .reshape(t_axis, dmax), -1).astype(np.int32)
    for quota in (0, CLEAN_QUOTA):
        outs = []
        for d in (dev, torch.device("cpu")):
            r = reuse.pod_distances(sids, wr, Policy.RO, d, host=False)
            args = [torch.from_numpy(x).to(d) for x in (sids, ten, cand,
                                                        pages, over)]
            cs = torch.tensor([512.0], device=d)
            da = torch.from_numpy(dage).to(d)
            table = pop.table_init(t_axis, k, d)
            table, *_ = serving_maintenance(table, r.dist, r.served, *args,
                                            cs, decay=0.5, dirty_age=da,
                                            clean_quota=quota)
            if d.type == "cuda":
                torch.cuda.synchronize()
                torch.cuda.set_sync_debug_mode("error")
            try:
                out = serving_maintenance(table, r.dist, r.served, *args, cs,
                                          decay=0.5, dirty_age=da,
                                          clean_quota=quota)
            finally:
                if d.type == "cuda":
                    torch.cuda.set_sync_debug_mode("default")
            outs.append([out[0].addr, out[0].val, *out[1:]])
            if d.type == "cuda":
                call = (table, r.dist, r.served, *args, cs)
                ms = cuda_ms(lambda: serving_maintenance(
                    *call, decay=0.5, dirty_age=da, clean_quota=quota), 20)
        max_abs_err([x.cpu() for x in outs[0]], outs[1])
        log(f"serving_maintenance [T {t_axis}, N {n}, K {k}] clean_quota="
            f"{quota}: no host sync inside (sync debug mode 'error'), card =="
            f" CPU, {ms:.4f} ms per call (plain PyTorch around run_sums)")


# ---------------------------------------------------------------------------
# phase 9: the oracle ladder (staged and sequential modes, FAST, L2ARC)
# ---------------------------------------------------------------------------

def drive_card(build, trace, label, expect):
    """One card run with the launch counts set to 0 just before and read
    just after: exactly the kernels in ``expect`` launched. Returns
    ``(launches, cache, results, requests/s)``."""
    from repro_torch import kernels
    kernels.reset_launch_counts()
    cache, res, wall = run_controller(build, trace, "cuda")
    launches = serving_launches(label, expect, only=True)
    rate = len(trace) / wall
    log(f"{label} ({len(trace)} requests): card {wall:.3f} s, {rate:.0f} "
        f"requests/s, launches {launches}")
    return launches, cache, res, rate


def same_run(label, want, got, ignore=()):
    """Two controllers' results, interval logs and final states, exactly
    (``want``/``got`` are ``(cache, results)``), but for the stats keys
    in ``ignore``."""
    import dataclasses
    import torch
    (wc, wres), (gc, gres) = want, got

    def cut(res):
        return [dataclasses.replace(r, stats={k: x for k, x in r.stats.items()
                                              if k not in ignore})
                for r in res]
    assert_same(cut(gres), cut(wres), label)
    names = ("logs",) if hasattr(wc, "logs") else ("logs_dram", "logs_ssd")
    for name in names:
        wl, gl = getattr(wc, name), getattr(gc, name)
        if len(wl) != len(gl) or any(
                not np.array_equal(a.demands, b.demands)
                or not np.array_equal(a.alloc, b.alloc)
                or a.policies != b.policies for a, b in zip(wl, gl)):
            raise AssertionError(f"{label}: {name} differ")
    views = ("vm_cache",) if hasattr(wc, "vm_cache") else ("vm_dram",
                                                            "vm_ssd")
    for view in views:
        for v in range(len(wres)):
            for a, b in zip(getattr(wc, view)(v), getattr(gc, view)(v)):
                if not torch.equal(a, b):
                    raise AssertionError(f"{label}: VM {v} {view} differs")


def check_oracle_ladder(launches, paper, fused, clean, eci_run):
    """Phase 9: the staged and sequential modes of the paper's 12-VM
    deployment, without and with the cleaner, each equal to its fused
    card run (phases 3 and 5); ECI-Cache sequential equal to its batched
    run; FAST and L2ARC on the same mix as one stream, equal to the JAX
    package's CPU values. Each run launches exactly its own kernels."""
    import dataclasses
    from repro_torch.core.baselines import make_fast, make_l2arc
    from repro_torch.core.controller import EticaConfig, Geometry
    rates = {}
    for quota, (fc, fres, frate) in ((0, fused), (CLEAN_QUOTA, clean)):
        tag = "-clean" if quota else ""
        cfg = EticaConfig(dram_capacity=8192, ssd_capacity=16384,
                          clean_quota=quota)
        extra = ("clean_scatter",) if quota else ()
        # the staged path launches the evict scatter only for a non-empty
        # queue (a partition at least 90% full); the fused one always
        if np.sum(fc.telemetry.journal.column("evict_queue")):
            extra += ("evict_scatter",)
        for mode, kw, expect in (
                ("staged", dict(fused_maintenance=False),
                 STAGED_KERNELS + extra),
                ("seq", dict(batched=False), SEQ_KERNELS)):
            label = f"paper-12vm{tag}-{mode}"
            launches[label], cache, res, rates[label] = drive_card(
                etica(dataclasses.replace(cfg, **kw), 12), paper, label,
                expect)
            # pop_drops counts entries pushed past the fused path's
            # bounded [V, K] table; the trackers are unbounded
            same_run(label, (fc, fres), (cache, res), ignore=("pop_drops",))
            if any(r.stats["pop_drops"] for r in res):
                raise AssertionError(f"{label}: a tracker dropped entries")
        rates[f"paper-12vm{tag}"] = frate
        drops = [int(r.stats["pop_drops"]) for r in fres]
        log(f"paper-12vm{tag}: staged == sequential == fused (stats but "
            f"pop_drops, alloc_history, logs, final DRAM and SSD states); "
            f"the fused run's [V, {fc.cfg.pop_capacity}] table dropped "
            f"{drops} entries per VM, the trackers none")
    for mode in ("staged", "seq"):
        span_breakdown(etica(dataclasses.replace(
            EticaConfig(dram_capacity=8192, ssd_capacity=16384),
            **(dict(fused_maintenance=False) if mode == "staged"
               else dict(batched=False))), 12), paper, f"paper-12vm-{mode}")

    ec, eres, erate = eci_run
    launches["paper-12vm-eci-seq"], cache, res, rates["paper-12vm-eci-seq"] \
        = drive_card(eci(8192 + 16384, 12, geometry=Geometry(64, 64),
                         resize_interval=10_000, batched=False), paper,
                     "paper-12vm-eci-seq", ECI_KERNELS)
    same_run("paper-12vm-eci-seq", (ec, eres), (cache, res))
    rates["paper-12vm-eci"] = erate
    log("paper-12vm-eci-seq == paper-12vm-eci (stats, alloc_history, the "
        "logs' demands, allocations and policies, final states)")

    for name, factory, want in (("fast", make_fast, FAST_JAX_CPU),
                                ("l2arc", make_l2arc, L2ARC_JAX_CPU)):
        from repro_torch import kernels
        import torch
        label = f"paper-12vm-{name}"
        kernels.reset_launch_counts()
        cache = factory(8192, 16384, geometry=Geometry(256, 64),
                        device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = cache.run(paper)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches[label] = serving_launches(label, GLOBAL_KERNELS, only=True)
        rates[label] = len(paper) / wall
        got = {k: res.stats[k] for k in want}
        if got != want:
            raise AssertionError(f"{label}: {got} != the JAX CPU values "
                                 f"{want}")
        log(f"{label} (one stream, 256 x 64): card {wall:.3f} s, "
            f"{rates[label]:.0f} requests/s, hit {res.hit_ratio:.4f}, "
            f"ssd_writes {res.ssd_writes:.0f}: equal to the JAX CPU values; "
            f"launches {launches[label]}")
    log("requests/s by path: " + ", ".join(f"{k} {v:.0f}"
                                            for k, v in rates.items()))


def check_l2arc_promote(paper, dev="cuda", want_events: int | None = 1):
    """``promote_scatter``'s dedupe branch at L2ARC's own shape: a second
    L2ARC run (256 x 64, window 1,000) records every ``promote_scatter``
    call, a [1, 256, 64] state and the window's DRAM evictions padded to a
    power of two; each call is held to its plain version, and one CUDA
    graph of all of them gives their device time. The loss is that time
    less the sum of the calls' bounds. A call must put ``want_events``
    events on the device (None: any)."""
    from collections import Counter
    from repro_torch.core.baselines import make_l2arc
    from repro_torch.core.controller import Geometry
    from repro_torch.kernels.maintenance import ops
    calls, orig = [], ops.promote_scatter

    def record(tags, lru, dirty, queue, ways, t, dedupe=True):
        calls.append((*(x.clone() for x in (tags, lru, dirty, queue, ways,
                                            t)), dedupe))
        return orig(tags, lru, dirty, queue, ways, t, dedupe)

    ops.promote_scatter = record
    try:
        make_l2arc(8192, 16384, geometry=Geometry(256, 64),
                   device=dev).run(paper)
    finally:
        ops.promote_scatter = orig
    if not calls or not all(c[6] for c in calls):
        raise AssertionError("L2ARC: expected promote_scatter calls, all "
                             "with the dedupe")
    err = max(max_abs_err(ops.promote_scatter(*c[:6]),
                          ops.promote_scatter_plain(*c[:6])) for c in calls)

    def replay():
        for c in calls:
            ops.promote_scatter(*c[:6])

    total = graph_ms(replay, reps=1, replays=5)
    events = kernel_events(lambda: ops.promote_scatter(*calls[0][:6]),
                           "promote_kernel", want_events)
    v, s, w = calls[0][0].shape
    bounds = sum(bound_ms(2 * 9.0 * v * s * w + 4.0 * c[3].shape[1]
                          + 12.0 * v, 2.0 * (v * s * w + c[3].numel()))[0]
                 for c in calls)
    widths = dict(sorted(Counter(c[3].shape[1] for c in calls).items()))
    entries = [int((c[3] >= 0).sum()) for c in calls]
    log(f"promote_scatter dedupe at L2ARC's shape [{v},{s},{w}]: {len(calls)} "
        f"calls, each exact; queue widths {widths} (entries mean "
        f"{np.mean(entries):.1f}, max {max(entries)}); device {total:.4f} ms "
        f"for all ({total / len(calls):.5f} ms a call, {events} device "
        f"events a call), bounds {bounds:.5f} ms, loss "
        f"{total - bounds:.4f} ms a run")
    return dict(max_abs_err=err, calls=len(calls), queue_widths=widths,
                events_per_call=events,
                device_ms_total=total, device_ms_per_call=total / len(calls),
                bound_ms_total=bounds, loss_ms=total - bounds)


def seq_count_calls(paper, dev="cuda") -> list:
    """Every ``count_between`` call of a sequential 12-VM run (one VM's
    rows at a time), recorded as its ``(prev, touch, nt)``."""
    from repro_torch.core import reuse
    from repro_torch.core.controller import EticaConfig
    calls, orig = [], reuse.count_between

    def record(prev, touch, nt):
        calls.append(tuple(x.clone() for x in (prev, touch, nt)))
        return orig(prev, touch, nt)

    reuse.count_between = record
    try:
        etica(EticaConfig(dram_capacity=8192, ssd_capacity=16384,
                          batched=False), 12)(dev).run(paper)
    finally:
        reuse.count_between = orig
    return calls


def replay_count_calls(calls) -> dict:
    """Each recorded call held to its plain version, and one CUDA graph of
    all of them for their device time; the loss is that time less the sum
    of the calls' bounds."""
    from collections import Counter
    from repro_torch.kernels.reuse_distance import ops
    err = max(max_abs_err([ops.count_between(*c)],
                          [ops.count_between_plain(*c)]) for c in calls)

    def replay():
        for c in calls:
            ops.count_between(*c)

    total = graph_ms(replay, reps=1, replays=5)
    bounds = sum(count_bound(c[0])[0] for c in calls)
    shapes = dict(sorted(Counter(f"{c[0].shape[0]}x{c[0].shape[1]}"
                                 for c in calls).items()))
    return dict(max_abs_err=err, calls=len(calls), shapes=shapes,
                device_ms_total=total, device_ms_per_call=total / len(calls),
                bound_ms_total=bounds, loss_ms=total - bounds)


def check_seq_count_between(paper, dev="cuda"):
    """``count_between`` where paper-12vm-seq launches it: a second
    sequential 12-VM run records every call, each is held to its plain
    version and all are replayed in one CUDA graph
    (:func:`replay_count_calls`), with the plans the wrapper chose."""
    from collections import Counter
    from repro_torch.kernels.reuse_distance import ops
    calls = seq_count_calls(paper, dev)
    out = replay_count_calls(calls)
    sms = sm_count(calls[0][0].device)
    out["plans"] = dict(Counter(str(ops.count_plan(*c[0].shape, sms))
                                for c in calls))
    total, bounds = out["device_ms_total"], out["bound_ms_total"]
    log(f"count_between at paper-12vm-seq's calls: {len(calls)} calls, each "
        f"exact; shapes {out['shapes']}, plans (lanes, rows, threads) "
        f"{out['plans']}; device {total:.4f} ms for all "
        f"({total / len(calls):.5f} ms a call), bounds {bounds:.5f} ms, "
        f"loss {total - bounds:.4f} ms a run")
    return out


# ---------------------------------------------------------------------------
# phase 10: dense-model serving at qwen3-4b full width
# ---------------------------------------------------------------------------

def flash_bound(q, k) -> tuple[float, str, float]:
    """Least time for one causal bf16 flash call with Sq = Skv: q, k, v
    read once and the output written once over the HBM rate, against
    the products' FLOPs (2 B H S² D: both products, halved by the causal
    mask) at the bf16 tensor-core rate; also the float32 CUDA-core time
    of those FLOPs (/ 67 T/s), the rate the first version (the
    ``cuda_cores`` route) runs at."""
    b, h, s, d = q.shape
    nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
    flops = 2.0 * b * h * s * s * d
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_TENSOR_FLOPS * 1e3
    bound = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
    return (*bound, flops / SCALAR_OPS_PER_S * 1e3)


def flash_check(label, args, **kw):
    """Kernel against plain version on the same tensors (float32 within
    2e-5, bf16 within one bf16 ulp or 2e-5), through the route its dtype
    and head dim choose; returns the max error."""
    from repro_torch.kernels.flash_attention import ops
    route = ops.route(args[0].dtype, args[0].shape[-1])
    before = ops.route_counts()[route]
    got = ops.flash_attention(*args, **kw)
    if ops.route_counts()[route] != before + 1:
        raise AssertionError(f"flash_attention {label}: not on the "
                             f"{route} route")
    want = ops.flash_attention_plain(*args, **{k: v for k, v in kw.items()
                                               if k != "tq"})
    err, bad, over_ulp = decode_tolerance_err(got, want)
    if bad:
        raise AssertionError(f"flash_attention {label}: {bad} elements out "
                             f"of tolerance (max err {err:.3e})")
    return err, over_ulp


def check_flash_shapes(dev, rng, prefill=QWEN3_PREFILL):
    """``flash_attention`` against its plain version at the shapes of
    tests/test_kernels.py (float32 and bf16), its window and non-causal
    GQA cases, and random bf16 tensors at the prefill shape (B 4, H 32,
    Hkv 8, S 4096, D 128, causal)."""
    import torch
    worst = 0.0
    cases = [((1, 2, 1, 128, 32), dict(causal=True)),
             ((2, 4, 2, 256, 64), dict(causal=True)),
             ((1, 8, 8, 128, 128), dict(causal=True)),
             ((1, 2, 2, 256, 64), dict(causal=True, window=64)),
             ((1, 2, 1, 128, 64), dict(causal=False))]
    for (b, h, hkv, s, d), kw in cases:
        for dt in (torch.float32, torch.bfloat16):
            q = torch.from_numpy(rng.normal(size=(b, h, s, d)).astype(
                np.float32)).to(dev, dt)
            k, v = (torch.from_numpy(rng.normal(size=(b, hkv, s, d)).astype(
                np.float32)).to(dev, dt) for _ in range(2))
            err, _ = flash_check(f"{(b, h, hkv, s, d)} {kw}", (q, k, v),
                                 tq=64, tk=64, **kw)
            worst = max(worst, err)
    b, h, hkv, s, d = prefill
    q = torch.randn(b, h, s, d, device=dev, dtype=torch.bfloat16)
    k, v = (torch.randn(b, hkv, s, d, device=dev, dtype=torch.bfloat16)
            for _ in range(2))
    err, over = flash_check("prefill shape, random", (q, k, v), causal=True,
                            tq=s, tk=1024)
    log(f"flash_attention == plain at the tests/test_kernels.py shapes "
        f"(float32 on the cuda_cores route, bf16 on the wgmma route, "
        f"window 64, non-causal GQA; max err {worst:.3e}) and at the "
        f"prefill shape {prefill} bf16 causal on random tensors (max err "
        f"{err:.3e}; {over} of {q.numel()} outputs one bf16 ulp off)")
    return max(worst, err)


def ptxas_lines(source: str) -> list[str]:
    """ptxas's registers, spills and ``setmaxnreg`` lines for one source
    of the kernel build (``kernels.build_log()``: each verbose source's
    output after a line ``<source>:``)."""
    from repro_torch import kernels
    out, cur = [], None
    for ln in kernels.build_log().splitlines():
        if ln.endswith(".cu:") and " " not in ln:
            cur = ln[:-1]
        elif cur == source and ("registers" in ln or "spill" in ln
                                or "setmaxnreg" in ln):
            out.append(ln.strip())
    return out


def build_report(rows) -> None:
    """What ptxas said of the datapath kernels (registers and spills of
    each row variant), the decode kernel's routes, ``promote_scatter``,
    ``evict_scatter`` and ``count_between``, into their rows and the
    log."""
    for k, src in (("two_level", "datapath.cu"),
                   ("single_level", "single_level.cu"),
                   ("paged_decode_attention", "decode_attention.cu"),
                   ("promote_scatter", "promote_scatter.cu"),
                   ("evict_scatter", "evict_scatter.cu"),
                   ("count_between", "count_between.cu")):
        rows[k]["ptxas"] = ptxas_lines(src)
        for ln in rows[k]["ptxas"]:
            log(f"ptxas {src}: {ln}")


def flash_build_report() -> dict:
    """What ptxas said of ``flash_attention_sm90.cu`` (registers and
    spills of each head-dim variant), its dynamic shared memory at D 64
    and 128, and the SASS count of ``HGMMA`` instructions in the kernel
    library (``cuobjdump -sass``, where the toolkit has it)."""
    import re
    from repro_torch import kernels
    lines = ptxas_lines("flash_attention_sm90.cu")
    lib = kernels.library()
    smem = {d: lib.etica_flash_attention_sm90_smem(d) for d in (64, 128)}
    cuobjdump = Path("/usr/local/cuda/bin/cuobjdump")
    hgmma = None
    if cuobjdump.exists():
        sass = subprocess.run([str(cuobjdump), "-sass", lib._name],
                              capture_output=True, text=True).stdout
        hgmma = len(re.findall(r"\bHGMMA\.", sass))
        if not hgmma:
            raise AssertionError("no HGMMA in the kernel library's SASS")
    for ln in lines:
        log(f"ptxas flash_attention_sm90.cu: {ln}")
    n_hgmma = "not measured (no cuobjdump)" if hgmma is None else hgmma
    log(f"flash_attention_sm90: dynamic shared memory {smem[64]} bytes "
        f"(D <= 64), {smem[128]} bytes (D <= 128); HGMMA instructions in "
        f"the SASS: {n_hgmma}")
    return dict(ptxas=lines, smem_bytes=smem, sass_hgmma=hgmma)


def time_flash(q, k, v):
    """Times at the prefill shape on the model's own tensors (q [B, S, H,
    D], k and v [B, S, Hkv, D] passed as transposed views, as
    ``blocked_attention`` passes them): the kernel (calls back to back,
    and a CUDA graph of the calls), the plain version, and
    ``scaled_dot_product_attention(is_causal=True, enable_gqa=True)`` on
    the same views, never called by the port."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops
    args = [x.transpose(1, 2) for x in (q, k, v)]
    s = q.shape[1]

    def kernel():
        return ops.flash_attention(*args, causal=True, tq=s, tk=1024)

    def sdpa():
        return F.scaled_dot_product_attention(*args, is_causal=True,
                                              enable_gqa=True)
    f32 = [x.float() for x in args]

    def first_version():
        return ops.flash_attention(*f32, causal=True, tq=s, tk=1024)
    ms = cuda_ms(kernel, 5)
    dev_ms = graph_ms(kernel, reps=4, replays=3)
    plain_ms = cuda_ms(lambda: ops.flash_attention_plain(
        *args, causal=True, tk=1024), 2)
    lib_ms = cuda_ms(sdpa, 10)
    lib_dev_ms = graph_ms(sdpa, reps=4, replays=3)
    first_dev_ms = graph_ms(first_version, reps=2, replays=2)
    del f32
    b, by, fp32_core_ms = flash_bound(*args[:2])
    bq, h, sq, d = args[0].shape
    return dict(ms=ms, device_ms=dev_ms, plain_ms=plain_ms, bound_ms=b,
                bound_by=by, fp32_core_ms=fp32_core_ms, library_ms=lib_ms,
                library_device_ms=lib_dev_ms,
                first_version_device_ms=first_dev_ms,
                tflops=2.0 * bq * h * sq * sq * d / dev_ms / 1e9)


def layer0_qkv(model, cfg, toks):
    """Layer 0's q [B, S, H, D] and k, v [B, S, Hkv, D] on a prompt, from
    the port's ``_project_q`` / ``_project_kv`` on the embedded tokens."""
    import torch
    from repro_torch.models import attention as A
    from repro_torch.models.layers import embed, rmsnorm
    layer0 = model.layers[0]["block0"]
    pos = torch.arange(toks.shape[1], device=toks.device)[None]
    h = rmsnorm(layer0.norm1, embed(model.embed, toks), cfg.norm_eps)
    return (A._project_q(layer0.mixer, cfg, h, pos),
            *A._project_kv(layer0.mixer, cfg, h, pos))


def logit_err(got, want) -> float:
    """max |got - want| / max |want| (tests/test_serving.py's measure)."""
    return float((got.float().cpu() - want.float().cpu()).abs().max()
                 / (want.float().abs().max().cpu() + 1e-6))


def check_dense_serving(launches, row, dev="cuda", cfg=None,
                        prefill=QWEN3_PREFILL, n_steps=QWEN3_DECODE_STEPS,
                        p=1022):
    """qwen3-4b at full width and depth, weights from a seeded generator
    on the card: the kernel on layer 0's real activations; a prefill of
    4 x 4096 tokens through ``make_prefill_step`` (launch counts set to 0
    just before, exactly 36 ``flash_attention`` launches after) and 32
    greedy ``make_decode_step`` steps (no kernel of the list); logits
    finite; decode == a fresh prefill of the longer prompt at B 1 within
    2e-2 of the logit scale."""
    import torch
    from repro_torch import configs, kernels
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.launch import steps
    from repro_torch.models import model as M
    dev = torch.device(dev)
    cfg = cfg or configs.get("qwen3-4b")
    b, _, _, s, _ = prefill
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                          device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    want_params = cfg.param_counts()[0] + (2 * cfg.num_layers + 1) * \
        cfg.d_model + 2 * cfg.num_layers * cfg.head_dim
    if n_params != want_params:
        raise AssertionError(f"{n_params} parameters, expected {want_params}")
    log(f"qwen3-4b full width: {n_params:,} float32 parameters "
        f"({n_params * 4 / 1e9:.2f} GB) drawn on the card in "
        f"{time.perf_counter() - t0:.1f} s")
    gen = torch.Generator(device=dev).manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (b, s), device=dev,
                         generator=gen)

    # the kernel on layer 0's real activations, then its times there
    q, k, v = layer0_qkv(model, cfg, toks)
    err, over = flash_check("layer-0 activations",
                            [x.transpose(1, 2) for x in (q, k, v)],
                            causal=True, tq=s, tk=1024)
    log(f"flash_attention == plain on layer 0's q, k, v of the prompt "
        f"(max err {err:.3e}; {over} of {q.numel()} outputs one bf16 ulp "
        f"off)")
    row.update(time_flash(q, k, v))
    row["max_abs_err"] = max(row["max_abs_err"], err)
    log(f"flash_attention prefill shape {prefill} bf16 causal, model "
        f"layout: kernel (wgmma route) {row['ms']:.4f} ms (device "
        f"{row['device_ms']:.4f} ms, {row['tflops']:.1f} TFLOP/s), plain "
        f"{row['plain_ms']:.4f} ms, sdpa {row['library_ms']:.4f} ms (device "
        f"{row['library_device_ms']:.4f} ms), bound {row['bound_ms']:.4f} ms "
        f"({row['bound_by']}, bf16 tensor cores); the first version "
        f"(cuda_cores route) on float32 copies: device "
        f"{row['first_version_device_ms']:.4f} ms; float32 CUDA-core time "
        f"for the same FLOPs {row['fp32_core_ms']:.4f} ms")
    del q, k, v

    # a warm-up prefill (its logits checked), then the timed steps
    logits, _ = M.prefill(model, cfg, {"tokens": toks},
                          cache_len=s + n_steps)
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("prefill logits not finite")
    del logits, _
    prefill_step = steps.make_prefill_step(cfg, s + n_steps)
    decode_step = steps.make_decode_step(cfg)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    nxt, cache = prefill_step(model, {"tokens": toks})
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    launches["qwen3-4b-prefill"] = serving_launches(
        "qwen3-4b prefill", ("flash_attention",), only=True)
    routes = flash_ops.route_counts()
    if launches["qwen3-4b-prefill"]["flash_attention"] != cfg.num_layers \
            or routes != {"wgmma": cfg.num_layers, "cuda_cores": 0}:
        raise AssertionError(f"{launches['qwen3-4b-prefill']} launches, "
                             f"routes {routes}: expected {cfg.num_layers} "
                             f"flash_attention, all on the wgmma route")
    row["routes"] = routes
    kernels.reset_launch_counts()
    out = [nxt]
    tok = nxt[:, None]
    t0 = time.perf_counter()
    for i in range(n_steps):
        tok, cache = decode_step(model, cache, tok, s + i)
        out.append(tok[:, 0])
    torch.cuda.synchronize()
    t_decode = time.perf_counter() - t0
    launches["qwen3-4b-decode"] = serving_launches("qwen3-4b decode", (),
                                                   only=True)
    gen_toks = torch.stack(out, 1)
    if not bool(((gen_toks >= 0) & (gen_toks < cfg.vocab_size)).all()):
        raise AssertionError("greedy tokens out of range")
    for kv in ("k", "v"):
        if not bool(torch.isfinite(cache["layers"]["block0"][kv]).all()):
            raise AssertionError(f"cache {kv} not finite")
    peak = torch.cuda.max_memory_allocated()
    served = dict(prefill_tokens_per_s=b * s / t_prefill,
                 decode_tokens_per_s=b * n_steps / t_decode)
    log(f"qwen3-4b serving ({b} x {s} prompt tokens, {n_steps} "
        f"greedy steps): prefill {t_prefill:.3f} s, "
        f"{served['prefill_tokens_per_s']:.0f} tokens/s; decode "
        f"{t_decode:.3f} s, {served['decode_tokens_per_s']:.1f} tokens/s "
        f"({t_decode / n_steps * 1e3:.2f} ms a step); peak device "
        f"memory {peak / 2**30:.2f} GiB; launches: prefill "
        f"{launches['qwen3-4b-prefill']['flash_attention']} flash_attention "
        f"(routes {routes}), decode none")

    served["decode_breakdown"] = decode_breakdown(
        model, cfg, cache, tok, s + n_steps - 1, t_decode / n_steps * 1e3)
    del cache
    pre_dev_ms, pre_events = device_profile(
        lambda: prefill_step(model, {"tokens": toks}), 1)
    served["prefill_device_ms"] = pre_dev_ms
    idle = "idle not measured" if pre_dev_ms is None else \
        f"{pre_dev_ms:.1f} ms device time in {pre_events:.0f} kernels and " \
        f"copies, idle {1 - pre_dev_ms / (t_prefill * 1e3):.1%}"
    log(f"qwen3-4b prefill {t_prefill * 1e3:.1f} ms (host clock; {idle}); "
        f"{cfg.num_layers} flash_attention calls at {row['device_ms']:.2f} "
        f"ms = {cfg.num_layers * row['device_ms']:.1f} ms")

    # decode == a fresh prefill of the longer prompt (B 1, full width);
    # then once more with cuBLAS's reduced-precision bf16 reductions off
    # (PyTorch's default leaves them on; the port never changes it)
    matmul = torch.backends.cuda.matmul
    default = matmul.allow_bf16_reduced_precision_reduction
    one = toks[:1, :p + 2]
    errs = {}
    try:
        for reduced in (default, False):
            matmul.allow_bf16_reduced_precision_reduction = reduced
            errs[reduced] = decode_vs_prefill(model, cfg, one, p)
    finally:
        matmul.allow_bf16_reduced_precision_reduction = default
    if max(errs[default]) >= 2e-2:
        raise AssertionError(f"decode vs prefill: {errs[default]} >= 2e-2")
    log(f"qwen3-4b decode == prefill of the longer prompt (B 1, {p} + 2 "
        f"tokens): relative logit error {errs[default][0]:.4e}, "
        f"{errs[default][1]:.4e} (< 2e-2); with reduced-precision bf16 "
        f"reductions off: {errs[False][0]:.4e}, {errs[False][1]:.4e}")
    served["decode_vs_prefill"] = dict(
        errs=errs[default], errs_full_precision_reductions=errs[False],
        **decode_gap_causes(model, cfg, one, p))
    del model
    torch.cuda.empty_cache()
    return served, peak, n_params


def decode_vs_prefill(model, cfg, one, p) -> list[float]:
    """Relative logit errors of two decode steps after a prefill of
    ``one[:, :p]`` against fresh prefills of the longer prompts."""
    import torch
    from repro_torch.models import model as M
    lp, cache = M.prefill(model, cfg, {"tokens": one[:, :p]},
                          cache_len=p + 2)
    errs = []
    for i in range(2):
        ld, cache = M.decode_step(model, cfg, one[:, p + i:p + i + 1], cache,
                                  p + i)
        lf, _ = M.prefill(model, cfg, {"tokens": one[:, :p + i + 1]})
        for x in (lp, ld, lf):
            if not bool(torch.isfinite(x).all()):
                raise AssertionError("logits not finite")
        errs.append(logit_err(ld[:, -1], lf[:, -1]))
    return errs


@contextlib.contextmanager
def swapped(module, name, fn):
    """``module.name`` replaced by ``fn`` inside the block."""
    old = getattr(module, name)
    setattr(module, name, fn)
    try:
        yield
    finally:
        setattr(module, name, old)


def attention_decode_f32(params, cfg, x, cache_k, cache_v, pos: int):
    """``attention_decode`` (no sliding window) with q·scale and p kept in
    float32, as the prefill computes them; the reference rounds both to
    bf16 on its decode path."""
    import torch
    from repro_torch.models import attention as A
    from repro_torch.models.layers import dense
    b, skv = x.shape[0], cache_k.shape[1]
    at = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q = A._project_q(params, cfg, x, at)
    k_new, v_new = A._project_kv(params, cfg, x, at)
    cache_k[:, pos % skv] = k_new[:, 0].to(cache_k.dtype)
    cache_v[:, pos % skv] = v_new[:, 0].to(cache_v.dtype)
    qh = q[:, 0].reshape(b, cfg.num_kv_heads, -1, cfg.head_dim).float()
    s = torch.einsum("bhgd,bshd->bhgs", qh * cfg.head_dim ** -0.5,
                     cache_k.float())
    s = torch.where(torch.arange(skv, device=x.device) <= pos, s, -1e30)
    out = torch.einsum("bhgs,bshd->bhgd", torch.softmax(s, -1),
                       cache_v.float())
    return dense(params.wo, out.reshape(b, 1, -1).to(x.dtype)), cache_k, \
        cache_v


def decode_gap_causes(model, cfg, one, p) -> dict:
    """Where decode's departure from a fresh prefill comes from, at full
    width (B 1): the same comparison with every prefill's attention
    through the plain version instead of the kernel, and the kernel's
    and the plain version's prefill logits of the longer prompt against
    each other; the same comparison with decode's attention in float32
    (:func:`attention_decode_f32`); and the move of the last logits when
    one embedded element of the prompt gains one bf16 ulp, the model's
    own noise floor."""
    import torch
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.models import attention as A
    from repro_torch.models import model as M
    from repro_torch.models.layers import embed, rmsnorm, unembed

    def plain(q, k, v, *, causal, window, tq, tk, q_offset):
        return ops.flash_attention_plain(q, k, v, causal=causal,
                                         window=window, tk=tk,
                                         q_offset=q_offset)
    longer = {"tokens": one[:, :p + 1]}
    with swapped(ops, "flash_attention", plain):
        plain_errs = decode_vs_prefill(model, cfg, one, p)
        lf_plain, _ = M.prefill(model, cfg, longer)
    lf, _ = M.prefill(model, cfg, longer)
    with swapped(A, "attention_decode", attention_decode_f32):
        f32_errs = decode_vs_prefill(model, cfg, one, p)

    x = embed(model.embed, one[:, :p + 1])
    positions = torch.arange(p + 1, device=x.device)[None]

    def logits(x):
        x = M._scan_train(model, cfg, x, positions)
        return unembed(model.unembed, rmsnorm(model.final_norm, x[:, -1:],
                                              cfg.norm_eps))
    base = logits(x)
    ulp_moves = []
    for i, j in ((0, 0), (p // 2, 5), (p, 3)):
        xb = x.clone()
        xb.view(torch.int16)[0, i, j] += 1      # one ulp away from zero
        ulp_moves.append(logit_err(logits(xb), base))
    out = dict(plain_prefill_errs=plain_errs,
               kernel_vs_plain_prefill=logit_err(lf, lf_plain),
               f32_decode_errs=f32_errs, one_ulp_moves=ulp_moves)
    log("qwen3-4b decode vs prefill, its causes (B 1, full width): with "
        "the plain version in every prefill "
        + ", ".join(f"{e:.4e}" for e in plain_errs)
        + f"; kernel vs plain prefill logits "
        f"{out['kernel_vs_plain_prefill']:.4e}; with decode's attention in "
        "float32 " + ", ".join(f"{e:.4e}" for e in f32_errs)
        + "; one bf16 ulp on one embedded element moves the last logits "
        + ", ".join(f"{e:.4e}" for e in ulp_moves))
    return out


def decode_breakdown(model, cfg, cache, tok, pos, step_ms):
    """Where one decode step's time goes: device time of the whole step
    (a profiler trace) against its host-clock time (the device's idle
    share), with the trace's largest device events; and device time of
    its parts (CUDA graphs of the calls), layer 0 times 36 where per
    layer: the bf16 casts of one layer's weights inside ``dense``, the
    float32 copies of one layer's K and V cache inside
    ``attention_decode``, one whole ``attention_decode`` and one ``mlp``,
    and ``unembed``."""
    import torch
    from repro_torch.launch import steps
    from repro_torch.models import attention as A
    from repro_torch.models.layers import embed, mlp, rmsnorm, unembed
    layer = model.layers[0]["block0"]
    ck, cv = (cache["layers"]["block0"][n][0] for n in ("k", "v"))
    h = rmsnorm(layer.norm1, embed(model.embed, tok), cfg.norm_eps)
    weights = [p for p in layer.parameters() if p.dim() == 2]
    n = cfg.num_layers

    def dev(fn, times=1):
        return times * graph_ms(fn, reps=3, replays=3)
    parts = dict(
        weight_casts=dev(lambda: [w.to(torch.bfloat16) for w in weights], n),
        cache_upcasts=dev(lambda: (ck.float(), cv.float()), n),
        attention_decode=dev(lambda: A.attention_decode(
            layer.mixer, cfg, h, ck, cv, pos), n),
        mlp=dev(lambda: mlp(layer.ffn, h, cfg.mlp_act), n),
        unembed=dev(lambda: unembed(model.unembed, h)))
    decode_step = steps.make_decode_step(cfg)
    top = []
    dev_ms, events = device_profile(
        lambda: decode_step(model, cache, tok, pos), 2, top)
    idle = "idle not measured" if dev_ms is None else \
        f"{dev_ms:.2f} ms device time in {events:.0f} kernels and copies, " \
        f"idle {1 - dev_ms / step_ms:.1%}"
    log(f"qwen3-4b decode step {step_ms:.2f} ms (host clock; {idle}); "
        f"device time of its parts, x{n} layers: " + ", ".join(
            f"{k} {fmt_ms(v)}" for k, v in parts.items())
        + "; its largest device events: " + "; ".join(
            f"{name} {ms:.2f} ms in {cnt:.0f}" for ms, cnt, name in top))
    return dict(step_ms=step_ms, device_ms=dev_ms, device_events=events,
                **parts)


def check_reduced_card_cpu(dev="cuda"):
    """Reduced qwen3-4b, one weight set on both devices: prefill (B 4, S
    96) and 4 decode steps fed the CPU's greedy tokens; logits within
    1e-2 of their scale, greedy tokens equal wherever the CPU's top-2
    margin exceeds 1e-2 of it."""
    import torch
    from repro_torch import configs
    from repro_torch.models import model as M
    cfg = configs.get_reduced("qwen3-4b")
    cpu = M.init_params(cfg, torch.Generator().manual_seed(2), device="cpu")
    card = M.init_params(cfg, torch.Generator().manual_seed(2),
                         device="cpu").to(dev)
    toks = torch.randint(0, cfg.vocab_size, (4, 96),
                         generator=torch.Generator().manual_seed(3))
    lc, cc = M.prefill(card, cfg, {"tokens": toks.to(dev)}, cache_len=100)
    lp, cp = M.prefill(cpu, cfg, {"tokens": toks}, cache_len=100)
    errs, checked = [], 0
    for i in range(5):
        errs.append(logit_err(lc, lp))
        top2 = lp[:, -1].topk(2, -1).values
        sure = (top2[:, 0] - top2[:, 1]) > 1e-2 * lp.abs().max()
        if not torch.equal(lc[:, -1].argmax(-1).cpu()[sure],
                           lp[:, -1].argmax(-1)[sure]):
            raise AssertionError(f"reduced step {i}: greedy tokens differ")
        checked += int(sure.sum())
        if i == 4:
            break
        nxt = lp[:, -1].argmax(-1)[:, None]
        lc, cc = M.decode_step(card, cfg, nxt.to(dev), cc, 96 + i)
        lp, cp = M.decode_step(cpu, cfg, nxt, cp, 96 + i)
    if max(errs) >= 1e-2:
        raise AssertionError(f"reduced card vs CPU: {errs}")
    log(f"reduced qwen3-4b card == CPU: prefill + 4 decode steps, relative "
        f"logit errors {', '.join(f'{e:.4e}' for e in errs)} (< 1e-2); "
        f"{checked} of 20 greedy tokens past the margin, all equal")
    return max(errs)


def check_serve_prefill(launches, dev="cuda"):
    """``serve.main --arch qwen3-4b`` on the card with decode: its page
    bank from one prefill of the reduced model (the kernel launches once
    per layer); statistics equal a run of the same manager on gaussian
    pages. Then the kernel against its plain version at that prefill's
    shape; returns the max error."""
    import torch
    from repro_torch import configs, kernels
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kvcache import TwoTierConfig, TwoTierKVManager
    from repro_torch.launch import serve
    from repro_torch.models import model as M
    from repro_torch.traces.generators import SessionSpec, generate_sessions
    argv = ["--arch", "qwen3-4b", "--events", "2000", "--live", "64",
            "--decode-every", "8", "--seed", "4", "--device", dev]
    kernels.reset_launch_counts()
    stats = serve.main(argv)
    torch.cuda.synchronize()
    launches["serve-qwen3-4b"] = serving_launches(
        "serve --arch qwen3-4b", SERVING_DECODE_KERNELS + ("flash_attention",),
        only=True)
    cfg = configs.get_reduced("qwen3-4b")
    routes = flash_ops.route_counts()
    if launches["serve-qwen3-4b"]["flash_attention"] != cfg.num_layers or \
            routes != {"wgmma": cfg.num_layers, "cuda_cores": 0}:
        raise AssertionError(f"serve: one flash_attention launch per layer, "
                             f"on the wgmma route, expected (routes "
                             f"{routes})")
    hkv, d = serve.kv_geometry(cfg)
    kv_cfg = TwoTierConfig(page_size=16, hbm_pages=64, num_kv_heads=hkv,
                           head_dim=d, num_layers=1, dtype="float32")
    mgr = TwoTierKVManager(kv_cfg, 4, device=dev)
    trace = generate_sessions(SessionSpec(num_tenants=4, target_live=64,
                                          max_pages=6), 2000, seed=4)
    kb, vb = serve.gaussian_pages(kv_cfg, 8, 4, pin=dev == "cuda")
    serve.run_events(mgr, trace, kb, vb, decode_every=8, seed=4)
    if stats != mgr.stats.as_dict():
        raise AssertionError(f"serve prefill branch {stats} != gaussian "
                             f"{mgr.stats.as_dict()}")
    log(f"serve --arch qwen3-4b (prefill page bank, {cfg.num_layers} "
        f"flash_attention launches, routes {routes}): statistics equal the "
        f"gaussian-page run ({stats['activations']} activations)")

    # the kernel at the bank prefill's own shape (B 1, H 4, Hkv 2, S 128,
    # D 16, tq = tk = 128): on that prefill's layer-0 q, k, v (the model
    # and tokens kv_page_bank draws from --seed 4), then on random tensors
    model = M.init_params(cfg, torch.Generator().manual_seed(4),
                          device="cpu").to(dev)
    toks = torch.randint(0, cfg.vocab_size, (1, 8 * kv_cfg.page_size),
                         generator=torch.Generator().manual_seed(5)).to(dev)
    q, k, v = (x.transpose(1, 2) for x in layer0_qkv(model, cfg, toks))
    s = toks.shape[1]
    err, _ = flash_check("serve bank prefill, layer-0 activations",
                         (q, k, v), causal=True, tq=s, tk=s)
    rand = [torch.randn_like(x) for x in (q, k, v)]
    err_rand, _ = flash_check("serve bank prefill shape, random", rand,
                              causal=True, tq=s, tk=s)
    log(f"flash_attention == plain at serve's bank prefill shape (B "
        f"{q.shape[0]}, H {q.shape[1]}, Hkv {k.shape[1]}, S {s}, D "
        f"{q.shape[-1]}, bf16, causal): layer-0 activations max err "
        f"{err:.3e}, random tensors max err {err_rand:.3e}")
    return max(err, err_rand)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from repro_torch import kernels
    from repro_torch.core.controller import EticaConfig, Geometry

    # phase 1: the device
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"device: {kind} x{count}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}")
    t0 = time.perf_counter()
    kernels.library()
    log(f"kernel build + load: {time.perf_counter() - t0:.1f} s")

    # phase 2: every kernel against its plain version at the shapes of
    # the 12-VM and 1024-VM runs (the JSON rows are the 12-VM ones)
    rng = np.random.default_rng(0)
    paper = trace_mix(PAPER_VMS, 20_000, 1.0)
    fig128 = trace_mix((FIG15_WORKLOADS * 8)[:128], 150, 0.25)
    fig1024 = trace_mix((FIG15_WORKLOADS * 64)[:1024], 150, 0.25)
    win, chunk = len(fig1024) // 3, len(fig1024) // 12
    subs12, blocks12 = first_blocks(paper, 12, 10_000, 1_000, 1)
    _, blocks12b = first_blocks(paper[10_000:], 12, 10_000, 1_000, 1)
    subs1024, blocks1024 = first_blocks(fig1024, 1024, win, chunk, 1)
    _, blocks1024b = first_blocks(fig1024[win:], 1024, win, chunk, 1)
    step_ns = chain_step_ns(dev)
    log(f"chain_probe: one dependent on-chip load {step_ns:.3f} ns")
    fadd_ns = fadd_step_ns(dev)
    log(f"chain_probe: one dependent float32 add {fadd_ns:.3f} ns")
    rows = {}
    rows["count_between"] = check_count_between(dev, subs12, "12-VM POD")
    check_count_between(dev, subs1024, "1024-VM POD")
    ways12 = (rng.integers(8, 65, 12), rng.integers(8, 65, 12))
    g64, g16 = ((64, 64), (64, 64)), ((16, 32), (16, 32))
    rows["two_level"] = check_datapath(dev, blocks12 + blocks12b, g64,
                                       ways12, "full", "12-VM", step_ns)
    npe12 = check_datapath(dev, blocks12 + blocks12b, g64, ways12, "npe",
                           "12-VM", step_ns)
    big = check_datapath(dev, blocks1024 + blocks1024b, g16,
                         (rng.integers(0, 33, 1024),
                          rng.integers(0, 33, 1024)),
                         "full", "1024-VM", step_ns)
    rows["single_level"] = check_single_level(
        dev, rng, blocks12 + blocks12b, 64, 64, "12-VM", step_ns)
    big_single = check_single_level(dev, rng, blocks1024 + blocks1024b, 16,
                                    32, "1024-VM", step_ns)
    shapes, single_shapes = check_set_walk(dev, rng, paper,
                                           blocks12 + blocks12b, ways12,
                                           step_ns)
    shapes.update({"12-VM npe": npe12, "1024-VM": big})
    single_shapes["1024-VM"] = big_single
    for k, extra in (("two_level", shapes), ("single_level", single_shapes)):
        rows[k]["max_abs_err"] = max([rows[k]["max_abs_err"]] + [
            r.pop("max_abs_err") for r in extra.values()])
        rows[k]["shapes"] = extra
    rows.update(check_scatters(dev, rng, 12, 64, 64))
    check_scatters(dev, rng, 1024, 16, 32)
    rows["clean_scatter"] = check_clean(dev, rng, 12, 64, 64)
    check_clean(dev, rng, 1024, 16, 32)
    maint_err = max(
        check_maintenance(dev, rng, 12, 64, 64, (600, 1000), "12-VM"),
        check_maintenance(dev, rng, 1024, 16, 32, (20, 60), "1024-VM"))
    rows["run_sums"] = check_window_runs(dev, rng, blocks12, "12-VM",
                                         fadd_ns)
    rows["run_sums"]["max_abs_err"] = max(rows["run_sums"]["max_abs_err"],
                                          maint_err)
    check_window_runs(dev, rng, blocks1024, "1024-VM", fadd_ns)
    rows["popularity"] = check_popularity(dev, rng, blocks12, "12-VM staged",
                                          fadd_ns)
    check_popularity(dev, rng, blocks1024, "1024-VM staged", fadd_ns)
    limit_err = check_row_limits(dev, rng)
    for k in ("run_sums", "popularity"):
        rows[k]["max_abs_err"] = max(rows[k]["max_abs_err"], limit_err)
    rows["paged_decode_attention"] = check_decode(dev, rng)
    build_report(rows)
    rows["flash_attention"] = dict(max_abs_err=check_flash_shapes(dev, rng),
                                   **flash_build_report())
    check_serving_sync(dev, rng)

    # phases 3 and 4: the paper's §5.1 deployment, then fig15
    # consolidation at 128 and 1024 VMs; card == CPU in each
    launches = {}
    cfg = EticaConfig(dram_capacity=8192, ssd_capacity=16384)
    launches["paper-12vm"], fused, paper_res, fused_rate = drive(
        etica(cfg, 12), paper, "paper 12-VM", ETICA_KERNELS)
    span_breakdown(etica(cfg, 12), paper, "paper 12-VM", repeats=3)
    launches["fig15-128vm"], *_ = drive(
        etica(fig15_config(128, len(fig128)), 128), fig128, "fig15 128-VM",
        ETICA_KERNELS)
    build1024 = etica(fig15_config(1024, len(fig1024)), 1024)
    launches["fig15-1024vm"], *_ = drive(build1024, fig1024,
                                           "fig15 1024-VM", ETICA_KERNELS)
    span_breakdown(build1024, fig1024, "fig15 1024-VM")
    log(f"fig15 1024-VM avg_hit beside the JAX package's CPU value "
        f"{FIG15_JAX_CPU_AVG_HIT_1024} (benchmarks/BENCH_sharding.json)")

    # phase 5: the 12-VM deployment under the endurance comparison
    ccfg = EticaConfig(dram_capacity=8192, ssd_capacity=16384,
                       clean_quota=CLEAN_QUOTA)
    launches["paper-12vm-clean"], clean, clean_res, clean_rate = drive(
        etica(ccfg, 12), paper, "paper 12-VM ETICA clean_quota=4",
        CLEAN_KERNELS)
    span_breakdown(etica(ccfg, 12), paper, "paper 12-VM ETICA clean")
    geo64 = Geometry(num_sets=64, max_ways=64)
    build_eci = eci(8192 + 16384, 12, geometry=geo64,
                    resize_interval=10_000)
    launches["paper-12vm-eci"], eci_cache, eci_res, eci_rate = drive(
        build_eci, paper, "paper 12-VM ECI-Cache", ECI_KERNELS)
    span_breakdown(build_eci, paper, "paper 12-VM ECI-Cache")
    endurance("paper 12-VM", paper_res, eci_res, clean)

    # phase 6: fig14's own mix, held to the JAX package's CPU values
    check_fig14(launches)

    # phase 7: ECI-Cache at the fig15 1024-VM configuration
    total = len(fig1024)
    launches["fig15-1024vm-eci"], *_ = drive(
        eci(37 * 1024, 1024, geometry=Geometry(num_sets=16, max_ways=32),
            resize_interval=total // 3, sim_chunk=total // 12),
        fig1024, "fig15 1024-VM ECI-Cache", ECI_KERNELS)

    # phase 8: two-tier KV serving (BENCH_serving.json, then qwen3-4b's
    # KV width with decode)
    serving = check_serving(launches)
    rows["paged_decode_attention"].update(
        serving_decode_ms=serving["decode_ms"],
        serving_decodes=serving["decodes"],
        serving_max_abs_err=serving["max_abs_err"],
        serving_mean_pages=serving["mean_pages"],
        serving_pages_histogram=serving["pages_histogram"])

    # phase 9: the oracle ladder on the card (staged, sequential, FAST,
    # L2ARC)
    check_oracle_ladder(launches, paper, (fused, paper_res, fused_rate),
                        (clean, clean_res, clean_rate),
                        (eci_cache, eci_res, eci_rate))
    rows["promote_scatter"]["l2arc_dedupe"] = check_l2arc_promote(paper)
    rows["count_between"]["seq"] = check_seq_count_between(paper)

    # phase 10: dense-model serving at qwen3-4b full width and depth
    served, peak, n_params = check_dense_serving(launches,
                                                 rows["flash_attention"])
    rows["flash_attention"].update(
        qwen3_4b=dict(served, peak_bytes=peak, params=n_params,
                      reduced_card_cpu_logit_err=check_reduced_card_cpu()))
    rows["flash_attention"]["max_abs_err"] = max(
        rows["flash_attention"]["max_abs_err"], check_serve_prefill(launches))

    sources = {"count_between": "src/repro_torch/csrc/count_between.cu",
               "evict_scatter": "src/repro_torch/csrc/evict_scatter.cu",
               "promote_scatter": "src/repro_torch/csrc/promote_scatter.cu",
               "clean_scatter": "src/repro_torch/csrc/clean_scatter.cu",
               "two_level": "src/repro_torch/csrc/datapath.cu",
               "single_level": "src/repro_torch/csrc/single_level.cu",
               "run_sums": "src/repro_torch/csrc/run_sums.cu",
               "paged_decode_attention":
                   "src/repro_torch/csrc/decode_attention.cu",
               "popularity": "src/repro_torch/csrc/popularity.cu",
               "flash_attention":
                   "src/repro_torch/csrc/flash_attention_sm90.cu"}
    replaces = {
        "count_between": "src/repro/kernels/reuse_distance/kernel.py:29",
        "evict_scatter": "src/repro/kernels/maintenance/kernel.py:51",
        "promote_scatter": "src/repro/kernels/maintenance/kernel.py:167",
        "clean_scatter": "src/repro/kernels/maintenance/kernel.py:110",
        "two_level": "src/repro/core/simulator.py:374 (lax.scan step; "
                     "no Pallas kernel)",
        "single_level": "src/repro/core/simulator.py:264 (lax.scan step; "
                        "no Pallas kernel)",
        "run_sums": "src/repro/core/popularity.py:238 (_row_update's "
                    "stable argsort + _compact_runs scatter-add at :204; "
                    "no Pallas kernel)",
        "paged_decode_attention":
            "src/repro/kernels/decode_attention/kernel.py:28",
        "popularity": "src/repro/kernels/popularity/kernel.py:26",
        "flash_attention": "src/repro/kernels/flash_attention/kernel.py:29"}
    # each kernel's own 12-VM path: the one whose launches it reports
    own_path = dict.fromkeys(kernels.KERNELS, "paper-12vm")
    own_path.update(clean_scatter="paper-12vm-clean",
                    single_level="paper-12vm-eci",
                    paged_decode_attention="serving-full-width",
                    popularity="paper-12vm-staged",
                    flash_attention="qwen3-4b-prefill")
    log(smi)
    print(json.dumps({"kernels": [
        dict(name=k, route="cuda", source=sources[k], replaces=replaces[k],
             launches=launches[own_path[k]][k], path=own_path[k], **rows[k],
             launches_by_path={p: n[k] for p, n in launches.items()})
        for k in kernels.KERNELS]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
