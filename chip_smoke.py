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
   ``chain_probe.cu``); holds both, on heavy ties, one key for a whole
   row, an empty row and runs across every multiple of
   ``kernels.ROW_MAX``, at the ``row`` route's widest row
   (``kernels.ROW_MAX`` entries) and at 16,385 and 40,000 entries
   through the ``tiled`` route, each call's route checked and timed;
   holds the cleaner (``ops.clean``: one ``clean_scatter`` launch that
   finds each VM's cutoff itself, one device event a call, asserted) to
   ``_clean_cutoffs`` + ``clean_scatter_plain`` at the 12-VM and 1024-VM
   shapes, with its plan; and
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
   memory and the SASS count of ``HGMMA`` instructions; holds the IO
   classifier's ``classified`` routes of ``two_level`` and
   ``single_level`` to their plain versions, exactly, at the paper's
   [12, 1000] blocks, the 1024-VM blocks, V = 1, rows of 9,000, rows of
   128 ways and one set taking every request (four classes drawn at
   random: the default pool, an exclusive slice, an empty slice, a
   bypass class; at one level the five policies mixed across (VM,
   class)), each with its call and device time beside the unclassified
   route's, bound, chain bound, plan, one device event a call
   (asserted) and ptxas's registers and spills; match-all tables equal
   the unclassified routes;
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
   layer-0 activations;
11. runs two paths whose maintenance windows are wider than
   ``kernels.ROW_MAX``, card == CPU, each of which must launch
   ``run_sums`` on the ``tiled`` route: ``EticaCache.run`` on two of the
   paper's VMs with one 34,000-request window (17,000 requests a VM),
   and two-tier KV serving on 30,000 churn events with a 20,000-access
   trace ring;
12. runs the paper's figures through ``examples/torch_paper_figures.py``
   on the card at the benchmarks' own sizes: fig3 (4 workloads x 3
   policies x 6,000 requests, 16 x 32), fig10/11 (8 workloads x 10
   intervals of 1,000), fig12/13 (6 VMs x 8,000; ETICA-Full, ETICA-NPE
   and ECI-Cache; DRAM 400 / SSD 800, ECI-Cache at 1,200, resize 2,000,
   promotion 500) and fig17 (3 VMs x 6,000, promotion intervals 100 to
   2,000, from the telemetry journal), each held to the JAX package's
   CPU values (hard-coded below: integer counts exact, ``latency_sum``
   the same float32 value, derived floats equal, ``format_report``
   lines equal) with its launches counted per path; holds the per-state
   ``resize`` and ``clean_blocks`` to ``resize_ref`` /
   ``clean_blocks_ref`` at 64 x 64 and 16 x 32; prints fig12/13's
   derived rows at the §5.1 deployment from phases 3 and 5;
13. feeds the controllers from on-disk trace stores
   (``repro_torch.traces.TraceStore``): (a) the §5.1 deployment written
   to a store of shards of 4,096, run by ETICA at prefetch depth 2 and
   0, with ``prefetch=False`` and from a pre-built
   ``StreamingTraceSource``, by ETICA with the cleaner and by
   ECI-Cache, each equal to its in-memory card run of phases 3 and 5
   (stats, allocation histories, interval logs, final states), with
   requests/s beside the in-memory rate and a span breakdown; (b)
   fig15's streaming section
   (``examples/torch_trace_streaming.py``) at 32, 64 and 128 VMs, 32
   equal to the in-memory CPU run, with requests/s and the
   ``tracemalloc`` peak; (c) the §5.1 mix at 12 x 20,000 and 12 x
   100,000 requests in shards of 65,536, streamed == in memory, the two
   streamed ``tracemalloc`` peaks within 1.5x of each other while the
   trace grows 5x; (d) ``examples/torch_stream_external_trace.py``'s
   MSR import, streamed == in memory; (e) fig3, fig12/13 and fig17 in
   their ``--streamed`` forms, held to the JAX package's CPU values;
14. IO classification: (a) ``benchmarks/classification_bench.py``'s
   protocol (``SCAN_HEAVY_MIX``, 4 VMs x 8,000, Centaur and ETICA
   unclassified, with ``match_all()`` and with ``seq_cutoff(48)``,
   Centaur batched and sequential, ETICA fused, staged and sequential),
   each run on its own datapath route, match-all == unclassified, the
   modes equal, every stats dict and per-class count equal to the JAX
   package's CPU values (``CLASS_BENCH_JAX_CPU``) and
   ``BENCH_classification.json``'s six numbers; (b) the §5.1 deployment
   with ``seq_cutoff(48)`` and with a four-class classifier, ETICA and
   ECI-Cache, card == CPU (stats, histories, logs, final states,
   per-class counts), requests/s beside unclassified ETICA's (three
   interleaved runs each), span breakdowns; (c) the seq-cutoff ETICA run
   from a store of shards of 4,096 == (b)'s in-memory card run;
15. VM-axis sharding over a mesh that repeats ``cuda:0``
   (``VMMesh((cuda:0,) * d)``): (a) each sharded dispatch (both
   datapaths, both resizes, the stats aggregation, the fused interval
   with the cleaner, POD / TRD distances, the URD sizing metric) at the
   1024-VM shapes over 1, 2, 4 and 8 shards == the unsharded card
   dispatch bit for bit, each kernel launched exactly d times as often
   (the aggregation == its plain version on the CPU); (b), run in phase
   2, every kernel of the sharded path against its plain version on one
   8-way shard of the 1024-VM run, ``[128, 16, 32]``, whose last 4 rows
   are dead VMs (zero ways, ``addr = -1``, zero-length windows), the
   dead rows untouched; (c) fig15's 1024-VM consolidation split 8 ways:
   ETICA, ETICA with the cleaner and ECI-Cache, each == its unsharded
   card run (phase 4's, one made here, phase 7's: stats, histories,
   logs, final states; launches 8x), avg_hit ==
   ``FIG15_JAX_CPU_AVG_HIT_1024``; (d) 1,020 VMs over 8 shards (4 dead
   rows) == the unsharded 1,020-VM card run; (e) (c)'s ETICA run from a
   trace store == (c); (f) ``examples/torch_vm_sharding.py``'s 1, 2, 4
   and 8 shards of 128 VMs beside the unsharded run, three interleaved
   rounds, requests/s with ``nvidia-smi``'s name and power limit.

The §5.1 deployment (VMs, requests, intervals, the DRAM share of the
capacity) comes from ``src/repro_torch/configs/etica_paper.py``.

Each card run of phases 3 to 15 sets the launch counts to 0 just before
and reads them just after; exactly the kernels of that path's own set
must have launched (``popularity`` only on the staged paths), and in
phase 14 only the datapath route of its run (``classified`` with a
classifier). Phase 2
holds the kernels against their plain versions at the shapes of both
the 12-VM and the 1024-VM runs.

The line before the last is ``{"kernels": [...]}`` (one entry per
kernel; ``routes`` and ``routes_by_path``, where a kernel has more than
one route, count each route's launches; ``launches`` from its own path: the 12-VM paths, the full-width
serving run for ``paged_decode_attention``, the staged 12-VM run for
``popularity`` and the full-width prefill for ``flash_attention``; the
``classified`` routes as entries of their own, ``two_level_classified``
and ``single_level_classified``, with their route's launches on the
seq-cutoff 12-VM runs); the
last is ``{"ok": true, "device": {...}}``. Any
failed phase raises and the exit code is nonzero. Without a CUDA device
it exits 2 and prints no result; run from a directory without the
repository's ``src/repro_torch`` it exits 1 and prints no result.
"""
from __future__ import annotations

import contextlib
import dataclasses
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

PAPER_CACHE_BLOCKS = 24_576   # DRAM + SSD blocks of the 12-VM cells, split
#                               by the §5.1 config's dram_fraction
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


def paper_config():
    """The §5.1 deployment: ``CONFIG`` of this checkout's
    ``src/repro_torch/configs/etica_paper.py``, loaded from its file so
    that the timing scripts read it whichever tree they time."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "etica_paper_config",
        ROOT / "src" / "repro_torch" / "configs" / "etica_paper.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.CONFIG


def paper_caps() -> tuple[int, int]:
    """(DRAM, SSD) blocks of the 12-VM cells: ``dram_fraction`` of
    ``PAPER_CACHE_BLOCKS``, and the rest (8,192 and 16,384)."""
    dram = round(PAPER_CACHE_BLOCKS * paper_config().dram_fraction)
    return dram, PAPER_CACHE_BLOCKS - dram


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
    dram, ssd = paper_caps()
    gw = ([int(capacity_to_ways(dram, 256, 64))],
          [int(capacity_to_ways(ssd, 256, 64))])
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


# ---------------------------------------------------------------------------
# phase 2: the classified datapath routes (IO classification)
# ---------------------------------------------------------------------------

def kernel_classes():
    """The classes of the classified kernels' checks: the default pool,
    an exclusive slice (a quarter of the ways), an empty slice
    (``ways_frac`` 0) and a bypass class."""
    from repro_torch.classify import Classifier, IOClass
    return Classifier([IOClass("default"), IOClass("slice", ways_frac=0.25),
                       IOClass("empty", ways_frac=0.0),
                       IOClass("bypass", bypass=True)])


def ptxas_by_kernel(source: str) -> dict:
    """ptxas's registers and spills of each walk kernel instantiation of
    one source (``kernels.build_log()``), keyed ``kernel<Row>``."""
    import re
    from repro_torch import kernels
    out, cur, name = {}, None, None
    for ln in kernels.build_log().splitlines():
        if ln.endswith(".cu:") and " " not in ln:
            cur = ln[:-1]
        elif cur != source:
            continue
        elif "Compiling entry function" in ln:
            k = re.search(r"((?:two|single)_level[a-z_]*_kernel)I", ln)
            row = re.search(r"(MemRow|RegRowILi(\d)E)", ln)
            name = (f"{k.group(1) if k else '?'}<"
                    f"{'RegRow<' + row.group(2) + '>' if row and row.group(2) else 'MemRow'}>")
        elif name and ("registers" in ln or "spill" in ln):
            out[name] = (out.get(name, "") + " " + ln.split(":", 1)[-1]
                         .strip()).strip()
    return out


def walk_parts(dev, v, sets_d, sets_s) -> int:
    """The CTAs a VM of a datapath launch (``ops._split``'s plan)."""
    from repro_torch.kernels.datapath import ops
    if sets_d != sets_s:
        return 1
    return max(1, min(sm_count(dev) // v, sets_d // ops.WALK_WARPS))


def random_policy_flags(rng, v, c, dev) -> list:
    """``[V, C]`` policy flags, the five policies mixed across (VM,
    class)."""
    import torch
    from repro_torch.core.policies import Policy
    pick = rng.integers(0, len(Policy), (v, c))
    return [torch.from_numpy(np.asarray(
        [[getattr(list(Policy)[p], f) for p in row] for row in pick],
        bool).reshape(v, c)).to(dev)
        for f in ("allocates_reads", "write_invalidates", "holds_dirty",
                  "write_through")]


def check_classified(dev, rng, blocks, geo, ways, label, step_ns,
                     single=False, mode="full", time_plain=False):
    """A ``classified`` route (``two_level`` or, with ``single``,
    ``single_level``) against its plain version over chained blocks,
    with random class ids of :func:`kernel_classes` (and, at one level,
    the five policies mixed across (VM, class)); times the fullest block
    beside the unclassified route at the same shape; its bound, chain
    bound, plan and device events a call (one, asserted)."""
    import torch
    from repro_torch.core.policies import T_SSD
    from repro_torch.core.simulator import make_cache_batch
    from repro_torch.kernels.datapath import ops
    clf = kernel_classes()
    c = clf.num_classes
    (sd, wmd), (ss, wms) = geo if not single else (geo[0], geo[0])
    v = blocks[0][0].shape[0]
    put = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    w_np = [np.asarray(x, np.int32) for x in ways]
    bounds = [put(x) for w in (w_np if not single else w_np[:1])
              for x in clf.way_bounds(w)]
    wd, ws = put(w_np[0]), put(w_np[1])
    byp = put(clf.bypass)
    npe = mode == "npe"
    if single:
        flags = random_policy_flags(rng, v, c, dev)
        kstate = rstate = tuple(make_cache_batch(v, sd, wmd, dev))
        run = lambda a, w, cl, st, t: ops.single_level_classified(
            a, w, cl, *st, wd, *flags, t, byp, *bounds, t_cache=T_SSD)
        plain = lambda a, w, cl, st, t: ops.single_level_classified_plain(
            a, w, cl, *st, wd, *flags, t, byp, *bounds, t_cache=T_SSD)
        base = lambda a, w, st, t: ops.single_level(
            a, w, *st, wd, *(f[:, 0].contiguous() for f in flags), t,
            t_cache=T_SSD)
        nst, it = 3, 5
        name = f"single_level_classified {label}"
    else:
        kstate = rstate = (*make_cache_batch(v, sd, wmd, dev),
                           *make_cache_batch(v, ss, wms, dev))
        run = lambda a, w, cl, st, t: ops.two_level_classified(
            a, w, cl, *st, wd, ws, t, byp, *bounds, npe=npe)
        plain = lambda a, w, cl, st, t: ops.two_level_classified_plain(
            a, w, cl, *st, wd, ws, t, byp, *bounds, npe=npe)
        base = lambda a, w, st, t: ops.two_level(a, w, *st, wd, ws, t,
                                                 npe=npe)
        nst, it = 6, 8
        name = f"two_level_classified {label} {mode}"
    kt = rt = torch.zeros(v, dtype=torch.int32, device=dev)
    err, timed = 0.0, None
    for a_np, w_np_ in blocks:
        a, w = put(a_np), put(w_np_)
        cl = put(rng.integers(0, c, a_np.shape).astype(np.int32))
        if timed is None or (a >= 0).sum() > (timed[0] >= 0).sum():
            timed = (a, w, cl, kstate, kt)
        kout = run(a, w, cl, kstate, kt)
        rout = plain(a, w, cl, rstate, rt)
        err = max(err, max_abs_err(kout, rout))
        kstate, kt = kout[:nst], kout[it]
        rstate, rt = rout[:nst], rout[it]
    a, w, cl, st, t = timed
    call = lambda: run(a, w, cl, st, t)
    ms, dev_ms = cuda_ms(call, 20), graph_ms(call, 10)
    u_ms = cuda_ms(lambda: base(a, w, st, t), 20)
    u_dev = graph_ms(lambda: base(a, w, st, t), 10)
    plain_ms = (cuda_ms(lambda: plain(a, w, cl, st, t), 1, warmup=0)
                if time_plain else None)
    events = kernel_events(call, ("single_level" if single else "two_level")
                           + "_classified_kernel")
    n = a.shape[1]
    sets = sorted({sd, ss})
    chain = sum(longest_set_chain(a, s) for s in sets)
    chain_b = chain * step_ns * 1e-6
    state_bytes = 2 * 9.0 * v * (sd * wmd + (0 if single else ss * wms))
    nbytes = 9.0 * v * n + state_bytes + 16.0 * v * c + (40.0 + 8 * c) * v
    ops_count = float((a >= 0).sum()) * 2 * (wmd + (0 if single else wms))
    b, by = bound_ms(nbytes, ops_count)
    parts = walk_parts(dev, v, sd, ss)
    log(f"{name} [{v},{n}] {sd}x{wmd}" + ("" if single else f" / {ss}x{wms}")
        + f", C {c}: exact over {len(blocks)} blocks; kernel {ms:.4f} ms "
        f"(device {dev_ms:.4f} ms, {events:.0f} device event a call), "
        f"unclassified route {u_ms:.4f} ms (device {u_dev:.4f} ms), plain "
        f"{fmt_ms(plain_ms)}, bound {b:.5f} ms ({by}), longest same-set "
        f"chain {chain} x {step_ns:.2f} ns = chain bound {chain_b:.5f} ms, "
        f"plan {parts} CTA(s) a VM")
    return dict(max_abs_err=err, ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                bound_ms=b, bound_by=by, library_ms=None, chain=chain,
                chain_bound_ms=chain_b, unclassified_ms=u_ms,
                unclassified_device_ms=u_dev, parts=parts, events=events)


def check_match_all_routes(dev, blocks, ways):
    """Match-all tables (one class, no bypass, the whole active range)
    through the classified routes at the 12-VM shape: states, the eight
    counts, the ``latency_sum`` bits and clocks equal the unclassified
    routes', ``bypassed`` 0 and every non-padding request counted once in
    its class."""
    import torch
    from repro_torch.core.policies import T_SSD
    from repro_torch.core.simulator import make_cache_batch, policy_flags
    from repro_torch.core.policies import Policy
    from repro_torch.kernels.datapath import ops
    v = blocks[0][0].shape[0]
    wd, ws = (torch.as_tensor(x, dtype=torch.int32, device=dev)
              for x in ways)
    zero = torch.zeros((v, 1), dtype=torch.int32, device=dev)
    byp = torch.zeros(1, dtype=torch.bool, device=dev)
    flags = policy_flags([list(Policy)[k % 5] for k in range(v)], dev)
    st2 = (*make_cache_batch(v, 64, 64, dev), *make_cache_batch(v, 64, 64,
                                                                 dev))
    st1 = tuple(make_cache_batch(v, 64, 64, dev))
    t2 = t1 = torch.zeros(v, dtype=torch.int32, device=dev)

    def same(label, got, want, nst):
        max_abs_err(list(got[:nst]) + [got[nst][:, :8]] + list(
            got[nst + 1:nst + 3]), want)
        if got[nst][:, 8].any() or not torch.equal(
                (got[-2] + got[-1])[:, 0], got[nst][:, :2].sum(1)):
            raise AssertionError(f"{label}: match-all class counts")
    for a_np, w_np in blocks:
        a, w = (torch.from_numpy(x).to(dev) for x in (a_np, w_np))
        cl = torch.zeros(a.shape, dtype=torch.int32, device=dev)
        for npe in (False, True):
            got = ops.two_level_classified(a, w, cl, *st2, wd, ws, t2, byp,
                                           zero, wd[:, None].contiguous(),
                                           zero, ws[:, None].contiguous(),
                                           npe=npe)
            want = ops.two_level(a, w, *st2, wd, ws, t2, npe=npe)
            same(f"two_level match-all npe={npe}", got, want, 6)
        st2, t2 = want[:6], want[8]
        got = ops.single_level_classified(
            a, w, cl, *st1, wd, *(f[:, None].contiguous() for f in flags),
            t1, byp, zero, wd[:, None].contiguous(), t_cache=T_SSD)
        want = ops.single_level(a, w, *st1, wd, *flags, t1, t_cache=T_SSD)
        same("single_level match-all", got, want, 3)
        st1, t1 = want[:3], want[5]
    log(f"match-all tables through both classified routes over "
        f"{len(blocks)} 12-VM blocks (two_level full and npe, single_level "
        f"under the five policies): equal to the unclassified routes "
        f"(states, counts, latency_sum bits, clocks), bypassed 0")


def check_classified_routes(dev, rng, paper, blocks12, blocks1024, ways12,
                            step_ns) -> dict:
    """Phase 2's classified routes: each at the paper's [12, 1000] blocks
    (64 x 64), the 1024-VM blocks (16 x 32), V = 1 (64 x 64), rows of
    9,000 (two tiles), rows of 128 ways and one set taking every
    request; match-all tables equal the unclassified routes. Returns the
    kernels line's two rows."""
    g64, g16 = ((64, 64), (64, 64)), ((16, 32), (16, 32))
    vm0 = [(a[:1], w[:1]) for a, w in blocks12[:1]]
    w0 = (ways12[0][:1], ways12[1][:1])
    two = stream_blocks(paper, 9_000, 1)
    w1024 = (rng.integers(0, 33, 1024), rng.integers(0, 33, 1024))
    rows = {}
    for single, key in ((False, "two_level_classified"),
                        (True, "single_level_classified")):
        chk = lambda *args, **kw: check_classified(dev, rng, *args,
                                                   step_ns=step_ns,
                                                   single=single, **kw)
        row = chk(blocks12, g64, ways12, "12-VM", time_plain=True)
        row["shapes"] = {
            "1024-VM": chk(blocks1024, g16, w1024, "1024-VM"),
            "V=1": chk(vm0, g64, w0, "V=1"),
            "two tiles": chk(two, g64, ([64], [64]), "rows of 9,000"),
            "wide rows": chk(blocks12[:1], ((32, 128), (32, 128)),
                             (rng.integers(8, 129, 12),
                              rng.integers(8, 129, 12)), "128 ways"),
            "one set": chk(one_set(blocks12[:1], 64), g64, ways12,
                           "one set", mode="npe")}
        if not single:
            row["shapes"]["12-VM npe"] = chk(blocks12, g64, ways12, "12-VM",
                                             mode="npe")
        row["max_abs_err"] = max([row["max_abs_err"]] + [
            r.pop("max_abs_err") for r in row["shapes"].values()])
        src = "single_level.cu" if single else "datapath.cu"
        row["ptxas"] = ptxas_by_kernel(src)
        for k, info in row["ptxas"].items():
            log(f"ptxas {src} {k}: {info}")
        rows[key] = row
    check_match_all_routes(dev, blocks12, ways12)
    return rows


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
    the trace drops events). A trace that holds no such kernel is taken
    again, up to three times; then the result is None, or, with ``want``
    set, a failure. A kernel that writes its outputs itself must put
    ``want`` (1): no copy or fill beside it."""
    for _ in range(3):
        names = {}
        _, events = device_profile(call, 20, by_name=names)
        kernel = sum(n for k, n in names.items() if name in k)
        if kernel:
            break
    else:
        if want is None:
            return None
        raise AssertionError(f"{name}: no such kernel in three profiler "
                             f"traces (device events: {names})")
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


ROW_WIDTHS = (1000, 16_384, 16_385, 40_000)   # rows of the row-limit check


def row_cases(rng, v, n):
    """``[v, n]`` addresses for the row-limit check: heavy ties (48 keys),
    one key for a whole row, an empty row (its valid length 0), runs of 80
    entries across each multiple of ``ROW_MAX`` (the tiled route's tile
    edges); row 4 random over 4,096 keys."""
    from repro_torch import kernels
    addr = rng.integers(0, 48, (v, n)).astype(np.int32)
    addr[1] = 7
    addr[3] = rng.integers(0, 4096, n)
    for e in range(kernels.ROW_MAX, n, kernels.ROW_MAX):
        addr[3, e - 40:e + 40] = 5000 + e // kernels.ROW_MAX
    addr[4] = rng.integers(0, 4096, n)
    nv = np.array([n, n, 0, n, n], np.int32)
    return addr, nv


def check_row_limits(dev, rng):
    """``popularity`` and ``run_sums`` against their plain versions,
    exactly, at the ``row`` route's widest row (``kernels.ROW_MAX``
    entries), a row of 1,000, and the ``tiled`` route's 16,385 (two
    tiles, the second of one entry) and 40,000 (three: a run without a
    partner in the merge), on ``row_cases``; each call's route is
    checked (the route counts of that call alone) and timed (call and
    CUDA-graph device time, the plain version once on the CPU, the
    bound). Returns
    ``(max_abs_err, {kernel: {width: stats}})``."""
    import torch
    from repro_torch import kernels
    from repro_torch.core import popularity as pop
    from repro_torch.kernels.popularity import ops
    err, out = 0.0, {"run_sums": {}, "popularity": {}}
    for n in ROW_WIDTHS:
        v = 5
        addr, nv_np = row_cases(rng, v, n)
        wa = torch.from_numpy(addr).to(dev)
        wc = torch.rand((v, n), device=dev)
        nv = torch.from_numpy(nv_np).to(dev)
        per = int(addr.max()) + 1
        seg = (wa + per * torch.arange(v, device=dev)[:, None]).to(
            torch.int32)
        seg[2] = v * per                         # all padding
        pargs = (torch.from_numpy(rng.integers(-1, 300, (v, n)).astype(
                     np.int32)).to(dev),
                 torch.from_numpy(rng.random((v, n)) < 0.7).to(dev), seg,
                 v * per, torch.full((v,), 64.0, device=dev))
        route = kernels.row_route(n)
        cpu = [x.cpu() for x in (wa, wc, nv)]
        pcpu = [x.cpu() if torch.is_tensor(x) else x for x in pargs]
        for name, call, plain, nbytes in (
                ("run_sums", lambda: pop.window_runs(wa, wc, nv),
                 lambda: pop.window_runs_plain(*cpu),
                 16.0 * v * n + 4.0 * v),
                ("popularity", lambda: [ops.popularity_rows(*pargs)],
                 lambda: [ops.popularity_rows_plain(*pcpu)],
                 9.0 * v * n + 4.0 * v + 4.0 * v * per)):
            kernels.reset_launch_counts()
            got = call()
            if kernels.route_counts(name)[route] != 1:
                raise AssertionError(f"{name} [{v},{n}]: not one launch on "
                                     f"the {route} route: "
                                     f"{kernels.route_counts(name)}")
            t0 = time.perf_counter()
            want = plain()
            plain_ms = (time.perf_counter() - t0) * 1e3
            e = max_abs_err([x.cpu() for x in got], want)
            err = max(err, e)
            ms = cuda_ms(call, 20)
            dev_ms = graph_ms(call, reps=5, replays=4)
            b, by = bound_ms(nbytes, 2.0 * float(nv.sum()))
            out[name][n] = dict(route=route, max_abs_err=e, ms=ms,
                                device_ms=dev_ms, plain_ms=plain_ms,
                                bound_ms=b, bound_by=by)
            log(f"row limits: {name} [{v},{n}] route {route}: exact (heavy "
                f"ties, one key for a whole row, an empty row, runs across "
                f"the tile edges), kernel {ms:.4f} ms (device {dev_ms:.4f} "
                f"ms), plain (one call, CPU) {plain_ms:.1f} ms, bound "
                f"{b:.6f} ms ({by})")
    return err, out


def select_passes(dirty, lru, ways, take) -> int:
    """The radix passes ``clean_scatter``'s selection makes in all (8
    bits each below the bits that every candidate key of a VM shares,
    for each VM with ``take > 0``; ``csrc/clean_scatter.cu``)."""
    v, s, w = dirty.shape
    b = (s * w - 1).bit_length() if s * w > 1 else 0
    flat = np.arange(s * w)
    passes = 0
    for r in range(v):
        cand = dirty[r].reshape(-1) & (flat % w < ways[r])
        if take[r] <= 0:
            continue
        keys = (((lru[r].reshape(-1)[cand].astype(np.int64) ^ -2**31)
                 & 0xFFFFFFFF) << b) | flat[cand]
        passes += -(-(int(keys.min()) ^ int(keys.max())).bit_length() // 8)
    return passes


def check_clean(dev, rng, v, s, w):
    """The cleaner as one launch (``ops.clean``: the kernel finds each
    VM's cutoff from its quota) against ``_clean_cutoffs`` +
    ``clean_scatter_plain`` on the CPU, all seven outputs, with random
    ways and quotas and lru ties; the cutoff form ``clean_scatter`` at
    the cutoffs it found against ``clean_scatter_plain``. Asserts one
    device event a call, prints the plan, and times ``clean`` whole (the
    parent's ``_clean_cutoffs`` + kernel) beside the plain composition on
    the card's tensors and the bound."""
    import torch
    from repro_torch.core.simulator import CacheState
    from repro_torch.kernels.maintenance import ops
    tags, lru, dirty = random_state(rng, v, s, w)
    lru = np.where(tags >= 0, rng.integers(0, 64, tags.shape),
                   -1).astype(np.int32)                          # ties
    ways_np = rng.integers(0, w + 1, v).astype(np.int32)
    quota_np = rng.integers(0, 2 * s * w // 3, v).astype(np.int32)
    quota_np[1] = 0                                  # the sentinel cutoff
    d, l, ways, quota = [torch.from_numpy(x).to(dev)
                         for x in (dirty, lru, ways_np, quota_np)]
    got = ops.clean_select(d, l, ways, quota)
    want = ops.clean_select(*[x.cpu() for x in (d, l, ways, quota)])
    err = max_abs_err([x.cpu() for x in got], want)
    if not torch.equal(got[1], got[4].clamp(min=0)):
        raise AssertionError("clean flushed other than the quota")
    err = max(err, max_abs_err(ops.clean_scatter(d, l, ways, got[2], got[3]),
                               ops.clean_scatter_plain(d, l, ways, got[2],
                                                       got[3])))
    state = CacheState(torch.from_numpy(tags).to(dev), l, d)
    call = lambda: ops.clean(state, ways, quota)  # noqa: E731

    def plain():
        lcut, icut, take, n_cand = ops._clean_cutoffs(d, l, ways, quota)
        return (ops.clean_scatter_plain(d, l, ways, lcut, icut),
                n_cand - take)
    events = kernel_events(call, "clean_kernel")
    ms = cuda_ms(call, 50)
    dev_ms = graph_ms(call)
    plain_ms = cuda_ms(plain, 10)
    cut_ms = cuda_ms(lambda: ops._clean_cutoffs(d, l, ways, quota), 10)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = ops.clean_plan(v, s * w, sms)
    passes = select_passes(dirty, lru, ways_np, want[4].numpy())
    # dirty and lru read once, dirty written, ways and quota read, five
    # [V] outputs and flushed written; a test and a key a slot a pass
    b, by = bound_ms(6.0 * v * s * w + 32.0 * v,
                     4.0 * v * s * w + 4.0 * passes * s * w)
    log(f"clean [{v},{s},{w}]: one launch == _clean_cutoffs + "
        f"clean_scatter_plain (all seven outputs; the cutoff form == "
        f"clean_scatter_plain), flushed {int(got[1].sum())}, plan (parts, "
        f"threads) {plan}, {passes} radix passes in all, {events:.0f} device "
        f"events a call, clean {ms:.4f} ms (device {dev_ms:.4f} ms), plain "
        f"(_clean_cutoffs + clean_scatter_plain on the card) {plain_ms:.4f} "
        f"ms, of which _clean_cutoffs {cut_ms:.4f} ms, bound {b:.6f} ms "
        f"({by})")
    return dict(max_abs_err=err, ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                bound_ms=b, bound_by=by, library_ms=None,
                device_events=events, plan=list(plan), radix_passes=passes)


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


def span_breakdown(build, trace, label, repeats=1, dev="cuda"):
    """``repeats`` more card runs with span timing on: CUDA-event time of
    the sizing, datapath and maintenance spans (each span waits for its
    work, so these runs are slower than the untimed one and their results
    are not reported as the cell's speed)."""
    from repro_torch.runtime.telemetry import TelemetryRecorder
    for _ in range(repeats):
        rec = TelemetryRecorder(span_timing=True)
        _, _, wall = run_controller(build, trace, dev, rec)
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
    routes = {k: {r: c for r, c in kernels.route_counts(k).items() if c}
              for k in kernels.ROUTES}
    n["routes"] = {k: r for k, r in routes.items() if r}
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
    (``want``/``got`` are ``(cache, results)``, on the card or the CPU),
    but for the stats keys in ``ignore``."""
    import torch
    (wc, wres), (gc, gres) = want, got

    def cut(res):
        return [dataclasses.replace(r, stats={k: x for k, x in r.stats.items()
                                              if k not in ignore})
                for r in res]
    assert_same(cut(gres), cut(wres), label)
    same_logs(label, wc, gc)
    views = ("vm_cache",) if hasattr(wc, "vm_cache") else ("vm_dram",
                                                            "vm_ssd")
    for view in views:
        for v in range(len(wres)):
            for a, b in zip(getattr(wc, view)(v), getattr(gc, view)(v)):
                if not torch.equal(a.cpu(), b.cpu()):
                    raise AssertionError(f"{label}: VM {v} {view} differs")


def same_logs(label, wc, gc) -> None:
    """Two controllers' interval logs (demands, allocations, policies)."""
    names = ("logs",) if hasattr(wc, "logs") else ("logs_dram", "logs_ssd")
    for name in names:
        wl, gl = getattr(wc, name), getattr(gc, name)
        if len(wl) != len(gl) or any(
                not np.array_equal(a.demands, b.demands)
                or not np.array_equal(a.alloc, b.alloc)
                or a.policies != b.policies for a, b in zip(wl, gl)):
            raise AssertionError(f"{label}: {name} differ")


def check_oracle_ladder(launches, paper, fused, clean, eci_run):
    """Phase 9: the staged and sequential modes of the paper's 12-VM
    deployment, without and with the cleaner, each equal to its fused
    card run (phases 3 and 5); ECI-Cache sequential equal to its batched
    run; FAST and L2ARC on the same mix as one stream, equal to the JAX
    package's CPU values. Each run launches exactly its own kernels."""
    from repro_torch.core.baselines import make_fast, make_l2arc
    from repro_torch.core.controller import EticaConfig, Geometry
    rates = {}
    dram, ssd = paper_caps()
    for quota, (fc, fres, frate) in ((0, fused), (CLEAN_QUOTA, clean)):
        tag = "-clean" if quota else ""
        cfg = EticaConfig(dram_capacity=dram, ssd_capacity=ssd,
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
            EticaConfig(dram_capacity=dram, ssd_capacity=ssd),
            **(dict(fused_maintenance=False) if mode == "staged"
               else dict(batched=False))), 12), paper, f"paper-12vm-{mode}")

    ec, eres, erate = eci_run
    launches["paper-12vm-eci-seq"], cache, res, rates["paper-12vm-eci-seq"] \
        = drive_card(eci(dram + ssd, 12, geometry=Geometry(64, 64),
                         resize_interval=paper_config().resize_interval,
                         batched=False), paper,
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
        cache = factory(dram, ssd, geometry=Geometry(256, 64),
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


def l2arc_promote_calls(paper, dev="cuda") -> list:
    """Every ``promote_scatter`` call of an L2ARC run (256 x 64, window
    1,000) on ``paper``, recorded: a [1, 256, 64] state, the window's
    DRAM evictions padded to a power of two, ways, t and ``dedupe``
    (always on)."""
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
        make_l2arc(*paper_caps(), geometry=Geometry(256, 64),
                   device=dev).run(paper)
    finally:
        ops.promote_scatter = orig
    if not calls or not all(c[6] for c in calls):
        raise AssertionError("L2ARC: expected promote_scatter calls, all "
                             "with the dedupe")
    return calls


def check_l2arc_promote(paper, dev="cuda", want_events: int | None = 1):
    """``promote_scatter``'s dedupe branch at L2ARC's own shape: a second
    L2ARC run (256 x 64, window 1,000) records every ``promote_scatter``
    call, a [1, 256, 64] state and the window's DRAM evictions padded to a
    power of two; each call is held to its plain version, and one CUDA
    graph of all of them gives their device time. The loss is that time
    less the sum of the calls' bounds. A call must put ``want_events``
    events on the device (None: any)."""
    from collections import Counter
    from repro_torch.kernels.maintenance import ops
    calls = l2arc_promote_calls(paper, dev)
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
        dram, ssd = paper_caps()
        etica(EticaConfig(dram_capacity=dram, ssd_capacity=ssd,
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


# ---------------------------------------------------------------------------
# phase 11: windows wider than one CTA's row sort (the tiled route)
# ---------------------------------------------------------------------------

WIDE_REQS = 17_000      # requests a VM of the 2-VM run: one chunk of both
WIDE_EVENTS = 30_000    # events of the serving run (about 20,800 activations)
WIDE_WINDOW = 20_000    # its trace ring: maintenance windows up to 20,000


def check_wide_rows(launches):
    """Two runs whose maintenance windows are wider than
    ``kernels.ROW_MAX``, card == CPU, each of which must launch
    ``run_sums`` on the ``tiled`` route: ``EticaCache.run`` on two of the
    paper's VMs with ``promo_interval`` (and ``resize_interval``) the
    whole 34,000-request trace, so the one window holds 17,000 requests a
    VM (rows of 32,768); and serving's churn trace at 30,000 events with
    a 20,000-access trace ring and maintenance every 2,048 activations,
    so the later windows hold more than 16,384 accesses (rows of
    32,768)."""
    from repro_torch.core.controller import EticaConfig
    from repro_torch.traces.generators import SessionSpec, generate_sessions
    from repro_torch import kernels
    trace = trace_mix(paper_config().vms[:2], WIDE_REQS, 1.0)
    cfg = EticaConfig(dram_capacity=4096, ssd_capacity=8192,
                      resize_interval=len(trace), promo_interval=len(trace))
    launches["paper-2vm-wide"], *_ = drive(
        etica(cfg, 2), trace, "paper 2-VM, one 34,000-request window",
        ETICA_KERNELS)
    spec = SessionSpec(num_tenants=SERVING_TENANTS, target_live=1024,
                       max_pages=6)
    strace = generate_sessions(spec, WIDE_EVENTS, seed=1)
    scfg = serving_cfg(resize_interval=WIDE_WINDOW,
                       maintenance_interval=2048)
    kernels.reset_launch_counts()
    mgr, wall = run_serving("etica", scfg, strace, "cuda")
    launches["serving-wide"] = serving_launches("serving-wide",
                                                SERVING_KERNELS, only=True)
    cpu, wall_cpu = run_serving("etica", scfg, strace, "cpu")
    if mgr.stats != cpu.stats or placements(mgr) != placements(cpu):
        raise AssertionError(f"serving-wide: card != CPU\n  {mgr.stats}\n"
                             f"  {cpu.stats}")
    log(f"serving-wide ({len(strace)} events, {mgr.stats.activations} "
        f"activations, trace ring {WIDE_WINDOW}): card {wall:.3f} s, card "
        f"== CPU (CPU plain path {wall_cpu:.1f} s); launches "
        f"{launches['serving-wide']}")
    for label in ("paper-2vm-wide", "serving-wide"):
        if not launches[label]["routes"].get("run_sums", {}).get("tiled"):
            raise AssertionError(f"{label}: run_sums never took the tiled "
                                 f"route: {launches[label]}")


# ---------------------------------------------------------------------------
# phase 12: the paper's figures (fig3, fig10/11, fig12/13, fig17)
# ---------------------------------------------------------------------------

FIG3_KERNELS = ("single_level",)
FIG10_KERNELS = ("count_between",)
NPE_KERNELS = ("count_between", "two_level")   # mode npe: no maintenance

# The figures of examples/torch_paper_figures.py on the JAX package, CPU,
# at the benchmarks' own sizes (fig3 4 workloads x 3 policies x 6,000
# requests; fig10 8 workloads x 10 intervals of 1,000; fig12 6 VMs x
# 8,000, three controllers; fig17 3 VMs x 6,000 at 5 intervals), printed
# by (the same experiments through the JAX package's public API):
#   PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_figures.py
# FIG3: workload/policy -> the 13 Stats fields in order (latency_sum the
# float32 value), then the IOPS. FIG10: workload -> per-interval URD,
# POD(RO), POD(WBWO) demands, then their means. FIG12: controller -> per
# VM the 13 Stats fields and evict_flushes; the VMs' (mean latency, hit
# ratio, contended latency); a digest of the allocation histories; the
# summary (latency improvement, NPE's, under contention, hit gain).
# FIG17: interval -> summarize_journal's intervals, total_requests,
# mean_hit_ratio, peak_dirty, overloaded_intervals, then latency_norm,
# ssd_writes_norm, and format_report's line count and digest. The rows'
# digests cover every printed "name,derived" line of each figure.
FIG3_JAX_CPU = {
    "fio_randrw/WB":
        (4207, 1793, 0, 3738, 1386, 2262, 469, 196, 2.400388479232788, 0, 0, 0,
         0, 2499.595399623697),
    "fio_randrw/RO":
        (4207, 1793, 0, 2376, 0, 1831, 1831, 1793, 10.075201034545898, 0, 0, 0,
         0, 595.5216158394429),
    "fio_randrw/WBWO":
        (4207, 1793, 0, 3621, 1300, 1793, 586, 32, 2.9842309951782227, 0, 0, 0,
         0, 2010.5682199851528),
    "web_server/WB":
        (5431, 569, 0, 771, 271, 5229, 4660, 326, 23.312091827392578, 0, 0, 0,
         0, 257.3771605064534),
    "web_server/RO":
        (5431, 569, 0, 576, 0, 4855, 4855, 569, 24.563892364501953, 0, 0, 0, 0,
         244.2609628379087),
    "web_server/WBWO":
        (5431, 569, 0, 769, 276, 569, 4662, 0, 23.322032928466797, 0, 0, 0, 0,
         257.26745255883844),
    "video_server/WB":
        (6000, 0, 0, 0, 0, 6000, 6000, 0, 29.997968673706055, 0, 0, 0, 0,
         200.01354309230763),
    "video_server/RO":
        (6000, 0, 0, 0, 0, 6000, 6000, 0, 29.997968673706055, 0, 0, 0, 0,
         200.01354309230763),
    "video_server/WBWO":
        (6000, 0, 0, 0, 0, 0, 6000, 0, 29.997968673706055, 0, 0, 0, 0,
         200.01354309230763),
    "varmail/WB":
        (3006, 2994, 0, 2698, 2551, 3302, 308, 157, 1.5969922542572021, 0, 0,
         0, 0, 3757.062680802255),
    "varmail/RO":
        (3006, 2994, 0, 1233, 0, 1773, 1773, 2994, 10.374372482299805, 0, 0, 0,
         0, 578.3482336147922),
    "varmail/WBWO":
        (3006, 2994, 0, 2625, 2456, 2994, 381, 32, 1.9612618684768677, 0, 0, 0,
         0, 3059.2549095239638),
}
FIG10_JAX_CPU = {
    "hm_1": (
        (133, 151, 132, 138, 151, 116, 124, 113, 125, 128),
        (127, 145, 128, 136, 148, 114, 120, 109, 118, 121),
        (20, 11, 14, 17, 15, 15, 13, 14, 14, 22),
        (131.1, 126.6, 15.5),
    ),
    "proj_0": (
        (221, 193, 218, 219, 195, 217, 187, 222, 211, 215),
        (169, 162, 176, 144, 162, 154, 144, 160, 162, 162),
        (124, 103, 107, 112, 95, 122, 94, 114, 106, 104),
        (209.8, 159.5, 108.1),
    ),
    "rsrch_0": (
        (75, 104, 74, 101, 68, 43, 73, 78, 70, 88),
        (29, 30, 19, 33, 26, 18, 30, 39, 29, 34),
        (65, 87, 67, 90, 59, 40, 66, 65, 58, 80),
        (77.4, 28.7, 67.7),
    ),
    "web_3": (
        (717, 593, 565, 689, 726, 528, 657, 695, 620, 749),
        (706, 583, 556, 681, 491, 521, 643, 686, 612, 734),
        (14, 20, 16, 15, 18, 14, 20, 16, 15, 19),
        (653.9, 621.3, 16.7),
    ),
    "ts_0": (
        (34, 43, 53, 45, 36, 45, 56, 43, 32, 32),
        (19, 33, 43, 38, 26, 39, 48, 35, 29, 26),
        (30, 37, 41, 34, 35, 39, 43, 35, 29, 29),
        (41.9, 33.6, 35.2),
    ),
    "wdev_0": (
        (42, 36, 17, 35, 49, 25, 28, 35, 26, 29),
        (31, 18, 9, 21, 34, 18, 26, 27, 17, 21),
        (41, 32, 16, 34, 20, 25, 27, 34, 25, 28),
        (32.2, 22.2, 28.2),
    ),
    "usr_0": (
        (40, 58, 38, 45, 47, 34, 43, 38, 45, 51),
        (5, 9, 12, 12, 12, 17, 6, 16, 10, 9),
        (37, 56, 37, 40, 45, 32, 41, 37, 44, 48),
        (43.9, 10.8, 41.7),
    ),
    "src2_0": (
        (61, 57, 55, 46, 34, 41, 53, 60, 59, 49),
        (41, 23, 28, 33, 20, 31, 32, 39, 32, 18),
        (43, 51, 54, 40, 34, 37, 50, 55, 53, 42),
        (51.5, 29.7, 45.9),
    ),
}
FIG11_JAX_CPU_REDUCTION = 0.4397197390674077
FIG12_JAX_CPU_STATS = {
    "etica_full": (
        (7599.0, 401.0, 6106.0, 631.0, 338.0, 435.0, 959.0, 63.0,
         4.354249536991119, 0.0, 0.0, 0.0, 0.0, 0.0),
        (4341.0, 3659.0, 2144.0, 1962.0, 3334.0, 3454.0, 355.0, 325.0,
         1.3915303340181708, 0.0, 0.0, 0.0, 0.0, 0.0),
        (1621.0, 6379.0, 280.0, 1223.0, 5791.0, 5869.0, 196.0, 588.0,
         0.9542781449854374, 0.0, 0.0, 0.0, 0.0, 0.0),
        (7747.0, 253.0, 1350.0, 443.0, 141.0, 230.0, 6043.0, 112.0,
         29.832480788230896, 0.0, 0.0, 0.0, 0.0, 0.0),
        (4012.0, 3988.0, 1818.0, 2007.0, 3687.0, 3777.0, 277.0, 301.0,
         1.1433483613654971, 0.0, 0.0, 0.0, 0.0, 0.0),
        (3216.0, 4784.0, 1090.0, 1910.0, 4376.0, 4485.0, 325.0, 409.0,
         1.3474033093079925, 0.0, 0.0, 0.0, 0.0, 1.0),
    ),
    "etica_npe": (
        (7599.0, 401.0, 6106.0, 551.0, 311.0, 401.0, 942.0, 3.0,
         4.722582504153252, 0.0, 0.0, 0.0, 0.0, 1.0),
        (4341.0, 3659.0, 2144.0, 2157.0, 3512.0, 3659.0, 40.0, 24.0,
         0.25923195597715676, 0.0, 0.0, 0.0, 0.0, 8.0),
        (1621.0, 6379.0, 280.0, 1326.0, 6181.0, 6379.0, 15.0, 64.0,
         0.1521901092492044, 0.0, 0.0, 0.0, 0.0, 24.0),
        (7747.0, 253.0, 1350.0, 390.0, 122.0, 253.0, 6007.0, 17.0,
         30.042070508003235, 0.0, 0.0, 0.0, 0.0, 5.0),
        (4012.0, 3988.0, 1818.0, 2171.0, 3877.0, 3988.0, 23.0, 9.0,
         0.1774989403784275, 0.0, 0.0, 0.0, 0.0, 4.0),
        (3216.0, 4784.0, 1090.0, 2086.0, 4603.0, 4784.0, 40.0, 38.0,
         0.2692448680754751, 0.0, 0.0, 0.0, 0.0, 16.0),
    ),
    "eci_cache": (
        (7599.0, 401.0, 0.0, 6600.0, 0.0, 999.0, 999.0, 401.0,
         5.2614927142858505, 0.0, 0.0, 0.0, 0.0, 0.0),
        (4341.0, 3659.0, 0.0, 4305.0, 3533.0, 3695.0, 36.0, 13.0,
         0.259639963041991, 0.0, 0.0, 0.0, 0.0, 8.0),
        (1621.0, 6379.0, 0.0, 1608.0, 6196.0, 6392.0, 13.0, 43.0,
         0.14487011032178998, 0.0, 0.0, 0.0, 0.0, 23.0),
        (7747.0, 253.0, 0.0, 1503.0, 0.0, 6244.0, 6244.0, 253.0,
         31.361521363258362, 0.0, 0.0, 0.0, 0.0, 0.0),
        (4012.0, 3988.0, 0.0, 3991.0, 3893.0, 4009.0, 21.0, 2.0,
         0.1847898717969656, 0.0, 0.0, 0.0, 0.0, 0.0),
        (3216.0, 4784.0, 0.0, 3183.0, 4628.0, 4817.0, 33.0, 20.0,
         0.24466986814513803, 0.0, 0.0, 0.0, 0.0, 9.0),
    ),
}
FIG12_JAX_CPU_MEANS = {
    "etica_full":
        (0.0008129852182270648, 0.8048125, 0.0008434018848937314),
    "etica_npe":
        (0.0007421420601215989, 0.8348958333333334, 0.000774582060121599),
    "eci_cache":
        (0.0007803538310593769, 0.8216666666666667, 0.0008239471643927102),
}
FIG12_JAX_CPU_ALLOC = {"etica_full": "f9eb4e52d9055cdf",
                       "etica_npe": "f9eb4e52d9055cdf",
                       "eci_cache": "fe3ffd93abdf998b"}
FIG12_JAX_CPU_SUMMARY = (-0.041816142714887095, 0.04896723693392169,
                         -0.02361161169279624, -0.016854166666666615)
FIG17_JAX_CPU = {
    100:
        (64, 18000.0, 0.9198333333333333, 0.0, 0, 1.0, 1.0, 66,
         'c8b63818a5093328'),
    250:
        (27, 18000.0, 0.9104444444444444, 0.0, 0, 1.0542714841273126,
         0.9852123185456518, 29, '43e90e7871d30b67'),
    500:
        (18, 18000.0, 0.8896111111111111, 0.0, 0, 1.1984150069145494,
         0.9500746167412835, 20, 'c4c43256e2aeb4f4'),
    1000:
        (9, 18000.0, 0.8767777777777778, 0.0, 0, 1.2849556551789894,
         0.9306742640075973, 11, '9b552bfc0be96bb5'),
    2000:
        (9, 18000.0, 0.8767777777777778, 0.0, 0, 1.2849556551789894,
         0.9306742640075973, 11, '9b552bfc0be96bb5'),
}
FIGURE_ROWS_JAX_CPU = {
    "fig3": "0004c14ec97a2ecc",
    "fig10": "c6668e4db31e6ae0",
    "fig12": "02291b1151102da7",
    "fig17": "9c9a2c604a80f832",
}
# fig3's streamed form (examples/torch_paper_figures.py --streamed: a
# one-VM store a workload, shards of 1,024 fed to the simulator one by
# one) on the JAX package, CPU, by the same script: (latency_sum, IOPS)
# a run, the float32 sums added a shard at a time; every count equals
# FIG3_JAX_CPU's, and the rows' digest is FIGURE_ROWS_JAX_CPU's.
FIG3_STREAMED_JAX_CPU = {
    "fio_randrw/WB": (2.400331974029541, 2499.654241545406),
    "fio_randrw/RO": (10.075263977050781, 595.5178954781404),
    "fio_randrw/WBWO": (2.9841701984405518, 2010.6091814519968),
    "web_server/WB": (23.31366729736328, 257.35976770495415),
    "web_server/RO": (24.56553077697754, 244.2446717098054),
    "web_server/WBWO": (23.323646545410156, 257.24965383600085),
    "video_server/WB": (30.00040054321289, 199.99732974756577),
    "video_server/RO": (30.00040054321289, 199.99732974756577),
    "video_server/WBWO": (30.00040054321289, 199.99732974756577),
    "varmail/WB": (1.596924901008606, 3757.2211418398224),
    "varmail/RO": (10.374307632446289, 578.3518488727507),
    "varmail/WBWO": (1.9612005949020386, 3059.3504894891685),
}


def example(name: str):
    """``examples/<name>.py`` as a module."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def digest(lines) -> str:
    """tests/test_torch_figures.py's report_digest."""
    import hashlib
    return hashlib.sha256("\n".join(lines).encode()).hexdigest()[:16]


def figure_path_kernels(name: str) -> tuple:
    """The kernels one figure path must launch, and no other."""
    if name == "fig3":
        return FIG3_KERNELS
    if name == "fig10":
        return FIG10_KERNELS
    if name == "fig12-eci_cache":
        return ECI_KERNELS
    if name == "fig12-etica_npe":
        return NPE_KERNELS
    return ETICA_KERNELS              # fig12-etica_full, fig17-<interval>


def counted(launches, suffix="", kernels_of=figure_path_kernels):
    """The figure functions' ``around``: the launch counts set to 0 just
    before a named path and read just after it (kept as ``launches[name
    + suffix]``), which must have launched exactly ``kernels_of(name)``."""
    import torch
    from repro_torch import kernels

    @contextlib.contextmanager
    def around(name):
        kernels.reset_launch_counts()
        yield
        torch.cuda.synchronize()
        launches[name + suffix] = serving_launches(
            name + suffix, kernels_of(name), only=True)
    return around


def expect_equal(label, got, want):
    if got != want:
        raise AssertionError(f"{label} differs from the JAX CPU values:\n"
                             f"  card {got}\n  JAX  {want}")


def check_paper_figures(launches) -> dict:
    """The four figures on the card at the benchmarks' sizes, each path's
    launches counted, every output held to the JAX package's CPU values:
    integer counts exact, ``latency_sum`` the same float32 value, derived
    floats equal, report lines equal. Logs each path's wall time and
    requests/s, then the span breakdown of a second, span-timed run of
    fig12's ETICA-Full and ECI-Cache and fig17's promotion interval
    100."""
    from repro_torch.core import Stats
    figs = example("torch_paper_figures")
    around = counted(launches)
    keys = Stats._fields
    speed = {}

    f3 = figs.fig3("cuda", around=around)
    for (w, p), run in f3["runs"].items():
        expect_equal(f"fig3 {w}/{p}",
                     tuple(run["stats"][k] for k in keys) + (run["iops"],),
                     FIG3_JAX_CPU[f"{w}/{p}"])
    speed["fig3"] = (f3["seconds"], f3["requests"])

    f10 = figs.fig10("cuda", around=around)
    for w, sizes in f10["sizes"].items():
        expect_equal(f"fig10 {w}", tuple(map(tuple, sizes))
                     + (f10["means"][w],), FIG10_JAX_CPU[w])
    expect_equal("fig11 reduction", f10["reduction"], FIG11_JAX_CPU_REDUCTION)
    speed["fig10"] = (f10["seconds"], f10["requests"])

    f12 = figs.fig12("cuda", around=around)
    speed.update(expect_fig12(f12))
    f17 = figs.fig17("cuda", around=around)
    speed.update(expect_fig17(f17))
    expect_rows((("fig3", f3), ("fig10", f10), ("fig12", f12),
                 ("fig17", f17)))
    log_speed(launches, speed)
    log("phase 12: fig3, fig10/11, fig12/13 and fig17 on the card equal the "
        "JAX package's CPU values (stats, latency sums, derived floats, "
        "report lines)")
    fig12_mix = figs.vm_mix(figs.FIG12_VMS)
    span_breakdown(etica(figs.etica_config("full"), len(figs.FIG12_VMS)),
                   fig12_mix, "fig12 ETICA-Full")
    span_breakdown(eci(figs.DRAM_CAP + figs.SSD_CAP, len(figs.FIG12_VMS),
                       geometry=figs.GEO, resize_interval=figs.RESIZE),
                   fig12_mix, "fig12 ECI-Cache")
    span_breakdown(etica(figs.etica_config("full", promo=100),
                         len(figs.FIG17_VMS)),
                   figs.vm_mix(figs.FIG17_VMS, figs.FIG17_REQS),
                   "fig17 promotion 100")


def expect_fig12(f12, label="fig12") -> dict:
    """fig12's three controllers held to the JAX CPU values; returns
    each path's (seconds, requests)."""
    from repro_torch.core import Stats
    keys = Stats._fields
    speed = {}
    for name, run in f12["runs"].items():
        expect_equal(f"{label} {name} stats", tuple(
            tuple(s[k] for k in keys + ("evict_flushes",))
            for s in run["stats"]), FIG12_JAX_CPU_STATS[name])
        expect_equal(f"{label} {name} alloc_history",
                     digest([json.dumps(run["alloc_history"])]),
                     FIG12_JAX_CPU_ALLOC[name])
        expect_equal(f"{label} {name} means", f12["means"][name],
                     FIG12_JAX_CPU_MEANS[name])
        speed[f"fig12-{name}"] = (run["seconds"], f12["requests"])
    expect_equal(f"{label} summary", f12["summary"], FIG12_JAX_CPU_SUMMARY)
    return speed


def expect_fig17(f17, label="fig17") -> dict:
    """fig17's sweep held to the JAX CPU values; returns each path's
    (seconds, requests)."""
    speed = {}
    for iv, run in f17["runs"].items():
        s = run["summary"]
        expect_equal(f"{label} interval {iv}", (
            s["intervals"], s["total_requests"], s["mean_hit_ratio"],
            s["peak_dirty"], s["overloaded_intervals"], run["latency_norm"],
            run["ssd_writes_norm"], len(run["report"]),
            digest(run["report"])), FIG17_JAX_CPU[iv])
        speed[f"fig17-{iv}"] = (run["seconds"], f17["requests"])
    return speed


def expect_rows(outs, label="", show=True) -> None:
    """Each figure's printed rows held to the JAX CPU digest, then
    logged (with ``show``)."""
    for key, out in outs:
        expect_equal(f"{key}{label} rows", digest([f"{n},{d}" for n, d in
                                                   out["rows"]]),
                     FIGURE_ROWS_JAX_CPU[key])
        for n, d in out["rows"] if show else ():
            log(f"  {n},{d}")


def log_speed(launches, speed, suffix="") -> None:
    for path, (sec, n) in speed.items():
        counts = {k: v for k, v in launches[path + suffix].items()
                  if k != "routes" and v}
        log(f"{path}{suffix}: {n} requests in {sec:.3f} s on the card, "
            f"{n / sec:.0f} requests/s, launches {counts}")


def check_state_ops(dev, rng):
    """Per-state ``resize`` and ``clean_blocks`` on the card at the 64 x
    64 and 16 x 32 geometries, equal to ``resize_ref`` and
    ``clean_blocks_ref`` on seeded random states (random ways and
    quotas, a quota of 0 and one above the dirty count)."""
    import torch
    from repro_torch.core.simulator import (CacheState, clean_blocks,
                                            clean_blocks_ref, resize,
                                            resize_ref)

    def same(label, got, want):
        for a, b in zip(got, want):
            if not torch.equal(a.cpu(), b.cpu()):
                raise AssertionError(f"{label}: card != numpy oracle")

    n = 0
    for s, w in ((64, 64), (16, 32)):
        for trial in range(6):
            st = CacheState(*(torch.from_numpy(np.ascontiguousarray(x[0]))
                              .to(dev) for x in random_state(rng, 1, s, w)))
            old, new = (int(x) for x in rng.integers(0, w + 1, 2))
            got, fl = resize(st, old, new)
            want, wfl = resize_ref(st, old, new)
            if int(fl) != wfl:
                raise AssertionError(f"resize [{s},{w}] {old}->{new}: "
                                     f"flushed {int(fl)} != {wfl}")
            same(f"resize [{s},{w}] {old}->{new}", got, want)
            ways = w if trial % 2 else int(rng.integers(0, w + 1))
            n_dirty = int(st.dirty[:, :ways].sum())
            for quota in (int(rng.integers(1, n_dirty + 2)), 0, n_dirty + 7):
                got, fl, left = clean_blocks(st, ways, quota)
                want, wfl, wleft = clean_blocks_ref(st, ways, quota)
                if (int(fl), int(left)) != (wfl, wleft):
                    raise AssertionError(
                        f"clean_blocks [{s},{w}] ways {ways} quota {quota}: "
                        f"{(int(fl), int(left))} != {(wfl, wleft)}")
                same(f"clean_blocks [{s},{w}] ways {ways} quota {quota}",
                     got, want)
                n += 1
    log(f"per-state resize (12 states) and clean_blocks ({n} calls, quotas "
        f"0 and above the dirty count included) on the card at [64, 64] "
        f"and [16, 32] equal resize_ref / clean_blocks_ref")


def paper_fig12_rows(etica_res, eci_res) -> None:
    """fig12/13's derived rows at the §5.1 deployment, from phase 3's
    ETICA-Full run and phase 5's ECI-Cache run (ETICA-NPE is not run
    there)."""
    figs = example("torch_paper_figures")
    full, eci = figs.vm_means(etica_res), figs.vm_means(eci_res)
    for name, (lat, hit, clat) in (("etica_full", full), ("eci_cache", eci)):
        log(f"  fig12/paper-12vm/{name}: mean_latency_ms={lat*1e3:.4f} "
            f"contended_ms={clat*1e3:.4f} hit_ratio={hit:.4f}")
    log(f"  fig12/paper-12vm/summary: etica_latency_improvement="
        f"{1 - full[0] / eci[0]:.4f} (paper: 0.45) "
        f"with_ssd_write_contention={1 - full[2] / eci[2]:.4f} "
        f"hit_gain={full[1] - eci[1]:.4f} (paper: +0.30); npe not run")


# ---------------------------------------------------------------------------
# phase 13: streamed ingestion from the on-disk trace store
# ---------------------------------------------------------------------------

STORE_SHARD = 4_096           # a 10,000-request window spans 3 or 4 shards
BOUNDED_SHARD = 65_536
BOUNDED_REQS = (20_000, 100_000)   # a VM: 240,000 and 1.2 M requests
PEAK_RATIO = 1.5              # streamed tracemalloc peaks, 1.2 M vs 240 k


def only(kernel_set):
    """A ``kernels_of`` for :func:`counted`: every path ``kernel_set``."""
    return lambda name: kernel_set


def drive_stream(build, source, n, label, expect, dev="cuda"):
    """One run of ``build(dev).run(source)`` with the launch counts set
    to 0 just before and read just after (exactly ``expect`` launched).
    Returns ``(launches, cache, results, requests/s)``."""
    from repro_torch import kernels
    kernels.reset_launch_counts()
    cache, res, wall = run_controller(build, source, dev)
    return serving_launches(label, expect, only=True), cache, res, n / wall


def traced_peak(build, source, dev="cuda") -> int:
    """The ``tracemalloc`` peak (bytes of the Python heap, numpy arrays
    included) of one ``run`` from ``source``; the build is outside."""
    import torch
    import tracemalloc
    cache = build(dev)
    if dev != "cpu":
        torch.cuda.synchronize()
    tracemalloc.start()
    try:
        cache.run(source)
        if dev != "cpu":
            torch.cuda.synchronize()
        return tracemalloc.get_traced_memory()[1]
    finally:
        tracemalloc.stop()


def launch_summary(n) -> dict:
    return {k: v for k, v in n.items() if k != "routes" and v}


def check_streamed_paper(launches, paper, cfg, ccfg, build_eci, fused,
                         clean, eci_run, dev="cuda"):
    """Phase 13 (a): the §5.1 deployment written to a store of shards of
    4,096 and run from it: ETICA at prefetch depth 2 (the default) and
    0, with ``prefetch=False`` and from a pre-built
    ``StreamingTraceSource``; the cleaner; ECI-Cache. Each equal to its
    in-memory card run of phases 3 and 5 (stats, allocation histories,
    interval logs, final states) and launching exactly its path's
    kernels; requests/s beside the in-memory rate (phase 3's or 5's, and
    for ETICA, the cleaner and ECI-Cache one more in-memory run now);
    the span breakdown of a span-timed streamed ETICA run."""
    import tempfile
    from repro_torch.traces import StreamingTraceSource, TraceStore
    n = len(paper)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_store_") as tmp:
        path = Path(tmp) / "paper"
        t0 = time.perf_counter()
        store = TraceStore.from_trace(path, paper, shard_size=STORE_SHARD)
        log(f"paper 12-VM store: {n} requests in {store.num_shards} shards "
            f"of {STORE_SHARD} ({time.perf_counter() - t0:.3f} s to write)")
        prebuilt = StreamingTraceSource(TraceStore.open(path), num_vms=1,
                                        window=1, chunk=1)
        cases = (
            ("paper-12vm-streamed", etica(cfg, 12), None, ETICA_KERNELS,
             fused),
            ("paper-12vm-streamed-depth0",
             etica(dataclasses.replace(cfg, prefetch_depth=0), 12), None,
             ETICA_KERNELS, fused),
            ("paper-12vm-streamed-no-prefetch",
             etica(dataclasses.replace(cfg, prefetch=False), 12), None,
             ETICA_KERNELS, fused),
            ("paper-12vm-streamed-prebuilt", etica(cfg, 12), prebuilt,
             ETICA_KERNELS, fused),
            ("paper-12vm-clean-streamed", etica(ccfg, 12), None,
             CLEAN_KERNELS, clean),
            ("paper-12vm-eci-streamed", build_eci, None, ECI_KERNELS,
             eci_run))
        for label, build, source, expect, (want_cache, want_res,
                                           want_rate) in cases:
            source = source or TraceStore.open(path)
            launches[label], cache, res, rate = drive_stream(
                build, source, n, label, expect, dev)
            same_run(label, (want_cache, want_res), (cache, res))
            again = ""
            if label in ("paper-12vm-streamed", "paper-12vm-clean-streamed",
                         "paper-12vm-eci-streamed"):
                # in memory once more, beside the streamed run
                _, _, mem_s = run_controller(build, paper, dev)
                again = f", {n / mem_s:.0f} again now"
            log(f"{label}: {rate:.0f} requests/s from the store "
                f"(in memory: {want_rate:.0f} in phase 3/5{again}); equal "
                f"to the in-memory card run; launches "
                f"{launch_summary(launches[label])}")
        span_breakdown(etica(cfg, 12), TraceStore.open(path),
                       "paper-12vm-streamed", dev=dev)


def check_streamed_fig15(launches, dev="cuda"):
    """Phase 13 (b): fig15's streaming section at 32, 64 and 128 VMs
    (``examples/torch_trace_streaming.py``): 32 VMs equal to the
    in-memory CPU run; requests/s and the ``tracemalloc`` peak a
    scale; the span breakdown at 128 VMs."""
    import tempfile
    from repro_torch.traces import TraceStore
    mod = example("torch_trace_streaming")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_fig15_") as tmp:
        out = mod.streaming_scaling(
            Path(tmp), dev, around=counted(launches,
                                           kernels_of=only(ETICA_KERNELS)))
        big = max(out)
        span_breakdown(etica(mod.etica_config("full", dram=200, ssd=400),
                             big),
                       TraceStore.open(Path(tmp) / f"mix_{big}"),
                       f"fig15-streaming-{big}vm", dev=dev)
    for active, r in out.items():
        log(f"fig15-streaming-{active}vm: {r['requests']} requests, "
            f"{r['requests'] / r['seconds']:.0f} requests/s, tracemalloc "
            f"peak {r['peak'] / 2**20:.3f} MiB, avg_hit {r['avg_hit']:.4f}"
            + ("; equal to the in-memory CPU run" if r["checked"] else "")
            + f"; launches "
            f"{launch_summary(launches[f'fig15-streaming-{active}vm'])}")


def check_bounded_memory(launches, cfg, paper, fused, reqs=BOUNDED_REQS,
                         shard=BOUNDED_SHARD, dev="cuda"):
    """Phase 13 (c): the §5.1 mix at 12 x 20,000 (phase 3's trace) and
    12 x 100,000 requests in stores of shards of 65,536, each streamed
    run equal to its in-memory card run (phase 3's at 240 k); the
    streamed ``tracemalloc`` peaks within ``PEAK_RATIO`` of each other
    while the trace grows 5x; the span breakdown at 1.2 M."""
    import tempfile
    from repro_torch.traces import TraceStore
    pcfg = paper_config()
    peaks = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_bounded_") as tmp:
        for r in reqs:
            t0 = time.perf_counter()
            trace = (paper if r == pcfg.requests_per_vm
                     else trace_mix(pcfg.vms, r, 1.0))
            path = Path(tmp) / f"paper_{r}"
            TraceStore.from_trace(path, trace, shard_size=shard)
            n = len(trace)
            log(f"paper 12 x {r}: {n} requests generated and stored in "
                f"{time.perf_counter() - t0:.3f} s "
                f"({n * 9 / 1e6:.1f} MB of columns)")
            label = (f"paper-12vm-{n / 1e6:g}M-streamed" if n >= 10**6
                     else f"paper-12vm-streamed-shard{shard}")
            launches[label], cache, res, rate = drive_stream(
                etica(cfg, 12), TraceStore.open(path), n, label,
                ETICA_KERNELS, dev)
            if trace is paper:
                want, mem_rate = fused, None
            else:
                mem_label = label.replace("-streamed", "")
                launches[mem_label], *want, mem_rate = drive_stream(
                    etica(cfg, 12), trace, n, mem_label, ETICA_KERNELS, dev)
            same_run(label, want, (cache, res))
            peaks[n] = traced_peak(etica(cfg, 12), TraceStore.open(path),
                                   dev)
            if n >= 10**6:
                span_breakdown(etica(cfg, 12), TraceStore.open(path), label,
                               dev=dev)
            log(f"{label}: {rate:.0f} requests/s from the store"
                + (f" (in memory {mem_rate:.0f})" if mem_rate else "")
                + f"; equal to the in-memory card run; streamed "
                f"tracemalloc peak {peaks[n] / 2**20:.3f} MiB; launches "
                f"{launch_summary(launches[label])}")
    lo, hi = min(peaks.values()), max(peaks.values())
    if hi > PEAK_RATIO * lo:
        raise AssertionError(f"streamed host memory grows with the trace: "
                             f"tracemalloc peaks {peaks}")
    log(f"bounded host memory: streamed peaks {hi / lo:.3f}x apart while "
        f"the trace grows {max(peaks) / min(peaks):.0f}x "
        f"(limit {PEAK_RATIO}x)")
    return peaks


def check_streamed_external(launches, dev="cuda"):
    """Phase 13 (d): ``examples/torch_stream_external_trace.py``'s MSR
    import, streamed == in memory on the card."""
    out = example("torch_stream_external_trace").stream_external(
        dev, around=counted(launches, kernels_of=only(ETICA_KERNELS)))
    n = out["requests"]
    log(f"external-streamed: {n} MSR requests imported in "
        f"{out['import_s']:.3f} s into {out['shards']} shards "
        f"({out['num_vms']} VMs); {n / out['streamed_s']:.0f} requests/s "
        f"streamed, {n / out['in_memory_s']:.0f} in memory, equal; launches "
        f"{launch_summary(launches['external-streamed'])}")


def check_streamed_figures(launches, dev="cuda"):
    """Phase 13 (e): fig3, fig12/13 and fig17 in their ``--streamed``
    forms, held to the JAX package's CPU values (fig3's float32 latency
    sums and IOPS to its streamed form's, ``FIG3_STREAMED_JAX_CPU``),
    each path's launches counted."""
    from repro_torch.core import Stats
    figs = example("torch_paper_figures")
    around = counted(launches, suffix="-streamed")
    keys = Stats._fields
    f3 = figs.fig3(dev, streamed=True, around=around)
    for (w, p), run in f3["runs"].items():
        want = list(FIG3_JAX_CPU[f"{w}/{p}"])
        want[keys.index("latency_sum")], want[-1] = \
            FIG3_STREAMED_JAX_CPU[f"{w}/{p}"]
        expect_equal(f"fig3 streamed {w}/{p}",
                     tuple(run["stats"][k] for k in keys) + (run["iops"],),
                     tuple(want))
    speed = {"fig3": (f3["seconds"], f3["requests"])}
    f12 = figs.fig12(dev, streamed=True, around=around)
    speed.update(expect_fig12(f12, "fig12 streamed"))
    f17 = figs.fig17(dev, streamed=True, around=around)
    speed.update(expect_fig17(f17, "fig17 streamed"))
    expect_rows((("fig3", f3), ("fig12", f12), ("fig17", f17)),
                " streamed", show=False)
    log_speed(launches, speed, "-streamed")
    log("phase 13: fig3, fig12/13 and fig17 streamed from trace stores "
        "equal the JAX package's CPU values")


# ---------------------------------------------------------------------------
# phase 14: IO classification on the card
# ---------------------------------------------------------------------------

CLASS_CUTOFF = 48             # benchmarks/classification_bench.py CUTOFF
CLASS_BENCH_REQS = 8_000      # its REQS, a VM
# benchmarks/classification_bench.py's runs on the JAX package, CPU
# (Centaur capacity 800, sim_chunk 500; ETICA DRAM 400 / SSD 800, resize
# 2,000, promotion 500; 16 x 32; SCAN_HEAVY_MIX, 4 VMs x 8,000, scale
# 0.25): per-VM stats in CLASS_STATS_KEYS order and the seq-cutoff runs'
# per-class counts, printed by
#   PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_classified_controller.py
CLASS_STATS_KEYS = ("disk_writes", "evict_flushes", "reads", "writes",
                    "read_hits_l1", "read_hits_l2", "write_hits_l2",
                    "cache_writes_l2", "disk_reads", "latency_sum",
                    "bypassed", "pop_drops", "flushes", "dirty_resident")
CLASS_BENCH_JAX_CPU = {
    "chassis/none": {"stats": [
        (791.0, 54.0, 6764.0, 1236.0, 0.0, 2304.0, 395.0, 5696.0, 4460.0,
         22.33540273059043, 0.0, 0.0, 0.0, 0.0),
        (81.0, 21.0, 7587.0, 413.0, 0.0, 6608.0, 364.0, 1392.0, 979.0,
         4.965219077275833, 0.0, 0.0, 0.0, 0.0),
        (5199.0, 471.0, 889.0, 7111.0, 0.0, 294.0, 1616.0, 7706.0, 595.0,
         3.0490585152474523, 0.0, 0.0, 0.0, 0.0),
        (307.0, 121.0, 3224.0, 4776.0, 0.0, 3168.0, 4435.0, 4832.0, 56.0,
         0.3594400858382869, 0.0, 0.0, 0.0, 0.0)]},
    "chassis/seq_cutoff": {"stats": [
        (809.0, 13.0, 6764.0, 1236.0, 0.0, 2384.0, 412.0, 3166.0, 4380.0,
         22.128283932543127, 2450.0, 0.0, 0.0, 0.0),
        (34.0, 11.0, 7587.0, 413.0, 0.0, 6919.0, 385.0, 1081.0, 668.0,
         3.413314672972774, 0.0, 0.0, 0.0, 0.0),
        (5221.0, 177.0, 889.0, 7111.0, 0.0, 311.0, 1690.0, 4206.0, 578.0,
         4.512137866437115, 3483.0, 0.0, 0.0, 0.0),
        (28.0, 15.0, 3224.0, 4776.0, 0.0, 3200.0, 4622.0, 4800.0, 24.0,
         0.19975925505787018, 0.0, 0.0, 0.0, 0.0)],
        "cls_hits": [[2796, 0], [7304, 0], [2001, 0], [7822, 0]],
        "cls_miss": [[2754, 0], [696, 0], [2516, 0], [178, 0]]},
    "etica/none": {"stats": [
        (846.0, 0.0, 6764.0, 1236.0, 1933.0, 493.0, 390.0, 449.0, 4397.0,
         22.122772101094597, 0.0, 0.0, 0.0, 0.0),
        (71.0, 2.0, 7587.0, 413.0, 6275.0, 519.0, 344.0, 474.0, 923.0,
         4.01128523100715, 0.0, 0.0, 0.0, 0.0),
        (5434.0, 0.0, 889.0, 7111.0, 35.0, 262.0, 1677.0, 1740.0, 655.0,
         5.696409459967981, 0.0, 0.0, 0.0, 0.0),
        (523.0, 9.0, 3224.0, 4776.0, 1111.0, 1865.0, 4262.0, 4404.0, 390.0,
         1.5588243119855179, 0.0, 0.0, 0.0, 0.0)]},
    "etica/seq_cutoff": {"stats": [
        (846.0, 0.0, 6764.0, 1236.0, 1992.0, 443.0, 390.0, 449.0, 4388.0,
         22.077301274250203, 2450.0, 0.0, 0.0, 0.0),
        (67.0, 0.0, 7587.0, 413.0, 6418.0, 442.0, 346.0, 458.0, 839.0,
         3.67960400788661, 0.0, 0.0, 0.0, 0.0),
        (5434.0, 0.0, 889.0, 7111.0, 35.0, 264.0, 1677.0, 1740.0, 653.0,
         5.686429526467691, 3483.0, 0.0, 0.0, 0.0),
        (505.0, 0.0, 3224.0, 4776.0, 1132.0, 1854.0, 4271.0, 4388.0, 355.0,
         1.504315271085943, 0.0, 0.0, 0.0, 0.0)],
        "cls_hits": [[2825, 0], [7206, 0], [1976, 0], [7257, 0]],
        "cls_miss": [[2725, 0], [794, 0], [2541, 0], [743, 0]]},
}
# benchmarks/BENCH_classification.json: (read-hit unclassified,
# classified, SSD writes unclassified, classified, bypassed) and ETICA's
# pop_drops
BENCH_CLASSIFICATION = {"chassis": ("0.6702", "0.6940", 19626, 13253, 5933),
                        "etica": ("0.6766", "0.6813", 7067, 7035, 5933)}
BENCH_CLASSIFICATION_ETICA_POP_DROPS = 0


def four_class():
    """Phase 14 (b)'s four-class classifier: the default class; writes of
    under 2 blocks in an exclusive quarter of the ways, write-through;
    VM 0's address range at half weight; a sequential bypass from a run
    of 48 blocks."""
    from repro_torch.classify import ClassRule, Classifier, IOClass
    from repro_torch.core.policies import Policy
    return Classifier([
        IOClass("default"),
        IOClass("small_writes", rules=(ClassRule(size=(None, 2),
                                                 direction="write"),),
                ways_frac=0.25, policy=Policy.WT),
        IOClass("vm0_range", rules=(ClassRule(lba=(0, 10_000_000)),),
                weight=0.5),
        IOClass("seq_bypass", rules=(ClassRule(run_len=(CLASS_CUTOFF,
                                                        None)),),
                bypass=True)])


def expect_route(label, n, kernel, route) -> None:
    """Only ``route`` of ``kernel`` launched in the run counted in ``n``."""
    got = n["routes"].get(kernel, {})
    if set(got) != {route}:
        raise AssertionError(f"{label}: {kernel} routes {got}, expected "
                             f"only {route}")


def same_classes(label, want, got) -> None:
    """Two classified runs' per-class counts and the journal's per-class
    columns, exactly."""
    for k in ("cls_hits", "cls_miss"):
        if not np.array_equal(getattr(want, k), getattr(got, k)):
            raise AssertionError(f"{label}: {k} differ")
        if not np.array_equal(want.telemetry.journal.column(k),
                              got.telemetry.journal.column(k)):
            raise AssertionError(f"{label}: journal {k} differ")


def read_hit(res) -> float:
    agg = {k: sum(r.stats.get(k, 0.0) for r in res)
           for k in ("read_hits_l1", "read_hits_l2", "reads")}
    return (agg["read_hits_l1"] + agg["read_hits_l2"]) / max(agg["reads"], 1)


def check_class_bench(launches) -> None:
    """Phase 14 (a): ``benchmarks/classification_bench.py``'s protocol on
    the card. Centaur and ETICA unclassified, with ``match_all()`` and
    with ``seq_cutoff(48)`` (Centaur batched and sequential; ETICA
    fused, staged and sequential), each launching exactly its path's
    kernels on its own datapath route; match-all == unclassified; the
    modes equal each other (ETICA's but ``pop_drops``, which only the
    fused table counts); every per-VM stats dict and per-class count
    equal to the JAX package's CPU values; the six numbers of
    ``BENCH_classification.json``."""
    from repro_torch.classify import match_all, seq_cutoff
    from repro_torch.core.baselines import make_centaur
    from repro_torch.core.controller import EticaConfig, Geometry
    from repro_torch.traces.generators import SCAN_HEAVY_MIX
    trace = trace_mix(SCAN_HEAVY_MIX, CLASS_BENCH_REQS, 0.25)
    geo = Geometry(16, 32)
    ecfg = EticaConfig(dram_capacity=400, ssd_capacity=800,
                       geometry_dram=geo, geometry_ssd=geo,
                       resize_interval=2000, promo_interval=500)
    v = len(SCAN_HEAVY_MIX)

    def centaur(clf, batched=True):
        def build(device, telemetry=None):
            return make_centaur(800, v, geometry=geo, resize_interval=2000,
                                sim_chunk=500, batched=batched,
                                classifier=clf, device=device,
                                telemetry=telemetry)
        return build

    def eti(clf, **kw):
        return etica(dataclasses.replace(ecfg, classifier=clf, **kw), v)

    cut = lambda: seq_cutoff(CLASS_CUTOFF)
    runs, plan = {}, (
        ("chassis/none", centaur(None), ECI_KERNELS, "single_level"),
        ("chassis/match_all", centaur(match_all()), ECI_KERNELS, None),
        ("chassis/seq_cutoff", centaur(cut()), ECI_KERNELS, None),
        ("chassis/seq_cutoff-seq", centaur(cut(), False), ECI_KERNELS, None),
        ("etica/none", eti(None), ETICA_KERNELS, "two_level"),
        ("etica/match_all", eti(match_all()), ETICA_KERNELS, None),
        ("etica/seq_cutoff", eti(cut()), ETICA_KERNELS, None),
        ("etica/seq_cutoff-staged", eti(cut(), fused_maintenance=False),
         None, None),
        ("etica/seq_cutoff-seq", eti(cut(), batched=False), SEQ_KERNELS,
         None))
    for key, build, expect, _ in plan:
        kernel = "single_level" if key.startswith("chassis") else "two_level"
        if expect is None:             # staged: evict_scatter where a
            expect = STAGED_KERNELS + (   # queue formed in the fused run
                ("evict_scatter",) if np.sum(runs["etica/seq_cutoff"][
                    0].telemetry.journal.column("evict_queue")) else ())
        label = f"class-bench-{key.replace('/', '-')}"
        launches[label], cache, res, rate = drive_card(build, trace, label,
                                                       expect)
        expect_route(label, launches[label], kernel,
                     "unclassified" if key.endswith("/none")
                     else "classified")
        runs[key] = (cache, res)
    for name in ("chassis", "etica"):
        assert_same(runs[f"{name}/match_all"][1], runs[f"{name}/none"][1],
                    f"class-bench {name} match_all vs none")
    same_run("class-bench chassis seq_cutoff batched vs sequential",
             runs["chassis/seq_cutoff"], runs["chassis/seq_cutoff-seq"])
    same_classes("class-bench chassis", runs["chassis/seq_cutoff"][0],
                 runs["chassis/seq_cutoff-seq"][0])
    for mode in ("staged", "seq"):
        same_run(f"class-bench etica seq_cutoff fused vs {mode}",
                 runs["etica/seq_cutoff"], runs[f"etica/seq_cutoff-{mode}"],
                 ignore=("pop_drops",))
        same_classes(f"class-bench etica {mode}", runs["etica/seq_cutoff"][0],
                     runs[f"etica/seq_cutoff-{mode}"][0])
    for key, (cache, res) in runs.items():
        want = CLASS_BENCH_JAX_CPU[key.split("-")[0].replace(
            "match_all", "none")]
        got = [tuple(r.stats[k] for k in CLASS_STATS_KEYS) for r in res]
        expect_equal(f"class-bench {key}", got, want["stats"])
        if "cls_hits" in want:
            expect_equal(f"class-bench {key} per-class counts",
                         (cache.cls_hits.tolist(), cache.cls_miss.tolist()),
                         (want["cls_hits"], want["cls_miss"]))
    for name, (h0, h1, w0, w1, byp) in BENCH_CLASSIFICATION.items():
        base, cls = runs[f"{name}/none"][1], runs[f"{name}/seq_cutoff"][1]
        got = (f"{read_hit(base):.4f}", f"{read_hit(cls):.4f}",
               sum(r.ssd_writes for r in base), sum(r.ssd_writes
                                                     for r in cls),
               sum(r.stats["bypassed"] for r in cls))
        expect_equal(f"class-bench {name} BENCH_classification.json", got,
                     (h0, h1, w0, w1, byp))
        log(f"class-bench {name}: read-hit {got[0]} -> {got[1]}, SSD writes "
            f"{got[2]:.0f} -> {got[3]:.0f}, bypassed {got[4]:.0f}: "
            f"BENCH_classification.json's numbers")
    drops = sum(r.stats["pop_drops"] for r in runs["etica/seq_cutoff"][1])
    expect_equal("class-bench etica pop_drops", drops,
                 BENCH_CLASSIFICATION_ETICA_POP_DROPS)
    log("phase 14 (a): match_all == unclassified on both controllers; the "
        "classified chassis batched == sequential; ETICA fused == staged == "
        "sequential (but pop_drops); every stats dict and per-class count "
        "equal to the JAX package's CPU values")


def check_paper_classified(launches, paper, cfg, eci_for, rate_unclassified):
    """Phase 14 (b): the §5.1 deployment with ``seq_cutoff(48)`` and with
    :func:`four_class`, ETICA and ECI-Cache: each card run launches
    exactly its path's kernels, only on the ``classified`` datapath
    route, and equals the CPU plain path (stats, histories, logs, final
    states, per-class counts and journal columns). Then three more card
    runs of unclassified ETICA and of each classified one, interleaved,
    for requests/s on the same host clock, and the span breakdown of
    the seq-cutoff run. Returns the seq-cutoff card run ``(cache,
    results)``."""
    from repro_torch.classify import seq_cutoff
    clfs = {"seq_cutoff": seq_cutoff(CLASS_CUTOFF), "four_class": four_class()}
    builds = {}
    out = None
    for name, clf in clfs.items():
        for kind, build, expect, kernel in (
                ("", etica(dataclasses.replace(cfg, classifier=clf), 12),
                 ETICA_KERNELS, "two_level"),
                ("-eci", eci_for(clf), ECI_KERNELS, "single_level")):
            label = f"paper-12vm-{name}{kind}"
            builds[label] = build
            launches[label], cache, res, rate = drive_card(build, paper,
                                                           label, expect)
            expect_route(label, launches[label], kernel, "classified")
            cpu, cres, wall_cpu = run_controller(build, paper, "cpu")
            same_run(label, (cpu, cres), (cache, res))
            same_classes(label, cpu, cache)
            byp = sum(r.stats["bypassed"] for r in res)
            log(f"{label}: card == CPU (CPU plain path {wall_cpu:.1f} s): "
                f"stats, alloc_history, logs, final states, per-class "
                f"counts; bypassed {byp:.0f}, avg_hit "
                f"{np.mean([r.hit_ratio for r in res]):.4f}, ssd_writes "
                f"{sum(r.ssd_writes for r in res):.0f}; launches "
                f"{launch_summary(launches[label])}, routes "
                f"{launches[label]['routes']}")
            if label == "paper-12vm-seq_cutoff":
                out = (cache, res)
    rates = {"paper-12vm": [], "paper-12vm-seq_cutoff": [],
             "paper-12vm-four_class": []}
    for _ in range(3):
        for label in rates:
            build = builds.get(label) or etica(cfg, 12)
            _, _, wall = run_controller(build, paper, "cuda")
            rates[label].append(len(paper) / wall)
    log(f"paper-12vm requests/s, three runs each, interleaved (phase 3's "
        f"run: {rate_unclassified:.0f}): " + "; ".join(
            f"{k} " + ", ".join(f"{r:.0f}" for r in v)
            for k, v in rates.items()))
    span_breakdown(builds["paper-12vm-seq_cutoff"], paper,
                   "paper-12vm-seq_cutoff")
    span_breakdown(builds["paper-12vm-four_class"], paper,
                   "paper-12vm-four_class")
    return out


def check_streamed_classified(launches, paper, cfg, want) -> None:
    """Phase 14 (c): the seq-cutoff ETICA run from a store of shards of
    4,096 (the run carry crosses window and shard edges) == (b)'s
    in-memory card run."""
    import tempfile
    from repro_torch.classify import seq_cutoff
    from repro_torch.traces import TraceStore
    label = "paper-12vm-seq_cutoff-streamed"
    build = etica(dataclasses.replace(cfg, classifier=seq_cutoff(
        CLASS_CUTOFF)), 12)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_class_") as tmp:
        path = Path(tmp) / "paper"
        TraceStore.from_trace(path, paper, shard_size=STORE_SHARD)
        launches[label], cache, res, rate = drive_stream(
            build, TraceStore.open(path), len(paper), label, ETICA_KERNELS)
    expect_route(label, launches[label], "two_level", "classified")
    same_run(label, want, (cache, res))
    same_classes(label, want[0], cache)
    log(f"{label}: {rate:.0f} requests/s from the store; equal to the "
        f"in-memory card run (stats, logs, states, per-class counts); "
        f"launches {launch_summary(launches[label])}")


# ---------------------------------------------------------------------------
# phase 15: VM-axis sharding (a mesh that repeats cuda:0)
# ---------------------------------------------------------------------------

SHARD_COUNTS = (1, 2, 4, 8)
DEAD_ROWS = 4                  # 1,020 VMs in 8 shards of 128 rows


def card_mesh(d: int):
    import torch
    from repro_torch.launch.mesh import VMMesh
    return VMMesh((torch.device("cuda", 0),) * d)


def tree_leaves(x) -> list:
    """The tensors of an output tree (NamedTuples, tuples, sharded
    lists gathered to one whole tensor)."""
    from repro_torch.core.simulator import gather_rows
    if isinstance(x, list):
        x = gather_rows(x)
    if isinstance(x, tuple):
        return [leaf for f in x for leaf in tree_leaves(f)]
    return [x]


def counted_call(call):
    """``(output, launches)`` of one call, the counts set to 0 just
    before and read after a sync."""
    import torch
    from repro_torch import kernels
    kernels.reset_launch_counts()
    out = call()
    torch.cuda.synchronize()
    return out, {k: n for k, n in kernels.launch_counts().items() if n}


def times_launches(label, d, want, got) -> None:
    if got != {k: d * n for k, n in want.items()}:
        raise AssertionError(f"{label}: {d} shards launched {got}, not "
                             f"{d} x {want}")


def dead_row_state(rng, v, s, w, dead):
    """``random_state`` with the last ``dead`` rows as a controller's
    dead VMs hold them: empty, never touched."""
    tags, lru, dirty = random_state(rng, v, s, w, fill=0.9)
    tags[v - dead:], lru[v - dead:], dirty[v - dead:] = -1, -1, False
    return tags, lru, dirty


def check_dead_rows(dev, rng, v=128, s=16, w=32, dead=4):
    """Phase 15 (b), with phase 2's shapes: one shard of the 1024-VM run
    split 8 ways (``[128, 16, 32]``) whose last ``dead`` rows are dead
    VMs (zero ways, ``addr = -1`` blocks, zero-length windows, pure-pad
    POD rows), through every kernel of the sharded path against its
    plain version; the dead rows come out untouched and count nothing,
    at the plans the kernels take at ``V / d`` rows."""
    import torch
    from repro_torch.core import popularity as pop
    from repro_torch.core import reuse, simulator
    from repro_torch.core.policies import Policy
    from repro_torch.kernels.maintenance import ops
    from repro_torch.kernels.reuse_distance import ops as rops
    cpu = torch.device("cpu")
    live = v - dead
    tags, lru, dirty = dead_row_state(rng, v, s, w, dead)
    ways = rng.integers(1, w + 1, v).astype(np.int32)
    ways[live:] = 0
    ways[0] = 0                            # a live VM sized to nothing
    t = np.full(v, 30_000, np.int32)
    a = rng.integers(0, 4 * s * w, (v, 600)).astype(np.int32)
    a[rng.random(a.shape) < 0.1] = -1
    a[live:] = -1
    wr = rng.random(a.shape) < 0.4
    lens = rng.integers(20, 60, v).astype(np.int32)
    lens[live:] = 0
    addrs = [a[i][:lens[i]].clip(min=0) for i in range(v)]
    writes = [wr[i][:lens[i]] for i in range(v)]
    amat, wmat = reuse._pad_rows(addrs, writes, list(range(v)),
                                 [int(k) for k in lens])
    names = list(Policy.__members__)
    pols = [Policy[names[i % len(names)]] for i in range(v)]
    outs = []
    for d in (dev, cpu):
        st = simulator.CacheState(*[torch.from_numpy(x).to(d)
                                    for x in (tags, lru, dirty)])
        up = [torch.from_numpy(x).to(d) for x in (ways, t, lens)]
        two = simulator.simulate_two_level_batch(a, wr, st, st, up[0],
                                                 up[0], t0=up[1])
        one = simulator.simulate_single_level_batch(
            a, wr, st, up[0], simulator.policy_flags(pols, d), t0=up[1])
        am = torch.from_numpy(amat).to(d)
        dist, served, touch = reuse.decompose(
            am, torch.from_numpy(wmat).to(d), Policy.WBWO)
        tdist, tserved, _ = reuse.decompose(
            am, torch.from_numpy(wmat).to(d), Policy.WB,
            sizing_reads_only=False)
        maint = ops.maintenance_interval(
            st, pop.table_init(v, 8192, d), tdist, tserved, am, up[2],
            up[0], up[1], evict_frac=0.05, decay=0.5,
            clean_quota=CLEAN_QUOTA)
        outs.append([x.cpu() for x in tree_leaves(
            (two, one, dist, served, touch, maint))])
    max_abs_err(*outs)
    # the dead rows come out as they went in: empty, counting nothing
    (dram2, ssd2, st2, _), (one_st, st1, _) = two, one
    dead_rows = [x[live:] for x in (
        *ssd2, *dram2, *one_st, *st2, *st1, dist, *maint[0], maint[1].addr,
        *maint[2:])]
    if not all(bool((x == -1).all() or (x == 0).all()
                    or (x == pop.TABLE_EMPTY).all()) for x in dead_rows):
        raise AssertionError("a dead row was touched")
    sms = sm_count(dev)
    per = (v, s * w, sms)
    log(f"phase 15 (b) dead rows [{v},{s},{w}] ({dead} dead, ways 0 on "
        f"{dead + 1} rows): two_level, single_level, count_between "
        f"(pure-pad rows), the fused interval with the cleaner (run_sums, "
        f"evict_scatter, promote_scatter, clean_scatter) == plain; plans "
        f"at V/d: evict {ops.evict_plan(*per)}, promote "
        f"{ops.promote_plan(v, s, sms)}, clean {ops.clean_plan(*per)}, "
        f"count {rops.count_plan(v, amat.shape[1], sms)}")


def check_sharded_dispatches(dev, rng, subs, blocks, blocks_b):
    """Phase 15 (a): every sharded dispatch at the 1024-VM shapes over
    1, 2, 4 and 8 shards of ``cuda:0`` == the unsharded card dispatch
    bit for bit, each kernel launched exactly ``d`` times as often:
    both datapaths, both resizes, the stats aggregation (== its plain
    version on the CPU, ints == the unsharded sums), the fused interval
    with the cleaner, POD(RO / WBWO) and TRD distances and the URD
    sizing metric."""
    import torch
    from repro_torch.core import popularity as pop
    from repro_torch.core import reuse, simulator as sim
    from repro_torch.core.controller import Geometry, _mrc_grid
    from repro_torch.core.policies import Policy
    from repro_torch.kernels.maintenance import ops
    from repro_torch.launch.mesh import VMMesh
    v = 1024
    g = Geometry(num_sets=16, max_ways=32)
    empty = sim.make_cache_batch(v, g.num_sets, g.max_ways, dev)
    w0 = [torch.from_numpy(rng.integers(0, 33, v).astype(np.int32)).to(dev)
          for _ in range(4)]
    dram, ssd, _, t0 = sim.simulate_two_level_batch(
        *blocks[0], empty, empty, w0[0], w0[1], mode="npe")
    a, w = blocks_b[0]
    names = list(Policy.__members__)
    flags = sim.policy_flags([Policy[names[int(i)]] for i in
                              rng.integers(0, len(names), v)], dev)
    tags, lru, dirty = random_state(rng, v, g.num_sets, g.max_ways, 0.9)
    lens = rng.integers(20, 60, v).astype(np.int32)
    lens[5] = 0
    maddrs = [rng.choice(tags[i][tags[i] >= 0], lens[i]).astype(np.int32)
              for i in range(v)]
    mwrites = [rng.random(k) < 0.4 for k in lens]
    amat, wmat = reuse._pad_rows(maddrs, mwrites, list(range(v)),
                                 [int(k) for k in lens])
    am = torch.from_numpy(amat).to(dev)
    tdist, tserved, _ = reuse.decompose(am, torch.from_numpy(wmat).to(dev),
                                        Policy.WB, sizing_reads_only=False)
    mstate = sim.CacheState(*[torch.from_numpy(x).to(dev)
                              for x in (tags, lru, dirty)])
    mvec = [torch.from_numpy(x).to(dev) for x in (
        lens, np.full(v, g.max_ways, np.int32), np.full(v, 30_000, np.int32))]
    addrs = [np.asarray(s.addr) for s in subs]
    writes = [np.asarray(s.is_write) for s in subs]
    grid = _mrc_grid(g)

    def maint(mesh=None):
        return ops.maintenance_interval(
            mstate, pop.table_init(v, 8192, dev), tdist, tserved, am,
            *mvec, evict_frac=0.05, decay=0.5, clean_quota=CLEAN_QUOTA,
            mesh=mesh)

    def dists(mesh=None):
        kw = dict(mesh=mesh) if mesh else {}
        out = [reuse.pod_distances_batch(addrs, writes, p, dev, **kw)
               for p in (Policy.RO, Policy.WBWO)]
        out.append(reuse.trd_distances_batch(addrs, writes, dev, **kw))
        return tuple(torch.from_numpy(np.concatenate(
            [getattr(r, f) for r in rs if r is not None]))
            for rs in out for f in ("dist", "served", "touch"))

    cases = {
        "simulate_two_level_sharded": (
            lambda: sim.simulate_two_level_batch(a, w, dram, ssd, w0[2],
                                                 w0[3], t0=t0),
            lambda m: sim.simulate_two_level_sharded(a, w, dram, ssd, w0[2],
                                                     w0[3], m, t0=t0)),
        "simulate_single_level_sharded": (
            lambda: sim.simulate_single_level_batch(a, w, ssd, w0[3], flags,
                                                    t0=t0),
            lambda m: sim.simulate_single_level_sharded(a, w, ssd, w0[3],
                                                        flags, m, t0=t0)),
        "resize_levels_sharded": (
            lambda: sim.resize_levels(dram, ssd, w0[0], w0[2], w0[1], w0[3]),
            lambda m: sim.resize_levels_sharded(dram, ssd, w0[0], w0[2],
                                                w0[1], w0[3], m)),
        "resize_batch_sharded": (
            lambda: sim.resize_batch(ssd, w0[1], w0[3]),
            lambda m: sim.resize_batch_sharded(ssd, w0[1], w0[3], m)),
        "maintenance_interval(mesh=)": (maint, maint),
        "POD(RO), POD(WBWO), TRD distances": (dists, dists),
        "sizing_metrics_batch urd": (
            lambda: reuse.sizing_metrics_batch(addrs, writes, "urd", grid,
                                               dev),
            lambda m: reuse.sizing_metrics_batch(addrs, writes, "urd", grid,
                                                 mesh=m)),
    }
    per_d = {}
    for name, (whole, sharded) in cases.items():
        want, n0 = counted_call(whole)
        want = [torch.as_tensor(x).cpu() for x in tree_leaves(tuple(want))]
        for d in SHARD_COUNTS:
            got, nd = counted_call(lambda: sharded(card_mesh(d)))
            max_abs_err([torch.as_tensor(x).cpu()
                         for x in tree_leaves(tuple(got))], want)
            times_launches(name, d, n0, nd)
            per_d.setdefault(d, {}).update(nd)
        log(f"phase 15 (a) {name}: 1/2/4/8 shards == unsharded, launches "
            f"{n0} x d")
    st = sim.simulate_two_level_batch(a, w, dram, ssd, w0[2], w0[3],
                                      t0=t0)[2]
    for d in SHARD_COUNTS:
        got, nd = counted_call(lambda: sim.aggregate_stats_sharded(
            st, card_mesh(d)))
        plain = sim.aggregate_stats_sharded(
            sim.Stats(*(x.cpu() for x in st)),
            VMMesh((torch.device("cpu"),) * d))
        max_abs_err([x.cpu() for x in got], list(plain))
        ints = [int(x.sum()) for k, x in zip(st._fields, st)
                if k != "latency_sum"]
        if [int(x) for k, x in zip(st._fields, got)
                if k != "latency_sum"] != ints or nd:
            raise AssertionError("aggregate_stats_sharded differs")
    log(f"phase 15 (a) aggregate_stats_sharded: 1/2/4/8 shards == its "
        f"plain version on the CPU (latency_sum in XLA:CPU's order), "
        f"integer fields == the unsharded sums; no launch")


def sharded_state(cache, name):
    """A controller's whole ``[V, ...]`` state ``name`` (gathered over
    shards), real rows only; the dead rows checked empty."""
    import torch
    from repro_torch.core.simulator import gather_rows
    x = getattr(cache, name)
    if isinstance(x, list):
        x = gather_rows(x)
        if not (x.tags[cache.num_vms:] == -1).all():
            raise AssertionError(f"a dead row of {name} holds a block")
    return [torch.as_tensor(f)[:cache.num_vms].cpu() for f in x]


def same_sharded(label, want, got) -> None:
    """An unsharded and a sharded run's results, interval logs and
    final states (gathered), exactly; ``want``/``got`` are ``(cache,
    results)``."""
    (wc, wres), (gc, gres) = want, got
    assert_same(gres, wres, label)
    same_logs(label, wc, gc)
    names = ("caches",) if hasattr(wc, "caches") else ("dram", "ssd")
    for name in names:
        max_abs_err(sharded_state(gc, name), sharded_state(wc, name))


def check_sharded_fig15(launches, fig1024, fig_run, eci_run):
    """Phase 15 (c) to (e): fig15's consolidation configuration at 1024
    VMs split 8 ways on ``cuda:0`` — ETICA, ETICA with the cleaner
    (against an unsharded card run made here) and ECI-Cache — each ==
    its unsharded card run (ETICA phase 4's, ECI-Cache phase 7's):
    stats, allocation histories, interval logs, final states, and every
    kernel launched 8 times as often; ETICA's avg_hit ==
    ``FIG15_JAX_CPU_AVG_HIT_1024``. (d) 1,020 VMs over 8 shards (4 dead
    rows) == the unsharded 1,020-VM card run. (e) the 8-shard ETICA run
    fed from a trace store == (c)."""
    import tempfile
    from repro_torch.core.controller import Geometry
    from repro_torch.traces import TraceStore
    mesh, total, v = card_mesh(8), len(fig1024), fig_run[0].num_vms
    cfg = fig15_config(v, total)
    eci_kw = dict(geometry=Geometry(num_sets=16, max_ways=32),
                  resize_interval=total // 3, sim_chunk=total // 12)
    clean_build = etica(dataclasses.replace(cfg, clean_quota=CLEAN_QUOTA),
                        v)
    launches["fig15-1024vm-clean"], *clean_run, _ = drive_card(
        clean_build, fig1024, "fig15-1024vm-clean", CLEAN_KERNELS)
    cases = (
        ("fig15-1024vm", etica(dataclasses.replace(cfg, mesh=mesh), v),
         fig_run, ETICA_KERNELS),
        ("fig15-1024vm-clean", etica(dataclasses.replace(
            cfg, clean_quota=CLEAN_QUOTA, mesh=mesh), v), clean_run,
         CLEAN_KERNELS),
        ("fig15-1024vm-eci", eci(37 * v, v, mesh=mesh, **eci_kw),
         eci_run, ECI_KERNELS))
    runs = {}
    for base, build, want, expect in cases:
        label = base + "-8shards"
        n, *got, rate = drive_card(build, fig1024, label, expect)
        same_sharded(label, want, got)
        times_launches(label, 8, launch_summary(launches[base]),
                       launch_summary(n))
        launches[label] = n
        runs[label] = got
        log(f"{label}: == the unsharded card run (stats, histories, logs, "
            f"final states); launches 8 x {base}'s")
    hit = float(np.mean([r.hit_ratio for r in runs[
        "fig15-1024vm-8shards"][1]]))
    if f"{hit:.3f}" != f"{FIG15_JAX_CPU_AVG_HIT_1024:.3f}":
        raise AssertionError(f"fig15 1024 VMs, 8 shards: avg_hit {hit} vs "
                             f"{FIG15_JAX_CPU_AVG_HIT_1024}")
    log(f"phase 15 (c): avg_hit {hit:.4f} == {FIG15_JAX_CPU_AVG_HIT_1024} "
        f"(benchmarks/BENCH_sharding.json, the JAX package's 8 shards)")

    rv = v - DEAD_ROWS
    ragged = trace_mix((FIG15_WORKLOADS * 64)[:rv], 150, 0.25)
    rcfg = fig15_config(rv, len(ragged))
    label = f"fig15-{rv}vm"
    launches[label], *want, _ = drive_card(etica(rcfg, rv), ragged, label,
                                           ETICA_KERNELS)
    n, *got, _ = drive_card(etica(dataclasses.replace(rcfg, mesh=mesh), rv),
                            ragged, label + "-8shards", ETICA_KERNELS)
    if got[0]._rows != v:
        raise AssertionError(f"{label}: {got[0]._rows} rows, not {v}")
    same_sharded(label + "-8shards", want, got)
    times_launches(label, 8, launch_summary(launches[label]),
                   launch_summary(n))
    launches[label + "-8shards"] = n
    log(f"phase 15 (d) {rv} VMs over 8 shards ({v} rows, {DEAD_ROWS} "
        f"dead): == the unsharded card run")

    with tempfile.TemporaryDirectory(prefix="chip_smoke_shard_") as tmp:
        path = Path(tmp) / "fig1024"
        TraceStore.from_trace(path, fig1024, shard_size=STORE_SHARD)
        label = "fig15-1024vm-8shards-streamed"
        launches[label], *got, rate = drive_stream(
            etica(dataclasses.replace(cfg, mesh=mesh), v),
            TraceStore.open(path), total, label, ETICA_KERNELS)
    same_sharded(label, runs["fig15-1024vm-8shards"], got)
    log(f"phase 15 (e) {label}: {rate:.0f} requests/s from a store of "
        f"shards of {STORE_SHARD}; == (c)'s in-memory 8-shard run")


def check_sharding_speed(smi, dev="cuda", smoke=False) -> None:
    """Phase 15 (f): ``examples/torch_vm_sharding.py`` on the card, 1, 2,
    4 and 8 shards of 128 VMs beside the unsharded run at each scale,
    three interleaved rounds (a finding: nothing is asserted but the
    results' equality)."""
    out = example("torch_vm_sharding").sharded_consolidation(
        dev, smoke=smoke, repeats=3)
    for n, r in out.items():
        rate = lambda ts: ", ".join(f"{r['requests'] / t:.0f}" for t in ts)
        log(f"phase 15 (f) {n} shards, {r['vms']} VMs, {r['requests']} "
            f"requests: sharded {rate(r['sharded_s'])} requests/s, "
            f"unsharded {rate(r['unsharded_s'])} requests/s (three rounds "
            f"in turns; {smi})")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {Path(__file__).name}:"
              " run it from the repository's root", file=sys.stderr)
        return 1
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
    pcfg = paper_config()
    paper = trace_mix(pcfg.vms, pcfg.requests_per_vm, 1.0)
    fig128 = trace_mix((FIG15_WORKLOADS * 8)[:128], 150, 0.25)
    fig1024 = trace_mix((FIG15_WORKLOADS * 64)[:1024], 150, 0.25)
    win, chunk = len(fig1024) // 3, len(fig1024) // 12
    iv = (pcfg.resize_interval, pcfg.promo_interval)
    subs12, blocks12 = first_blocks(paper, 12, *iv, 1)
    _, blocks12b = first_blocks(paper[iv[0]:], 12, *iv, 1)
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
    check_dead_rows(dev, rng)
    rows["popularity"] = check_popularity(dev, rng, blocks12, "12-VM staged",
                                          fadd_ns)
    check_popularity(dev, rng, blocks1024, "1024-VM staged", fadd_ns)
    limit_err, limit_rows = check_row_limits(dev, rng)
    for k in ("run_sums", "popularity"):
        rows[k]["max_abs_err"] = max(rows[k]["max_abs_err"], limit_err)
        rows[k]["widths"] = limit_rows[k]
    rows["paged_decode_attention"] = check_decode(dev, rng)
    build_report(rows)
    rows["flash_attention"] = dict(max_abs_err=check_flash_shapes(dev, rng),
                                   **flash_build_report())
    check_serving_sync(dev, rng)
    rows.update(check_classified_routes(
        dev, np.random.default_rng(14), paper, blocks12 + blocks12b,
        blocks1024 + blocks1024b, ways12, step_ns))

    # phases 3 and 4: the paper's §5.1 deployment, then fig15
    # consolidation at 128 and 1024 VMs; card == CPU in each
    launches = {}
    dram, ssd = paper_caps()
    cfg = EticaConfig(dram_capacity=dram, ssd_capacity=ssd,
                      resize_interval=pcfg.resize_interval,
                      promo_interval=pcfg.promo_interval)
    launches["paper-12vm"], fused, paper_res, fused_rate = drive(
        etica(cfg, 12), paper, "paper 12-VM", ETICA_KERNELS)
    span_breakdown(etica(cfg, 12), paper, "paper 12-VM", repeats=3)
    launches["fig15-128vm"], *_ = drive(
        etica(fig15_config(128, len(fig128)), 128), fig128, "fig15 128-VM",
        ETICA_KERNELS)
    build1024 = etica(fig15_config(1024, len(fig1024)), 1024)
    launches["fig15-1024vm"], *fig_run, _ = drive(
        build1024, fig1024, "fig15 1024-VM", ETICA_KERNELS)
    span_breakdown(build1024, fig1024, "fig15 1024-VM")
    log(f"fig15 1024-VM avg_hit beside the JAX package's CPU value "
        f"{FIG15_JAX_CPU_AVG_HIT_1024} (benchmarks/BENCH_sharding.json)")

    # phase 5: the 12-VM deployment under the endurance comparison
    ccfg = dataclasses.replace(cfg, clean_quota=CLEAN_QUOTA)
    launches["paper-12vm-clean"], clean, clean_res, clean_rate = drive(
        etica(ccfg, 12), paper, "paper 12-VM ETICA clean_quota=4",
        CLEAN_KERNELS)
    span_breakdown(etica(ccfg, 12), paper, "paper 12-VM ETICA clean")
    geo64 = Geometry(num_sets=64, max_ways=64)
    build_eci = eci(dram + ssd, 12, geometry=geo64,
                    resize_interval=pcfg.resize_interval)
    launches["paper-12vm-eci"], eci_cache, eci_res, eci_rate = drive(
        build_eci, paper, "paper 12-VM ECI-Cache", ECI_KERNELS)
    span_breakdown(build_eci, paper, "paper 12-VM ECI-Cache")
    endurance("paper 12-VM", paper_res, eci_res, clean)

    # phase 6: fig14's own mix, held to the JAX package's CPU values
    check_fig14(launches)

    # phase 7: ECI-Cache at the fig15 1024-VM configuration
    total = len(fig1024)
    launches["fig15-1024vm-eci"], *eci1024_run, _ = drive(
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

    # phase 11: windows wider than ROW_MAX, through the tiled route
    check_wide_rows(launches)

    # phase 12: the paper's figures on the card, held to the JAX package's
    # CPU values; the per-state maintenance ops; fig12/13 at §5.1
    check_state_ops(dev, rng)
    check_paper_figures(launches)
    paper_fig12_rows(paper_res, eci_res)

    # phase 13: streamed ingestion from the on-disk trace store
    t13 = time.perf_counter()
    check_streamed_paper(launches, paper, cfg, ccfg, build_eci,
                         (fused, paper_res, fused_rate),
                         (clean, clean_res, clean_rate),
                         (eci_cache, eci_res, eci_rate))
    check_streamed_fig15(launches)
    check_bounded_memory(launches, cfg, paper, (fused, paper_res))
    check_streamed_external(launches)
    check_streamed_figures(launches)
    log(f"phase 13: {time.perf_counter() - t13:.1f} s")

    # phase 14: IO classification: the classification benchmark, the
    # §5.1 deployment with two classifiers (card == CPU), streamed
    t14 = time.perf_counter()
    check_class_bench(launches)
    seq_cut = check_paper_classified(
        launches, paper, cfg,
        lambda clf: eci(dram + ssd, 12, geometry=geo64,
                        resize_interval=pcfg.resize_interval,
                        classifier=clf), fused_rate)
    check_streamed_classified(launches, paper, cfg, seq_cut)
    log(f"phase 14: {time.perf_counter() - t14:.1f} s")

    # phase 15: VM-axis sharding over a mesh that repeats cuda:0: the
    # sharded dispatches, fig15's 1024-VM consolidation split 8 ways (and
    # 1,020 VMs, and from a store) == the unsharded card runs; speed
    t15 = time.perf_counter()
    check_sharded_dispatches(dev, rng, subs1024, blocks1024, blocks1024b)
    check_sharded_fig15(launches, fig1024, fig_run, eci1024_run)
    check_sharding_speed(smi)
    log(f"phase 15: {time.perf_counter() - t15:.1f} s")

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

    def routes(k):
        """Launches of ``k``'s routes on its own path and on each path."""
        if k not in kernels.ROUTES:
            return {}
        by_path = {p: n["routes"][k] for p, n in launches.items()
                   if k in n.get("routes", {})}
        return dict(routes=by_path.get(own_path[k], {}),
                    routes_by_path=by_path)
    line = [dict(name=k, route="cuda", source=sources[k],
                 replaces=replaces[k], launches=launches[own_path[k]][k],
                 path=own_path[k], **{**rows[k], **routes(k)},
                 launches_by_path={p: n[k] for p, n in launches.items()})
            for k in kernels.KERNELS]
    # the classified routes: their launches are their route's counts
    for k, kernel, src, ref, path in (
            ("two_level_classified", "two_level",
             "src/repro_torch/csrc/datapath.cu",
             "src/repro/core/simulator.py:514 (lax.scan step of "
             "_simulate_two_level_classified; no Pallas kernel)",
             "paper-12vm-seq_cutoff"),
            ("single_level_classified", "single_level",
             "src/repro_torch/csrc/single_level.cu",
             "src/repro/core/simulator.py:377 (lax.scan step of "
             "_simulate_single_level_classified; no Pallas kernel)",
             "paper-12vm-seq_cutoff-eci")):
        by_path = {p: n["routes"].get(kernel, {}).get("classified", 0)
                   for p, n in launches.items()}
        line.append(dict(name=k, route="cuda", source=src, replaces=ref,
                         launches=by_path[path], path=path, **rows[k],
                         launches_by_path={p: c for p, c in by_path.items()
                                           if c}))
    log(smi)
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
