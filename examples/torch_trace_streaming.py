#!/usr/bin/env python3
"""The streaming trace-store ingestion layer on the PyTorch port.

The port's counterpart of ``benchmarks/trace_streaming.py`` and of
``benchmarks/fig15_vm_scaling.py``'s ``streaming_scaling``. Rows are
printed as ``name,us_per_call,derived`` like the benchmarks:

  * ``stream/import_msr``   — MSR-CSV parse -> chunked store (us/req);
  * ``stream/store_scan``   — memory-mapped shard iteration (us/req);
  * ``stream/etica_*``      — ``EticaCache`` off a ``TraceStore`` and off
    the materialised in-memory trace, per-VM stats and allocation
    histories asserted equal; wall clock (ending in
    ``torch.cuda.synchronize()`` on the card) for streamed (prefetch
    depth 2), streamed with ``prefetch=False`` and in memory, then the
    ``tracemalloc`` peak (the Python heap, numpy arrays included) of a
    second streamed and in-memory run (tracing slows the host, so the
    timed runs are untraced);
  * ``stream/eci_*``        — the same protocol for ECI-Cache;
  * ``fig15/streaming_{32,64,128}vms`` — 32, 64 and 128 consolidated VMs
    (750 requests a VM, scale 0.25) generated into stores of shards of
    16,000 and run by ETICA-Full (DRAM 200 / SSD 400, 16 x 32) from the
    store, once to warm up, once timed, then once under ``tracemalloc``
    (every section warms up first, as the benchmarks do); the smallest
    scale is checked against the in-memory run on ``--check-device``
    (the CPU by default).

Runs on the card unless ``--device cpu``; ``--smoke`` shrinks every
size for a quick CPU run::

    PYTHONPATH=src python examples/torch_trace_streaming.py
    PYTHONPATH=src python examples/torch_trace_streaming.py --device cpu --smoke
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import sys
import tempfile
import time
import tracemalloc
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parents[1] / "src"
if str(_SRC) not in sys.path:
    sys.path.insert(0, str(_SRC))

from repro_torch.core import (EticaCache, EticaConfig, Geometry,  # noqa: E402
                              make_eci_cache)
from repro_torch.traces import TraceStore, make_store, parse_msr_csv  # noqa

# benchmarks/common.py
GEO = Geometry(num_sets=16, max_ways=32)
RESIZE = 2_000
PROMO = 500
# benchmarks/trace_streaming.py
NUM_VMS = 8
REQS_PER_VM = 4_000
WORKLOADS = ["hm_1", "proj_0", "stg_1", "usr_0", "ts_0", "wdev_0",
             "web_3", "src2_0"]
SHARD = 6_000
BLOCK = 4096
# benchmarks/fig15_vm_scaling.py
STREAM_PHASES = (32, 64, 128)
STREAM_REQS_PER_VM = 750
STREAM_SHARD = 4 * 4_000      # 4 x REQS_PER_PHASE
SMOKE = dict(reqs_per_vm=600, phases=(8, 16), phase_reqs=150)


def row(name: str, us: float, derived: str) -> None:
    print(f"{name},{us:.1f},{derived}", flush=True)


def etica_config(mode="full", dram=400, ssd=800, **kw) -> EticaConfig:
    """``benchmarks/common.py``'s ``etica_config``."""
    return EticaConfig(dram_capacity=dram, ssd_capacity=ssd,
                       geometry_dram=GEO, geometry_ssd=GEO,
                       resize_interval=RESIZE, promo_interval=PROMO,
                       mode=mode, **kw)


def _sync(device) -> None:
    if str(device) != "cpu":
        import torch
        torch.cuda.synchronize()


def timed_run(build, trace, device, traced: bool = False):
    """``(results, seconds, tracemalloc peak bytes or None)`` of one
    ``build().run(trace)``; the host clock ends in a device sync, and
    with ``traced`` the run (not the build) is under ``tracemalloc``."""
    cache = build()
    _sync(device)
    if traced:
        tracemalloc.start()
    t0 = time.perf_counter()
    try:
        res = cache.run(trace)
        _sync(device)
        seconds = time.perf_counter() - t0
        peak = tracemalloc.get_traced_memory()[1] if traced else None
    finally:
        if traced:
            tracemalloc.stop()
    return res, seconds, peak


def assert_same(label, got, want) -> None:
    for v, (a, b) in enumerate(zip(got, want)):
        if a.stats != b.stats or not np.array_equal(a.alloc_history,
                                                    b.alloc_history):
            raise AssertionError(f"{label}: VM {v} differs\n"
                                 f"  got  {a.stats}\n  want {b.stats}")


def _msr_csv_of(trace) -> str:
    buf = io.StringIO()
    buf.write("Timestamp,Hostname,DiskNumber,Type,Offset,Size,ResponseTime\n")
    for i in range(len(trace)):
        typ = "Write" if bool(trace.is_write[i]) else "Read"
        buf.write(f"{i},vm{int(trace.vm[i])},0,{typ},"
                  f"{int(trace.addr[i]) * BLOCK},{BLOCK},100\n")
    return buf.getvalue()


def ingestion(tmp: Path, trace) -> dict:
    """MSR CSV import and a scan of the imported store, us per request."""
    csv_text = _msr_csv_of(trace)
    t0 = time.perf_counter()
    TraceStore.from_chunks(tmp / "imported",
                           parse_msr_csv(io.StringIO(csv_text)),
                           shard_size=SHARD)
    import_us = (time.perf_counter() - t0) * 1e6 / len(trace)
    row("stream/import_msr", import_us,
        f"reqs={len(trace)} shards={-(-len(trace) // SHARD)}")
    store = TraceStore.open(tmp / "imported")
    t0 = time.perf_counter()
    total = sum(len(s) for s in store.iter_shards())
    scan_us = (time.perf_counter() - t0) * 1e6 / total
    if total != len(trace):
        raise AssertionError(f"store scan read {total} of {len(trace)}")
    row("stream/store_scan", scan_us, f"mmap_shards={store.num_shards}")
    return dict(import_us=import_us, scan_us=scan_us)


def head_to_head(label: str, build, store_path: Path, trace,
                 device) -> dict:
    """A warm-up run, then streamed (default prefetch), streamed with
    ``prefetch=False`` and in memory: results asserted equal, then each
    rate and the streamed and in-memory ``tracemalloc`` peaks."""
    n = len(trace)
    build().run(TraceStore.open(store_path))   # first launches, allocator
    res_str, s_str, _ = timed_run(build, TraceStore.open(store_path), device)
    res_nopf, s_nopf, _ = timed_run(lambda: build(prefetch=False),
                                    TraceStore.open(store_path), device)
    res_mem, s_mem, _ = timed_run(build, trace, device)
    peak_str = timed_run(build, TraceStore.open(store_path), device,
                         traced=True)[2]
    peak_mem = timed_run(build, trace, device, traced=True)[2]
    assert_same(f"{label} streamed", res_str, res_mem)
    assert_same(f"{label} no prefetch", res_nopf, res_mem)
    row(f"stream/{label}_streamed", s_str * 1e6 / n,
        f"stats_equal=True peak_py_mb={peak_str / 2**20:.2f} "
        f"window_resident={RESIZE}")
    row(f"stream/{label}_no_prefetch", s_nopf * 1e6 / n,
        f"prefetch_gain={s_nopf / s_str:.2f}x")
    row(f"stream/{label}_in_memory", s_mem * 1e6 / n,
        f"peak_py_mb={peak_mem / 2**20:.2f} trace_resident={n}")
    return dict(requests=n, streamed_s=s_str, no_prefetch_s=s_nopf,
                in_memory_s=s_mem, streamed_peak=peak_str,
                in_memory_peak=peak_mem)


def streaming_scaling(tmp: Path, device, phases=STREAM_PHASES,
                      reqs_per_vm=STREAM_REQS_PER_VM, check_device="cpu",
                      around=None) -> dict:
    """fig15's streaming section: each scale's mix generated straight
    into a store and run from it by ETICA-Full: a warm-up run, a timed
    run, then one under ``tracemalloc``; the first scale's streamed run
    must equal its in-memory run on ``check_device``. ``around(name)`` wraps each timed streamed run
    (``fig15-streaming-<V>vm``)."""
    fig15 = WORKLOADS * 2
    cfg = etica_config("full", dram=200, ssd=400)
    out = {}
    for active in phases:
        workloads = (fig15 * (-(-active // len(fig15))))[:active]
        path = tmp / f"mix_{active}"
        store = make_store(path, workloads, reqs_per_vm, scale=0.25,
                           shard_size=STREAM_SHARD)
        n = len(store)
        ctx = (around(f"fig15-streaming-{active}vm") if around
               else contextlib.nullcontext())
        def build():
            return EticaCache(cfg, active, device=device)
        build().run(TraceStore.open(path))      # warm-up, as fig15's
        with ctx:
            res, seconds, _ = timed_run(build, TraceStore.open(path), device)
        peak = timed_run(build, TraceStore.open(path), device,
                         traced=True)[2]
        checked = active == phases[0]
        if checked:
            ref, _, _ = timed_run(
                lambda: EticaCache(cfg, active, device=check_device),
                store.to_trace(), check_device)
            assert_same(f"fig15 streaming {active} VMs", res, ref)
        store_mb = sum(f.stat().st_size for f in path.iterdir()) / 2**20
        hit = float(np.mean([r.hit_ratio for r in res]))
        row(f"fig15/streaming_{active}vms", seconds * 1e6 / n,
            f"avg_hit={hit:.3f} peak_py_mb={peak / 2**20:.2f} "
            f"store_mb={store_mb:.2f} "
            f"stats_equal={'True' if checked else 'n/a'}")
        out[active] = dict(requests=n, seconds=seconds, peak=peak,
                           avg_hit=hit, checked=checked)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--check-device", default="cpu",
                    help="device of fig15's in-memory check run")
    ap.add_argument("--smoke", action="store_true",
                    help="small sizes for a quick CPU run")
    args = ap.parse_args(argv)
    reqs = SMOKE["reqs_per_vm"] if args.smoke else REQS_PER_VM
    with tempfile.TemporaryDirectory(prefix="torch_streaming_") as tmp:
        tmp = Path(tmp)
        store = make_store(tmp / "mix", WORKLOADS, reqs, scale=0.25,
                           shard_size=SHARD)
        trace = store.to_trace()
        ingestion(tmp, trace)

        def etica(prefetch=True):
            cfg = dataclasses.replace(etica_config("full", dram=200,
                                                   ssd=400),
                                      prefetch=prefetch)
            return EticaCache(cfg, NUM_VMS, device=args.device)
        head_to_head("etica", etica, tmp / "mix", trace, args.device)

        def eci(prefetch=True):
            return make_eci_cache(600, NUM_VMS, geometry=GEO,
                                  resize_interval=2_000, sim_chunk=500,
                                  prefetch=prefetch, device=args.device)
        head_to_head("eci", eci, tmp / "mix", trace, args.device)
        del store, trace
        if args.smoke:
            streaming_scaling(tmp, args.device, SMOKE["phases"],
                              SMOKE["phase_reqs"], args.check_device)
        else:
            streaming_scaling(tmp, args.device,
                              check_device=args.check_device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
