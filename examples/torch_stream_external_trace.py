#!/usr/bin/env python3
"""Import an external trace into a TraceStore and stream it through
ETICA on the PyTorch port.

The port's counterpart of ``examples/stream_external_trace.py``:

  1. synthesize an MSR-Cambridge-style CSV (stand-in for a real download
     from SNIA IOTTA — the format is identical);
  2. import it into a chunked on-disk :class:`TraceStore` with the same
     parser the CLI uses (``python -m repro_torch.traces.store import``);
  3. run :class:`EticaCache` straight off the store — per-VM demux done
     with one stable sort per shard, ``[V, chunk]`` blocks copied to the
     device ahead of use — and check that the per-VM stats and
     allocation histories are identical to running the materialised
     in-memory trace.

Exits non-zero on any mismatch. Runs on the card unless ``--device
cpu``::

    PYTHONPATH=src python examples/torch_stream_external_trace.py --device cpu
"""
from __future__ import annotations

import argparse
import contextlib
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parents[1] / "src"
if str(_SRC) not in sys.path:
    sys.path.insert(0, str(_SRC))

from repro_torch.core import (EticaCache, EticaConfig, Geometry,  # noqa: E402
                              interleave)
from repro_torch.traces import TraceStore, make  # noqa: E402

BLOCK = 4096
WORKLOADS = ("hm_1", "usr_0", "web_3", "src2_0")


def synthesize_msr_csv(path: Path, num_vms: int = 4,
                       reqs_per_vm: int = 2000) -> None:
    """Write a consolidated multi-VM mix in the MSR CSV format."""
    traces = [make(w, reqs_per_vm, seed=i, addr_offset=i * 1_000_000,
                   scale=0.25)
              for i, w in enumerate(WORKLOADS[:num_vms])]
    mixed = interleave(traces, seed=7)
    with path.open("w") as f:
        f.write("Timestamp,Hostname,DiskNumber,Type,Offset,Size,"
                "ResponseTime\n")
        for i in range(len(mixed)):
            vm = int(mixed.vm[i])
            typ = "Write" if bool(mixed.is_write[i]) else "Read"
            off = int(mixed.addr[i]) * BLOCK
            f.write(f"{128166372003061629 + i},vm{vm},0,{typ},{off},"
                    f"{BLOCK},100\n")


def build_cache(num_vms: int, device) -> EticaCache:
    geo = Geometry(num_sets=16, max_ways=32)
    cfg = EticaConfig(dram_capacity=300, ssd_capacity=600, geometry_dram=geo,
                      geometry_ssd=geo, resize_interval=2000,
                      promo_interval=500)
    return EticaCache(cfg, num_vms, device=device)


def _timed_run(num_vms, device, trace):
    import torch
    cache = build_cache(num_vms, device)
    t0 = time.perf_counter()
    res = cache.run(trace)
    if str(device) != "cpu":
        torch.cuda.synchronize()
    return res, time.perf_counter() - t0


def stream_external(device="cuda", num_vms: int = 4, reqs_per_vm: int = 2000,
                    around=lambda name: contextlib.nullcontext()) -> dict:
    """Synthesize, import and run streamed and in memory; raises unless
    the two runs are identical. ``around(name)`` wraps the streamed run
    (``"external-streamed"``). Returns both runs' results and times."""
    with tempfile.TemporaryDirectory(prefix="torch_external_") as tmp:
        csv = Path(tmp) / "trace.csv"
        synthesize_msr_csv(csv, num_vms, reqs_per_vm)
        store_dir = Path(tmp) / "store"
        t0 = time.perf_counter()
        # the same code path as: python -m repro_torch.traces.store import
        store = TraceStore.from_msr_csv(store_dir, csv, shard_size=3000)
        import_s = time.perf_counter() - t0
        vms = store.num_vms
        with around("external-streamed"):
            streamed, s_str = _timed_run(vms, device,
                                         TraceStore.open(store_dir))
        in_memory, s_mem = _timed_run(vms, device, store.to_trace())
        out = dict(requests=len(store), shards=store.num_shards, num_vms=vms,
                   import_s=import_s, streamed=streamed, in_memory=in_memory,
                   streamed_s=s_str, in_memory_s=s_mem)
    for v in range(vms):
        if streamed[v].stats != in_memory[v].stats or not np.array_equal(
                streamed[v].alloc_history, in_memory[v].alloc_history):
            raise AssertionError(
                f"VM {v}: streamed != in-memory\n"
                f"  streamed:  {streamed[v].stats}\n"
                f"  in-memory: {in_memory[v].stats}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    out = stream_external(args.device)
    print(f"imported {out['requests']} requests, {out['shards']} shards, "
          f"{out['num_vms']} VMs")
    hit = np.mean([r.hit_ratio for r in out["streamed"]])
    lat = np.mean([r.mean_latency for r in out["streamed"]])
    print(f"streamed == in-memory (identical stats and allocation "
          f"histories) for {out['num_vms']} VMs")
    print(f"avg hit ratio {hit:.3f}, avg latency {lat:.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
