#!/usr/bin/env python3
"""fig15's VM-axis weak scaling on the PyTorch port.

The port's counterpart of ``benchmarks/fig15_vm_scaling.py``'s
``sharded_consolidation``: 128 VMs a shard (16 with ``--smoke``), 150
requests a VM (scale 0.25), over 1, 2, 4 and 8 shards of a mesh that
repeats one device (``VMMesh((device,) * d)``: the card, or the CPU with
``--device cpu``), so the 8-shard row is the 1024-VM consolidation run.
ETICA-Full with the benchmark's sizing (DRAM 12, SSD 25 blocks a VM,
16 x 32, resize a third and promotion a twelfth of the trace). Each
scale is also run unsharded on the same device, in turns with the
sharded run (``--repeats`` rounds), and its aggregate Stats must equal
the sharded run's, per-VM stats and allocation histories included,
before the rows are printed. Rows are ``name,us_per_req,derived`` like
the benchmark's; the wall clock of a run ends in
``torch.cuda.synchronize()`` on the card::

    PYTHONPATH=src python examples/torch_vm_sharding.py
    PYTHONPATH=src python examples/torch_vm_sharding.py --device cpu --smoke
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parents[1] / "src"
if str(_SRC) not in sys.path:
    sys.path.insert(0, str(_SRC))

from repro_torch.core import (EticaCache, EticaConfig, Geometry,  # noqa: E402
                              interleave)
from repro_torch.launch.mesh import VMMesh  # noqa: E402
from repro_torch.traces.generators import make  # noqa: E402

# benchmarks/fig15_vm_scaling.py and benchmarks/common.py
WORKLOADS = ["hm_1", "proj_0", "stg_1", "usr_0", "ts_0", "wdev_0", "web_3",
             "src2_0"] * 2
GEO = Geometry(num_sets=16, max_ways=32)
SCALE = 0.25
SHARDS = (1, 2, 4, 8)


def consolidation_trace(active: int, reqs: int):
    """``vm_mix`` of the first ``active`` VMs of the cycled workloads."""
    names = (WORKLOADS * -(-active // len(WORKLOADS)))[:active]
    return interleave([make(n, reqs, seed=i, addr_offset=i * 10_000_000,
                            scale=SCALE) for i, n in enumerate(names)],
                      seed=42)


def config(active: int, total: int, mesh=None, **kw) -> EticaConfig:
    """The benchmark's ``build`` configuration for ``active`` VMs and a
    trace of ``total`` requests."""
    return EticaConfig(dram_capacity=12 * active, ssd_capacity=25 * active,
                       geometry_dram=GEO, geometry_ssd=GEO,
                       resize_interval=max(500, total // 3),
                       promo_interval=max(125, total // 12), mesh=mesh,
                       **kw)


def aggregate(results) -> dict[str, float]:
    """``benchmarks/common.py``'s ``aggregate_stats``."""
    agg: dict[str, float] = {}
    for r in results:
        for k, v in r.stats.items():
            agg[k] = agg.get(k, 0.0) + v
    return agg


def timed(cfg, active, trace, device):
    """``(results, seconds)`` of one run, the clock ending in a device
    sync."""
    import torch
    cache = EticaCache(cfg, active, device=device)
    if device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = cache.run(trace)
    if device.type == "cuda":
        torch.cuda.synchronize()
    return res, time.perf_counter() - t0


def same(label, got, want) -> None:
    for v, (a, b) in enumerate(zip(got, want)):
        if a.stats != b.stats or not np.array_equal(a.alloc_history,
                                                    b.alloc_history):
            raise AssertionError(f"{label}: VM {v} differs\n"
                                 f"  sharded   {a.stats}\n"
                                 f"  unsharded {b.stats}")


def sharded_consolidation(device="cuda", smoke=False, shards=SHARDS,
                          repeats=1, reqs=150) -> dict:
    """Weak scaling over ``shards``: at each scale one warm-up run of
    each, then ``repeats`` rounds of (sharded, unsharded). Returns
    ``{shards: dict(vms, requests, sharded_s, unsharded_s, avg_hit,
    agg)}`` with the seconds of every round."""
    import torch
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    per_shard = 16 if smoke else 128
    out = {}
    for n in shards:
        active = per_shard * n
        trace = consolidation_trace(active, reqs)
        cfgs = (config(active, len(trace), VMMesh((dev,) * n)),
                config(active, len(trace)))
        for cfg in cfgs:                  # warm-up: builds, allocator
            timed(cfg, active, trace, dev)
        times = ([], [])
        for _ in range(repeats):
            runs = [timed(cfg, active, trace, dev) for cfg in cfgs]
            for t, (_, s) in zip(times, runs):
                t.append(s)
        (res, _), (ref, _) = runs
        same(f"{n} shards, {active} VMs", res, ref)
        agg = aggregate(res)
        if agg != aggregate(ref):
            raise AssertionError(f"{n} shards: aggregate Stats differ")
        out[n] = dict(vms=active, requests=len(trace), sharded_s=times[0],
                      unsharded_s=times[1],
                      avg_hit=float(np.mean([r.hit_ratio for r in res])),
                      agg=agg)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true",
                    help="16 VMs a shard instead of 128")
    ap.add_argument("--repeats", type=int, default=1)
    ap.add_argument("--shards", type=int, nargs="+", default=list(SHARDS))
    args = ap.parse_args(argv)
    out = sharded_consolidation(args.device, args.smoke, args.shards,
                                args.repeats)
    for n, r in out.items():
        best, base = min(r["sharded_s"]), min(r["unsharded_s"])
        print(f"fig15/sharded_{n}shards_{r['vms']}vms,"
              f"{best * 1e6 / r['requests']:.1f},"
              f"avg_hit={r['avg_hit']:.3f} reqs={r['requests']} "
              f"wall_s={best:.3f} unsharded_wall_s={base:.3f} "
              f"stats_equal=True device={args.device}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
