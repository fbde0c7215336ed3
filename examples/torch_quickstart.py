#!/usr/bin/env python3
"""Quickstart on the PyTorch port: the paper's metric and system.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

1. Computes TRD / URD / POD on the paper's own worked example (Fig. 8).
2. Runs ETICA's two-level cache vs ECI-Cache on a 3-VM workload mix and
   prints the endurance/latency comparison.

The lines are those of ``examples/quickstart.py``; the port runs on the
card unless ``--device cpu``.
"""
import argparse
import sys
from pathlib import Path

_SRC = Path(__file__).resolve().parents[1] / "src"
if str(_SRC) not in sys.path:
    sys.path.insert(0, str(_SRC))

from repro_torch.core import (EticaCache, EticaConfig, Geometry,  # noqa: E402
                              Policy, Trace, interleave, make_eci_cache, pod,
                              trd, urd)
from repro_torch.traces import make  # noqa: E402


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    dev = ap.parse_args(argv).device

    # --- 1. the POD metric (paper Figs. 8 & 9) ---------------------------
    fig8 = Trace.from_ops([('R', 1), ('R', 2), ('R', 3), ('W', 4), ('W', 5),
                           ('R', 1), ('R', 4)])
    print("Fig. 8 workload:  TRD =", trd(fig8, dev), " URD =", urd(fig8, dev),
          " POD(WBWO) =", pod(fig8, Policy.WBWO, dev))
    print("  -> URD reserves", urd(fig8, dev) + 1, "blocks; POD reserves only",
          pod(fig8, Policy.WBWO, dev) + 1, "for the same hit ratio\n")

    # --- 2. the two-level cache vs ECI-Cache ------------------------------
    vms = ["hm_1", "usr_0", "web_3"]
    trace = interleave(
        [make(n, 6000, seed=i, addr_offset=i * 10_000_000, scale=0.25)
         for i, n in enumerate(vms)], seed=0)
    geo = Geometry(num_sets=16, max_ways=32)
    etica = EticaCache(
        EticaConfig(dram_capacity=400, ssd_capacity=800, geometry_dram=geo,
                    geometry_ssd=geo, resize_interval=3000,
                    promo_interval=500),
        num_vms=len(vms), device=dev).run(trace)
    eci = make_eci_cache(1200, len(vms), geometry=geo, resize_interval=3000,
                         device=dev).run(trace)

    print(f"{'VM':8s} {'ETICA lat':>10s} {'ECI lat':>10s} "
          f"{'ETICA ssd_w':>12s} {'ECI ssd_w':>10s}")
    for vm, a, b in zip(vms, etica, eci):
        print(f"{vm:8s} {a.mean_latency*1e3:9.3f}ms "
              f"{b.mean_latency*1e3:9.3f}ms"
              f" {a.ssd_writes:12.0f} {b.ssd_writes:10.0f}")
    tot_a = sum(r.ssd_writes for r in etica)
    tot_b = sum(r.ssd_writes for r in eci)
    print(f"\nSSD write reduction: {1 - tot_a/tot_b:.1%} (paper: 33.8%)")


if __name__ == "__main__":
    main()
