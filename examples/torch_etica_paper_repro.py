#!/usr/bin/env python3
"""Paper reproduction on the PyTorch port at the configured scale: the
§5.1 VM mix through ETICA-Full and ECI-Cache, the three headline claims
next to the paper's numbers.

    PYTHONPATH=src python examples/torch_etica_paper_repro.py \
        [--reqs 6000] [--vms 8] [--device cpu]

The lines are those of ``examples/etica_paper_repro.py``; the port runs
on the card unless ``--device cpu``.
"""
import argparse
import sys
from pathlib import Path

_SRC = Path(__file__).resolve().parents[1] / "src"
if str(_SRC) not in sys.path:
    sys.path.insert(0, str(_SRC))

import numpy as np  # noqa: E402

from repro_torch.configs.etica_paper import CONFIG as PAPER  # noqa: E402
from repro_torch.core import (EticaCache, EticaConfig, Geometry,  # noqa: E402
                              Policy, demand_blocks, interleave,
                              make_eci_cache, pod, urd)
from repro_torch.traces import make  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--reqs", type=int, default=6000)
    ap.add_argument("--vms", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = args.device

    names = list(PAPER.vms)[: args.vms]
    traces = [make(n, args.reqs, seed=i, addr_offset=i * 10_000_000,
                   scale=0.25) for i, n in enumerate(names)]
    trace = interleave(traces, seed=7)
    geo = Geometry(num_sets=16, max_ways=32)

    # claim 3: POD sizes below URD
    urd_t = ro_t = wbwo_t = 0
    for tr in traces:
        head = tr[:2000]
        urd_t += demand_blocks(urd(head, dev))
        ro_t += demand_blocks(pod(head, Policy.RO, dev))
        wbwo_t += demand_blocks(pod(head, Policy.WBWO, dev))
    size_red = 1 - (ro_t + wbwo_t) / (2 * urd_t)

    cfg = EticaConfig(dram_capacity=400, ssd_capacity=800,
                      geometry_dram=geo, geometry_ssd=geo,
                      resize_interval=2000, promo_interval=500)
    etica = EticaCache(cfg, len(names), device=dev).run(trace)
    eci = make_eci_cache(1200, len(names), geometry=geo,
                         resize_interval=2000, device=dev).run(trace)

    lat_e = np.mean([r.mean_latency for r in etica])
    lat_c = np.mean([r.mean_latency for r in eci])
    w_e = sum(r.ssd_writes for r in etica)
    w_c = sum(r.ssd_writes for r in eci)

    print(f"{'claim':34s} {'paper':>8s} {'this repro':>11s}")
    print(f"{'cache size reduction (POD vs URD)':34s} {'51.7%':>8s} "
          f"{size_red:>10.1%}")
    print(f"{'SSD write reduction (endurance)':34s} {'33.8%':>8s} "
          f"{1 - w_e/max(w_c,1):>10.1%}")
    print(f"{'I/O latency improvement':34s} {'45%':>8s} "
          f"{1 - lat_e/lat_c:>10.1%}")
    print("\n(latency: see EXPERIMENTS.md — the paper's testbed couples "
          "write load to SSD latency; our clean device model does not)")


if __name__ == "__main__":
    main()
