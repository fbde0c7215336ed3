#!/usr/bin/env python3
"""The paper's figures through the PyTorch port: Fig. 3 (write policy),
Figs. 10/11 (URD vs POD cache sizes), Figs. 12/13 (latency and hit
ratio of ETICA-Full, ETICA-NPE and ECI-Cache) and Fig. 17 (the
promotion-interval sweep, read from the telemetry journal).

    PYTHONPATH=src python examples/torch_paper_figures.py --device cpu --smoke
    PYTHONPATH=src python examples/torch_paper_figures.py --fig 12
    PYTHONPATH=src python examples/torch_paper_figures.py --fig 12 --streamed

Each ``figN`` function runs the experiment of ``benchmarks/fig*.py`` at
that script's sizes by default (``--smoke`` shrinks them) and returns
``rows``, the ``(name, derived)`` pairs the JAX script prints (without
its timing column), beside the raw values they come from: per-run
``Stats`` and per-VM ``VMResult`` stats and allocation histories,
sizing series, journal summaries and report lines. Entry points run on
the card unless ``device="cpu"``. The CLI prints the rows as
``name,us_per_call,derived``, like the benchmarks.

``fig17`` keeps the JAX script's two checks: the journal's JSONL spill
reloads to the ring's retained series, and the journal's interval
deltas sum to the controller's own Stats.

``--streamed`` (``streamed=True``) is the JAX scripts' streamed form of
fig3, fig12/13 and fig17: the requests go through an on-disk
:class:`~repro_torch.traces.store.TraceStore` in a temporary directory.
fig3 makes a one-VM store of shards of 1,024 per workload and feeds
``iter_shards()`` to the simulator chunk by chunk (the counts equal the
in-memory form's; ``latency_sum`` is summed in float32 a chunk at a
time, as the JAX script sums it); fig12 and fig17 run the controllers on
``make_store``'s store of shards of 4,096, which gives results
identical to the in-memory mix. fig10/11 has no streamed form.
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
                              Policy, Stats, demand_blocks, interleave,
                              make_cache, make_eci_cache, pod,
                              simulate_single_level, urd)
from repro_torch.runtime.telemetry import (TelemetryRecorder,  # noqa: E402
                                           format_report, load_journal,
                                           summarize_journal)
from repro_torch.traces import make, make_store  # noqa: E402

# benchmarks/common.py
GEO = Geometry(num_sets=16, max_ways=32)
RESIZE = 2_000
PROMO = 500
DRAM_CAP = 400
SSD_CAP = 800
REQS = 8_000
SCALE = 0.25
# benchmarks/fig3_write_policy.py
FIG3_WORKLOADS = ("fio_randrw", "web_server", "video_server", "varmail")
FIG3_POLICIES = (Policy.WB, Policy.RO, Policy.WBWO)
FIG3_N = 6_000
FIG3_SHARD = 1_024          # the streamed form's store shards
# benchmarks/fig10_cache_size.py
FIG10_WORKLOADS = ("hm_1", "proj_0", "rsrch_0", "web_3", "ts_0", "wdev_0",
                   "usr_0", "src2_0")
FIG10_INTERVAL = 1_000
FIG10_N_INTERVALS = 10
# benchmarks/fig12_latency.py
FIG12_VMS = ("hm_1", "ts_0", "usr_0", "web_3", "wdev_0", "src2_0")
FIG12_CONTROLLERS = ("etica_full", "etica_npe", "eci_cache")
# benchmarks/fig17_intervals.py (--smoke: 1,500 requests, 100 and 500)
FIG17_VMS = ("hm_1", "usr_0", "ts_0")
FIG17_INTERVALS = (100, 250, 500, 1000, 2000)
FIG17_REQS = 6_000
# benchmarks/common.py vm_mix_source(streamed=True)
MIX_SHARD = 4_096

# the reduced sizes of --smoke (and of the CPU parity tests)
SMOKE = {
    "fig3": dict(n=1_500),
    "fig10": dict(workloads=FIG10_WORKLOADS[:3], interval=500,
                  n_intervals=3),
    "fig12": dict(vms=FIG12_VMS[:3], reqs=1_500, resize=500, promo=250),
    "fig17": dict(reqs=1_500, intervals=(100, 500)),
}


def _null(_name):
    return contextlib.nullcontext()


def _sync(device) -> None:
    import torch
    if str(device) != "cpu":
        torch.cuda.synchronize()


def vm_mix(names, reqs=REQS, scale=SCALE):
    """``benchmarks/common.py``'s mix: VM i's workload from seed i at
    address offset i x 10,000,000, interleaved with seed 42."""
    return interleave([make(n, reqs, seed=i, addr_offset=i * 10_000_000,
                            scale=scale) for i, n in enumerate(names)],
                      seed=42)


@contextlib.contextmanager
def mix_source(names, reqs=REQS, scale=SCALE, streamed=False,
               shard_size=MIX_SHARD):
    """``benchmarks/common.py``'s ``vm_mix_source``: the mix in memory,
    or with ``streamed`` the same arrival stream in a
    :func:`make_store` store (same per-VM seeds, address stride and
    interleave seed, so results are identical) that lives while the
    context is open."""
    if not streamed:
        yield vm_mix(names, reqs, scale)
        return
    with tempfile.TemporaryDirectory(prefix="torch_fig_store_") as tmp:
        yield make_store(Path(tmp) / "store", list(names), reqs, seed=0,
                         scale=scale, shard_size=shard_size)


def stats_dict(st: Stats) -> dict:
    """0-d :class:`Stats` as host numbers: ints, ``latency_sum`` the
    float32 value as a Python float."""
    return {k: (float(v) if k == "latency_sum" else int(v))
            for k, v in zip(Stats._fields, st)}


def etica_config(mode="full", resize=RESIZE, promo=PROMO) -> EticaConfig:
    """``benchmarks/common.py``'s ``etica_config``."""
    return EticaConfig(dram_capacity=DRAM_CAP, ssd_capacity=SSD_CAP,
                       geometry_dram=GEO, geometry_ssd=GEO,
                       resize_interval=resize, promo_interval=promo,
                       mode=mode)


# ---------------------------------------------------------------------------
# Fig. 3: the write policy's effect on IOPS and SSD writes
# ---------------------------------------------------------------------------

def _fig3_run(chunks, policy, device) -> Stats:
    """One policy over a workload's request chunks on a fresh cache."""
    state = make_cache(GEO.num_sets, GEO.max_ways, device)
    stats, t = Stats.zero(), 0
    for chunk in chunks:
        state, st, t = simulate_single_level(
            np.asarray(chunk.addr), np.asarray(chunk.is_write), state,
            GEO.max_ways, policy, t0=t)
        stats = stats.merge(st)
    return stats


def fig3(device="cuda", n=FIG3_N, streamed=False, around=_null) -> dict:
    """Each workload under each one-level policy on a 16 x 32 cache:
    IOPS (1 / mean latency) and SSD writes, then the WBWO/WB and RO/WB
    ratios. With ``streamed`` each workload is written to a one-VM
    store and fed shard by shard. ``around(name)`` is a context wrapped
    around the runs."""
    runs, rows = {}, []
    t0 = time.perf_counter()
    with around("fig3"), tempfile.TemporaryDirectory(
            prefix="torch_fig3_store_") as tmp:
        for w in FIG3_WORKLOADS:
            store = (make_store(Path(tmp) / w, [w], n, seed=0, scale=0.25,
                                shard_size=FIG3_SHARD) if streamed else None)
            for p in FIG3_POLICIES:
                r0 = time.perf_counter()
                stats = _fig3_run(
                    store.iter_shards() if streamed
                    else [make(w, n, seed=0, scale=0.25)], p, device)
                iops = 1.0 / max(stats.mean_latency(), 1e-12)
                writes = int(stats.cache_writes_l2)
                runs[(w, p.value)] = dict(
                    stats=stats_dict(stats), iops=iops, ssd_writes=writes,
                    seconds=time.perf_counter() - r0)
                rows.append((f"fig3/{w}/{p.value}",
                             f"iops={iops:.0f} ssd_writes={writes}"))
        _sync(device)
    seconds = time.perf_counter() - t0
    for w in FIG3_WORKLOADS:
        wb, wo, ro = (runs[(w, p)] for p in ("WB", "WBWO", "RO"))
        wb_w = max(wb["ssd_writes"], 1)
        rows.append((f"fig3/{w}/summary",
                     f"WBWO_writes/WB={wo['ssd_writes']/wb_w:.2f} "
                     f"RO_writes/WB={ro['ssd_writes']/wb_w:.2f} "
                     f"WBWO_iops/WB={wo['iops']/max(wb['iops'],1e-9):.2f}"))
    return dict(rows=rows, runs=runs, requests=n * len(runs),
                seconds=seconds)


# ---------------------------------------------------------------------------
# Figs. 10/11: URD vs POD cache sizes
# ---------------------------------------------------------------------------

def fig10(device="cuda", workloads=FIG10_WORKLOADS, interval=FIG10_INTERVAL,
          n_intervals=FIG10_N_INTERVALS, around=_null) -> dict:
    """Per-interval demand (max distance + 1) by URD, POD(RO) and
    POD(WBWO) of each workload, their means and POD's size reduction
    against URD (paper: 51.7%)."""
    sizes, means, rows = {}, {}, []
    total_urd = total_ro = total_wbwo = 0
    t0 = time.perf_counter()
    with around("fig10"):
        for w in workloads:
            tr = make(w, interval * n_intervals, seed=1, scale=0.25)
            s_u, s_r, s_w = [], [], []
            for win in tr.intervals(interval):
                s_u.append(demand_blocks(urd(win, device)))
                s_r.append(demand_blocks(pod(win, Policy.RO, device)))
                s_w.append(demand_blocks(pod(win, Policy.WBWO, device)))
            u, r, wb = map(np.mean, (s_u, s_r, s_w))
            total_urd += u
            total_ro += r
            total_wbwo += wb
            sizes[w] = (s_u, s_r, s_w)
            means[w] = (float(u), float(r), float(wb))
            rows.append((f"fig10/{w}", f"avg_urd={u:.0f} avg_pod_ro={r:.0f} "
                                       f"avg_pod_wbwo={wb:.0f}"))
    seconds = time.perf_counter() - t0
    red = float(1 - (total_ro + total_wbwo) / (2 * total_urd))
    rows.append(("fig11/average_reduction",
                 f"pod_vs_urd_size_reduction={red:.3f} (paper: 0.517)"))
    return dict(rows=rows, sizes=sizes, means=means, reduction=red,
                requests=interval * n_intervals * len(workloads),
                seconds=seconds)


# ---------------------------------------------------------------------------
# Figs. 12/13: latency and hit ratio of ETICA-Full, ETICA-NPE, ECI-Cache
# ---------------------------------------------------------------------------

def fig12_summary(out: dict) -> tuple[float, float, float, float]:
    """(latency improvement of ETICA-Full and of ETICA-NPE over
    ECI-Cache, the same under SSD write contention, hit-ratio gain) from
    ``{controller: (mean latency, hit ratio, contended latency)}``."""
    return (1 - out["etica_full"][0] / out["eci_cache"][0],
            1 - out["etica_npe"][0] / out["eci_cache"][0],
            1 - out["etica_full"][2] / out["eci_cache"][2],
            out["etica_full"][1] - out["eci_cache"][1])


def vm_means(res) -> tuple[float, float, float]:
    """The VMs' mean latency, hit ratio and contended latency."""
    return (float(np.mean([r.mean_latency for r in res])),
            float(np.mean([r.hit_ratio for r in res])),
            float(np.mean([r.contended_latency() for r in res])))


def fig12(device="cuda", vms=FIG12_VMS, reqs=REQS, resize=RESIZE,
          promo=PROMO, streamed=False, around=_null) -> dict:
    """The VMs' mix through each controller at equal total space
    (ECI-Cache sized at DRAM + SSD): mean latency, hit ratio and
    contended latency, per VM and averaged; then ETICA's improvements
    over ECI-Cache (paper: 45% latency, NPE 27%, +30% hit ratio).
    With ``streamed`` every controller runs on one store of the mix.
    ``around(name)`` wraps each controller's run."""
    with mix_source(vms, reqs, streamed=streamed) as trace:
        return _fig12(device, trace, vms, resize, promo, around)


def _fig12(device, trace, vms, resize, promo, around) -> dict:
    controllers = {
        "etica_full": lambda: EticaCache(
            etica_config("full", resize, promo), len(vms), device=device),
        "etica_npe": lambda: EticaCache(
            etica_config("npe", resize, promo), len(vms), device=device),
        "eci_cache": lambda: make_eci_cache(
            DRAM_CAP + SSD_CAP, len(vms), geometry=GEO,
            resize_interval=resize, device=device),
    }
    out, runs, rows = {}, {}, []
    for name in FIG12_CONTROLLERS:
        with around(f"fig12-{name}"):
            cache = controllers[name]()
            _sync(device)
            t0 = time.perf_counter()
            res = cache.run(trace)
            _sync(device)
            seconds = time.perf_counter() - t0
        lat, hit, clat = out[name] = vm_means(res)
        runs[name] = dict(
            stats=[r.stats for r in res],
            alloc_history=[np.asarray(r.alloc_history).tolist()
                           for r in res],
            seconds=seconds)
        rows.append((f"fig12/{name}", f"mean_latency_ms={lat*1e3:.3f} "
                                      f"contended_ms={clat*1e3:.3f} "
                                      f"hit_ratio={hit:.3f}"))
        for vm, r in zip(vms, res):
            rows.append((f"fig12/{name}/{vm}",
                         f"latency_ms={r.mean_latency*1e3:.3f} "
                         f"hit={r.hit_ratio:.3f}"))
    summary = fig12_summary(out)
    imp_full, imp_npe, imp_cont, gain = summary
    rows.append(("fig12/summary",
                 f"etica_latency_improvement={imp_full:.3f} "
                 f"(paper: 0.45) npe={imp_npe:.3f} (paper: 0.27) "
                 f"with_ssd_write_contention={imp_cont:.3f} "
                 f"hit_gain={gain:.3f}"))
    return dict(rows=rows, means=out, runs=runs, summary=summary,
                requests=len(trace))


# ---------------------------------------------------------------------------
# Fig. 17: the promotion-interval sweep, from the telemetry journal
# ---------------------------------------------------------------------------

def _sweep_one(iv: int, trace, spill: Path, num_vms: int, device):
    """One swept run with a journal-spilling recorder; the journal is
    checked against its spill and against the controller's Stats."""
    rec = TelemetryRecorder(spill=spill)
    cfg = etica_config("full")
    cfg.promo_interval = iv
    cfg.telemetry = rec
    t0 = time.perf_counter()
    cache = EticaCache(cfg, num_vms, device=device)
    res = cache.run(trace)
    _sync(device)
    seconds = time.perf_counter() - t0
    rec.journal.close()
    # the spill reloads to the series the in-memory ring retains
    cols = load_journal(spill)
    tail = cols["requests"][-rec.journal.retained:]
    if not np.array_equal(tail, rec.journal.column("requests")):
        raise AssertionError(f"fig17 interval {iv}: the spill's requests "
                             "differ from the journal ring's")
    # the journal's interval deltas sum to the controller's own counters
    stats = [r.stats for r in res]
    for col, total in (
            ("requests", sum(s["reads"] + s["writes"] for s in stats)),
            ("ssd_writes", sum(s["cache_writes_l2"] for s in stats))):
        if abs(cols[col].sum() - total) >= 1e-6:
            raise AssertionError(f"fig17 interval {iv}: journal {col} "
                                 f"{cols[col].sum()} != Stats {total}")
    return seconds, cols, res


def fig17(device="cuda", vms=FIG17_VMS, reqs=FIG17_REQS,
          intervals=FIG17_INTERVALS, journal=None, streamed=False,
          around=_null) -> dict:
    """ETICA-Full swept over promotion intervals, latency and SSD writes
    read from the journal columns and normalised to the first interval;
    each run's journal summary and report lines. ``journal`` keeps the
    last run's spill at that path; with ``streamed`` every run reads one
    store of the mix; ``around(name)`` wraps each run."""
    with mix_source(vms, reqs, streamed=streamed) as trace:
        return _fig17(device, trace, vms, intervals, journal, around)


def _fig17(device, trace, vms, intervals, journal, around) -> dict:
    base, runs, rows = None, {}, []
    with tempfile.TemporaryDirectory(prefix="fig17_journal_") as tmp:
        for iv in intervals:
            spill = (Path(journal) if journal and iv == intervals[-1]
                     else Path(tmp) / f"interval_{iv}.jsonl")
            with around(f"fig17-{iv}"):
                seconds, cols, res = _sweep_one(iv, trace, spill, len(vms),
                                                device)
            s = summarize_journal(cols)
            lat = cols["latency"].sum() / max(cols["requests"].sum(), 1)
            writes = cols["ssd_writes"].sum()
            if base is None:
                base = (lat, writes)
            lat_norm = float(lat / base[0])
            writes_norm = float(writes / max(base[1], 1))
            runs[iv] = dict(
                stats=[r.stats for r in res],
                summary={k: s[k] for k in (
                    "intervals", "total_requests", "mean_hit_ratio",
                    "peak_dirty", "overloaded_intervals")},
                latency_norm=lat_norm, ssd_writes_norm=writes_norm,
                report=format_report(cols), seconds=seconds)
            rows.append((f"fig17/interval_{iv}",
                         f"latency_norm={lat_norm:.3f} "
                         f"ssd_writes_norm={writes_norm:.3f} "
                         f"intervals={s['intervals']} "
                         f"mean_hit={s['mean_hit_ratio']:.3f} "
                         f"overloaded={s['overloaded_intervals']}"))
    return dict(rows=rows, runs=runs, requests=len(trace))


FIGS = {"3": fig3, "10": fig10, "12": fig12, "17": fig17}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--fig", choices=[*FIGS, "all"], default="all")
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced sizes of the CPU parity tests")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--journal", default=None,
                    help="fig17: keep the last swept run's JSONL spill here")
    ap.add_argument("--streamed", action="store_true",
                    help="fig3, fig12 and fig17 read their requests from "
                         "an on-disk trace store")
    args = ap.parse_args(argv)
    for key in (FIGS if args.fig == "all" else [args.fig]):
        kw = dict(SMOKE[f"fig{key}"]) if args.smoke else {}
        if key == "17":
            kw["journal"] = args.journal
        if args.streamed and key != "10":
            kw["streamed"] = True
        t0 = time.perf_counter()
        out = FIGS[key](args.device, **kw)
        us = (time.perf_counter() - t0) * 1e6 / out["requests"]
        for name, derived in out["rows"]:
            print(f"{name},{us:.1f},{derived}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
