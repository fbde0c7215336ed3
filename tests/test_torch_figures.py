"""The paper's figures through the port == through the JAX package.

``examples/torch_paper_figures.py`` runs fig3, fig10/11, fig12/13 and
fig17 on the port; the ``jax_fig*`` functions below run the same
experiments by calling the JAX package directly, in the order the
``benchmarks/fig*.py`` scripts call it, and return the same rows and raw
values. This file holds fig3 and fig10/11 at reduced sizes;
``test_torch_figures_fig12.py`` and ``test_torch_figures_fig17.py`` hold
the controllers' figures. Integer stats and allocation histories must be
exact, ``latency_sum`` the same float32 value and every derived float
equal.

Run as a script, it prints the JAX package's values at the benchmarks'
own sizes, the constants ``chip_smoke.py`` phases 12 and 13 hold the
card to (``FIG3_STREAMED``: fig3's streamed form)::

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_figures.py
"""
from __future__ import annotations

import functools
import hashlib
import importlib.util
import json
import sys
import tempfile
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
for p in (ROOT, ROOT / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))


def figures():
    """``examples/torch_paper_figures.py`` as a module."""
    mod = sys.modules.get("torch_paper_figures")
    if mod is None:
        spec = importlib.util.spec_from_file_location(
            "torch_paper_figures",
            ROOT / "examples" / "torch_paper_figures.py")
        mod = importlib.util.module_from_spec(spec)
        sys.modules["torch_paper_figures"] = mod
        spec.loader.exec_module(mod)
    return mod


def strip_seconds(x):
    """A figure's output without its host-clock times."""
    if isinstance(x, dict):
        return {k: strip_seconds(v) for k, v in x.items()
                if k != "seconds"}
    if isinstance(x, list):
        return [strip_seconds(v) for v in x]
    return x


def report_digest(lines) -> str:
    return hashlib.sha256("\n".join(lines).encode()).hexdigest()[:16]


# ---------------------------------------------------------------------------
# the same experiments on the JAX package
# ---------------------------------------------------------------------------

def jax_stats_dict(st) -> dict:
    from repro.core import Stats
    return {k: (float(v) if k == "latency_sum" else int(v))
            for k, v in zip(Stats._fields, st)}


def jax_fig3(n=6_000, workloads=("fio_randrw", "web_server",
                                 "video_server", "varmail"),
             streamed=False) -> dict:
    """benchmarks/fig3_write_policy.py's ``run_one`` and ``main``; with
    ``streamed``, its ``_workload_chunks`` store of shards of 1,024 (in a
    temporary directory)."""
    from benchmarks.common import GEO
    from repro.core import Policy, Stats, make_cache, simulate_single_level
    from repro.traces import make, make_store
    runs, rows = {}, []
    tmp = tempfile.TemporaryDirectory()
    for w in workloads:
        for p in (Policy.WB, Policy.RO, Policy.WBWO):
            state = make_cache(GEO.num_sets, GEO.max_ways)
            stats, t0 = Stats.zero(), 0
            chunks = ((make(w, n, seed=0, scale=0.25),) if not streamed
                      else make_store(Path(tmp.name) / f"{w}_{p.value}",
                                      [w], n, seed=0, scale=0.25,
                                      shard_size=1024).iter_shards())
            for chunk in chunks:
                state, st, t0 = simulate_single_level(
                    np.asarray(chunk.addr), np.asarray(chunk.is_write),
                    state, GEO.max_ways, p, t0=t0)
                stats = stats.merge(st)
            del chunk, chunks
            iops = 1.0 / max(stats.mean_latency(), 1e-12)
            writes = int(stats.cache_writes_l2)
            runs[(w, p.value)] = dict(stats=jax_stats_dict(stats), iops=iops,
                                      ssd_writes=writes)
            rows.append((f"fig3/{w}/{p.value}",
                         f"iops={iops:.0f} ssd_writes={writes}"))
    for w in workloads:
        wb_i, wb_w = runs[(w, "WB")]["iops"], runs[(w, "WB")]["ssd_writes"]
        wo_i, wo_w = runs[(w, "WBWO")]["iops"], runs[(w, "WBWO")]["ssd_writes"]
        ro_w = runs[(w, "RO")]["ssd_writes"]
        rows.append((f"fig3/{w}/summary",
                     f"WBWO_writes/WB={wo_w/max(wb_w,1):.2f} "
                     f"RO_writes/WB={ro_w/max(wb_w,1):.2f} "
                     f"WBWO_iops/WB={wo_i/max(wb_i,1e-9):.2f}"))
    tmp.cleanup()
    return dict(rows=rows, runs=runs, requests=n * len(runs))


def jax_fig10(workloads=("hm_1", "proj_0", "rsrch_0", "web_3", "ts_0",
                         "wdev_0", "usr_0", "src2_0"),
              interval=1_000, n_intervals=10) -> dict:
    """benchmarks/fig10_cache_size.py's ``main``."""
    from repro.core import Policy, demand_blocks, pod, urd
    from repro.traces import make
    sizes, means, rows = {}, {}, []
    total_urd = total_ro = total_wbwo = 0
    for w in workloads:
        tr = make(w, interval * n_intervals, seed=1, scale=0.25)
        s_u, s_r, s_w = [], [], []
        for win in tr.intervals(interval):
            s_u.append(demand_blocks(urd(win)))
            s_r.append(demand_blocks(pod(win, Policy.RO)))
            s_w.append(demand_blocks(pod(win, Policy.WBWO)))
        u, r, wb = map(np.mean, (s_u, s_r, s_w))
        total_urd += u
        total_ro += r
        total_wbwo += wb
        sizes[w] = (s_u, s_r, s_w)
        means[w] = (float(u), float(r), float(wb))
        rows.append((f"fig10/{w}", f"avg_urd={u:.0f} avg_pod_ro={r:.0f} "
                                   f"avg_pod_wbwo={wb:.0f}"))
    red = float(1 - (total_ro + total_wbwo) / (2 * total_urd))
    rows.append(("fig11/average_reduction",
                 f"pod_vs_urd_size_reduction={red:.3f} (paper: 0.517)"))
    return dict(rows=rows, sizes=sizes, means=means, reduction=red,
                requests=interval * n_intervals * len(workloads))


def jax_vm_means(res):
    return (float(np.mean([r.mean_latency for r in res])),
            float(np.mean([r.hit_ratio for r in res])),
            float(np.mean([r.contended_latency() for r in res])))


def jax_fig12(vms=("hm_1", "ts_0", "usr_0", "web_3", "wdev_0", "src2_0"),
              reqs=8_000, resize=2_000, promo=500) -> dict:
    """benchmarks/fig12_latency.py's ``main`` (in memory), with the
    resize and promotion intervals as arguments."""
    from benchmarks.common import DRAM_CAP, GEO, SSD_CAP, vm_mix
    from repro.core import EticaCache, EticaConfig, make_eci_cache

    def cfg(mode):
        return EticaConfig(dram_capacity=DRAM_CAP, ssd_capacity=SSD_CAP,
                           geometry_dram=GEO, geometry_ssd=GEO,
                           resize_interval=resize, promo_interval=promo,
                           mode=mode)
    trace = vm_mix(list(vms), reqs=reqs)
    out, runs, rows = {}, {}, []
    for name, runner in [
        ("etica_full", lambda: EticaCache(cfg("full"), len(vms))),
        ("etica_npe", lambda: EticaCache(cfg("npe"), len(vms))),
        ("eci_cache", lambda: make_eci_cache(
            DRAM_CAP + SSD_CAP, len(vms), geometry=GEO,
            resize_interval=resize)),
    ]:
        res = runner().run(trace)
        lat, hit, clat = out[name] = jax_vm_means(res)
        runs[name] = dict(stats=[r.stats for r in res],
                          alloc_history=[np.asarray(r.alloc_history).tolist()
                                         for r in res])
        rows.append((f"fig12/{name}", f"mean_latency_ms={lat*1e3:.3f} "
                                      f"contended_ms={clat*1e3:.3f} "
                                      f"hit_ratio={hit:.3f}"))
        for vm, r in zip(vms, res):
            rows.append((f"fig12/{name}/{vm}",
                         f"latency_ms={r.mean_latency*1e3:.3f} "
                         f"hit={r.hit_ratio:.3f}"))
    imp_full = 1 - out["etica_full"][0] / out["eci_cache"][0]
    imp_npe = 1 - out["etica_npe"][0] / out["eci_cache"][0]
    imp_cont = 1 - out["etica_full"][2] / out["eci_cache"][2]
    gain = out["etica_full"][1] - out["eci_cache"][1]
    rows.append(("fig12/summary",
                 f"etica_latency_improvement={imp_full:.3f} (paper: 0.45) "
                 f"npe={imp_npe:.3f} (paper: 0.27) "
                 f"with_ssd_write_contention={imp_cont:.3f} "
                 f"hit_gain={gain:.3f}"))
    return dict(rows=rows, means=out, runs=runs,
                summary=(imp_full, imp_npe, imp_cont, gain),
                requests=len(trace))


def jax_fig17(reqs=6_000, intervals=(100, 250, 500, 1000, 2000)) -> dict:
    """benchmarks/fig17_intervals.py's ``main`` (in memory), through its
    own ``_sweep_one`` (which asserts the spill round trip and the
    journal-to-Stats sums)."""
    from benchmarks import fig17_intervals as f17
    from benchmarks.common import vm_mix
    from repro.runtime.telemetry import format_report, summarize_journal
    trace = vm_mix(f17.VMS, reqs=reqs)
    base, runs, rows = None, {}, []
    with tempfile.TemporaryDirectory() as tmp:
        for iv in intervals:
            _, cols, _ = f17._sweep_one(iv, trace,
                                        Path(tmp) / f"interval_{iv}.jsonl")
            s = summarize_journal(cols)
            lat = cols["latency"].sum() / max(cols["requests"].sum(), 1)
            writes = cols["ssd_writes"].sum()
            if base is None:
                base = (lat, writes)
            lat_norm = float(lat / base[0])
            writes_norm = float(writes / max(base[1], 1))
            runs[iv] = dict(
                summary={k: s[k] for k in (
                    "intervals", "total_requests", "mean_hit_ratio",
                    "peak_dirty", "overloaded_intervals")},
                latency_norm=lat_norm, ssd_writes_norm=writes_norm,
                report=format_report(cols))
            rows.append((f"fig17/interval_{iv}",
                         f"latency_norm={lat_norm:.3f} "
                         f"ssd_writes_norm={writes_norm:.3f} "
                         f"intervals={s['intervals']} "
                         f"mean_hit={s['mean_hit_ratio']:.3f} "
                         f"overloaded={s['overloaded_intervals']}"))
    return dict(rows=rows, runs=runs, requests=len(trace))


# ---------------------------------------------------------------------------
# fig3 and fig10/11 at reduced sizes
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def jax_fig3_smoke(streamed=False) -> dict:
    """:func:`jax_fig3` at ``--smoke`` size, once per form."""
    return jax_fig3(streamed=streamed, **figures().SMOKE["fig3"])


def test_fig3_port_equals_jax():
    """4 workloads x 3 policies at N 1,500: every Stats field (the
    float32 ``latency_sum`` through ``Stats.zero``/``merge``), IOPS and
    SSD writes, and the printed rows."""
    f = figures()
    got = strip_seconds(f.fig3("cpu", **f.SMOKE["fig3"]))
    want = jax_fig3_smoke()
    assert got == want


def test_fig3_streamed_port_equals_jax():
    """fig3's streamed form (a one-VM store per workload, shards of
    1,024 fed to the simulator one by one) at N 1,500: equal to the JAX
    script's streamed form; the counts also equal the in-memory form's
    (``latency_sum`` is summed a chunk at a time in both packages)."""
    f = figures()
    got = strip_seconds(f.fig3("cpu", streamed=True, **f.SMOKE["fig3"]))
    assert got == jax_fig3_smoke(streamed=True)
    mem = jax_fig3_smoke()
    for key, run in got["runs"].items():
        counts = {k: v for k, v in run["stats"].items()
                  if k != "latency_sum"}
        assert counts == {k: v for k, v in mem["runs"][key]["stats"].items()
                          if k != "latency_sum"}, key


def test_fig10_port_equals_jax():
    """3 workloads x 3 intervals of 500: every interval's URD, POD(RO)
    and POD(WBWO) demand, the means and the fig11 reduction."""
    f = figures()
    got = strip_seconds(f.fig10("cpu", **f.SMOKE["fig10"]))
    want = jax_fig10(**f.SMOKE["fig10"])
    assert got == want
    assert got["rows"][-1][0] == "fig11/average_reduction"


def test_smoke_cli_prints_every_figure(capsys):
    """The CLI at --smoke --fig 3 prints the JAX script's rows with a
    timing column."""
    f = figures()
    assert f.main(["--fig", "3", "--device", "cpu", "--smoke"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    want = jax_fig3_smoke()["rows"]
    assert [(ln.split(",")[0], ln.split(",", 2)[2]) for ln in lines] == want


# ---------------------------------------------------------------------------
# the JAX package's values at the benchmarks' sizes (chip_smoke phase 12)
# ---------------------------------------------------------------------------

def constants(f3, f10, f12, f17, f3s) -> dict:
    """The four figures' outputs in the layout of chip_smoke.py's
    constants; ``f3s`` is fig3's streamed form, whose float32 latency
    sums (and IOPS) are summed a shard at a time."""
    stat_keys = list(f3["runs"][("fio_randrw", "WB")]["stats"])
    return {
        "FIG3_STREAMED": {f"{w}/{p}": [r["stats"]["latency_sum"], r["iops"]]
                          for (w, p), r in f3s["runs"].items()},
        "FIG3": {f"{w}/{p}": [r["stats"][k] for k in stat_keys] + [r["iops"]]
                 for (w, p), r in f3["runs"].items()},
        "FIG10": {w: [list(map(int, s)) for s in f10["sizes"][w]]
                  + [list(f10["means"][w])] for w in f10["sizes"]},
        "FIG11_REDUCTION": f10["reduction"],
        "FIG12": {name: {"stats": [[s[k] for k in stat_keys
                                    + ["evict_flushes"]]
                                   for s in run["stats"]],
                         "alloc": run["alloc_history"],
                         "means": list(f12["means"][name])}
                  for name, run in f12["runs"].items()},
        "FIG12_SUMMARY": list(f12["summary"]),
        "FIG17": {iv: {"summary": run["summary"],
                       "norms": [run["latency_norm"],
                                 run["ssd_writes_norm"]],
                       "report": [len(run["report"]),
                                  report_digest(run["report"]),
                                  run["report"][-1]]}
                  for iv, run in f17["runs"].items()},
        "ROWS": {k: report_digest([f"{n},{d}" for n, d in out["rows"]])
                 for k, out in (("fig3", f3), ("fig10", f10),
                                ("fig12", f12), ("fig17", f17))},
    }


if __name__ == "__main__":
    print(json.dumps(constants(jax_fig3(), jax_fig10(), jax_fig12(),
                               jax_fig17(), jax_fig3(streamed=True)),
                     indent=1))
