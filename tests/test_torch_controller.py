"""Port parity: ``repro_torch`` ``EticaCache.run`` vs ``repro.core``.

A fig15-style MSR mix (``benchmarks/common.py`` geometry, resize 2000,
promo 500) through both controllers — per-VM stats dicts and allocation
histories must be equal, in modes full and npe, at prefetch depths 0
and 2. Also: a state carried over from a JAX run with ``load_state``,
a mesh with ``batched=False`` raising the reference's ``ValueError``
(a plain mesh runs) and a classifier that is not the port's
raising ``TypeError``, inputs other than a
port ``Trace``, ``TraceStore`` or ``StreamingTraceSource`` raising
``TypeError``, and a subprocess port job (every maintenance mode, the
baselines, serving, the ``core``, ``traces`` and ``launch`` exports, the
trace store and streamed ingestion, a sharded run of both controllers on
a CPU mesh, the §5.1 config,
``examples/torch_paper_figures.py`` and a classified cache in every
mode and ECI-Cache with a classifier) that loads neither ``jax`` nor any
``repro`` module.
"""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import EticaCache as JCache, EticaConfig as JConfig
from repro.core import Geometry as JGeometry
from repro.core.trace import interleave as jinterleave
from repro.traces import make as jmake

from repro_torch.core.controller import EticaCache, EticaConfig, Geometry
from repro_torch.core.trace import Trace, interleave
from repro_torch.launch.mesh import VMMesh
from repro_torch.traces.generators import make

NAMES = ["hm_1", "proj_0", "stg_1", "usr_0", "ts_0"]
REQS = 1000
ROOT = Path(__file__).resolve().parent.parent


def _traces():
    j = jinterleave([jmake(n, REQS, seed=i, addr_offset=i * 10_000_000,
                           scale=0.25) for i, n in enumerate(NAMES)], seed=42)
    t = interleave([make(n, REQS, seed=i, addr_offset=i * 10_000_000,
                         scale=0.25) for i, n in enumerate(NAMES)], seed=42)
    return j, t


def _configs(**kw):
    common = dict(dram_capacity=400, ssd_capacity=800, resize_interval=2000,
                  promo_interval=500, **kw)
    return (JConfig(geometry_dram=JGeometry(16, 32),
                    geometry_ssd=JGeometry(16, 32), **common),
            EticaConfig(geometry_dram=Geometry(16, 32),
                        geometry_ssd=Geometry(16, 32), **common))


def _assert_results(jres, tres):
    assert len(jres) == len(tres)
    for v, (a, b) in enumerate(zip(jres, tres)):
        assert a.stats == b.stats, v
        assert np.array_equal(a.alloc_history, b.alloc_history), v


@pytest.mark.parametrize("depth", [0, 2])
@pytest.mark.parametrize("mode", ["full", "npe"])
def test_run_matches_jax(mode, depth):
    jtrace, ttrace = _traces()
    jcfg, tcfg = _configs(mode=mode, prefetch_depth=depth)
    jcache = JCache(jcfg, len(NAMES))
    jres = jcache.run(jtrace)
    tcache = EticaCache(tcfg, len(NAMES), device="cpu")
    tres = tcache.run(ttrace)
    _assert_results(jres, tres)
    if mode == "full":
        assert sum(r.stats["cache_writes_l2"] for r in tres) > 0
    # one telemetry row per block, with the same per-VM deltas
    jj, tj = jcache.telemetry.journal, tcache.telemetry.journal
    assert len(jj) == len(tj) > 0
    for col in ("requests", "hits", "ssd_writes", "promoted", "evict_queue",
                "alloc_l2", "overloaded"):
        assert np.array_equal(jj.column(col), tj.column(col)), col


def test_span_timing_changes_no_result():
    from repro_torch.runtime.telemetry import TelemetryRecorder
    _, ttrace = _traces()
    _, plain_cfg = _configs()
    _, timed_cfg = _configs(telemetry=TelemetryRecorder(span_timing=True))
    plain = EticaCache(plain_cfg, len(NAMES), device="cpu").run(ttrace)
    cache = EticaCache(timed_cfg, len(NAMES), device="cpu")
    _assert_results(plain, cache.run(ttrace))
    spans = cache.telemetry.spans
    assert set(spans) == {"sizing", "datapath", "maintenance"}
    assert spans["datapath"].n == len(cache.telemetry.journal)
    assert spans["sizing"].n == 2 * len(cache.logs_ssd)


def test_load_state_carries_a_jax_run():
    """Run the first resize window in JAX, carry the state over, and run
    the rest in both controllers side by side."""
    jtrace, ttrace = _traces()
    jcfg, tcfg = _configs()
    jc = JCache(jcfg, len(NAMES))
    jc.run(jtrace[:2000])
    tc = EticaCache(tcfg, len(NAMES), device="cpu")
    tc.load_state(
        dram=[np.asarray(x) for x in jc.dram],
        ssd=[np.asarray(x) for x in jc.ssd],
        pop_table=[np.asarray(x) for x in jc.pop_table],
        ways_dram=jc.ways_dram, ways_ssd=jc.ways_ssd, t=jc.t,
        stats=jc.stats)
    _assert_results(jc.run(jtrace[2000:]), tc.run(ttrace[2000:]))
    for a, b in zip(jc.ssd, tc.ssd):
        assert np.array_equal(np.asarray(a), b.numpy())
    assert np.array_equal(np.asarray(jc.pop_table.val).view(np.int32),
                          tc.pop_table.val.numpy().view(np.int32))


CPU_MESH = VMMesh((torch.device("cpu"),) * 2)


@pytest.mark.parametrize("option", [
    dict(batched=False, mesh=CPU_MESH),
    dict(fused_maintenance=False, classifier=object()), dict(mesh=CPU_MESH),
    dict(classifier=object())])
def test_options_outside_the_port_raise(option):
    """A mesh needs the batched controller (the reference's
    ``ValueError``), and a plain mesh runs; a classifier that is not a
    ``repro_torch.classify.Classifier`` is the wrong type."""
    _, tcfg = _configs(**option)
    if option == dict(mesh=CPU_MESH):
        assert EticaCache(tcfg, 3, device="cpu")._rows == 4
        return
    err = TypeError if "classifier" in option else ValueError
    with pytest.raises(err):
        EticaCache(tcfg, 2, device="cpu")


def test_non_trace_inputs_raise():
    _, tcfg = _configs()
    cache = EticaCache(tcfg, 2, device="cpu")
    with pytest.raises(TypeError):
        cache.run(str(ROOT))          # a path, not an opened TraceStore
    jtrace, _ = _traces()
    with pytest.raises(TypeError):
        cache.run(jtrace)             # the JAX package's Trace


def test_default_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs on it")
    _, tcfg = _configs()
    with pytest.raises(RuntimeError, match="CUDA"):
        EticaCache(tcfg, 2)


def test_port_job_loads_no_jax_and_no_repro():
    code = textwrap.dedent("""
        import sys
        from repro_torch.core.controller import EticaCache, EticaConfig, Geometry
        from repro_torch.core.trace import interleave
        from repro_torch.traces.generators import make
        from repro_torch.core.baselines import make_eci_cache
        from repro_torch.runtime import metrics
        import repro_torch.kernels.maintenance.ops
        trace = interleave([make(n, 400, seed=i, addr_offset=i * 10_000_000,
                                 scale=0.25) for i, n in
                            enumerate(["hm_1", "usr_0", "web_3"])], seed=0)
        geo = Geometry(8, 16)
        for quota in (0, 2):               # ETICA, and with the cleaner
            runs = []
            for mode in (dict(batched=False), dict(fused_maintenance=False),
                         {}):              # sequential, staged, fused
                cfg = EticaConfig(dram_capacity=60, ssd_capacity=120,
                                  geometry_dram=geo, geometry_ssd=geo,
                                  resize_interval=600, promo_interval=200,
                                  clean_quota=quota, **mode)
                cache = EticaCache(cfg, 3, device="cpu")
                runs.append([r.stats for r in cache.run(trace)])
                assert sum(s["reads"] + s["writes"] for s in runs[-1]) == 1200
            assert runs[0] == runs[1] == runs[2]
        assert sum(s["flushes"] for s in runs[2]) > 0
        metrics.parse_exposition(metrics.render_cache(cache))
        eci = make_eci_cache(180, 3, geometry=geo, resize_interval=600,
                             sim_chunk=200, device="cpu")
        res = eci.run(trace)
        assert sum(r.stats["reads"] + r.stats["writes"] for r in res) == 1200
        seq = make_eci_cache(180, 3, geometry=geo, resize_interval=600,
                             sim_chunk=200, batched=False, device="cpu")
        assert [r.stats for r in seq.run(trace)] == [r.stats for r in res]
        from repro_torch.core.baselines import make_fast, make_l2arc
        from repro_torch.kernels.maintenance import ref
        from repro_torch.kernels.popularity import ops as pop_ops
        for factory in (make_fast, make_l2arc):
            assert factory(60, 120, geometry=geo, device="cpu").run(
                trace[:400]).stats["reads"] > 0
        import repro_torch.kvcache
        from repro_torch.launch import serve
        stats = serve.main(["--events", "300", "--live", "16",
                            "--hbm-pages", "16", "--decode-every", "10",
                            "--device", "cpu"])
        assert stats["activations"] > 0
        import torch
        import repro_torch.models
        from repro_torch import configs
        from repro_torch.launch import steps
        from repro_torch.models import model as M
        cfg = configs.get_reduced("qwen3-4b")
        params = M.init_params(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
        toks = torch.randint(0, cfg.vocab_size, (2, 24))
        nxt, cache = steps.make_prefill_step(cfg, 26)(params,
                                                      {"tokens": toks})
        nxt, cache = steps.make_decode_step(cfg)(params, cache,
                                                 nxt[:, None], 24)
        assert nxt.shape == (2, 1) and cache["layers"]["block0"]["k"].shape \
            == (cfg.num_layers, 2, 26, cfg.num_kv_heads, cfg.head_dim)
        import importlib.util
        import repro_torch.core
        import repro_torch.launch
        import repro_torch.traces
        from repro_torch.configs.etica_paper import CONFIG
        for pkg in (repro_torch.core, repro_torch.traces, repro_torch.launch):
            for name in pkg.__all__:
                getattr(pkg, name)
        assert len(CONFIG.vms) == 12
        spec = importlib.util.spec_from_file_location(
            "torch_paper_figures", sys.argv[1])
        figs = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(figs)
        out = figs.fig10("cpu", workloads=("hm_1",), interval=200,
                         n_intervals=2)
        assert out["rows"][-1][0] == "fig11/average_reduction"
        out = figs.fig17("cpu", vms=("hm_1", "usr_0"), reqs=300,
                         intervals=(100,))
        assert out["runs"][100]["report"][-1].startswith("summary:")
        import dataclasses
        import tempfile
        from pathlib import Path
        import repro_torch.traces.store
        import repro_torch.traces.stream
        from repro_torch.traces.store import TraceStore, main as store_cli
        with tempfile.TemporaryDirectory() as tmp:
            TraceStore.from_trace(Path(tmp) / "s", trace, shard_size=256)
            store = TraceStore.open(Path(tmp) / "s")
            ecfg = EticaConfig(dram_capacity=60, ssd_capacity=120,
                               geometry_dram=geo, geometry_ssd=geo,
                               resize_interval=600, promo_interval=200,
                               clean_quota=2)
            streamed = EticaCache(ecfg, 3, device="cpu").run(store)
            assert [r.stats for r in streamed] == runs[2]
            src = repro_torch.traces.stream.StreamingTraceSource(
                store, num_vms=3, window=600, chunk=200, prefetch=False)
            eci = make_eci_cache(180, 3, geometry=geo, resize_interval=600,
                                 sim_chunk=200, device="cpu")
            assert [r.stats for r in eci.run(src)] == \
                [r.stats for r in res]
            mesh = repro_torch.launch.VMMesh((torch.device("cpu"),) * 2)
            sharded = EticaCache(dataclasses.replace(ecfg, mesh=mesh), 3,
                                 device="cpu")
            assert [r.stats for r in sharded.run(store)] == runs[2]
            eci = make_eci_cache(180, 3, geometry=geo, resize_interval=600,
                                 sim_chunk=200, device="cpu", mesh=mesh)
            assert [r.stats for r in eci.run(trace)] == \
                [r.stats for r in res]
            csv = Path(tmp) / "t.csv"
            csv.write_text("0,h,0,Read,8192,8192,1\\n1,h,1,Write,0,4096,1\\n")
            assert store_cli(["import", str(csv), str(Path(tmp) / "m")]) == 0
            assert TraceStore.open(Path(tmp) / "m").num_vms == 2
            del store, src
        import repro_torch.classify
        from repro_torch.classify import seq_cutoff
        trace = interleave([make(n, 400, seed=i, addr_offset=i * 10_000_000,
                                 scale=0.25) for i, n in
                            enumerate(["scan_mix", "hm_1", "backup_scan"])],
                           seed=0)
        for mode in (dict(batched=False), dict(fused_maintenance=False), {}):
            ccfg = EticaConfig(dram_capacity=60, ssd_capacity=120,
                               geometry_dram=geo, geometry_ssd=geo,
                               resize_interval=600, promo_interval=200,
                               classifier=seq_cutoff(4), **mode)
            classified = EticaCache(ccfg, 3, device="cpu")
            cres = [r.stats for r in classified.run(trace)]
            assert sum(s["reads"] + s["writes"] for s in cres) == 1200
        assert sum(s["bypassed"] for s in cres) > 0
        assert classified.cls_hits.sum() + classified.cls_miss.sum() == \
            1200 - sum(s["bypassed"] for s in cres)
        eci = make_eci_cache(180, 3, geometry=geo, resize_interval=600,
                             sim_chunk=200, classifier=seq_cutoff(4),
                             device="cpu")
        assert sum(r.stats["bypassed"] for r in eci.run(trace)) > 0
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith("jax.")
                     or m == "repro" or m.startswith("repro."))
        print("LOADED", bad)
        sys.exit(1 if bad else 0)
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code,
                          str(ROOT / "examples" / "torch_paper_figures.py")],
                         env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "LOADED []" in out.stdout


def test_trace_slicing_matches():
    jtrace, ttrace = _traces()
    assert isinstance(ttrace[10:20], Trace)
    assert np.array_equal(jtrace[10:500].addr, ttrace[10:500].addr)
