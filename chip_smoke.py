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
   version and, where one exists, a one-call PyTorch equivalent; runs
   the fused maintenance interval under
   ``torch.cuda.set_sync_debug_mode("error")``;
3. runs the paper's §5.1 deployment (12 VMs x 20,000 requests, 64 x 64
   geometry) through ``EticaCache.run`` on the card and again on the
   CPU; per-VM stats and allocation histories must be identical;
4. runs the fig15 consolidation configuration at 128 and 1024 VMs the
   same way (card == CPU).

Each card run of phases 3 and 4 sets the launch counts to 0 just before
and reads them just after; every kernel must have launched in each.
Phase 2 holds the kernels against their plain versions at the shapes of
both the 12-VM and the 1024-VM runs.

The line before the last is ``{"kernels": [...]}`` (one entry per
kernel); the last is ``{"ok": true, "device": {...}}``. Any failed phase
raises and the exit code is nonzero. Without a CUDA device it exits 2
and prints no result.
"""
from __future__ import annotations

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

PAPER_VMS = ("hm_1", "proj_0", "stg_1", "usr_0", "ts_0", "wdev_0", "web_3",
             "usr_0", "mds_0", "src2_0", "rsrch_0", "mds_1")
FIG15_WORKLOADS = ["hm_1", "proj_0", "stg_1", "usr_0", "ts_0", "wdev_0",
                   "web_3", "src2_0"] * 2
FIG15_JAX_CPU_AVG_HIT_1024 = 0.271   # benchmarks/BENCH_sharding.json


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

def check_count_between(dev, subs, label):
    import torch
    from repro_torch.core import reuse
    from repro_torch.kernels.reuse_distance import ops
    addrs = [np.asarray(s.addr) for s in subs]
    writes = [np.asarray(s.is_write) for s in subs]
    lens = [len(a) for a in addrs]
    amat, wmat = reuse._pad_rows(addrs, writes, list(range(len(subs))), lens)
    a = torch.from_numpy(amat).to(dev)
    w = torch.from_numpy(wmat).to(dev)
    served = ~w & (reuse._prev_same(a, w) >= 0)          # POD(WBWO)
    touch = (w | served).contiguous()
    prev = reuse._prev_same(a, touch)
    nt = reuse._next_same(a, touch)
    got = ops.count_between(prev, touch, nt)
    want = ops.count_between_plain(prev, touch, nt)
    err = max_abs_err([got], [want])
    ms = cuda_ms(lambda: ops.count_between(prev, touch, nt), 50)
    plain_ms = cuda_ms(lambda: ops.count_between_plain(prev, touch, nt), 3)
    v, n = prev.shape
    i = torch.arange(n, device=dev)[None, :]
    pairs = float((i - prev.long() - 1).clamp(min=0).sum())
    b, by = bound_ms(13.0 * v * n, 2.0 * pairs)
    log(f"count_between {label} [{v},{n}]: exact, kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, bound {b:.5f} ms ({by}), "
        f"pairs {pairs:.0f}")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b,
                bound_by=by, library_ms=None)


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


def longest_set_chain(a, sets) -> int:
    """Most valid requests that any (VM, set) receives in block ``a``:
    those requests must run one after another."""
    import torch
    v = a.shape[0]
    valid = a >= 0
    key = (torch.arange(v, device=a.device)[:, None] * sets
           + a.clamp(min=0) % sets)[valid]
    return int(torch.bincount(key, minlength=1).max()) if key.numel() else 0


def check_datapath(dev, blocks, sets, ways_max, ways, mode, label, step_ns):
    import torch
    from repro_torch.core.simulator import make_cache_batch
    from repro_torch.kernels.datapath import ops
    v = blocks[0][0].shape[0]
    wd = torch.as_tensor(ways[0], dtype=torch.int32, device=dev)
    ws = torch.as_tensor(ways[1], dtype=torch.int32, device=dev)
    npe = mode == "npe"
    kstate = rstate = (*make_cache_batch(v, sets, ways_max, dev),
                       *make_cache_batch(v, sets, ways_max, dev))
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
    ms = cuda_ms(lambda: ops.two_level(*timed, npe=npe), 20)
    plain_ms = cuda_ms(lambda: ops.two_level_plain(*timed, npe=npe), 1,
                       warmup=0)
    a = timed[0]
    n = a.shape[1]
    valid = float((a >= 0).sum())
    state_bytes = 2 * 2 * 9.0 * v * sets * ways_max
    b, by = bound_ms(5.0 * v * n + state_bytes + 40.0 * v,
                     valid * 2 * (2 * ways_max))
    chain = longest_set_chain(a, sets)
    chain_b = chain * step_ns * 1e-6
    log(f"two_level {label} {mode} [{v},{n}] {sets}x{ways_max}: exact over "
        f"{len(blocks)} blocks, kernel {ms:.4f} ms, plain {plain_ms:.2f} ms, "
        f"bound {b:.5f} ms ({by}), {valid:.0f} valid requests, longest "
        f"same-set chain {chain} x {step_ns:.2f} ns = chain bound "
        f"{chain_b:.5f} ms")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b,
                bound_by=by, library_ms=None, chain_bound_ms=chain_b)


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


def check_scatters(dev, rng, v, s, w):
    import torch
    from repro_torch.kernels.maintenance import ops
    q = 1 << (s * w - 1).bit_length()        # next_pow2(S*W), as on the path
    tags, lru, dirty = random_state(rng, v, s, w)
    ways = rng.integers(8, w + 1, v).astype(np.int32)
    t = rng.integers(10_000, 20_000, v).astype(np.int32)
    equeue = np.full((v, q), -1, np.int32)
    pqueue = np.full((v, q), -1, np.int32)
    for i in range(v):
        res = tags[i][tags[i] >= 0]
        k = max(int(np.ceil(0.05 * res.size)), 1)
        equeue[i, :k] = rng.choice(res, k, replace=False)
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
    plain_ms = cuda_ms(lambda: ops.evict_scatter_plain(*st, eq), 10)
    vm = torch.arange(v, device=dev, dtype=torch.int64)
    tk = (st[0].long() + (vm << 32)[:, None, None]).reshape(-1)
    qk = (eq.long() + (vm << 32)[:, None]).reshape(-1)
    lib_ms = cuda_ms(lambda: torch.isin(tk, qk), 50)
    b, by = bound_ms(2 * 9.0 * v * s * w + 4.0 * v * q + 4.0 * v,
                     2.0 * (v * s * w + v * q))
    log(f"evict_scatter [{v},{s},{w}] Q={q}: exact, flushed "
        f"{int(got[3].sum())}, kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"torch.isin {lib_ms:.4f} ms, bound {b:.5f} ms ({by})")
    out["evict_scatter"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                bound_ms=b, bound_by=by, library_ms=lib_ms)

    got = ops.promote_scatter(*st, pq, ways_t, t_t)
    want = ops.promote_scatter_plain(*st, pq, ways_t, t_t)
    err = max_abs_err(got, want)
    ms = cuda_ms(lambda: ops.promote_scatter(*st, pq, ways_t, t_t), 50)
    plain_ms = cuda_ms(
        lambda: ops.promote_scatter_plain(*st, pq, ways_t, t_t), 10)
    b, by = bound_ms(2 * 9.0 * v * s * w + 4.0 * v * q + 12.0 * v,
                     2.0 * (v * s * w + v * q))
    log(f"promote_scatter [{v},{s},{w}] Q={q}: exact, promoted "
        f"{int(got[3].sum())}, kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"bound {b:.5f} ms ({by})")
    out["promote_scatter"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                  bound_ms=b, bound_by=by, library_ms=None)
    return out


def check_maintenance(dev, rng, v, s, w, lens_range):
    """The fused interval on the card (kernels, no host sync allowed)
    against the same interval on the CPU (plain versions), and the
    run_sums helper against its plain version, for ``v`` VMs whose
    windows hold ``lens_range`` requests."""
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

    results = []
    for d in (dev, torch.device("cpu")):
        a = torch.from_numpy(amat).to(d)
        dist, served, _ = reuse.decompose(a, torch.from_numpy(wmat).to(d),
                                          Policy.WB, sizing_reads_only=False)
        ssd = CacheState(*[torch.from_numpy(x).to(d)
                           for x in (tags, lru, dirty)])
        table = pop.table_init(v, 8192, d)
        args = [torch.from_numpy(x).to(d) for x in (lens, ways, t)]
        if d.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
        try:
            counts = []              # 7 count vectors per interval
            for _ in range(3):       # three intervals: table merges + decay
                out = ops.maintenance_interval(
                    ssd, table, dist, served, a, *args, evict_frac=0.05,
                    decay=0.5)
                ssd, table = out[0], out[1]
                counts.extend(out[2:])
        finally:
            if d.type == "cuda":
                torch.cuda.set_sync_debug_mode("default")
        results.append([x.cpu() for x in (*ssd, *table, *counts)])
    max_abs_err(*results)
    promoted = sum(int(x.sum()) for x in results[0][6::7])
    if promoted == 0:
        raise AssertionError("maintenance check promoted nothing")
    log(f"maintenance_interval [{v},{s},{w}] K=8192 x3 intervals: card == "
        f"CPU, no host sync; promoted {promoted}")

    # run_sums helper on the first merge's sorted window
    a = torch.from_numpy(amat).to(dev)
    c = torch.rand(a.shape, device=dev)
    sa, order = torch.sort(a, dim=1, stable=True)
    sc = c.gather(1, order)
    head = torch.ones_like(sa, dtype=torch.bool)
    head[:, 1:] = sa[:, 1:] != sa[:, :-1]
    seg = head.long().cumsum(dim=1) - 1
    got = pop._run_sums_cuda(sa, sc, head, seg)
    cpu = [x.cpu() for x in (sa, sc, head, seg)]
    want = pop._run_sums(*cpu).to(dev)
    err = max_abs_err([got], [want])
    ms = cuda_ms(lambda: pop._run_sums_cuda(sa, sc, head, seg), 50)
    plain_ms = cuda_ms(lambda: pop._run_sums(*cpu), 3)
    b, by = bound_ms(21.0 * sa.numel(), 2.0 * sa.numel())
    log(f"run_sums {list(sa.shape)}: exact, kernel {ms:.4f} ms, plain (CPU) "
        f"{plain_ms:.4f} ms, bound {b:.5f} ms ({by})")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b,
                bound_by=by, library_ms=None)


# ---------------------------------------------------------------------------
# phases 3 and 4: the controller's main path
# ---------------------------------------------------------------------------

def run_controller(cfg, num_vms, trace, device):
    import torch
    from repro_torch.core.controller import EticaCache
    cache = EticaCache(cfg, num_vms, device=device)
    if device != "cpu":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = cache.run(trace)
    if device != "cpu":
        torch.cuda.synchronize()
    return res, time.perf_counter() - t0


def span_breakdown(cfg, num_vms, trace, label):
    """One more card run with span timing on: CUDA-event time of the
    sizing, datapath and maintenance spans (each span waits for its
    work, so this run is slower than the untimed one and its results are
    not reported as the cell's speed)."""
    import dataclasses
    from repro_torch.runtime.telemetry import TelemetryRecorder
    rec = TelemetryRecorder(span_timing=True)
    _, wall = run_controller(dataclasses.replace(cfg, telemetry=rec),
                             num_vms, trace, "cuda")
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


def drive(cfg, num_vms, trace, label):
    """One card run of ``EticaCache.run`` with the launch counts set to 0
    just before and read just after (every kernel must have launched),
    then the same run on the CPU, which must give identical results."""
    import torch
    from repro_torch import kernels
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    res_card, wall = run_controller(cfg, num_vms, trace, "cuda")
    launches = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    log(f"{label} ({len(trace)} requests): card {wall:.3f} s, "
        f"{len(trace) / wall:.0f} requests/s, peak device memory "
        f"{peak / 2**20:.1f} MiB, launches {launches}")
    missing = [k for k, n in launches.items() if n == 0]
    if missing:
        raise AssertionError(f"{label}: kernels not launched: {missing}")
    res_cpu, wall_cpu = run_controller(cfg, num_vms, trace, "cpu")
    assert_same(res_card, res_cpu, label)
    hit = float(np.mean([r.hit_ratio for r in res_card]))
    log(f"{label}: card == CPU (CPU plain path {wall_cpu:.1f} s); avg_hit "
        f"{hit:.4f}, ssd_writes {sum(r.ssd_writes for r in res_card):.0f}")
    return launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from repro_torch import kernels
    from repro_torch.core.controller import EticaConfig

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
    rows = {}
    rows["count_between"] = check_count_between(dev, subs12, "12-VM POD")
    check_count_between(dev, subs1024, "1024-VM POD")
    ways12 = (rng.integers(8, 65, 12), rng.integers(8, 65, 12))
    rows["two_level"] = check_datapath(dev, blocks12 + blocks12b, 64, 64,
                                       ways12, "full", "12-VM", step_ns)
    check_datapath(dev, blocks12 + blocks12b, 64, 64, ways12, "npe",
                   "12-VM", step_ns)
    check_datapath(dev, blocks1024 + blocks1024b, 16, 32,
                   (rng.integers(0, 33, 1024), rng.integers(0, 33, 1024)),
                   "full", "1024-VM", step_ns)
    rows.update(check_scatters(dev, rng, 12, 64, 64))
    check_scatters(dev, rng, 1024, 16, 32)
    rows["run_sums"] = check_maintenance(dev, rng, 12, 64, 64, (600, 1000))
    check_maintenance(dev, rng, 1024, 16, 32, (20, 60))

    # phases 3 and 4: the paper's §5.1 deployment, then fig15
    # consolidation at 128 and 1024 VMs; card == CPU in each
    launches = {}
    cfg = EticaConfig(dram_capacity=8192, ssd_capacity=16384)
    launches["paper-12vm"] = drive(cfg, 12, paper, "paper 12-VM")
    span_breakdown(cfg, 12, paper, "paper 12-VM")
    launches["fig15-128vm"] = drive(fig15_config(128, len(fig128)), 128,
                                    fig128, "fig15 128-VM")
    cfg1024 = fig15_config(1024, len(fig1024))
    launches["fig15-1024vm"] = drive(cfg1024, 1024, fig1024, "fig15 1024-VM")
    span_breakdown(cfg1024, 1024, fig1024, "fig15 1024-VM")
    log(f"fig15 1024-VM avg_hit beside the JAX package's CPU value "
        f"{FIG15_JAX_CPU_AVG_HIT_1024} (benchmarks/BENCH_sharding.json)")

    sources = {"count_between": "src/repro_torch/csrc/count_between.cu",
               "evict_scatter": "src/repro_torch/csrc/evict_scatter.cu",
               "promote_scatter": "src/repro_torch/csrc/promote_scatter.cu",
               "two_level": "src/repro_torch/csrc/datapath.cu",
               "run_sums": "src/repro_torch/csrc/run_sums.cu"}
    replaces = {
        "count_between": "src/repro/kernels/reuse_distance/kernel.py:29",
        "evict_scatter": "src/repro/kernels/maintenance/kernel.py:51",
        "promote_scatter": "src/repro/kernels/maintenance/kernel.py:167",
        "two_level": "src/repro/core/simulator.py:374 (lax.scan step; "
                     "no Pallas kernel)",
        "run_sums": "src/repro/core/popularity.py:204 (_compact_runs "
                    "scatter-add; no Pallas kernel)"}
    log(smi)
    print(json.dumps({"kernels": [
        dict(name=k, route="cuda", source=sources[k], replaces=replaces[k],
             launches=launches["paper-12vm"][k], **rows[k],
             launches_by_path={p: n[k] for p, n in launches.items()})
        for k in kernels.KERNELS]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
