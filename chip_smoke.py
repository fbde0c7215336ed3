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
   device time alone, replaying a CUDA graph of the calls); runs
   the fused maintenance interval, with and without the cleaner, under
   ``torch.cuda.set_sync_debug_mode("error")``;
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
7. runs ECI-Cache at the fig15 1024-VM configuration, card == CPU.

Each card run of phases 3 to 7 sets the launch counts to 0 just before
and reads them just after; every kernel of that path's own set must
have launched. Phase 2 holds the kernels against their plain versions
at the shapes of both the 12-VM and the 1024-VM runs.

The line before the last is ``{"kernels": [...]}`` (one entry per
kernel, ``launches`` from its own 12-VM path); the last is ``{"ok":
true, "device": {...}}``. Any failed phase raises and the exit code is
nonzero. Without a CUDA device it exits 2 and prints no result.
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

# the kernels each path must launch
ETICA_KERNELS = ("count_between", "evict_scatter", "promote_scatter",
                 "two_level", "run_sums")
CLEAN_KERNELS = ETICA_KERNELS + ("clean_scatter",)
ECI_KERNELS = ("count_between", "single_level")


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
    dev_ms = graph_ms(lambda: ops.count_between(prev, touch, nt))
    plain_ms = cuda_ms(lambda: ops.count_between_plain(prev, touch, nt), 3)
    v, n = prev.shape
    i = torch.arange(n, device=dev)[None, :]
    pairs = float((i - prev.long() - 1).clamp(min=0).sum())
    b, by = bound_ms(13.0 * v * n, 2.0 * pairs)
    log(f"count_between {label} [{v},{n}]: exact, kernel {ms:.4f} ms "
        f"(device {dev_ms:.4f} ms), plain {plain_ms:.4f} ms, bound "
        f"{b:.5f} ms ({by}), pairs {pairs:.0f}")
    return dict(max_abs_err=err, ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                bound_ms=b, bound_by=by, library_ms=None)


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
    dev_ms = graph_ms(lambda: ops.two_level(*timed, npe=npe), 10)
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
        f"{len(blocks)} blocks, kernel {ms:.4f} ms (device {dev_ms:.4f} "
        f"ms), plain {plain_ms:.2f} ms, bound {b:.5f} ms ({by}), "
        f"{valid:.0f} valid requests, longest same-set chain {chain} x "
        f"{step_ns:.2f} ns = chain bound {chain_b:.5f} ms")
    return dict(max_abs_err=err, ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                bound_ms=b, bound_by=by, library_ms=None,
                chain_bound_ms=chain_b)


def check_single_level(dev, rng, blocks, sets, ways_max, label, step_ns):
    """``single_level`` against its plain version over chained blocks,
    every VM under a random one of the five policies (each present)."""
    import torch
    from repro_torch.core.policies import T_SSD, Policy
    from repro_torch.core.simulator import make_cache_batch, policy_flags
    from repro_torch.kernels.datapath import ops
    v = blocks[0][0].shape[0]
    pols = list(Policy) + [Policy(p) for p in rng.choice(
        [p.value for p in Policy], v - len(Policy))]
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
    ms = cuda_ms(lambda: ops.single_level(*timed, **kw), 20)
    dev_ms = graph_ms(lambda: ops.single_level(*timed, **kw), 10)
    plain_ms = cuda_ms(lambda: ops.single_level_plain(*timed, **kw), 1,
                       warmup=0)
    a = timed[0]
    n = a.shape[1]
    valid = float((a >= 0).sum())
    b, by = bound_ms(5.0 * v * n + 2 * 9.0 * v * sets * ways_max + 52.0 * v,
                     valid * 2 * ways_max)
    chain = longest_set_chain(a, sets)
    chain_b = chain * step_ns * 1e-6
    log(f"single_level {label} [{v},{n}] {sets}x{ways_max}: exact over "
        f"{len(blocks)} blocks, kernel {ms:.4f} ms (device {dev_ms:.4f} "
        f"ms), plain {plain_ms:.2f} ms, bound {b:.5f} ms ({by}), "
        f"{valid:.0f} valid requests, longest same-set chain {chain} x "
        f"{step_ns:.2f} ns = chain bound {chain_b:.5f} ms")
    return dict(max_abs_err=err, ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                bound_ms=b, bound_by=by, library_ms=None,
                chain_bound_ms=chain_b)


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
    dev_ms = graph_ms(lambda: ops.evict_scatter(*st, eq))
    plain_ms = cuda_ms(lambda: ops.evict_scatter_plain(*st, eq), 10)
    vm = torch.arange(v, device=dev, dtype=torch.int64)
    tk = (st[0].long() + (vm << 32)[:, None, None]).reshape(-1)
    qk = (eq.long() + (vm << 32)[:, None]).reshape(-1)
    lib_ms = cuda_ms(lambda: torch.isin(tk, qk), 50)
    b, by = bound_ms(2 * 9.0 * v * s * w + 4.0 * v * q + 4.0 * v,
                     2.0 * (v * s * w + v * q))
    log(f"evict_scatter [{v},{s},{w}] Q={q}: exact, flushed "
        f"{int(got[3].sum())}, kernel {ms:.4f} ms (device {dev_ms:.4f} ms), "
        f"plain {plain_ms:.4f} ms, torch.isin {lib_ms:.4f} ms (it cannot "
        f"be captured in a CUDA graph), bound {b:.5f} ms ({by})")
    out["evict_scatter"] = dict(max_abs_err=err, ms=ms, device_ms=dev_ms,
                                plain_ms=plain_ms, bound_ms=b, bound_by=by,
                                library_ms=lib_ms)

    got = ops.promote_scatter(*st, pq, ways_t, t_t)
    want = ops.promote_scatter_plain(*st, pq, ways_t, t_t)
    err = max_abs_err(got, want)
    ms = cuda_ms(lambda: ops.promote_scatter(*st, pq, ways_t, t_t), 50)
    dev_ms = graph_ms(lambda: ops.promote_scatter(*st, pq, ways_t, t_t))
    plain_ms = cuda_ms(
        lambda: ops.promote_scatter_plain(*st, pq, ways_t, t_t), 10)
    b, by = bound_ms(2 * 9.0 * v * s * w + 4.0 * v * q + 12.0 * v,
                     2.0 * (v * s * w + v * q))
    log(f"promote_scatter [{v},{s},{w}] Q={q}: exact, promoted "
        f"{int(got[3].sum())}, kernel {ms:.4f} ms (device {dev_ms:.4f} ms), "
        f"plain {plain_ms:.4f} ms, bound {b:.5f} ms ({by})")
    out["promote_scatter"] = dict(max_abs_err=err, ms=ms, device_ms=dev_ms,
                                  plain_ms=plain_ms, bound_ms=b, bound_by=by,
                                  library_ms=None)
    return out


def check_clean(dev, rng, v, s, w):
    """``clean_scatter`` against its plain version, with random ways,
    random quotas and the cutoffs ``_clean_cutoffs`` gives them."""
    import torch
    from repro_torch.kernels.maintenance import ops
    tags, lru, dirty = random_state(rng, v, s, w)
    lru = np.where(tags >= 0, rng.integers(0, 64, tags.shape), -1)  # ties
    ways = torch.as_tensor(rng.integers(0, w + 1, v), dtype=torch.int32,
                           device=dev)
    quota = torch.as_tensor(rng.integers(0, 2 * s * w // 3, v),
                            dtype=torch.int32, device=dev)
    d = torch.from_numpy(dirty).to(dev)
    l = torch.from_numpy(lru.astype(np.int32)).to(dev)
    lcut, icut, take, _ = ops._clean_cutoffs(d, l, ways, quota)
    args = (d, l, ways, lcut, icut)
    got = ops.clean_scatter(*args)
    err = max_abs_err(got, ops.clean_scatter_plain(*args))
    if not torch.equal(got[1], take):
        raise AssertionError("clean_scatter flushed other than the quota")
    ms = cuda_ms(lambda: ops.clean_scatter(*args), 50)
    dev_ms = graph_ms(lambda: ops.clean_scatter(*args))
    plain_ms = cuda_ms(lambda: ops.clean_scatter_plain(*args), 10)
    cut_ms = cuda_ms(lambda: ops._clean_cutoffs(d, l, ways, quota), 10)
    b, by = bound_ms(6.0 * v * s * w + 16.0 * v, 4.0 * v * s * w)
    log(f"clean_scatter [{v},{s},{w}]: exact, flushed {int(got[1].sum())}, "
        f"kernel {ms:.4f} ms (device {dev_ms:.4f} ms), plain "
        f"{plain_ms:.4f} ms, bound {b:.5f} ms ({by}); _clean_cutoffs (two "
        f"stable sorts, plain torch) {cut_ms:.4f} ms")
    return dict(max_abs_err=err, ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                bound_ms=b, bound_by=by, library_ms=None)


def check_maintenance(dev, rng, v, s, w, lens_range):
    """The fused interval on the card (kernels, no host sync allowed)
    against the same interval on the CPU (plain versions), without and
    with the cleaner, and the run_sums helper against its plain version,
    for ``v`` VMs whose windows hold ``lens_range`` requests."""
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
    dev_ms = graph_ms(lambda: pop._run_sums_cuda(sa, sc, head, seg))
    plain_ms = cuda_ms(lambda: pop._run_sums(*cpu), 3)
    # the same per-run sum as one library call, in atomics' order
    flat = (seg + torch.arange(sa.shape[0], device=dev)[:, None]
            * sa.shape[1]).reshape(-1)
    vals = sc.reshape(-1)

    def index_add():
        return torch.zeros(sa.numel(), device=dev).index_add_(0, flat, vals)
    lib_ms = cuda_ms(index_add, 50)
    lib_dev_ms = graph_ms(index_add)
    b, by = bound_ms(21.0 * sa.numel(), 2.0 * sa.numel())
    log(f"run_sums {list(sa.shape)}: exact, kernel {ms:.4f} ms (device "
        f"{dev_ms:.4f} ms), plain (CPU) {plain_ms:.4f} ms, index_add_ "
        f"{lib_ms:.4f} ms (device {lib_dev_ms:.4f} ms), bound {b:.5f} ms "
        f"({by})")
    return dict(max_abs_err=err, ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                bound_ms=b, bound_by=by, library_ms=lib_ms,
                library_device_ms=lib_dev_ms)


# ---------------------------------------------------------------------------
# phases 3 to 7: the controllers' paths
# ---------------------------------------------------------------------------

def etica(cfg, num_vms):
    """A builder ``(device, telemetry=None) -> EticaCache``."""
    import dataclasses
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


def span_breakdown(build, trace, label):
    """One more card run with span timing on: CUDA-event time of the
    sizing, datapath and maintenance spans (each span waits for its
    work, so this run is slower than the untimed one and its results are
    not reported as the cell's speed)."""
    from repro_torch.runtime.telemetry import TelemetryRecorder
    rec = TelemetryRecorder(span_timing=True)
    _, _, wall = run_controller(build, trace, "cuda", rec)
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
    set to 0 just before and read just after (every kernel in
    ``expect`` must have launched), then the same run on the CPU, which
    must give identical results. Returns ``(launches, cache, results)``
    of the card run."""
    import torch
    from repro_torch import kernels
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    cache, res_card, wall = run_controller(build, trace, "cuda")
    launches = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    log(f"{label} ({len(trace)} requests): card {wall:.3f} s, "
        f"{len(trace) / wall:.0f} requests/s, peak device memory "
        f"{peak / 2**20:.1f} MiB, launches {launches}")
    missing = [k for k in expect if launches[k] == 0]
    if missing:
        raise AssertionError(f"{label}: kernels not launched: {missing}")
    _, res_cpu, wall_cpu = run_controller(build, trace, "cpu")
    assert_same(res_card, res_cpu, label)
    hit = float(np.mean([r.hit_ratio for r in res_card]))
    log(f"{label}: card == CPU (CPU plain path {wall_cpu:.1f} s); avg_hit "
        f"{hit:.4f}, ssd_writes {sum(r.ssd_writes for r in res_card):.0f}")
    return launches, cache, res_card


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
    import dataclasses
    from repro_torch.core.controller import EticaConfig, Geometry
    from repro_torch.runtime import metrics
    trace = trace_mix(FIG14_VMS, scale_reqs, 0.25)
    geo = Geometry(num_sets=16, max_ways=32)
    cfg = EticaConfig(dram_capacity=400, ssd_capacity=800,
                      geometry_dram=geo, geometry_ssd=geo,
                      resize_interval=2_000, promo_interval=500)
    n = len(FIG14_VMS)
    launches["fig14-etica"], _, e_res = drive(
        etica(cfg, n), trace, "fig14 ETICA", ETICA_KERNELS)
    launches["fig14-eci"], _, c_res = drive(
        eci(1200, n, geometry=geo, resize_interval=2_000), trace,
        "fig14 ECI-Cache", ECI_KERNELS)
    ccfg = dataclasses.replace(cfg, clean_quota=CLEAN_QUOTA)
    launches["fig14-etica-clean"], clean, cl_res = drive(
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


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
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
    rows["single_level"] = check_single_level(
        dev, rng, blocks12 + blocks12b, 64, 64, "12-VM", step_ns)
    check_single_level(dev, rng, blocks1024 + blocks1024b, 16, 32,
                       "1024-VM", step_ns)
    rows.update(check_scatters(dev, rng, 12, 64, 64))
    check_scatters(dev, rng, 1024, 16, 32)
    rows["clean_scatter"] = check_clean(dev, rng, 12, 64, 64)
    check_clean(dev, rng, 1024, 16, 32)
    rows["run_sums"] = check_maintenance(dev, rng, 12, 64, 64, (600, 1000))
    check_maintenance(dev, rng, 1024, 16, 32, (20, 60))

    # phases 3 and 4: the paper's §5.1 deployment, then fig15
    # consolidation at 128 and 1024 VMs; card == CPU in each
    launches = {}
    cfg = EticaConfig(dram_capacity=8192, ssd_capacity=16384)
    launches["paper-12vm"], _, paper_res = drive(
        etica(cfg, 12), paper, "paper 12-VM", ETICA_KERNELS)
    span_breakdown(etica(cfg, 12), paper, "paper 12-VM")
    launches["fig15-128vm"], _, _ = drive(
        etica(fig15_config(128, len(fig128)), 128), fig128, "fig15 128-VM",
        ETICA_KERNELS)
    build1024 = etica(fig15_config(1024, len(fig1024)), 1024)
    launches["fig15-1024vm"], _, _ = drive(build1024, fig1024,
                                           "fig15 1024-VM", ETICA_KERNELS)
    span_breakdown(build1024, fig1024, "fig15 1024-VM")
    log(f"fig15 1024-VM avg_hit beside the JAX package's CPU value "
        f"{FIG15_JAX_CPU_AVG_HIT_1024} (benchmarks/BENCH_sharding.json)")

    # phase 5: the 12-VM deployment under the endurance comparison
    ccfg = EticaConfig(dram_capacity=8192, ssd_capacity=16384,
                       clean_quota=CLEAN_QUOTA)
    launches["paper-12vm-clean"], clean, _ = drive(
        etica(ccfg, 12), paper, "paper 12-VM ETICA clean_quota=4",
        CLEAN_KERNELS)
    span_breakdown(etica(ccfg, 12), paper, "paper 12-VM ETICA clean")
    geo64 = Geometry(num_sets=64, max_ways=64)
    build_eci = eci(8192 + 16384, 12, geometry=geo64,
                    resize_interval=10_000)
    launches["paper-12vm-eci"], _, eci_res = drive(
        build_eci, paper, "paper 12-VM ECI-Cache", ECI_KERNELS)
    span_breakdown(build_eci, paper, "paper 12-VM ECI-Cache")
    endurance("paper 12-VM", paper_res, eci_res, clean)

    # phase 6: fig14's own mix, held to the JAX package's CPU values
    check_fig14(launches)

    # phase 7: ECI-Cache at the fig15 1024-VM configuration
    total = len(fig1024)
    launches["fig15-1024vm-eci"], _, _ = drive(
        eci(37 * 1024, 1024, geometry=Geometry(num_sets=16, max_ways=32),
            resize_interval=total // 3, sim_chunk=total // 12),
        fig1024, "fig15 1024-VM ECI-Cache", ECI_KERNELS)

    sources = {"count_between": "src/repro_torch/csrc/count_between.cu",
               "evict_scatter": "src/repro_torch/csrc/evict_scatter.cu",
               "promote_scatter": "src/repro_torch/csrc/promote_scatter.cu",
               "clean_scatter": "src/repro_torch/csrc/clean_scatter.cu",
               "two_level": "src/repro_torch/csrc/datapath.cu",
               "single_level": "src/repro_torch/csrc/single_level.cu",
               "run_sums": "src/repro_torch/csrc/run_sums.cu"}
    replaces = {
        "count_between": "src/repro/kernels/reuse_distance/kernel.py:29",
        "evict_scatter": "src/repro/kernels/maintenance/kernel.py:51",
        "promote_scatter": "src/repro/kernels/maintenance/kernel.py:167",
        "clean_scatter": "src/repro/kernels/maintenance/kernel.py:110",
        "two_level": "src/repro/core/simulator.py:374 (lax.scan step; "
                     "no Pallas kernel)",
        "single_level": "src/repro/core/simulator.py:264 (lax.scan step; "
                        "no Pallas kernel)",
        "run_sums": "src/repro/core/popularity.py:204 (_compact_runs "
                    "scatter-add; no Pallas kernel)"}
    # each kernel's own 12-VM path: the one whose launches it reports
    own_path = dict.fromkeys(kernels.KERNELS, "paper-12vm")
    own_path.update(clean_scatter="paper-12vm-clean",
                    single_level="paper-12vm-eci")
    log(smi)
    print(json.dumps({"kernels": [
        dict(name=k, route="cuda", source=sources[k], replaces=replaces[k],
             launches=launches[own_path[k]][k], path=own_path[k], **rows[k],
             launches_by_path={p: n[k] for p, n in launches.items()})
        for k in kernels.KERNELS]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
