#!/usr/bin/env python3
"""Device time of ``paged_decode_attention``, ``promote_scatter``,
``count_between``, ``evict_scatter``, the cleaner and the wide-row route
of ``run_sums`` and ``popularity`` at the shapes their paths launch, for
one source tree.

Run on a machine with an NVIDIA card and the CUDA toolkit, from the
repository root::

    python3 examples/torch_kernel_timing.py [--src DIR] [--label NAME]

``--src`` (default: this tree's ``src``) is the directory whose
``repro_torch`` package, and so whose kernels, are timed. Two trees are
compared on one card in one run by calling the script in turns, e.g. an
earlier commit unpacked with ``git archive`` under ``build/`` and this
tree: earlier, this, this, earlier.

Shapes (the inputs of ``chip_smoke.py``, from generators of their own):

- decode (a), the serving path's: B 1, H = Hkv = 8, D 128, float32 q,
  bf16 pages of 16 in a 512-page pool, a 6-page table, at lengths of 16,
  48 and 96 tokens (1, 3 and 6 pages);
- decode (b), qwen3-4b batched decode: B 64, H 32, Hkv 8, D 128, bf16,
  256 pages of 16 a row from a 16,384-page pool, lengths in [1, 4096];
- promote, the fused path's: [12, 64, 64], Q 4096, unique, dedupe off;
  the same queue with every address twice, dedupe on (the staged path);
- promote at L2ARC's own calls: every ``promote_scatter`` call of an
  L2ARC run on the paper's 12-VM mix ([1, 256, 64], dedupe on), replayed
  in one CUDA graph (``chip_smoke.check_l2arc_promote``), and run back
  to back through the kernel and through its plain version for the
  call time of each;
- ``count_between`` at the POD rows of the paper's 12-VM first window
  ([12, 1024]) and of fig15's 1024-VM first window, and at every call of
  the sequential 12-VM run ([1, 1024], one VM's row at a time), replayed
  in one CUDA graph (``chip_smoke.replay_count_calls``), and run back
  to back through the kernel and through its plain version;
- ``evict_scatter`` at the fused path's [12, 64, 64], Q 4096, and at the
  1024-VM [1024, 16, 32], Q 512, each queue the bottom 5% of a VM's
  residents then ``-1`` padding (``chip_smoke.evict_queue``);
- the cleaner, ``ops.clean`` whole (whatever a tree runs for it: the
  cutoffs in plain PyTorch and then the kernel, or one launch), at the
  same two states, lru in [0, 64) (ties), random ways and quotas;
- ``run_sums`` and ``popularity`` on ``[5, n]`` rows of
  ``chip_smoke.row_cases`` at n 16,385 and 40,000 (a tree whose kernels
  refuse such rows prints the refusal), each beside its one-call
  PyTorch pair on the same inputs: ``torch.sort(stable=True)`` +
  ``index_add_`` and ``torch.exp`` + ``index_add_`` (call time, and
  device time from a profiler trace).

Device time: ``chip_smoke.graph_ms``, the calls captured in a CUDA graph
and replayed between CUDA events; what a wrapper puts on the device
(copies, zeroed outputs) stays in. Device events a launch from a profiler
trace (``chip_smoke.kernel_events``). Prints one JSON line per shape,
with the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="this tree")
    opts = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs          # puts this tree's src on the path
    sys.path.insert(0, opts.src)     # ahead of it: the tree to time
    import torch
    if not torch.cuda.is_available():
        print("torch_kernel_timing: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch import kernels
    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.kernels.maintenance import ops as mops
    from repro_torch.kernels.reuse_distance import ops as rops
    if not Path(kernels.__file__).resolve().is_relative_to(
            Path(opts.src).resolve()):
        raise RuntimeError(f"repro_torch came from {kernels.__file__}")
    kernels.library()
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]

    def emit(**row):
        print(json.dumps(dict(tree=opts.label, card=smi, **row)), flush=True)

    def events(fn):
        return cs.device_profile(fn, 20)[1]

    def per_call_ms(fn, calls):
        """Mean ms of one of ``calls``, all run back to back (host
        included) between CUDA events."""
        def run():
            for c in calls:
                fn(*c)
        return cs.cuda_ms(run, 1) / len(calls)

    rng = np.random.default_rng(19)
    f32, bf16 = torch.float32, torch.bfloat16
    for n_tok in (16, 48, 96):
        args = cs.decode_inputs(dev, rng, 1, 8, 8, 128, 512, 16, 6, f32,
                                bf16, [n_tok])
        call = lambda: dops.paged_decode_attention(*args)  # noqa: E731
        emit(kernel="paged_decode_attention", shape=f"(a) {n_tok} tokens",
             device_ms=cs.graph_ms(call), call_ms=cs.cuda_ms(call, 50),
             events_per_call=events(call), bound_ms=cs.decode_bound(args)[0])
    b_, h_, hkv, d, pool, ps, n_pages = cs.QWEN3_DECODE
    lens = rng.integers(1, n_pages * ps + 1, b_)
    lens[:2] = (1, n_pages * ps)
    args = cs.decode_inputs(dev, rng, *cs.QWEN3_DECODE, bf16, bf16, lens)
    call = lambda: dops.paged_decode_attention(*args)  # noqa: E731
    emit(kernel="paged_decode_attention", shape="(b) qwen3-4b batched",
         tokens=int(lens.sum()), device_ms=cs.graph_ms(call, 10),
         call_ms=cs.cuda_ms(call, 20), events_per_call=events(call),
         bound_ms=cs.decode_bound(args)[0])
    del args

    v, s, w = 12, 64, 64
    q = 4096
    tags, lru, dirty = cs.random_state(rng, v, s, w)
    pqueue = np.full((v, q), -1, np.int32)
    for i in range(v):
        res = tags[i][tags[i] >= 0]
        fresh = np.setdiff1d(np.arange(4 * w * s), res)
        m = min(q - 64, fresh.size)
        pq = np.concatenate([rng.choice(fresh, m, replace=False),
                             rng.choice(res, 64, replace=False)])
        pqueue[i, :pq.size] = rng.permutation(pq)
    dq = np.stack([rng.permutation(np.concatenate([r[:q // 2], r[:q // 2]]))
                   for r in pqueue])
    ways = rng.integers(8, w + 1, v).astype(np.int32)
    t = rng.integers(10_000, 20_000, v).astype(np.int32)
    st = [torch.from_numpy(x).to(dev) for x in (tags, lru, dirty)]
    tail = [torch.from_numpy(x).to(dev) for x in (ways, t)]
    for label, queue, dedupe in (("unique, dedupe off", pqueue, False),
                                 ("each address twice, dedupe on", dq,
                                  True)):
        qt = torch.from_numpy(queue).to(dev)
        call = lambda: mops.promote_scatter(  # noqa: E731
            *st, qt, *tail, dedupe=dedupe)
        emit(kernel="promote_scatter", shape=f"[{v},{s},{w}] Q {q}, {label}",
             device_ms=cs.graph_ms(call), call_ms=cs.cuda_ms(call, 50),
             events_per_call=cs.kernel_events(call, "promote_kernel", None))
    paper = cs.trace_mix(cs.paper_config().vms, 20_000, 1.0)
    l2 = cs.check_l2arc_promote(paper, want_events=None)
    l2_calls = [c[:6] for c in cs.l2arc_promote_calls(paper)]
    emit(kernel="promote_scatter", shape="L2ARC's calls [1,256,64], dedupe",
         calls=l2["calls"], device_ms=l2["device_ms_per_call"],
         device_ms_run=l2["device_ms_total"],
         bound_ms_run=l2["bound_ms_total"], loss_ms_run=l2["loss_ms"],
         events_per_call=l2["events_per_call"],
         call_ms=per_call_ms(mops.promote_scatter, l2_calls),
         plain_ms=per_call_ms(mops.promote_scatter_plain, l2_calls))

    fig1024 = cs.trace_mix((cs.FIG15_WORKLOADS * 64)[:1024], 150, 0.25)
    subs12, _ = cs.first_blocks(paper, 12, 10_000, 1_000, 0)
    subs1024, _ = cs.first_blocks(fig1024, 1024, len(fig1024) // 3,
                                  len(fig1024) // 12, 0)
    for label, subs in (("12-VM POD", subs12), ("1024-VM POD", subs1024)):
        rows = cs.pod_rows(dev, subs)
        call = lambda: rops.count_between(*rows)  # noqa: E731
        emit(kernel="count_between",
             shape=f"{label} [{rows[0].shape[0]},{rows[0].shape[1]}]",
             device_ms=cs.graph_ms(call), call_ms=cs.cuda_ms(call, 50),
             events_per_call=cs.kernel_events(call, "count_between_kernel",
                                              None),
             bound_ms=cs.count_bound(rows[0])[0])
    seq_calls = cs.seq_count_calls(paper)
    seq = cs.replay_count_calls(seq_calls)
    emit(kernel="count_between", shape="paper-12vm-seq's calls [1,1024]",
         calls=seq["calls"], device_ms=seq["device_ms_per_call"],
         device_ms_run=seq["device_ms_total"],
         bound_ms_run=seq["bound_ms_total"], loss_ms_run=seq["loss_ms"],
         call_ms=per_call_ms(rops.count_between, seq_calls),
         plain_ms=per_call_ms(rops.count_between_plain, seq_calls))

    for v, s, w, q in ((12, 64, 64, 4096), (1024, 16, 32, 512)):
        tags, lru, dirty = cs.random_state(rng, v, s, w)
        st = [torch.from_numpy(x).to(dev) for x in (tags, lru, dirty)]
        eq = torch.from_numpy(cs.evict_queue(rng, tags, q)).to(dev)
        call = lambda: mops.evict_scatter(*st, eq)  # noqa: E731
        emit(kernel="evict_scatter", shape=f"[{v},{s},{w}] Q {q}",
             live_entries=int((eq >= 0).sum()),
             device_ms=cs.graph_ms(call), call_ms=cs.cuda_ms(call, 50),
             events_per_call=cs.kernel_events(call, "evict_kernel", None),
             bound_ms=cs.bound_ms(18.0 * v * s * w + 4.0 * v * q + 4.0 * v,
                                  2.0 * (v * s * w + v * q))[0])

    from repro_torch.core import popularity as pop
    from repro_torch.core.simulator import CacheState
    from repro_torch.kernels.popularity import ops as pops
    for v, s, w in ((12, 64, 64), (1024, 16, 32)):
        tags, lru, dirty = cs.random_state(rng, v, s, w)
        lru = np.where(tags >= 0, rng.integers(0, 64, tags.shape),
                       -1).astype(np.int32)
        st = CacheState(*[torch.from_numpy(x).to(dev)
                          for x in (tags, lru, dirty)])
        ways = torch.from_numpy(rng.integers(0, w + 1, v).astype(
            np.int32)).to(dev)
        quota = torch.from_numpy(rng.integers(0, 2 * s * w // 3, v).astype(
            np.int32)).to(dev)
        call = lambda: mops.clean(st, ways, quota)  # noqa: E731
        emit(kernel="clean", shape=f"[{v},{s},{w}]",
             device_ms=cs.graph_ms(call), call_ms=cs.cuda_ms(call, 50),
             events_per_call=events(call),
             bound_ms=cs.bound_ms(6.0 * v * s * w + 32.0 * v, 0.0)[0])

    for n in (16_385, 40_000):
        v = 5
        addr, nv = cs.row_cases(rng, v, n)
        wa = torch.from_numpy(addr).to(dev)
        wc = torch.rand((v, n), device=dev)
        nvt = torch.from_numpy(nv).to(dev)
        per = int(addr.max()) + 1
        seg = (wa + per * torch.arange(v, device=dev)[:, None]).to(
            torch.int32)
        seg[2] = v * per
        pargs = (torch.from_numpy(rng.integers(-1, 300, (v, n)).astype(
                     np.int32)).to(dev),
                 torch.from_numpy(rng.random((v, n)) < 0.7).to(dev), seg,
                 v * per, torch.full((v,), 64.0, device=dev))
        for name, call, nbytes in (
                ("run_sums", lambda: pop.window_runs(wa, wc, nvt),
                 16.0 * v * n + 4.0 * v),
                ("popularity", lambda: pops.popularity_rows(*pargs),
                 9.0 * v * n + 4.0 * v + 4.0 * v * per)):
            try:
                call()
            except ValueError as e:
                emit(kernel=name, shape=f"[{v},{n}]", refused=str(e))
                continue
            emit(kernel=name, shape=f"[{v},{n}]",
                 device_ms=cs.graph_ms(call, reps=5, replays=4),
                 call_ms=cs.cuda_ms(call, 20), events_per_call=events(call),
                 bound_ms=cs.bound_ms(nbytes, 2.0 * float(nv.sum()))[0])
        # the one-call PyTorch pairs beside them, as chip_smoke.py times
        # them: the stable sort that groups the window and index_add_
        # into each entry's run slot; Eq. 1's contributions by torch.exp
        # and index_add_ into the blocks
        library = cs.row_library_calls(wa, wc, pargs)
        for name, call in (("run_sums library: torch.sort(stable) + "
                            "index_add_", library["run_sums"]),
                           ("popularity library: torch.exp + index_add_",
                            library["popularity"])):
            dev_ms, ev = cs.device_profile(call, 20)
            emit(kernel=name, shape=f"[{v},{n}]",
                 call_ms=cs.cuda_ms(call, 20), profiler_device_ms=dev_ms,
                 events_per_call=ev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
