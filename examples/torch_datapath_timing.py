#!/usr/bin/env python3
"""Device time of the datapath kernels, ``two_level`` and ``single_level``,
at the shapes their paths launch, for one source tree.

Run on a machine with an NVIDIA card and the CUDA toolkit, from the
repository root::

    python3 examples/torch_datapath_timing.py [--src DIR] [--label NAME]

``--src`` (default: this tree's ``src``) is the directory whose
``repro_torch`` package, and so whose kernels, are timed. Two trees are
compared on one card in one run by calling the script in turns, e.g. an
earlier commit unpacked with ``git archive`` under ``build/`` and this
tree: earlier, this, this, earlier.

Shapes, each the second block of a run on the state the first left (the
traces and blocks of ``chip_smoke.py``):

- ``12-VM``: [12, 1000], 64 x 64 (paper-12vm; single_level as
  paper-12vm-eci);
- ``1024-VM``: fig15's 1024-VM run, [1024, 12800], 16 x 32;
- ``V=1 seq``: VM 0's block alone, [1, 1000], 64 x 64 (the sequential
  modes, one launch per VM);
- ``V=1 stream``: the stream's 1,000-request window, [1, 1000], 256 x 64
  (FAST in npe mode, L2ARC in full mode).

Device time: ``chip_smoke.graph_ms``, 10 calls captured in a CUDA graph
and replayed between CUDA events; what a wrapper puts on the device
(state copies, outputs) stays in. At V = 1 also a call's time back to
back (host included) and the plain version's. Prints one JSON line per
shape, with the card's name and power limit. Where the tree has the
IO classifier's ``classified`` routes, each shape also times them
(``"route": "classified"``), with ``chip_smoke.kernel_classes``' four
classes drawn at random for each request and, at one level, the five
policies mixed across (VM, class).

``--diagnose`` adds, at the 12-VM shape, what the classified routes'
cost is made of: each route with ``kernel_classes``' four classes and
with one match-all class (C = 1: every request served, no bypass, the
whole active range), on the blocks as drawn (64 sets) and with every
request moved to set 0 (``chip_smoke.one_set``: one chain a VM), each
beside the unclassified route (at one level under class 0's policies);
then ptxas's registers and spills of every walk kernel
(``chip_smoke.ptxas_by_kernel``) and the SASS of their request steps
(``chip_smoke.sass_walk_steps``: static instructions, shared atomics,
shuffles and shared loads of each innermost loop that holds a warp
reduction).
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
    ap.add_argument("--diagnose", action="store_true",
                    help="also the classified routes' cost breakdown")
    opts = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs          # puts this tree's src on the path
    sys.path.insert(0, opts.src)     # ahead of it: the tree to time
    import torch
    if not torch.cuda.is_available():
        print("torch_datapath_timing: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch import kernels
    from repro_torch.core.policies import T_SSD, Policy
    from repro_torch.core.simulator import make_cache_batch, policy_flags
    from repro_torch.kernels.datapath import ops
    if not kernels.__file__.startswith(str(Path(opts.src).resolve())):
        raise RuntimeError(f"repro_torch came from {kernels.__file__}")
    kernels.library()
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]

    def v1_times(v, call, plain) -> dict:
        """At V = 1 (the per-VM and one-stream shapes): a call back to
        back with the host's share, and the plain version's call."""
        if v != 1:
            return {}
        return dict(call_ms=cs.cuda_ms(call, 50),
                    plain_ms=cs.cuda_ms(plain, 1, warmup=0))

    paper = cs.trace_mix(cs.paper_config().vms, 20_000, 1.0)
    fig = cs.trace_mix((cs.FIG15_WORKLOADS * 64)[:1024], 150, 0.25)
    b12 = [cs.first_blocks(paper[w0:], 12, 10_000, 1_000, 1)[1][0]
           for w0 in (0, 10_000)]
    win = len(fig) // 3
    b1024 = [cs.first_blocks(fig[w0:], 1024, win, len(fig) // 12, 1)[1][0]
             for w0 in (0, win)]
    seq = [(a[:1], w[:1]) for a, w in b12]
    stream = cs.stream_blocks(paper, 1_000, 2)
    rng = np.random.default_rng(0)
    cases = [("12-VM", b12, 64, 64, rng.integers(8, 65, (2, 12)), "full"),
             ("1024-VM", b1024, 16, 32, rng.integers(0, 33, (2, 1024)),
              "full"),
             ("V=1 seq", seq, 64, 64, [[37], [52]], "full"),
             ("V=1 stream", stream, 256, 64, [[32], [64]], "full"),
             ("V=1 stream", stream, 256, 64, [[32], [64]], "npe")]
    for name, blk, sets, ways_max, ways, mode in cases:
        v = blk[0][0].shape[0]
        wd, ws = (torch.as_tensor(np.asarray(x), dtype=torch.int32,
                                  device=dev) for x in ways)
        (a0, w0), (a1, w1) = [(torch.from_numpy(a).to(dev),
                               torch.from_numpy(w).to(dev)) for a, w in blk]
        t0 = torch.zeros(v, dtype=torch.int32, device=dev)
        row = dict(tree=opts.label, shape=name, v=v, n=int(a1.shape[1]),
                   geometry=[sets, ways_max], card=smi)
        st = (*make_cache_batch(v, sets, ways_max, dev),
              *make_cache_batch(v, sets, ways_max, dev))
        out = ops.two_level(a0, w0, *st, wd, ws, t0, npe=mode == "npe")
        args = (a1, w1, *out[:6], wd, ws, out[8])
        npe = mode == "npe"
        ms = cs.graph_ms(lambda: ops.two_level(*args, npe=npe), 10)
        print(json.dumps(dict(row, kernel="two_level", mode=mode,
                              device_ms=ms, **v1_times(
                                  v, lambda: ops.two_level(*args, npe=npe),
                                  lambda: ops.two_level_plain(*args,
                                                              npe=npe)))),
              flush=True)
        classified = hasattr(ops, "two_level_classified")
        if classified:
            clf = cs.kernel_classes()
            cl = torch.from_numpy(rng.integers(
                0, clf.num_classes, a1.shape).astype(np.int32)).to(dev)
            byp = torch.from_numpy(clf.bypass).to(dev)
            bounds = [torch.from_numpy(x).to(dev) for w in ways
                      for x in clf.way_bounds(np.asarray(w, np.int32))]
            cargs = (a1, w1, cl, *out[:6], wd, ws, out[8], byp, *bounds)
            call = lambda: ops.two_level_classified(*cargs, npe=npe)
            print(json.dumps(dict(
                row, kernel="two_level", route="classified", mode=mode,
                device_ms=cs.graph_ms(call, 10), **v1_times(
                    v, call, lambda: ops.two_level_classified_plain(
                        *cargs, npe=npe)))), flush=True)
        if name == "V=1 stream":
            continue
        flags = policy_flags([list(Policy)[k % 5] for k in range(v)], dev)
        out = ops.single_level(a0, w0, *make_cache_batch(v, sets, ways_max,
                                                         dev),
                               wd, *flags, t0, t_cache=T_SSD)
        sargs = (a1, w1, *out[:3], wd, *flags, out[5])
        ms = cs.graph_ms(lambda: ops.single_level(*sargs, t_cache=T_SSD), 10)
        print(json.dumps(dict(row, kernel="single_level",
                              mode="mixed policies", device_ms=ms,
                              **v1_times(v, lambda: ops.single_level(
                                  *sargs, t_cache=T_SSD),
                                  lambda: ops.single_level_plain(
                                      *sargs, t_cache=T_SSD)))),
              flush=True)
        if classified:
            fl = cs.random_policy_flags(rng, v, clf.num_classes, dev)
            cargs = (a1, w1, cl, *out[:3], wd, *fl, out[5], byp,
                     *bounds[:2])
            call = lambda: ops.single_level_classified(*cargs,
                                                       t_cache=T_SSD)
            print(json.dumps(dict(
                row, kernel="single_level", route="classified",
                mode="mixed policies", device_ms=cs.graph_ms(call, 10),
                **v1_times(v, call,
                           lambda: ops.single_level_classified_plain(
                               *cargs, t_cache=T_SSD)))), flush=True)
    if opts.diagnose:
        diagnose(cs, ops, b12, smi, opts.label, dev)
    return 0


def diagnose(cs, ops, b12, smi, label, dev) -> None:
    """The classified routes at [12, 1000], 64 x 64: C = 4 and C = 1
    (match-all), 64 sets and one set, beside the unclassified route; then
    ptxas and the SASS of the walk kernels (see the module docstring)."""
    import torch
    from repro_torch.core.policies import T_SSD
    from repro_torch.core.simulator import make_cache_batch
    put = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    rng = np.random.default_rng(1)
    ways = [rng.integers(8, 65, 12).astype(np.int32) for _ in range(2)]
    wd, ws = put(ways[0]), put(ways[1])
    clf = cs.kernel_classes()
    four = dict(byp=put(clf.bypass), bounds=[put(x) for w in ways
                                             for x in clf.way_bounds(w)])
    zero = torch.zeros((12, 1), dtype=torch.int32, device=dev)
    one = dict(byp=torch.zeros(1, dtype=torch.bool, device=dev),
               bounds=[zero, wd[:, None].contiguous(), zero,
                       ws[:, None].contiguous()])
    flags4 = cs.random_policy_flags(rng, 12, clf.num_classes, dev)
    for sets_name, blocks in (("64 sets", b12),
                              ("one set", cs.one_set(b12, 64))):
        (a0, w0), (a1, w1) = [(put(a), put(w)) for a, w in blocks]
        t0 = torch.zeros(12, dtype=torch.int32, device=dev)
        cl4 = put(rng.integers(0, clf.num_classes, a1.shape).astype(np.int32))
        cl1 = torch.zeros(a1.shape, dtype=torch.int32, device=dev)
        row = dict(tree=label, shape="12-VM", sets=sets_name, card=smi)
        for mode in ("full", "npe"):
            npe = mode == "npe"
            st = (*make_cache_batch(12, 64, 64, dev),
                  *make_cache_batch(12, 64, 64, dev))
            out = ops.two_level(a0, w0, *st, wd, ws, t0, npe=npe)
            args = (a1, w1, *out[:6], wd, ws, out[8])
            base = cs.graph_ms(lambda: ops.two_level(*args, npe=npe), 10)
            for c, cl, tab in ((4, cl4, four), (1, cl1, one)):
                ms = cs.graph_ms(lambda: ops.two_level_classified(
                    a1, w1, cl, *out[:6], wd, ws, out[8], tab["byp"],
                    *tab["bounds"], npe=npe), 10)
                print(json.dumps(dict(
                    row, kernel="two_level", route="classified", mode=mode,
                    classes=c, device_ms=ms, unclassified_device_ms=base,
                    ratio=ms / base)), flush=True)
        st = make_cache_batch(12, 64, 64, dev)
        for c, cl, tab, fl in ((4, cl4, four, flags4),
                               (1, cl1, one, [f[:, :1].contiguous()
                                              for f in flags4])):
            vm_flags = [f[:, 0].contiguous() for f in fl]
            out = ops.single_level(a0, w0, *st, wd, *vm_flags, t0,
                                   t_cache=T_SSD)
            sargs = (a1, w1, *out[:3], wd)
            base = cs.graph_ms(lambda: ops.single_level(
                *sargs, *vm_flags, out[5], t_cache=T_SSD), 10)
            ms = cs.graph_ms(lambda: ops.single_level_classified(
                a1, w1, cl, *out[:3], wd, *fl, out[5], tab["byp"],
                *tab["bounds"][:2], t_cache=T_SSD), 10)
            print(json.dumps(dict(
                row, kernel="single_level", route="classified",
                mode="class 0's policies", classes=c, device_ms=ms,
                unclassified_device_ms=base, ratio=ms / base)), flush=True)
    for src in ("datapath.cu", "single_level.cu"):
        print(json.dumps(dict(tree=label, source=src, card=smi,
                              ptxas=cs.ptxas_by_kernel(src),
                              sass=cs.sass_walk_steps(src))), flush=True)


if __name__ == "__main__":
    sys.exit(main())
