#!/usr/bin/env python3
"""The ``tiled`` route of ``run_sums`` and ``popularity`` on the card, one
source tree: each call's device events in launch order with their times,
the call's device time, and the yardsticks beside it.

Run on a machine with an NVIDIA card and the CUDA toolkit, from the
repository root::

    python3 examples/torch_tiled_split.py [--src DIR] [--label NAME]

``--src`` (default: this tree's ``src``) is the directory whose
``repro_torch`` package, and so whose kernels, are timed; two trees are
compared on one card in one run by calling the script in turns (an
earlier commit unpacked with ``git archive`` under ``build/``, then this
tree: earlier, this, this, earlier).

Shapes (made by this tree's ``chip_smoke.py``):

- ``[5, 16385]`` and ``[5, 40000]`` of ``chip_smoke.row_cases``: heavy
  ties, one key for a whole row, an empty row, runs across each multiple
  of 16,384, random keys;
- ``[12, 32768]``: the paper's 12 VMs, each VM's whole 20,000-request
  mix as one window (``chip_smoke.paper_wide_rows``);
- ``[4, 32768]``: serving-wide's 20,000-record ring split by tenant
  (``chip_smoke.serving_wide_rows``).

Each kernel is held exactly to its plain version (on CPU copies) and
its route checked; then printed: the device events of one call in order
(``chip_smoke.event_split``, a profiler trace of 10 calls), the device
time of a CUDA graph of the calls (``chip_smoke.graph_ms``), the library
pair's device time from a profiler trace (``torch.sort(stable)`` +
``index_add_``, ``torch.exp`` + ``index_add_``), the longest run
``L_max`` and the chain floor ``L_max`` dependent float32 adds
(``chain_probe.cu``'s step), and the bytes bound. One JSON line per
(kernel, shape), with the card's name and power limit.
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
        print("torch_tiled_split: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch import kernels
    from repro_torch.core import popularity as pop
    from repro_torch.kernels.popularity import ops as pops
    if not Path(kernels.__file__).resolve().is_relative_to(
            Path(opts.src).resolve()):
        raise RuntimeError(f"repro_torch came from {kernels.__file__}")
    kernels.library()
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    fadd_ns = cs.fadd_step_ns(dev)
    rng = np.random.default_rng(21)
    shapes = [(f"[5,{n}] row_cases", *cs.row_cases(rng, 5, n))
              for n in (16_385, 40_000)]
    shapes += [("[12,32768] paper-12vm", *cs.paper_wide_rows()),
               ("[4,32768] serving-wide", *cs.serving_wide_rows())]
    for label, addr, nv_np in shapes:
        v, n = addr.shape
        wa = torch.from_numpy(addr).to(dev)
        nv = torch.from_numpy(nv_np).to(dev)
        wc = torch.from_numpy(rng.random((v, n)).astype(np.float32)).to(dev)
        seg, nb = cs.row_segments(wa, nv)
        pargs = (torch.from_numpy(rng.integers(-1, 300, (v, n)).astype(
                     np.int32)).to(dev),
                 torch.from_numpy(rng.random((v, n)) < 0.7).to(dev), seg,
                 nb, torch.full((v,), 64.0, device=dev))
        library = cs.row_library_calls(wa, wc, pargs)
        valid = torch.arange(n, device=dev)[None, :] < nv[:, None]
        for name, call, plain, keys, keep, nbytes in (
                ("run_sums", lambda: pop.window_runs(wa, wc, nv),
                 lambda: pop.window_runs_plain(wa.cpu(), wc.cpu(), nv.cpu()),
                 wa, valid, 16.0 * v * n + 4.0 * v),
                ("popularity", lambda: [pops.popularity_rows(*pargs)],
                 lambda: [pops.popularity_rows_plain(
                     *[x.cpu() if torch.is_tensor(x) else x
                       for x in pargs])],
                 seg, seg < nb, 9.0 * v * n + 4.0 * v + 4.0 * nb)):
            kernels.reset_launch_counts()
            got = call()
            routes = kernels.route_counts(name)
            err = cs.max_abs_err([x.cpu() for x in got], plain())
            if err != 0.0:
                raise AssertionError(f"{name} {label}: {err} from plain")
            split = cs.event_split(call)
            l_max = cs.longest_run(keys, keep)
            lib_ms, lib_events = cs.device_profile(library[name], 20)
            row = dict(tree=opts.label, card=smi, kernel=name, shape=label,
                       routes=routes, exact=True,
                       device_ms=cs.graph_ms(call, reps=5, replays=4),
                       call_ms=cs.cuda_ms(call, 20), split=split,
                       library_device_ms=lib_ms,
                       library_events=lib_events, l_max=l_max,
                       chain_ms=l_max * fadd_ns * 1e-6,
                       bytes_bound_ms=cs.bound_ms(nbytes, 0.0)[0])
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
