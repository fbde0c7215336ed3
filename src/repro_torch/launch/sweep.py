"""Run the whole dry-run sweep: every (arch x shape) cell on both
production meshes, the cells dealt over ``--jobs`` worker processes (the
port of :mod:`repro.launch.sweep`)::

  PYTHONPATH=src python -m repro_torch.launch.sweep [--out build/dryrun]
      [--multi-pod-only|--single-pod-only] [--timeout 2400] [--jobs N]

Each worker is one ``python -m repro_torch.launch.dryrun --cells ...``
process: its cells run one after another in it (a first trace pays some
seconds of one-time set-up), each cell's meshes from one ``meta``
trace. The costliest cells (the SSM configs' chunk loops at
``train_4k`` and ``prefill_32k``) are dealt first, one a worker.
Resumable: cells whose JSONs exist are skipped.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

MESHES = (("16x16", False), ("2x16x16", True))


def cells():
    from repro_torch import configs
    from repro_torch.models.config import SHAPES
    for arch in configs.ARCH_IDS:
        for shape in SHAPES:
            yield arch, shape


def cost_rank(arch: str, shape: str) -> int:
    """A rough order of a cell's trace time (lower first): the SSM chunk
    loops at long sequences, then the other training steps, then the
    rest."""
    from repro_torch import configs
    from repro_torch.models.config import SHAPES
    cfg, kind = configs.get(arch), SHAPES[shape].kind
    if cfg.family in ("ssm", "hybrid") and kind != "decode":
        return 0
    return 1 if kind == "train" else 2


def _command(group, meshes, out, tag) -> list[str]:
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--cells",
           ",".join(f"{a}:{s}" for a, s, _ in group), "--out", out,
           "--tag", tag]
    if len(meshes) == 2:
        return cmd + ["--both-meshes"]
    return cmd + (["--multi-pod"] if meshes[0][1] else [])


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="build/dryrun")
    ap.add_argument("--timeout", type=int, default=2400,
                    help="seconds a worker may take")
    ap.add_argument("--multi-pod-only", action="store_true")
    ap.add_argument("--single-pod-only", action="store_true")
    ap.add_argument("--tag", default="baseline")
    ap.add_argument("--jobs", type=int, default=1)
    args = ap.parse_args(argv)

    meshes = [m for m in MESHES
              if not (args.multi_pod_only and not m[1])
              and not (args.single_pod_only and m[1])]
    os.makedirs(args.out, exist_ok=True)
    todo, n_cached = [], 0
    for arch, shape in cells():
        paths = [os.path.join(args.out, f"{arch}__{shape}__{m}__{args.tag}"
                              ".json") for m, _ in meshes]
        if all(os.path.exists(p) for p in paths):
            n_cached += 1
        else:
            todo.append((arch, shape, paths))
    todo.sort(key=lambda c: cost_rank(c[0], c[1]))
    jobs = max(1, min(args.jobs, len(todo)))
    groups = [todo[i::jobs] for i in range(jobs)]
    t_start = time.time()
    procs = []
    for group in groups:
        if group:
            print(f"worker: {', '.join(f'{a} {s}' for a, s, _ in group)}",
                  flush=True)
            procs.append((group, subprocess.Popen(
                _command(group, meshes, args.out, args.tag),
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    counts = {"ok": 0, "skip": 0, "fail": 0}
    for group, proc in procs:
        try:
            out, err = proc.communicate(timeout=max(
                1, args.timeout - (time.time() - t_start)))
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
            out, err = "", "timeout"
        for arch, shape, paths in group:
            status = []
            for p in paths:
                if os.path.exists(p):
                    with open(p) as f:
                        status.append(json.load(f).get("status", "?"))
            if len(status) == len(paths) and all(
                    s in ("ok", "skip") for s in status):
                key = "skip" if status[0] == "skip" else "ok"
                counts[key] += 1
                print(f"{arch} {shape}: {key}", flush=True)
            else:
                counts["fail"] += 1
                tail = (err or out or "")[-2000:]
                print(f"{arch} {shape}: FAIL rc={proc.returncode}\n{tail}",
                      flush=True)
                with open(paths[0] + ".fail", "w") as f:
                    f.write(tail)
    print(f"done in {time.time() - t_start:.0f}s: ok={counts['ok']} "
          f"skip={counts['skip']} fail={counts['fail']} cached={n_cached}",
          flush=True)
    return 0 if counts["fail"] == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
