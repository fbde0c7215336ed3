#!/usr/bin/env python3
"""A short card check of ``flash_attention_bwd``'s ``wgmma`` route: what
ptxas said of its kernels and the forward's (registers, spills), their
``HGMMA`` counts, the route against its plain version on a few bf16
cells (causal, non-causal, a window, a q offset, rows that keep no key,
D 16 to 128) and at the training shape, its times there beside the
plain version and SDPA's backward (``chip_smoke.time_flash_bwd``: the
device time of a CUDA graph and the profiler's split over its three
kernels), and the forward's output with its row statistics written
against it without, with both forwards' device times at the prefill
shape.

Run on a machine with an NVIDIA card and the CUDA toolkit, from the
repository root::

    python3 examples/torch_flash_bwd_check.py

It builds the kernels from this tree's ``src/repro_torch/csrc`` and
takes about a minute and a half with the build; ``chip_smoke.py`` phase
17 runs the full checks.
"""
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.kernels.flash_attention import ops  # noqa: E402

# B, H, Hkv, Sq, Skv, D and the mask
CELLS = [((1, 2, 1, 128, 128, 64), dict(causal=True)),
         ((1, 2, 2, 128, 128, 128), dict(causal=False)),
         ((2, 8, 2, 256, 256, 128), dict(causal=True)),
         ((1, 4, 2, 100, 96, 16), dict(causal=True, window=16, q_offset=60)),
         ((1, 4, 2, 100, 96, 64), dict(causal=True, window=16, q_offset=60)),
         ((1, 4, 2, 70, 200, 48), dict(causal=True, q_offset=130)),
         ((1, 8, 2, 330, 330, 64), dict(causal=True, window=100)),
         ((1, 8, 2, 100, 384, 128), dict(causal=False))]


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    t0 = time.perf_counter()
    kernels.library()
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    for src in ("flash_attention_bwd_sm90.cu", "flash_attention_sm90.cu"):
        for fn, ln in cs.ptxas_by_function(src).items():
            print(f"ptxas {src} {fn}: {ln}", flush=True)
        print(f"HGMMA {src}: {cs.sass_hgmma(src)}", flush=True)
    dev = torch.device("cuda")
    b, h, hkv, s, d = cs.TRAIN_BWD
    for shape, kw in CELLS + [((b, h, hkv, s, s, d), dict(causal=True))]:
        args = cs.bwd_inputs(dev, shape, torch.bfloat16, 1, **kw)
        got = ops.flash_attention_bwd(*args, **kw)
        want = ops.flash_attention_bwd_plain(*args, **kw)
        errs = [float((g.float() - w.float()).abs().max())
                / float(w.float().abs().max()) for g, w in zip(got, want)]
        print(shape, kw, "dq, dk, dv relative errors",
              [f"{e:.3e}" for e in errs], flush=True)
    row = cs.time_flash_bwd(cs.bwd_inputs(dev, (b, h, hkv, s, s, d),
                                          torch.bfloat16, 17, causal=True))
    print("training shape:", row, flush=True)
    b, h, hkv, s, d = cs.QWEN3_PREFILL
    q = torch.randn(b, h, s, d, device=dev, dtype=torch.bfloat16)
    k, v = (torch.randn(b, hkv, s, d, device=dev, dtype=torch.bfloat16)
            for _ in range(2))
    kw = dict(causal=True, tq=s, tk=1024)

    def fwd(stats):
        return ops.flash_attention(q, k, v, return_stats=stats, **kw)
    same = torch.equal(fwd(False), fwd(True)[0])
    off, on = (cs.graph_ms(lambda: fwd(x), 4, 3) for x in (False, True))
    print(f"prefill shape: output with statistics == without: {same}; "
          f"device ms without {off:.4f}, with {on:.4f}", flush=True)
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
