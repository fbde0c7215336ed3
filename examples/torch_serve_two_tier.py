#!/usr/bin/env python3
"""Serving on the PyTorch port: churn-driven multi-tenant decode with the
ETICA two-tier KV manager, paged-attention decode steps, and the
global-LRU baseline for comparison.

    PYTHONPATH=src python examples/torch_serve_two_tier.py [--device cpu]

The twin of ``examples/serve_two_tier.py``: the same two
``repro_torch.launch.serve.main`` runs and the host-DMA write reduction
of ETICA over LRU. Runs on the card unless ``--device cpu``.
"""
import argparse
import sys
from pathlib import Path

_SRC = Path(__file__).resolve().parents[1] / "src"
if str(_SRC) not in sys.path:
    sys.path.insert(0, str(_SRC))

from repro_torch.launch.serve import main as serve_main  # noqa: E402

COMMON = ["--events", "800", "--live", "48", "--hbm-pages", "40",
          "--tenants", "3"]


def main(argv=None):
    """Returns ``(etica_stats, lru_stats, reduction)``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    common = [*COMMON, "--device", ap.parse_args(argv).device]
    print("=== ETICA two-tier manager (batched controller) ===")
    a = serve_main(["--manager", "etica", *common])
    print("\n=== global-LRU write-back baseline ===")
    b = serve_main(["--manager", "lru", *common])
    reduction = 1 - a["dma_write_bytes"] / max(b["dma_write_bytes"], 1)
    print(f"\nhost-DMA write reduction: {reduction:.1%}")
    return a, b, reduction


if __name__ == "__main__":
    main()
