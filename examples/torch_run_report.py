#!/usr/bin/env python3
"""Summarize a telemetry journal spill (JSONL) on the terminal, with the
PyTorch port.

    PYTHONPATH=src python examples/torch_run_report.py journal.jsonl \
        [--last N] [--vm V]

Prints one line per recorded interval (requests, hit ratio, dirty
occupancy, overload flags) and a run summary, for journals written by
either controller family (per-VM columns) or the serving manager
(scalar columns and per-tenant quota). ``--vm`` narrows the series to
one VM's columns; ``--last N`` keeps the tail only. A spill comes from
``TelemetryRecorder(spill=...)``, e.g. ``examples/torch_paper_figures.py
--fig 17 --journal PATH`` or ``python -m repro_torch.launch.serve
--journal PATH``.

The work is :mod:`repro_torch.runtime.telemetry`'s ``load_journal`` and
``format_report``, the functions fig17 renders from.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

_SRC = Path(__file__).resolve().parents[1] / "src"
if str(_SRC) not in sys.path:
    sys.path.insert(0, str(_SRC))

from repro_torch.runtime.telemetry import (format_report,  # noqa: E402
                                           load_journal)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Per-interval telemetry journal report")
    ap.add_argument("journal", help="JSONL spill written by a "
                                    "TelemetryRecorder journal")
    ap.add_argument("--last", type=int, default=None,
                    help="print only the last N intervals")
    ap.add_argument("--vm", type=int, default=None,
                    help="narrow the series to one VM/tenant index")
    args = ap.parse_args(argv)
    for line in format_report(load_journal(args.journal), last=args.last,
                              vm=args.vm):
        print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
