"""The dry-run tools as a user runs them, each in a process of its own:
``python -m repro_torch.launch.dryrun`` on one cell (mamba2-370m
``decode_32k``, as tests/test_system.py runs the reference's: the
record's keys, the H100 datasheet device, the reference's state bytes),
``--list``, ``--profile`` at a cut on the CPU, the sweep over two cells
(resumed, then tabled by ``roofline``), and an import check: the new
modules load no ``jax`` and no ``repro`` module.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

from repro import configs as jconfigs
from repro.models.config import SHAPES as JSHAPES, shape_applicable

from repro_torch import configs
from repro_torch.launch import dryrun, roofline, sweep
from repro_torch.models.config import ShapeSpec

from test_torch_dryrun import _reference_state_bytes

ROOT = Path(__file__).resolve().parent.parent


def test_dryrun_cell_subprocess(tmp_path):
    """One cell end to end in a subprocess: the record's keys, a
    positive FLOP count, the H100 device, the reference's state bytes."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("XLA_FLAGS", None)
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "mamba2-370m", "--shape", "decode_32k", "--out", str(tmp_path)],
        capture_output=True, text=True, timeout=600, env=env, cwd=ROOT)
    assert r.returncode == 0, (r.stderr or "")[-2000:]
    rec = json.loads(r.stdout)
    assert rec["status"] == "ok" and rec["device"] == "H100 SXM (datasheet)"
    assert rec["flops"] > 0 and rec["collective_bytes"] >= 0
    assert rec["chips"] == 256 and rec["mesh"] == "16x16"
    assert rec["bottleneck"] in ("compute", "memory", "collective")
    assert rec["state_bytes_per_device"] == _reference_state_bytes(
        "mamba2-370m", "decode_32k", False)
    for k in ("t_compute_s", "t_memory_s", "t_collective_s",
              "model_flops", "useful_flops_ratio", "flops_per_device",
              "collectives", "collective_bytes_per_device"):
        assert k in rec, k
    saved = tmp_path / "mamba2-370m__decode_32k__16x16__baseline.json"
    assert json.loads(saved.read_text()) == rec
    listed = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--list"],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=120)
    assert "mamba2-370m long_500k" in listed.stdout.splitlines()
    assert len(listed.stdout.splitlines()) == 40


def test_skip_cell_and_sweep(tmp_path, monkeypatch):
    """A skipped cell carries the reference's reason; the sweep runs each
    cell in its own process, both meshes, and resumes."""
    rec = dryrun.run_cell("qwen3-4b", "long_500k", False)
    assert rec["status"] == "skip"
    assert rec["reason"] == shape_applicable(
        jconfigs.get("qwen3-4b"), JSHAPES["long_500k"])[1]
    monkeypatch.setattr(sweep, "cells", lambda: iter(
        [("qwen3-4b", "long_500k"), ("phi4-mini-3.8b", "long_500k")]))
    monkeypatch.setenv("PYTHONPATH", str(ROOT / "src"))
    assert sweep.main(["--out", str(tmp_path), "--jobs", "2"]) == 0
    names = sorted(p.name for p in tmp_path.glob("*.json"))
    assert len(names) == 4 and all("long_500k" in n for n in names)
    assert sweep.main(["--out", str(tmp_path)]) == 0     # all cached
    recs = roofline.load(str(tmp_path), "2x16x16", "baseline")
    assert [r["status"] for r in recs] == ["skip", "skip"]
    assert "SKIP" in roofline.table(recs)


def test_profile_cell_on_cpu(tmp_path):
    """``--profile`` runs the cell's step at the cut (here a narrowed
    qwen3 through ``--override``, on the CPU: no device time) beside the
    cut's roofline from its ``meta`` trace; the record lists the cut."""
    narrow = ("d_model=64,num_heads=4,num_kv_heads=2,head_dim=16,"
              "d_ff=128,vocab_size=512")
    assert dryrun.main(["--arch", "qwen3-4b", "--shape", "train_4k",
                        "--override", narrow, "--profile", "--layers", "2",
                        "--batch", "2", "--seq", "64", "--device", "cpu",
                        "--out", str(tmp_path)]) == 0
    rec = json.loads((tmp_path / "qwen3-4b__train_4k__16x16__baseline.json")
                     .read_text())
    prof = rec["profile"]
    assert prof["reduced"] == {"num_layers": 2, "global_batch": 2,
                               "seq_len": 64}
    assert prof["kind"] == "train" and prof["step_ms"] > 0
    assert prof["launches"] == {}          # the CPU launches no kernel
    want = dryrun.trace_step(configs.get_reduced("qwen3-4b"),
                             ShapeSpec("train_4k", 64, 2, "train"))
    assert prof["step_flops"] == want["flops"]
    assert prof["roofline_one_device"]["t_collective_s"] == 0.0


def test_new_modules_import_neither_jax_nor_the_reference():
    """The distribution plan and the dry-run tools, run in a fresh
    process, load no ``jax`` and no ``repro`` module."""
    code = textwrap.dedent("""
        import sys
        import numpy as np, torch
        from repro_torch.core.policies import Policy
        from repro_torch.core.popularity import table_init, table_len
        from repro_torch.kernels.reuse_distance import ops
        from repro_torch.launch import (dryrun, mesh, roofline, sharding,
                                        steps, sweep, trace_analysis)
        from repro_torch.optim import compressed_psum
        rec = dryrun.run_cell("qwen3-4b", "decode_32k", True)
        assert rec["status"] == "ok", rec
        cpu = torch.device("cpu")
        m = mesh.ModelMesh(((cpu,), (cpu,)), ("data", "model"))
        compressed_psum([{"w": torch.ones(2, 3)}, {"w": torch.zeros(2, 3)}], m)
        ops.sizing_reduction(np.arange(8), np.zeros(8, bool), "trd",
                             np.arange(4), device="cpu")
        table_len(table_init(1, 4, device="cpu"))
        bad = sorted(n for n in sys.modules
                     if n == "jax" or n.startswith("jax.")
                     or n == "repro" or n.startswith("repro."))
        print("LOADED", bad)
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "LOADED []" in out.stdout
