"""Checkpointing with atomic commit and elastic restore (the port of
:mod:`repro.checkpoint.store`).

Layout per step, the reference's:
    <dir>/step_<n>.tmp/...   (write)
    <dir>/step_<n>/          (atomic rename on completion)
        manifest.json        leaf names, shapes, dtypes, step, extra
        arr_<k>.npy          one file per leaf (a host copy)

The reference's manifest holds the JAX treedef as a proto, which cannot
be read without jax; this one lists each leaf's name in its place (the
path of keys and indices, :mod:`repro_torch._tree`), with its dtype. A
bfloat16 tensor, which numpy lacks, is written as its int16 bits and
read back as bfloat16.

Properties kept from the reference:
  * atomicity — a crash mid-save never corrupts the latest checkpoint
    (tmp dir + rename; restore picks the newest *committed* step);
  * async save — :class:`AsyncCheckpointer` copies the state to the host
    on the caller's thread (the port's optimizer updates tensors in
    place, so a later step would change what a thread still reads) and
    writes those copies on a background thread;
  * elastic restore — leaves are loaded as host arrays and placed on
    whatever device the caller names;
  * retention — keep the newest ``keep`` checkpoints.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time

import numpy as np
import torch

from repro_torch._tree import named_leaves, unflatten


def _host(leaf) -> tuple[str, np.ndarray]:
    """``(dtype name, a host copy)`` of one leaf (always a copy: a CPU
    tensor's ``numpy()`` would share its memory)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return "bfloat16", t.view(torch.int16).numpy()
        return str(t.dtype).removeprefix("torch."), t.numpy()
    a = np.array(leaf)
    return str(a.dtype), a


def _snapshot(state) -> list[tuple[str, str, np.ndarray]]:
    """``[(name, dtype name, host copy)]`` of every leaf, in order."""
    return [(name, *_host(leaf)) for name, leaf in named_leaves(state)]


def _write(ckpt_dir: str, step: int, snap, keep: int, extra) -> str:
    tmp = os.path.join(ckpt_dir, f"step_{step}.tmp")
    final = os.path.join(ckpt_dir, f"step_{step}")
    os.makedirs(tmp, exist_ok=True)
    manifest = {
        "step": step,
        "names": [n for n, _, _ in snap],
        "dtypes": [d for _, d, _ in snap],
        "shapes": [list(a.shape) for _, _, a in snap],
        "num_leaves": len(snap),
        "time": time.time(),
        "extra": extra or {},
    }
    for i, (_, _, a) in enumerate(snap):
        np.save(os.path.join(tmp, f"arr_{i}.npy"), a)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)          # atomic commit
    _retain(ckpt_dir, keep)
    return final


def save(ckpt_dir: str, step: int, state, *, keep: int = 3,
         extra: dict | None = None) -> str:
    return _write(ckpt_dir, step, _snapshot(state), keep, extra)


def _retain(ckpt_dir: str, keep: int):
    steps = sorted(all_steps(ckpt_dir))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s}"), ignore_errors=True)


def all_steps(ckpt_dir: str) -> list[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and not name.endswith(".tmp"):
            if os.path.exists(os.path.join(ckpt_dir, name, "manifest.json")):
                out.append(int(name.split("_")[1]))
    return out


def latest_step(ckpt_dir: str) -> int | None:
    steps = all_steps(ckpt_dir)
    return max(steps) if steps else None


def _place(a: np.ndarray, dtype: str, like, device):
    """A loaded array as ``like`` holds it: a tensor (bfloat16 from its
    bits) on ``device``, or on ``like``'s device when ``device`` is
    None; a numpy array for any other leaf."""
    if not isinstance(like, torch.Tensor):
        return a
    t = torch.from_numpy(a)
    if dtype == "bfloat16":
        t = t.view(torch.bfloat16)
    return t.to(like.device if device is None else device)


def restore(ckpt_dir: str, state_like, *, step: int | None = None,
            device=None):
    """Restore into the structure of ``state_like``: ``(state, step,
    extra)``. Tensor leaves go to ``device`` (each like-leaf's own device
    when None), which is how a run moves to other hardware."""
    step = latest_step(ckpt_dir) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    like = named_leaves(state_like)
    assert manifest["num_leaves"] == len(like), "structure mismatch"
    assert manifest["names"] == [n for n, _ in like], "leaf names differ"
    placed = [_place(np.load(os.path.join(d, f"arr_{i}.npy")), dt, leaf,
                     device)
              for i, ((_, leaf), dt) in enumerate(zip(like,
                                                      manifest["dtypes"]))]
    return unflatten(state_like, placed), step, manifest.get("extra", {})


class AsyncCheckpointer:
    """Overlap checkpoint serialization with training."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread: threading.Thread | None = None
        self.last_path: str | None = None

    def save(self, step: int, state, extra: dict | None = None):
        self.wait()
        # host copies on the caller thread (a consistent snapshot), IO async
        snap = _snapshot(state)

        def work():
            self.last_path = _write(self.ckpt_dir, step, snap, self.keep,
                                    extra)

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
