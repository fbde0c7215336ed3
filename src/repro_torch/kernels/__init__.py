"""Hand-written CUDA kernels for Hopper, with their plain PyTorch versions.

Every kernel lives in ``repro_torch/csrc/`` as CUDA C++ with a plain C
interface. :func:`library` compiles all sources for ``sm_90a`` at first
use (one ``nvcc`` per source, started together, then one link) into a
shared library under ``build/`` at the repository root, named by a hash
of the sources and flags so an edit rebuilds, and loads it with
``ctypes``.

Each wrapper (``kernels/*/ops.py``) follows one rule: a tensor on the
CPU takes the plain PyTorch version that sits beside the kernel; a CUDA
tensor launches the kernel on the current stream or raises. There is no
fallback between the two. A launch adds one to the kernel's entry in the
launch counter (:func:`launch_counts`), and nothing else does.

  * ``reuse_distance`` — ``count_between``, the O(N^2) distinct count
    under every reuse distance (POD sizing and the maintenance TRD)
  * ``datapath``       — ``two_level``, the DRAM(RO) + SSD(WBWO) request
    loop, and ``single_level``, the one-level baselines' request loop
    under per-VM write policies, both of which the JAX package runs as
    a ``lax.scan``
  * ``maintenance``    — ``evict_scatter`` / ``promote_scatter`` /
    ``clean_scatter`` and the fused per-interval maintenance;
    ``run_sums`` is an in-order segment sum that keeps the popularity
    table's float32 sums in the reference's order

``chain_probe.cu`` is no kernel of the path: it times one dependent
on-chip load, which prices the datapath's dependency chain.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD = Path(__file__).resolve().parents[3] / "build"
SOURCES = ("count_between.cu", "evict_scatter.cu", "promote_scatter.cu",
           "clean_scatter.cu", "datapath.cu", "single_level.cu",
           "run_sums.cu", "chain_probe.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

KERNELS = ("count_between", "evict_scatter", "promote_scatter",
           "clean_scatter", "two_level", "single_level", "run_sums")
_launches = dict.fromkeys(KERNELS, 0)
_lib = None

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "etica_count_between": (_P, _P, _P, _P, _I, _I, _P),
    "etica_evict_scatter": (_P, _P, _P, _P, _P, _I, _I, _I, _P),
    "etica_promote_scatter": (_P, _P, _P, _P, _P, _P, _P,
                              _I, _I, _I, _I, _P),
    "etica_clean_scatter": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _P),
    "etica_two_level": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                        _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                        _F, _F, _F, _F, _P),
    "etica_single_level": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                           _P, _P, _P, _I, _I, _I, _I, _F, _F, _F, _P),
    "etica_run_sums": (_P, _P, _P, _P, _P, _I, _I, _P),
    "etica_chain_probe": (_P, _I, _P, _P),
}


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks
    for the CPU. Raises when CUDA is asked for and no card is present."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def launch_counts() -> dict[str, int]:
    """Kernel launches since the last :func:`reset_launch_counts`."""
    return dict(_launches)


def reset_launch_counts() -> None:
    for k in _launches:
        _launches[k] = 0


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels are built "
                           "from source on a machine with the CUDA toolkit")
    return nvcc


def _build() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in sorted(p.name for p in CSRC.iterdir()):
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    so = BUILD / f"libetica_{h.hexdigest()[:16]}.so"
    if so.exists():
        return so
    BUILD.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD) as tmp:
        objs, procs = [], []
        for src in SOURCES:
            obj = Path(tmp) / (src + ".o")
            objs.append(str(obj))
            procs.append(subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(CSRC / src),
                 "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        errors = []
        for src, p in zip(SOURCES, procs):
            out, _ = p.communicate()
            if p.returncode:
                errors.append(f"{src}:\n{out}")
        if errors:
            raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
        tmp_so = Path(tmp) / so.name
        subprocess.run([nvcc, *NVCC_FLAGS, "-shared", *objs, "-o",
                        str(tmp_so)], check=True, capture_output=True,
                       text=True)
        os.replace(tmp_so, so)
    return so


def library() -> ctypes.CDLL:
    """The compiled kernel library (built and loaded at first use)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(_build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def launch(kernel: str, *args) -> None:
    """Call ``etica_<kernel>`` on the current stream; count the launch
    and raise on a launch error (``cudaGetLastError`` != 0)."""
    stream = torch.cuda.current_stream().cuda_stream
    err = getattr(library(), "etica_" + kernel)(*args, stream)
    if err:
        raise RuntimeError(f"CUDA kernel {kernel} failed to launch "
                           f"(cudaError {err})")
    _launches[kernel] += 1


def check(t: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple,
          device: torch.device) -> None:
    """Validate one kernel operand: device, dtype, shape, contiguity."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
