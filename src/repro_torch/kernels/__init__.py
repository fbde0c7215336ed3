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
    ``run_sums`` compacts a maintenance window into each distinct
    address and its in-order float32 sum, the popularity table's window
    step in the reference's order
  * ``decode_attention`` — ``paged_decode_attention``, one-token flash
    decode over the two-tier KV serving pool's pages
  * ``popularity``     — ``popularity``, the Eq. 1 per-block scores
    (contribution fused into an in-order segment sum) that the staged
    maintenance mode merges into its host trackers
  * ``flash_attention`` — ``flash_attention``, blocked causal /
    sliding-window attention with an online softmax, GQA-native; the
    model's ``blocked_attention`` (every attention layer of a prefill).
    It has two routes (:func:`route_counts`): ``wgmma``
    (``flash_attention_sm90.cu``, bf16 on the tensor cores, D a multiple
    of 16 up to 128) and ``cuda_cores`` (``flash_attention.cu``, float32
    and the other head dims)

``popularity`` and ``run_sums`` have two routes each, chosen on the
host from the padded row width (:func:`row_route`): ``row`` groups each
row in one CTA's shared memory (``row_sort.cuh``), for rows of up to
:data:`ROW_MAX` entries; ``tiled`` (``row_merge.cuh``) sorts tiles of
``ROW_MAX`` entries and merges them in global memory, for rows of any
width. ``two_level`` and
``single_level`` walk each VM's requests set by set, one CTA a VM or
several while the VMs leave SMs idle (``set_walk.cuh``), and take rows
of any length in tiles.

``chain_probe.cu`` is no kernel of the path: it times one dependent
on-chip load and one dependent float32 add, which price the datapath's
dependency chain and the in-order sums'.
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
           "run_sums.cu", "decode_attention.cu", "popularity.cu",
           "flash_attention.cu", "flash_attention_sm90.cu", "chain_probe.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")
# ptxas reports registers, shared memory and spills of these sources into
# the build's log (:func:`build_log`)
VERBOSE_SOURCES = ("flash_attention_sm90.cu", "datapath.cu",
                   "single_level.cu", "decode_attention.cu",
                   "promote_scatter.cu", "count_between.cu",
                   "evict_scatter.cu", "clean_scatter.cu", "run_sums.cu",
                   "popularity.cu")

KERNELS = ("count_between", "evict_scatter", "promote_scatter",
           "clean_scatter", "two_level", "single_level", "run_sums",
           "paged_decode_attention", "popularity", "flash_attention")
# kernels with more than one CUDA entry point: route -> C symbol
ROUTES = {"flash_attention": {"wgmma": "etica_flash_attention_sm90",
                              "cuda_cores": "etica_flash_attention"},
          "popularity": {"row": "etica_popularity",
                         "tiled": "etica_popularity_tiled"},
          "run_sums": {"row": "etica_run_sums",
                       "tiled": "etica_run_sums_tiled"}}
_launches = dict.fromkeys(KERNELS, 0)
_route_launches = {k: dict.fromkeys(r, 0) for k, r in ROUTES.items()}
_lib = None

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_L = ctypes.c_longlong
_SIGNATURES = {
    "etica_count_between": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    "etica_evict_scatter": (*(_P,) * 8, *(_I,) * 5, _P),
    "etica_promote_scatter": (*(_P,) * 10, *(_I,) * 7, _P),
    "etica_clean_scatter": (*(_P,) * 11, *(_I,) * 5, _P),
    "etica_two_level": (*(_P,) * 23, *(_I,) * 8, _F, _F, _F, _F, _P),
    "etica_single_level": (*(_P,) * 20, *(_I,) * 5, _F, _F, _F, _P),
    "etica_run_sums": (_P, _P, _P, _P, _P, _I, _I, _P),
    "etica_run_sums_tiled": (*(_P,) * 10, _I, _I, _P),
    "etica_paged_decode_attention": (*(_P,) * 6, *(_I,) * 7, _F,
                                     *(_I,) * 8, _P),
    "etica_popularity": (_P, _P, _P, _P, _P, _I, _I, _I, _P),
    "etica_popularity_tiled": (*(_P,) * 9, _I, _I, _I, _P),
    "etica_flash_attention": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                              *(_L,) * 12, _I, _I, _I, _F, _I, _P),
    "etica_flash_attention_sm90": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                   *(_L,) * 12, _I, _I, _I, _F, _P),
    "etica_flash_attention_sm90_smem": (_I,),
    "etica_chain_probe": (_P, _I, _P, _P),
    "etica_fadd_probe": (_F, _I, _P, _P),
}
# the widest row that popularity's and run_sums' "row" route takes: one CTA
# of 512 threads sorts it in shared memory, 8 bytes an entry, and in
# registers, 32 entries a thread (csrc/row_sort.cuh, kMaxRow); also the
# "tiled" route's tile (csrc/row_merge.cuh, kTile)
ROW_MAX = 16384
ROW_THREADS = 512    # csrc/row_scan.cuh kRowThreads: a chunk of positions


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


def upload(x, dev: torch.device) -> torch.Tensor:
    """A host (numpy) array as a tensor on ``dev``; on the card through a
    pinned buffer and a ``non_blocking`` copy on the current stream, so
    the upload does not wait for the device."""
    t = torch.as_tensor(x)
    if dev.type == "cpu":
        return t
    return t.pin_memory().to(dev, non_blocking=True)


def launch_counts() -> dict[str, int]:
    """Kernel launches since the last :func:`reset_launch_counts`."""
    return dict(_launches)


def route_counts(kernel: str) -> dict[str, int]:
    """Launches of each of ``kernel``'s routes since the last
    :func:`reset_launch_counts`."""
    return dict(_route_launches[kernel])


def reset_launch_counts() -> None:
    for k in _launches:
        _launches[k] = 0
    for counts in _route_launches.values():
        for r in counts:
            counts[r] = 0


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels are built "
                           "from source on a machine with the CUDA toolkit")
    return nvcc


def _build() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + VERBOSE_SOURCES).encode())
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
            verbose = ("-Xptxas", "-v") if src in VERBOSE_SOURCES else ()
            procs.append(subprocess.Popen(
                [nvcc, *NVCC_FLAGS, *verbose, "-I", str(CSRC), "-c",
                 str(CSRC / src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        errors, logs = [], []
        for src, p in zip(SOURCES, procs):
            out, _ = p.communicate()
            if p.returncode:
                errors.append(f"{src}:\n{out}")
            elif out:
                logs.append(f"{src}:\n{out}")
        if errors:
            raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
        so.with_suffix(".log").write_text("\n".join(logs))
        tmp_so = Path(tmp) / so.name
        subprocess.run([nvcc, *NVCC_FLAGS, "-shared", *objs, "-o",
                        str(tmp_so)], check=True, capture_output=True,
                       text=True)
        os.replace(tmp_so, so)
    return so


def build_log() -> str:
    """What ``nvcc`` printed while building the loaded library (ptxas's
    report for :data:`VERBOSE_SOURCES`); empty before the first build."""
    log = _build().with_suffix(".log")
    return log.read_text() if log.exists() else ""


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


def launch(kernel: str, *args, route: str | None = None) -> None:
    """Call ``etica_<kernel>`` (or the C symbol of ``kernel``'s
    ``route``) on the current stream; count the launch, and the route's,
    and raise on a launch error (``cudaGetLastError`` != 0)."""
    symbol = ROUTES[kernel][route] if route else "etica_" + kernel
    stream = torch.cuda.current_stream().cuda_stream
    err = getattr(library(), symbol)(*args, stream)
    if err:
        raise RuntimeError(f"CUDA kernel {kernel} ({symbol}) failed to "
                           f"launch (cudaError {err})")
    _launches[kernel] += 1
    if route:
        _route_launches[kernel][route] += 1


def row_route(n: int) -> str:
    """The route of ``popularity`` and ``run_sums`` for rows padded to
    ``n`` entries, chosen from the shape (the valid lengths live on the
    device): ``row`` (one CTA sorts a row in shared memory) up to
    :data:`ROW_MAX`, ``tiled`` (tiles of ``ROW_MAX`` merged in global
    memory) above it. The controller's windows are ``reuse._bucket(longest
    VM row)`` wide, a power of two like ``ROW_MAX``, so a window takes the
    tiled route exactly when one VM issues more than ``ROW_MAX`` requests
    in it; a serving window is as wide as the whole window (at most
    ``resize_interval`` accesses) whatever each tenant's share."""
    return "row" if n <= ROW_MAX else "tiled"


def row_scratch(v: int, n: int, device: torch.device) -> list:
    """The tiled route's scratch for ``[v, n]`` rows: two pair buffers
    (int64 ``[v, n]``), the tile counts (int32 ``[v, tiles]``), their
    bases (``[v, tiles + 1]``) and the run heads of each 512-position
    chunk (``[v, chunks]``; ``csrc/row_merge.cuh``)."""
    tiles = -(-n // ROW_MAX)
    chunks = -(-n // ROW_THREADS)
    return [torch.empty((v, n), dtype=torch.int64, device=device),
            torch.empty((v, n), dtype=torch.int64, device=device),
            torch.empty((v, tiles), dtype=torch.int32, device=device),
            torch.empty((v, tiles + 1), dtype=torch.int32, device=device),
            torch.empty((v, chunks), dtype=torch.int32, device=device)]


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
