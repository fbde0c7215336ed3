"""Sharding rules: the parameter, optimizer, cache and batch specs of a
mesh (the port of :mod:`repro.launch.sharding`).

Policy (the reference's):
  * tensor parallelism over ``'model'`` — attention heads, MLP hidden,
    MoE experts (expert-parallel when the expert count divides the axis,
    otherwise tensor-parallel inside each expert), vocabulary;
  * batch over ``('pod', 'data')``;
  * FSDP (``'data'``-axis weight sharding) for configs whose TP-sharded
    float32 parameters would exceed ``threshold_bytes`` a device;
    otherwise only the optimizer moments are ``'data'``-sharded
    (ZeRO-1);
  * KV caches: batch over the data axes when divisible, KV heads over
    ``'model'`` when divisible, else the KV sequence over ``'model'``.

Everything is divisibility-checked against the mesh's axis sizes, so the
same rules serve the 16 x 16 pod, the 2 x 16 x 16 multi-pod and the
one-device host mesh. The rules are pure functions of a leaf's path,
its shape and the mesh's ``axis_names`` and ``shape``: a
:class:`~repro_torch.launch.mesh.ModelMesh` or an
:class:`~repro_torch.launch.mesh.AbstractMesh` serves. A spec is a tuple
with one entry a dimension: ``None`` (replicated), an axis name, or a
tuple of axis names (their product) — the entries of the reference's
``PartitionSpec``. A path is the reference's, as a tuple of keys or
joined by ``/`` (``"layers/block0/mixer/wq/w"``); the trees are the
reference's (:func:`repro_torch.models.model.param_shapes`, the cache
of :func:`repro_torch.models.model.init_cache`).
"""
from __future__ import annotations

import math

from repro_torch._tree import named_leaves, unflatten
from repro_torch.models.config import ModelConfig
from .mesh import axis_size, dp_axes

Spec = tuple


def _divides(n: int, size: int) -> bool:
    return size > 0 and n % size == 0 and n >= size


def _axes_size(mesh, axes) -> int:
    return math.prod(axis_size(mesh, a) for a in axes)


def _names(path) -> list[str]:
    return path.split("/") if isinstance(path, str) else [str(p)
                                                          for p in path]


def _greedy(shape, mesh, prefs) -> Spec:
    """Assign mesh axes to dims by preference order with divisibility.

    prefs: list of (dim, axes) where axes is a str or tuple of axis names
    (tried as a combined product). Later prefs skip used axes/dims.
    """
    spec = [None] * len(shape)
    used: set[str] = set()
    for dim, axes in prefs:
        if dim >= len(shape) or spec[dim] is not None:
            continue
        axes_t = axes if isinstance(axes, tuple) else (axes,)
        axes_t = tuple(a for a in axes_t
                       if a in mesh.axis_names and a not in used)
        if not axes_t:
            continue
        if _divides(shape[dim], _axes_size(mesh, axes_t)):
            spec[dim] = axes_t if len(axes_t) > 1 else axes_t[0]
            used.update(axes_t)
    return tuple(spec)


def param_spec(path, shape, cfg: ModelConfig, mesh, fsdp: bool) -> Spec:
    """The spec of the parameter leaf at ``path`` with ``shape``."""
    names = _names(path)
    shape = tuple(shape)
    stacked = "layers" in names  # leading superlayer axis
    off = 1 if stacked else 0
    m = axis_size(mesh, "model")
    d = axis_size(mesh, "data")

    def pad(*spec):
        full = (None,) * off + spec
        full = full + (None,) * (len(shape) - len(full))
        return list(full[: len(shape)])

    spec: list = pad()
    if "table" in names:  # embeddings [V, D]
        spec = [None] * len(shape)
        if _divides(shape[0], m):
            spec[0] = "model"
    elif names[-1] == "w":
        site = names[-2]
        if site in ("wq", "wk", "wv"):
            if _divides(shape[off + 1], m):
                spec = pad(None, "model")
        elif site == "wo":
            if _divides(shape[off + 0], m):
                spec = pad("model", None)
        elif site in ("w_up", "w_gate", "in_proj"):
            if _divides(shape[off + 1], m):
                spec = pad(None, "model")
        elif site in ("w_down", "out_proj"):
            if _divides(shape[off + 0], m):
                spec = pad("model", None)
        # router stays replicated
    elif names[-1] in ("w_up", "w_gate") and len(shape) - off == 3:
        # MoE expert weights [E, D, F]
        e, ff = shape[off], shape[off + 2]
        if _divides(e, m):
            spec = pad("model", None, None)        # expert parallel
        elif _divides(ff, m):
            spec = pad(None, None, "model")        # TP inside experts
    elif names[-1] == "w_down" and len(shape) - off == 3:
        e, ff = shape[off], shape[off + 1]
        if _divides(e, m):
            spec = pad("model", None, None)
        elif _divides(ff, m):
            spec = pad(None, "model", None)
    elif names[-1] in ("conv_w", "conv_b", "A_log", "D", "dt_bias",
                       "norm_scale", "scale"):
        spec = [None] * len(shape)  # small/replicated

    # FSDP: shard the largest still-unsharded non-stacked dim over 'data'
    if fsdp and len(shape) - off >= 2:
        cands = sorted(
            (i for i in range(off, len(shape))
             if spec[i] is None and _divides(shape[i], d)),
            key=lambda i: -shape[i])
        if cands:
            spec[cands[0]] = "data"
    return tuple(spec)


def should_fsdp(cfg: ModelConfig, mesh, threshold_bytes: float = 4e9) -> bool:
    """FSDP when the TP-sharded float32 parameters pass
    ``threshold_bytes`` a device."""
    total, _ = cfg.param_counts()
    m = axis_size(mesh, "model")
    return total * 4 / m > threshold_bytes


def _map(tree, fn):
    """``tree`` with each leaf replaced by ``fn(path, leaf)``."""
    return unflatten(tree, [fn(p, x) for p, x in named_leaves(tree)])


def param_shardings(cfg: ModelConfig, params_shape, mesh, fsdp=None):
    """The spec of every leaf of the reference-layout parameter tree."""
    fsdp = should_fsdp(cfg, mesh) if fsdp is None else fsdp
    return _map(params_shape, lambda path, leaf: param_spec(
        path, leaf.shape, cfg, mesh, fsdp))


def opt_shardings(cfg: ModelConfig, params_shape, mesh, fsdp=None):
    """Moments get ``'data'`` sharding even without FSDP (ZeRO-1)."""
    moments = param_shardings(cfg, params_shape, mesh, fsdp=True)
    return {"m": moments, "v": moments, "step": ()}


# ---------------------------------------------------------------------------
# batch / cache shardings
# ---------------------------------------------------------------------------

def batch_sharding(shape, mesh) -> Spec:
    """Token-like arrays [B, ...]: batch over ('pod','data')."""
    return _greedy(tuple(shape), mesh, [(0, dp_axes(mesh))])


def cache_leaf_spec(path, shape, mesh) -> Spec:
    """The spec of the cache leaf at ``path`` with ``shape``."""
    names = _names(path)
    shape = tuple(shape)
    dp = dp_axes(mesh)
    if names[-1] in ("k", "v"):
        if len(shape) == 5:    # [R, B, S, Hkv, Dh]
            return _greedy(shape, mesh,
                           [(1, dp), (3, "model"), (2, "model"),
                            (2, dp), (2, ("data", "model"))])
        if len(shape) == 4:    # [B, S, Hkv, Dh] (prefix layer)
            return _greedy(shape, mesh,
                           [(0, dp), (2, "model"), (1, "model")])
    if names[-1] == "ssd":     # [R, B, H, P, N] or [B, H, P, N]
        off = len(shape) - 4
        return _greedy(shape, mesh,
                       [(off + 0, dp), (off + 1, "model")])
    if names[-1] == "conv":    # [R, B, W-1, conv_dim]
        off = len(shape) - 3
        return _greedy(shape, mesh,
                       [(off + 0, dp), (off + 2, "model")])
    if names and names[0] == "memory_kv":  # [R, B, S_enc, Hkv, Dh]
        return _greedy(shape, mesh,
                       [(1, dp), (3, "model"), (2, "model")])
    return ()


def cache_shardings(cache_shape, mesh):
    return _map(cache_shape, lambda path, leaf: cache_leaf_spec(
        path, leaf.shape, mesh))


def batch_shardings(batch_shape, mesh):
    return _map(batch_shape, lambda path, leaf: batch_sharding(leaf.shape,
                                                               mesh))


def shards(spec: Spec, mesh) -> int:
    """How many ways a leaf with ``spec`` is split over ``mesh``."""
    n = 1
    for s in spec:
        if s is not None:
            n *= _axes_size(mesh, s if isinstance(s, tuple) else (s,))
    return n
