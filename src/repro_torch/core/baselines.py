"""The one-level baselines the paper compares ETICA against (§2, Table 1).

The PyTorch counterpart of :mod:`repro.core.baselines` on its batched
path. All four share the :class:`~repro_torch.core.controller
.PartitionedSingleLevelCache` chassis and differ in sizing metric and
write policy:

  * ECI-Cache   — URD sizing, per-VM WB/RO from the read ratio (the
    paper's main comparison, fig. 12 and fig. 14);
  * Centaur     — TRD sizing, WB;
  * S-CAVE      — working-set-size sizing, WT;
  * vCacheShare — reuse-intensity sizing, RO.

A :class:`~repro_torch.core.reuse.SizingMetric` (re-exported here) sizes
every VM in one batched pass
(:func:`repro_torch.core.reuse.sizing_metrics_batch`). The reference's
per-VM ``*_ref`` closures, ``FastCache`` and ``L2ARCCache`` are not
ported yet.
"""
from __future__ import annotations

from repro_torch.core.controller import (Geometry,
                                         PartitionedSingleLevelCache,
                                         PolicyChooser, SingleLevelConfig,
                                         _mrc_grid)
from repro_torch.core.policies import Policy
from repro_torch.core.reuse import SizingMetric


def urd_metric(geom: Geometry, points: int = 17) -> SizingMetric:
    """ECI-Cache: max reuse distance over read re-references, + 1."""
    return SizingMetric("urd", _mrc_grid(geom, points))


def trd_metric(geom: Geometry, points: int = 17) -> SizingMetric:
    """Centaur: max reuse distance over every re-access, + 1."""
    return SizingMetric("trd", _mrc_grid(geom, points))


def wss_metric(geom: Geometry, points: int = 17) -> SizingMetric:
    """S-CAVE: distinct blocks touched (TRD curve for partitioning)."""
    return SizingMetric("wss", _mrc_grid(geom, points))


def reuse_intensity_metric(geom: Geometry, points: int = 17) -> SizingMetric:
    """vCacheShare: distinct re-referenced read blocks (POD(RO) curve)."""
    return SizingMetric("reuse_intensity", _mrc_grid(geom, points))


def eci_policy(read_heavy_threshold: float = 0.8) -> PolicyChooser:
    """ECI-Cache gives RO to read-dominated VMs (endurance) and WB to
    the rest (performance)."""
    def from_ratio(read_ratio: float) -> Policy:
        return (Policy.RO if read_ratio >= read_heavy_threshold
                else Policy.WB)
    return PolicyChooser(from_read_ratio=from_ratio)


def fixed_policy(p: Policy):
    return lambda sub: p


def make_eci_cache(capacity: int, num_vms: int,
                   geometry: Geometry | None = None,
                   resize_interval: int = 10_000, device="cuda",
                   **kw) -> PartitionedSingleLevelCache:
    geometry = geometry or Geometry()
    cfg = SingleLevelConfig(capacity=capacity, geometry=geometry,
                            resize_interval=resize_interval, **kw)
    return PartitionedSingleLevelCache(cfg, num_vms, urd_metric(geometry),
                                       eci_policy(), device)


def make_centaur(capacity: int, num_vms: int,
                 geometry: Geometry | None = None, device="cuda", **kw):
    geometry = geometry or Geometry()
    cfg = SingleLevelConfig(capacity=capacity, geometry=geometry, **kw)
    return PartitionedSingleLevelCache(cfg, num_vms, trd_metric(geometry),
                                       fixed_policy(Policy.WB), device)


def make_scave(capacity: int, num_vms: int,
               geometry: Geometry | None = None, device="cuda", **kw):
    geometry = geometry or Geometry()
    cfg = SingleLevelConfig(capacity=capacity, geometry=geometry, **kw)
    return PartitionedSingleLevelCache(cfg, num_vms, wss_metric(geometry),
                                       fixed_policy(Policy.WT), device)


def make_vcacheshare(capacity: int, num_vms: int,
                     geometry: Geometry | None = None, device="cuda", **kw):
    geometry = geometry or Geometry()
    cfg = SingleLevelConfig(capacity=capacity, geometry=geometry, **kw)
    return PartitionedSingleLevelCache(cfg, num_vms,
                                       reuse_intensity_metric(geometry),
                                       fixed_policy(Policy.RO), device)
