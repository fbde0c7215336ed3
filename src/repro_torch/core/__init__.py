"""ETICA core: the paper's contribution as PyTorch modules.

Layering (bottom-up):

  * :mod:`~repro_torch.core.policies`  — write-policy semantics + device
    model.
  * :mod:`~repro_torch.core.trace`     — block-I/O traces (host numpy).
  * :mod:`~repro_torch.core.reuse`     — TRD / URD / POD reuse-distance
    engine and miss-ratio curves.
  * :mod:`~repro_torch.core.popularity`— Eq. 1 popularity scoring.
  * :mod:`~repro_torch.core.partition` — PPC (Eq. 3) cache-space
    partitioning.
  * :mod:`~repro_torch.core.simulator` — exact set-associative datapaths
    (single-level + ETICA two-level) and the maintenance ops.
  * :mod:`~repro_torch.core.controller`— interval-driven controllers
    (ETICA and the shared one-level baseline chassis).
  * :mod:`~repro_torch.core.baselines` — ECI-Cache, Centaur, S-CAVE,
    vCacheShare.

The names below are those of :mod:`repro.core` that the port has. Each
is imported from its module on first use, so importing the package
imports no submodule and builds no kernel.
"""
from __future__ import annotations

import importlib

_EXPORTS = {
    "policies": ("LEVEL_LATENCY", "Level", "Policy", "T_DRAM", "T_HDD",
                 "T_SSD"),
    "trace": ("Trace", "interleave", "pad_batch", "split_by_vm"),
    "reuse": ("DistResult", "SizingMetric", "demand_blocks",
              "hit_counts_at_sizes", "hit_counts_at_sizes_weighted", "mrc",
              "pod", "pod_distances", "trd", "trd_distances", "urd",
              "urd_distances"),
    "popularity": ("PopularityTable", "PopularityTracker", "block_scores",
                   "contributions", "table_init", "table_least_popular",
                   "table_len", "table_scores", "table_top_known",
                   "table_update"),
    "partition": ("PartitionResult", "partition"),
    "simulator": ("CacheState", "PolicyFlags", "Stats",
                  "aggregate_stats_sharded", "capacity_to_ways",
                  "evict_blocks", "gather_rows", "make_cache",
                  "make_cache_batch", "policy_flags", "promote_blocks",
                  "resize", "resize_batch", "resize_batch_sharded",
                  "resize_levels", "resize_levels_sharded", "shard_rows",
                  "simulate_single_level", "simulate_single_level_batch",
                  "simulate_single_level_classified",
                  "simulate_single_level_classified_batch",
                  "simulate_single_level_sharded",
                  "simulate_two_level", "simulate_two_level_batch",
                  "simulate_two_level_classified",
                  "simulate_two_level_classified_batch",
                  "simulate_two_level_sharded", "stack_states",
                  "unstack_states"),
    "controller": ("EticaCache", "EticaConfig", "Geometry", "IntervalLog",
                   "PartitionedSingleLevelCache", "PolicyChooser",
                   "SingleLevelConfig", "VMResult"),
    "baselines": ("make_centaur", "make_eci_cache", "make_scave",
                  "make_vcacheshare", "reuse_intensity_metric",
                  "reuse_intensity_metric_ref", "trd_metric",
                  "trd_metric_ref", "urd_metric", "urd_metric_ref",
                  "wss_metric", "wss_metric_ref"),
}
_MODULE_OF = {name: mod for mod, names in _EXPORTS.items() for name in names}

__all__ = [name for names in _EXPORTS.values() for name in names]


def __getattr__(name: str):
    mod = _MODULE_OF.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(f"{__name__}.{mod}"), name)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(__all__))
