"""IO classification: rule-driven sub-partitions, per-class write
policies and sequential-cutoff bypass (the Open-CAS io_class model).

The PyTorch counterpart of :mod:`repro.classify`: the rule engine in
:mod:`repro_torch.classify.rules` and the class-to-sub-partition mapping
the controllers consume (``EticaConfig.classifier`` /
``SingleLevelConfig.classifier``) in :mod:`repro_torch.classify.classifier`.
"""
from .classifier import Classifier, match_all, seq_cutoff
from .rules import (ClassRule, IOClass, RulePlan, classify_block,
                    classify_ref, compile_rules)

__all__ = [
    "ClassRule",
    "IOClass",
    "RulePlan",
    "compile_rules",
    "classify_block",
    "classify_ref",
    "Classifier",
    "match_all",
    "seq_cutoff",
]
