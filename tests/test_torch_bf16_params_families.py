"""Port parity with bf16 weights, the other three families: the hybrid
(jamba, its reference compiled with excess precision off), the VLM
(internvl2, 16 patches before the text) and the enc-dec (seamless)
prefill on parameters cast to bfloat16 by the reference dry-run's rule,
vs the reference's ``make_prefill_step`` on the same cast leaves, on the
CPU. Helpers and tolerances: tests/test_torch_bf16_params_models.py
(logits within 2e-2 of the logit scale, the same next tokens wherever
the reference's top-2 margin is clear).
"""
import pytest

from test_torch_bf16_params_models import FAMILIES, check_prefill


@pytest.mark.parametrize("arch", FAMILIES[3:])
def test_prefill_on_bf16_leaves_matches_reference(arch):
    check_prefill(arch)
