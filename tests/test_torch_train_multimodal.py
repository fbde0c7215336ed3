"""Port parity: VLM (internvl2 reduced: patches first, no loss at their
positions) and audio enc-dec (seamless reduced: frames through the
encoder, the decoder's cross attention on its memory) training against
``jax.value_and_grad`` of the reference on the CPU
(``tests/train_parity.py``).

Bars: the loss within 2e-2, the loss's token count equal, every
parameter with a gradient (the frontend's and the encoder's included),
each leaf's relative L2 error within 2e-2. ``-rP`` prints the errors.
"""
import numpy as np
import pytest
import torch

from repro_torch.models import model as M
from train_parity import GRAD_REL, compare, family_batch, pair


@pytest.mark.parametrize("arch", ("internvl2-26b", "seamless-m4t-large-v2"))
def test_loss_and_grads_match_jax(arch):
    errs, summary, _, _ = compare(arch)
    print(summary)
    assert max(errs.values()) <= GRAD_REL, errs


def test_patch_positions_carry_no_loss():
    """The VLM's loss counts the text positions but the last: B x (S_text
    - 1) tokens; the labels at the patches' positions change nothing."""
    _, _, cfg, tree = pair("internvl2-26b")
    batch = {k: torch.from_numpy(v) for k, v in family_batch(cfg).items()}
    model = M.params_from_jax(tree, cfg, device="cpu")
    with torch.no_grad():
        loss, metrics = M.forward_train(model, cfg, batch)
        mask, _ = M._loss_targets(cfg, batch, cfg.frontend_tokens
                                  + batch["tokens"].shape[1])
    b, s_text = batch["tokens"].shape
    assert float(metrics["tokens"]) == b * (s_text - 1)
    assert not mask[:, :cfg.frontend_tokens].any()


def test_encoder_layers_are_checkpointed():
    """Under autograd each encoder layer runs under
    ``torch.utils.checkpoint`` (the reference's ``jax.checkpoint`` of its
    scan body), beside the decoder's superlayers and the loss chunks;
    under ``no_grad`` nothing is, and the loss is the same bits."""
    _, _, cfg, tree = pair("seamless-m4t-large-v2")
    batch = {k: torch.from_numpy(v) for k, v in family_batch(cfg).items()}
    model = M.params_from_jax(tree, cfg, device="cpu").requires_grad_(True)
    calls = []
    orig = M.checkpoint

    def counted(fn, *args, **kw):
        calls.append(fn.__name__)
        return orig(fn, *args, **kw)
    M.checkpoint = counted
    try:
        with torch.no_grad():
            plain, _ = M.forward_train(model, cfg, batch)
        assert calls == []
        traced, _ = M.forward_train(model, cfg, batch)
    finally:
        M.checkpoint = orig
    assert calls.count("_encoder_layer") == cfg.encoder_layers
    assert calls.count("_superlayer") == cfg.num_superlayers
    assert torch.equal(plain, traced.detach())
    traced.backward()
    assert all(p.grad is not None and bool(torch.isfinite(p.grad).all())
               for p in model.encoder.parameters())
    assert np.isfinite(float(traced.detach()))
