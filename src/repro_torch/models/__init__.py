"""Model zoo for serving: configs, layers, attention, blocks and the
dense causal LM (the port of :mod:`repro.models`, dense family)."""
