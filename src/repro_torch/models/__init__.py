"""Model zoo for serving: configs, layers, attention, MoE, SSM, blocks
and the models of every family (the port of :mod:`repro.models`)."""
