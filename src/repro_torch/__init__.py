"""PyTorch/CUDA port of the ETICA two-level cache (see ``repro`` for the
JAX reference). Entry points run on the CUDA card unless the caller
passes ``device="cpu"``; the CUDA kernels live in ``csrc/`` and are
built at first use (:mod:`repro_torch.kernels`)."""
