"""The optimizer and gradient compression (the port of
:mod:`repro.optim`)."""
from .adamw import OptConfig, apply_updates, clip_by_global_norm, \
    global_norm, init_opt_state, schedule
from .compress import (compressed_psum, dequantize_int8, ef_compress_update,
                       init_error_buf, quantize_int8)
