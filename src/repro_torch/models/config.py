"""Model configuration schema for the assigned architecture pool (a copy
of :mod:`repro.models.config`, so the port imports nothing of the JAX
package).

One :class:`ModelConfig` describes any member of the zoo: dense GQA
transformers, MoE (incl. fine-grained + shared experts), pure SSM
(Mamba2/SSD), hybrid SSM+attention (Jamba), encoder-decoder (Seamless),
and VLM/audio backbones with stub modality frontends.

The layer stack is expressed as a repeating *superlayer pattern* so that
heterogeneous stacks (Jamba's 1:7 attn:mamba interleave with MoE every
2nd layer) share one block layout per pattern position; the port runs
the stack as a loop over its superlayers.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Literal

BlockKind = Literal["attn", "ssm"]


@dataclasses.dataclass(frozen=True)
class BlockSpec:
    """One block inside the superlayer pattern."""
    kind: BlockKind = "attn"          # sequence mixer
    moe: bool = False                 # MoE FFN instead of dense FFN
    has_mlp: bool = True              # SSM blocks carry no separate FFN


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                       # dense | moe | ssm | hybrid | encdec | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # --- attention details ---
    qk_norm: bool = False
    sliding_window: int = 0           # 0 = full attention
    rope_theta: float = 10_000.0
    mlp_act: str = "swiglu"           # swiglu | relu2 | gelu

    # --- MoE ---
    moe_num_experts: int = 0
    moe_top_k: int = 0
    moe_num_shared: int = 0
    moe_d_ff: int = 0                 # per-expert ffn width
    moe_layer_period: int = 1         # every k-th block uses MoE
    first_dense_ff: int = 0           # deepseek: layer 0 dense FFN width
    moe_capacity_factor: float = 1.25

    # --- SSM (Mamba2/SSD) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    ssm_chunk: int = 128
    attn_period: int = 0              # hybrid: one attn block per `period`

    # --- encoder-decoder ---
    encoder_layers: int = 0

    # --- modality frontend stub ---
    frontend: str = "none"            # none | audio | vision
    frontend_tokens: int = 256        # vision: image tokens prepended

    # --- numerics ---
    dtype: str = "bfloat16"
    norm_eps: float = 1e-5

    # ------------------------------------------------------------------
    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for the long_500k shape (SSM / hybrid / SWA)."""
        return self.family in ("ssm", "hybrid") or self.sliding_window > 0

    @property
    def ssm_heads(self) -> int:
        return (self.ssm_expand * self.d_model) // self.ssm_head_dim

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    # --- superlayer pattern -------------------------------------------
    def layer_pattern(self) -> tuple[BlockSpec, ...]:
        """The repeating block pattern (one *superlayer*)."""
        if self.family == "hybrid":
            period = self.attn_period or 8
            blocks = []
            for i in range(period):
                kind = "attn" if i == period - 1 else "ssm"
                moe = (self.moe_num_experts > 0
                       and (i % self.moe_layer_period) == self.moe_layer_period - 1)
                blocks.append(BlockSpec(kind=kind, moe=moe, has_mlp=True))
            return tuple(blocks)
        if self.family == "ssm":
            return (BlockSpec(kind="ssm", has_mlp=False),)
        if self.moe_num_experts > 0:
            return (BlockSpec(kind="attn", moe=True),)
        return (BlockSpec(kind="attn"),)

    @property
    def pattern_len(self) -> int:
        return len(self.layer_pattern())

    @property
    def num_superlayers(self) -> int:
        n = self.num_layers - (1 if self.first_dense_ff else 0)
        assert n % self.pattern_len == 0, (
            f"{self.name}: {n} layers not divisible by pattern "
            f"{self.pattern_len}")
        return n // self.pattern_len

    # --- parameter counts (for roofline MODEL_FLOPS) --------------------
    def _attn_params(self) -> int:
        d, h, hk, dh = self.d_model, self.num_heads, self.num_kv_heads, self.head_dim
        return d * h * dh + 2 * d * hk * dh + h * dh * d

    def _mlp_params(self, ff: int) -> int:
        mult = 3 if self.mlp_act == "swiglu" else 2
        return mult * self.d_model * ff

    def _moe_params(self) -> tuple[int, int]:
        """(total, active) params of one MoE FFN."""
        e, k, sh = self.moe_num_experts, self.moe_top_k, self.moe_num_shared
        per = self._mlp_params(self.moe_d_ff or self.d_ff)
        router = self.d_model * e
        total = e * per + sh * per + router
        active = k * per + sh * per + router
        return total, active

    def _ssm_params(self) -> int:
        d, di, n = self.d_model, self.d_inner, self.ssm_state
        h = self.ssm_heads
        in_proj = d * (2 * di + 2 * n + h)   # z, x, B, C, dt
        conv = (di + 2 * n) * self.ssm_conv
        out_proj = di * d
        return in_proj + conv + out_proj + 3 * h  # + A, D, dt_bias

    def param_counts(self) -> tuple[int, int]:
        """(total, active) parameter counts, embeddings included."""
        total = active = self.vocab_size * self.d_model * 2  # in + out embed
        def add(n_total, n_active=None):
            nonlocal total, active
            total += n_total
            active += n_active if n_active is not None else n_total

        stacks = [self.num_layers]
        if self.is_encdec:
            stacks = [self.encoder_layers, self.num_layers]
        # decoder/self stack
        pattern = self.layer_pattern()
        reps = self.num_superlayers
        for spec in pattern:
            if spec.kind == "attn":
                add(reps * self._attn_params())
            else:
                add(reps * self._ssm_params())
            if spec.has_mlp:
                if spec.moe:
                    t, a = self._moe_params()
                    add(reps * t, reps * a)
                else:
                    add(reps * self._mlp_params(self.d_ff))
        if self.first_dense_ff:
            add(self._attn_params() + self._mlp_params(self.first_dense_ff))
        if self.is_encdec:
            # encoder: attn + mlp; decoder adds cross-attention
            add(self.encoder_layers * (self._attn_params()
                                       + self._mlp_params(self.d_ff)))
            add(self.num_layers * self._attn_params())  # cross-attn
        return total, active

    def model_flops(self, tokens: int, decode: bool = False) -> float:
        """6·N·D for training, 2·N_active·D for inference forward."""
        total, active = self.param_counts()
        return (2.0 if decode else 6.0) * active * tokens


# ---------------------------------------------------------------------------
# input shapes assigned to the LM pool
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # train | prefill | decode


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """Whether an (arch, shape) cell runs; else the documented skip reason."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, ("full-attention arch: 500k-context decode requires "
                       "sub-quadratic attention (DESIGN.md §6)")
    return True, ""
