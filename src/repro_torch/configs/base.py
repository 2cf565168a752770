"""Model configuration system: one frozen dataclass drives every family.

A copy of ``repro/configs/base.py`` (plain dataclasses, no framework), so
that the port's models read the same fields.  Each architecture gets a
``configs/<id>.py`` exporting ``CONFIG`` with the exact public numbers;
``reduced()`` derives the small same-family variant used by CPU tests.
``repro_torch.configs.get_config(name)`` is the registry entry point.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

__all__ = ["ModelConfig", "SHAPES", "ShapeSpec"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None          # default d_model // n_heads

    # attention features
    qk_norm: bool = False                   # qwen3
    attn_softcap: float = 0.0               # gemma2 (50.0)
    final_softcap: float = 0.0              # gemma2 (30.0)
    sliding_window: int = 0                 # local-attention window
    layer_pattern: str = "global"           # "global" | "local_global" | "hymba"
    global_layers: Tuple[int, ...] = ()     # full-attn layers for hymba pattern
    rope_theta: float = 10_000.0
    embed_scale: bool = False               # gemma2 multiplies embeds by sqrt(d)
    post_norms: bool = False                # gemma2 sandwich (post-block) norms

    # MoE
    n_experts: int = 0
    top_k_experts: int = 0
    moe_shared_expert: bool = False         # llama4 shared expert
    capacity_factor: float = 1.25

    # SSM / hybrid
    ssm_state: int = 0
    ssm_conv: int = 4
    slstm_every: int = 0                    # xlstm: every Nth block is sLSTM

    # encoder-decoder
    n_enc_layers: int = 0

    # modality frontend stubs
    frontend: str = "none"                  # none | vision | audio
    frontend_len: int = 0                   # patch/frame positions per example

    # misc
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    kv_cache_int8: bool = False             # quantised KV cache (serving)
    subquadratic: bool = False              # supports long_500k decode

    # ------------------------------------------------------------------
    @property
    def dh(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def is_encdec(self) -> bool:
        return self.n_enc_layers > 0

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    def n_params(self) -> int:
        """Approximate parameter count (used for MODEL_FLOPS roofline term)."""
        d, dh = self.d_model, self.dh
        attn = d * dh * self.n_heads + 2 * d * dh * self.n_kv_heads + dh * self.n_heads * d
        if self.family == "ssm":
            # xLSTM block: qkv projections + gates + up/down proj (factor 2)
            per_layer = 3 * d * d + 4 * d + 2 * d * 2 * d
        elif self.family == "hybrid":
            di = 2 * d
            ssm = d * 2 * di + di * self.ssm_conv + di * (2 * self.ssm_state + 2) + di * d
            per_layer = attn + ssm + 3 * d * self.d_ff
        elif self.is_moe:
            ff = 3 * d * self.d_ff * self.n_experts + d * self.n_experts
            if self.moe_shared_expert:
                ff += 3 * d * self.d_ff
            per_layer = attn + ff
        else:
            per_layer = attn + 3 * d * self.d_ff
        total = self.n_layers * per_layer + self.vocab_size * d
        if self.is_encdec:
            total += self.n_enc_layers * (attn + 2 * d * self.d_ff) + self.n_enc_layers * attn
        if not self.tie_embeddings:
            total += self.vocab_size * d
        return int(total)

    def n_active_params(self) -> int:
        """Active params per token (MoE: only routed experts count)."""
        if not self.is_moe:
            return self.n_params()
        d = self.d_model
        dense_ff = 3 * d * self.d_ff
        active_ff = dense_ff * self.top_k_experts + (dense_ff if self.moe_shared_expert else 0)
        full_ff = 3 * d * self.d_ff * self.n_experts + (
            dense_ff if self.moe_shared_expert else 0
        )
        return int(self.n_params() - self.n_layers * (full_ff - active_ff))

    # ------------------------------------------------------------------
    def reduced(self) -> "ModelConfig":
        """Same-family small config for CPU smoke tests."""
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            n_layers=min(self.n_layers, 2),
            n_enc_layers=min(self.n_enc_layers, 2),
            d_model=128,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads < self.n_heads else 4,
            head_dim=32,
            d_ff=256 if self.d_ff else 0,
            vocab_size=512,
            n_experts=min(self.n_experts, 8) if self.n_experts else 0,
            top_k_experts=min(self.top_k_experts, 2) if self.top_k_experts else 0,
            # no capacity dropping at smoke scale: keeps prefill (S-1 tokens)
            # and teacher-forced forward (S tokens) bit-comparable
            capacity_factor=8.0 if self.n_experts else self.capacity_factor,
            sliding_window=64 if self.sliding_window else 0,
            frontend_len=16 if self.frontend_len else 0,
            ssm_state=min(self.ssm_state, 8) if self.ssm_state else 0,
            slstm_every=min(self.slstm_every, 2) if self.slstm_every else 0,
            global_layers=tuple(g for g in self.global_layers if g < 2),
        )


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}
