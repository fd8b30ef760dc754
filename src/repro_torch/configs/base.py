"""Architecture + shape configuration dataclasses (a copy of the reference's)."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0            # 0 -> d_model // n_heads
    # --- attention flavour ---
    rope_theta: float = 1e4
    rope_style: str = "standard"     # standard | partial (chatglm 2d) | mrope
    rope_fraction: float = 1.0       # chatglm3: rotary on half the dims
    mrope_sections: tuple[int, ...] = ()  # qwen2-vl (t, h, w) splits of hd/2
    qk_norm: bool = False            # qwen3
    qkv_bias: bool = False           # qwen2
    sliding_window: int = 0          # gemma3 local layers
    global_every: int = 0            # gemma3: layer i is global iff i % this == this-1
    # --- MoE ---
    moe_experts: int = 0
    moe_top_k: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    # --- SSM (mamba2 / zamba2) ---
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 128
    conv_kernel: int = 4
    # --- hybrid (zamba2) ---
    shared_attn_every: int = 0       # shared transformer block after every N mamba layers
    # --- enc-dec (whisper) ---
    encoder_layers: int = 0
    # --- modality stubs ---
    embeddings_input: bool = False   # vlm/audio: inputs are precomputed embeddings
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    norm_eps: float = 1e-6

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // max(1, self.n_heads))

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim

    @property
    def is_ssm(self) -> bool:
        return self.family in ("ssm", "hybrid")

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for long_500k (see DESIGN.md §4)."""
        return self.family in ("ssm", "hybrid") or (
            self.sliding_window > 0 and self.global_every > 0
        )

    def reduced(self) -> "ArchConfig":
        """Tiny same-family config for CPU smoke tests."""
        small = dict(
            n_layers=min(self.n_layers, 2),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads else 0,
            d_ff=128,
            vocab=256,
            head_dim=16,
            encoder_layers=min(self.encoder_layers, 2),
        )
        if self.moe_experts:
            small.update(moe_experts=4, moe_top_k=2, moe_d_ff=32)
        if self.ssm_state:
            small.update(ssm_state=16, ssm_headdim=16, ssm_chunk=16, ssm_expand=2)
        if self.sliding_window:
            small.update(sliding_window=32, global_every=2)
        if self.shared_attn_every:
            small.update(shared_attn_every=2, n_layers=5)
        if self.mrope_sections:
            small.update(mrope_sections=(2, 3, 3))
        return dataclasses.replace(self, **small)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524288, 1, "decode")

SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}


def shapes_for(cfg: ArchConfig) -> list[ShapeConfig]:
    out = [TRAIN_4K, PREFILL_32K, DECODE_32K]
    if cfg.sub_quadratic:
        out.append(LONG_500K)
    return out
