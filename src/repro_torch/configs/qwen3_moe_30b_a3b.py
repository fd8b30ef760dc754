"""Qwen3-30B-A3B [hf:Qwen/Qwen3-30B-A3B]. 128 experts, top-8, d_ff=768/expert."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-moe-30b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=4, d_ff=768,
    vocab=151936, head_dim=128, rope_theta=1e6, qk_norm=True,
    moe_experts=128, moe_top_k=8, moe_d_ff=768,
)
