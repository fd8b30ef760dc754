"""OLMoE-1B-7B [arXiv:2409.02060; hf]. 64 experts, top-8, d_ff=1024/expert."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="olmoe-1b-7b", family="moe",
    n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16, d_ff=1024,
    vocab=50304, head_dim=128, rope_theta=1e4, qk_norm=True,
    moe_experts=64, moe_top_k=8, moe_d_ff=1024,
)
