"""ChatGLM3-6B [arXiv:2406.12793; hf]. 2D/partial RoPE (half dims), GQA kv=2."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="chatglm3-6b", family="dense",
    n_layers=28, d_model=4096, n_heads=32, n_kv_heads=2, d_ff=13696,
    vocab=65024, head_dim=128, rope_theta=1e4,
    rope_style="partial", rope_fraction=0.5, qkv_bias=True,
)
