"""Qwen2-VL-7B backbone [arXiv:2409.12191; hf]. M-RoPE; vision frontend is a
stub (input_specs provides patch embeddings + 3D positions)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-7b", family="vlm",
    n_layers=28, d_model=3584, n_heads=28, n_kv_heads=4, d_ff=18944,
    vocab=152064, head_dim=128,
    rope_theta=1e6, rope_style="mrope", mrope_sections=(16, 24, 24),
    qkv_bias=True, embeddings_input=True,
)
