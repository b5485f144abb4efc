# Port of src/repro/configs/qwen2_7b.py: a copy with its imports rewired to repro_torch.
"""Qwen2-7B: dense GQA with QKV bias. [arXiv:2407.10671; hf]"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-7b",
    family="dense",
    num_layers=28,
    d_model=3584,
    num_heads=28,
    num_kv_heads=4,
    head_dim=128,
    d_ff=18944,
    vocab_size=152064,
    attention="gqa",
    qkv_bias=True,
    rope_theta=1_000_000.0,
    ffn_activation="silu_glu",
    source="[arXiv:2407.10671; hf]",
)
