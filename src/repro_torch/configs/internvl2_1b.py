# Port of src/repro/configs/internvl2_1b.py: a copy with its imports rewired to repro_torch.
"""InternVL2-1B backbone (Qwen2-0.5B-style LM): the InternViT frontend is a
stub per the brief — input_specs() provides 256 precomputed patch embeddings
prepended to the text sequence. [arXiv:2404.16821; hf]
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b",
    family="vlm",
    num_layers=24,
    d_model=896,
    num_heads=14,
    num_kv_heads=2,
    head_dim=64,
    d_ff=4864,
    vocab_size=151655,
    attention="gqa",
    qkv_bias=True,
    rope_theta=1_000_000.0,
    ffn_activation="silu_glu",
    frontend="vision",
    num_prefix_embeds=256,
    source="[arXiv:2404.16821; hf]",
)
