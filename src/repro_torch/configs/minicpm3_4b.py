# Port of src/repro/configs/minicpm3_4b.py: a copy with its imports rewired to repro_torch.
"""MiniCPM3-4B: dense with Multi-head Latent Attention (MLA).

[hf:openbmb/MiniCPM3-4B; hf] — 62L, d_model=2560, 40 heads (kv=40 at the
architectural level; MLA compresses KV to kv_lora_rank=256 + 32 rope dims),
d_ff=6400, vocab=73448. MLA dims follow the HF config: q_lora_rank=768,
kv_lora_rank=256, qk_nope_head_dim=64, qk_rope_head_dim=32, v_head_dim=64.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="minicpm3-4b",
    family="dense",
    num_layers=62,
    d_model=2560,
    num_heads=40,
    num_kv_heads=40,
    head_dim=64,
    d_ff=6400,
    vocab_size=73448,
    attention="mla",
    q_lora_rank=768,
    kv_lora_rank=256,
    qk_nope_dim=64,
    qk_rope_dim=32,
    v_head_dim=64,
    ffn_activation="silu_glu",
    source="[hf:openbmb/MiniCPM3-4B; hf]",
)
