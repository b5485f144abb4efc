# Port of src/repro/configs/musicgen_medium.py: a copy with its imports rewired to repro_torch.
"""MusicGen-medium backbone: decoder-only over EnCodec tokens.
[arXiv:2306.05284; hf] — the EnCodec frontend is a stub per the brief; the
backbone consumes audio-token ids (vocab 2048) directly. Plain GELU MLP.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    family="audio",
    num_layers=48,
    d_model=1536,
    num_heads=24,
    num_kv_heads=24,
    head_dim=64,
    d_ff=6144,
    vocab_size=2048,
    attention="gqa",
    ffn_activation="gelu",
    frontend="audio",
    source="[arXiv:2306.05284; hf]",
)
