# Port of src/repro/configs/base.py: a copy with its imports rewired to repro_torch.
"""Model / run configuration dataclasses.

A single frozen ``ModelConfig`` drives every architecture family in the
assigned pool (dense GQA, MLA, MoE, SSM, RG-LRU hybrid, audio, VLM). The
config is static (hashable) so it can be a jit static argument.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from repro_torch.core.policy import QuantPolicy


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int                  # true architectural head count
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128

    # --- attention ---
    attention: str = "gqa"          # gqa | mla | none
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    sliding_window: int = 0         # 0 = full attention
    # MLA (minicpm3 / deepseek-style)
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0

    # --- FFN / MoE ---
    ffn_activation: str = "silu_glu"  # silu_glu | gelu_glu | gelu
    num_experts: int = 0
    experts_per_token: int = 0
    moe_shared_expert_ff: int = 0   # >0: llama4-style shared expert width
    moe_capacity_factor: float = 1.25

    # --- SSM (mamba1) ---
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    dt_rank: int = 0

    # --- hybrid (recurrentgemma) ---
    block_pattern: Tuple[str, ...] = ()   # e.g. ("rec", "rec", "attn")
    lru_width: int = 0

    # --- modality frontend (stub per brief) ---
    frontend: str = "none"          # none | audio | vision
    num_prefix_embeds: int = 0      # patch/frame embeddings provided upstream

    # --- misc ---
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    subquadratic: bool = False      # eligible for long_500k

    # Reference/source tag: [source; verified-tier]
    source: str = ""

    @property
    def d_attn_out(self) -> int:
        """Width of the attention-value output entering o_proj (true heads)."""
        if self.attention == "mla":
            return self.num_heads * self.v_head_dim
        return self.num_heads * self.head_dim

    @property
    def d_inner(self) -> int:  # mamba inner width
        return self.ssm_expand * self.d_model

    def reduced(self, **over) -> "ModelConfig":
        """A tiny same-family config for CPU smoke tests."""
        small = dict(
            num_layers=min(self.num_layers, 2 if not self.block_pattern else len(self.block_pattern)),
            d_model=128,
            num_heads=4,
            num_kv_heads=min(self.num_kv_heads, 2) if self.num_kv_heads else 0,
            head_dim=32,
            d_ff=256,
            vocab_size=512,
        )
        if self.attention == "mla":
            small.update(q_lora_rank=64, kv_lora_rank=32, qk_nope_dim=16,
                         qk_rope_dim=16, v_head_dim=32)
        if self.num_experts:
            small.update(num_experts=4,
                         experts_per_token=min(self.experts_per_token, 2))
        if self.moe_shared_expert_ff:
            small.update(moe_shared_expert_ff=256)
        if self.ssm_state:
            small.update(ssm_state=8, dt_rank=8)
        if self.lru_width:
            small.update(lru_width=128)
        if self.sliding_window:
            small.update(sliding_window=64)
        if self.num_prefix_embeds:
            small.update(num_prefix_embeds=8)
        small.update(over)
        return dataclasses.replace(self, **small)


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """Everything around the model: shapes, quantization, execution knobs."""

    model: ModelConfig
    seq_len: int = 4096
    global_batch: int = 256
    mode: str = "train"             # train | prefill | decode
    # training
    microbatch: int = 0             # 0 = auto (one sample per data shard)
    remat: bool = True
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    grad_clip: float = 1.0
    grad_compression: str = "none"  # none | int8_ag
    # serving (the paper's regime)
    quant: Optional[QuantPolicy] = None
    # attention blocking
    attn_block_kv: int = 1024
    # sharding
    fsdp: bool = True

    @property
    def quantized(self) -> bool:
        return self.quant is not None and self.quant.scheme != "fp16"
