"""qwen2-moe-a2.7b [moe] — 24L d_model=2048 16H (GQA kv=16) d_ff=1408
(per-expert) vocab=151936, MoE 60 routed top-4 + 4 shared experts.
[hf:Qwen/Qwen1.5-MoE-A2.7B]"""
from ..models.moe import MoEConfig
from ..models.transformer import TransformerConfig
from .base import ArchSpec, bf16, register
from .lm_family import lm_cells, lm_input_specs, reduce_config

CONFIG = TransformerConfig(
    name="qwen2-moe-a2.7b",
    vocab=151936, d_model=2048, n_layers=24,
    n_heads=16, n_kv=16, d_head=128,
    d_ff=1408,
    act="swiglu",
    rope_theta=1_000_000.0,
    moe=MoEConfig(n_experts=60, top_k=4, d_ff=1408, n_shared=4,
                  capacity_factor=1.25),
    dtype=bf16,
)

ARCH = register(ArchSpec(
    name="qwen2-moe-a2.7b", family="lm", source="hf:Qwen/Qwen1.5-MoE-A2.7B",
    model_config=lambda reduced=False: (reduce_config(CONFIG) if reduced
                                        else CONFIG),
    cells=lambda: lm_cells("qwen2-moe-a2.7b"),
    input_specs=lambda shape, reduced=False: lm_input_specs(
        reduce_config(CONFIG) if reduced else CONFIG, shape, reduced),
))
