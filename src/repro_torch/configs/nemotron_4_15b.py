"""nemotron-4-15b [dense] — 32L d_model=6144 48H (GQA kv=8) d_ff=24576
vocab=256000 — GQA, squared-ReLU MLP (no gating). [arXiv:2402.16819]"""
from ..models.transformer import TransformerConfig
from .base import ArchSpec, bf16, register
from .lm_family import lm_cells, lm_input_specs, reduce_config

CONFIG = TransformerConfig(
    name="nemotron-4-15b",
    vocab=256000, d_model=6144, n_layers=32,
    n_heads=48, n_kv=8, d_head=128,        # 48*128 == d_model
    d_ff=24576, act="sq_relu",             # squared-ReLU (Primer)
    rope_theta=10_000.0,
    dtype=bf16,
)

ARCH = register(ArchSpec(
    name="nemotron-4-15b", family="lm", source="arXiv:2402.16819",
    model_config=lambda reduced=False: (reduce_config(CONFIG) if reduced
                                        else CONFIG),
    cells=lambda: lm_cells("nemotron-4-15b"),
    input_specs=lambda shape, reduced=False: lm_input_specs(
        reduce_config(CONFIG) if reduced else CONFIG, shape, reduced),
))
