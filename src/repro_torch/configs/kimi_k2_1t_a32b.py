"""kimi-k2-1t-a32b [moe] — 61L d_model=7168 64H (GQA kv=8) d_ff=2048
(per-expert) vocab=163840, MoE 384 experts top-8 (+1 shared, K2-style) —
trillion-param MoE. [arXiv:2501.kimi2 (paper-table); unverified]

~1.04e12 total / ~3.2e10 active params (cfg.n_params() /
n_active_params()). Memory plan (DESIGN.md §6): Adafactor (factored
second moment, bf16 params, no fp32 master) — full Adam at 14 B/param
would need 27 GB/chip on 512 chips; factored state fits ~4 GB/chip."""
from ..models.moe import MoEConfig
from ..models.transformer import TransformerConfig
from .base import ArchSpec, bf16, register
from .lm_family import lm_cells, lm_input_specs, reduce_config

CONFIG = TransformerConfig(
    name="kimi-k2-1t-a32b",
    vocab=163840, d_model=7168, n_layers=61,
    n_heads=64, n_kv=8, d_head=128,
    d_ff=2048,                              # (unused: MoE layers)
    act="swiglu",
    rope_theta=50_000.0,
    moe=MoEConfig(n_experts=384, top_k=8, d_ff=2048, n_shared=1,
                  capacity_factor=1.25),
    dtype=bf16,
)

ARCH = register(ArchSpec(
    name="kimi-k2-1t-a32b", family="lm", source="arXiv:2501.kimi2",
    model_config=lambda reduced=False: (reduce_config(CONFIG) if reduced
                                        else CONFIG),
    cells=lambda: lm_cells("kimi-k2-1t-a32b"),
    input_specs=lambda shape, reduced=False: lm_input_specs(
        reduce_config(CONFIG) if reduced else CONFIG, shape, reduced),
))
