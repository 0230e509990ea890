"""qwen1.5-32b [dense] — 64L d_model=5120 40H (GQA kv=40 per assignment)
d_ff=27392 vocab=152064 — QKV bias. [hf:Qwen/Qwen1.5 family]

Note: 40 heads is NOT divisible by the 16-way model axis; the sharding
rules keep projections sharded on the fused head*dh dim (5120 % 16 == 0)
and let GSPMD pad the per-head reshape (verified to compile; see
EXPERIMENTS.md §Dry-run)."""
from ..models.transformer import TransformerConfig
from .base import ArchSpec, bf16, register
from .lm_family import lm_cells, lm_input_specs, reduce_config

CONFIG = TransformerConfig(
    name="qwen1.5-32b",
    vocab=152064, d_model=5120, n_layers=64,
    n_heads=40, n_kv=40, d_head=128,       # kv=40 per assignment (MHA-like)
    d_ff=27392, act="swiglu",
    qkv_bias=True,                         # Qwen1.5 signature
    rope_theta=1_000_000.0,
    dtype=bf16,
)

ARCH = register(ArchSpec(
    name="qwen1.5-32b", family="lm", source="hf:Qwen/Qwen1.5-0.5B (family)",
    model_config=lambda reduced=False: (reduce_config(CONFIG) if reduced
                                        else CONFIG),
    cells=lambda: lm_cells("qwen1.5-32b"),
    input_specs=lambda shape, reduced=False: lm_input_specs(
        reduce_config(CONFIG) if reduced else CONFIG, shape, reduced),
))
