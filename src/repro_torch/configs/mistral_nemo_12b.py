"""mistral-nemo-12b [dense] — 40L d_model=5120 32H (GQA kv=8) d_ff=14336
vocab=131072, 128k ctx, bf16. The generator of RAG serving.
[hf:mistralai/Mistral-Nemo-Base-2407; hf]"""
from ..models.transformer import TransformerConfig
from .base import ArchSpec, bf16, register
from .lm_family import lm_cells, lm_input_specs, reduce_config

SOURCE = "hf:mistralai/Mistral-Nemo-Base-2407"

CONFIG = TransformerConfig(
    name="mistral-nemo-12b",
    vocab=131072, d_model=5120, n_layers=40,
    n_heads=32, n_kv=8, d_head=128,        # GQA 4:1, head_dim 128
    d_ff=14336, act="swiglu",
    rope_theta=1_000_000.0,                # 128k-context rope base
    dtype=bf16,
)

ARCH = register(ArchSpec(
    name="mistral-nemo-12b", family="lm", source=SOURCE,
    model_config=lambda reduced=False: (reduce_config(CONFIG) if reduced
                                        else CONFIG),
    cells=lambda: lm_cells("mistral-nemo-12b"),
    input_specs=lambda shape, reduced=False: lm_input_specs(
        reduce_config(CONFIG) if reduced else CONFIG, shape, reduced),
))
