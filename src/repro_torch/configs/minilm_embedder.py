"""minilm-embedder — the paper's OWN model (§III-B:
SentenceTransformers all-MiniLM-L6-v2): 6L d_model=384 12H d_ff=1536,
mean pooling, 384-d output. The embedding layer of LiveVectorLake.

Cells: batched corpus encode (ingest path) + single-query encode (query
path). Not part of the assigned 40-cell matrix; included because the
paper's system depends on it."""
from ..models.transformer import TransformerConfig
from .base import ArchSpec, Cell, i32, register, sds

SOURCE = "hf:sentence-transformers/all-MiniLM-L6-v2"

CONFIG = TransformerConfig(
    name="minilm-embedder",
    vocab=30_522, d_model=384, n_layers=6,
    n_heads=12, n_kv=12, d_head=32, d_ff=1536,
    act="gelu", causal=False, remat=False,
)

SHAPES = {
    "encode_corpus": dict(batch=4096, seq=128),   # bulk ingest embedding
    "encode_query": dict(batch=16, seq=64),       # online query embedding
}
SHAPES_REDUCED = {
    "encode_corpus": dict(batch=4, seq=16),
    "encode_query": dict(batch=2, seq=16),
}


def _reduce(cfg):
    import dataclasses
    return dataclasses.replace(cfg, n_layers=2, vocab=512)


def _input_specs(shape: str, reduced: bool = False) -> dict:
    info = (SHAPES_REDUCED if reduced else SHAPES)[shape]
    return {"tokens": sds((info["batch"], info["seq"]), i32)}


ARCH = register(ArchSpec(
    name="minilm-embedder", family="lm-encoder", source=SOURCE,
    model_config=lambda reduced=False: (_reduce(CONFIG) if reduced
                                        else CONFIG),
    cells=lambda: [Cell("minilm-embedder", s, "encode") for s in SHAPES],
    input_specs=_input_specs,
))
