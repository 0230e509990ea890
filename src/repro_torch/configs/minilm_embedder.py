"""minilm-embedder — the paper's OWN model (§III-B:
SentenceTransformers all-MiniLM-L6-v2): 6L d_model=384 12H d_ff=1536,
mean pooling, 384-d output. The embedding layer of LiveVectorLake.

``SHAPES`` are repro's two cells: batched corpus encode (ingest path) and
single-query encode (query path)."""
import torch

from ..models.transformer import TransformerConfig

SOURCE = "hf:sentence-transformers/all-MiniLM-L6-v2"

CONFIG = TransformerConfig(
    name="minilm-embedder",
    vocab=30_522, d_model=384, n_layers=6,
    n_heads=12, n_kv=12, d_head=32, d_ff=1536,
    act="gelu", causal=False, dtype=torch.float32,
)

SHAPES = {
    "encode_corpus": dict(batch=4096, seq=128),   # bulk ingest embedding
    "encode_query": dict(batch=16, seq=64),       # online query embedding
}
