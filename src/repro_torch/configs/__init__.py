"""Model configurations of the port: repro's ``configs/`` without JAX.
``base`` holds the ``ArchSpec`` registry, which registers the LM family
(Mistral-NeMo-12B, Nemotron-4-15B, Qwen1.5-32B, Kimi-K2, Qwen2-MoE), the
recsys family (FM, DLRM, Wide&Deep, BERT4Rec) and the MiniLM embedder.
SchNet, whose only cell is ``train``, waits for ROADMAP Queue 1 item 12."""
from .base import (ArchSpec, Cell, all_cells, get_arch,  # noqa: F401
                   list_archs, register)
