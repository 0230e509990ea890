"""Model configurations of the port: repro's ``configs/`` without JAX.
``base`` holds the ``ArchSpec`` registry, which registers the recsys
family (FM, DLRM, Wide&Deep, BERT4Rec); the MiniLM embedder and
Mistral-NeMo-12B are ``CONFIG`` constants of the RAG path, each with
its ``SOURCE``. The other families wait for their port (ROADMAP Queue 1
item 11)."""
from .base import (ArchSpec, Cell, all_cells, get_arch,  # noqa: F401
                   list_archs, register)
