"""Semantic chunking (paper §III-A1).

Documents are split at paragraph boundaries (double newlines) into semantic
units. Tables, fenced code blocks, and contiguous list blocks are treated as
ATOMIC chunks to preserve structural integrity — a change inside a table is
a change of the whole table.
"""
from __future__ import annotations

import re

from .hashing import chunk_hash
from .types import Chunk

_FENCE = re.compile(r"^(```|~~~)")
_TABLE_ROW = re.compile(r"^\s*\|.*\|\s*$")
_LIST_ITEM = re.compile(r"^\s*([-*+]|\d+[.)])\s+")


def _classify_block(block: str) -> str:
    first = block.split("\n", 1)[0]
    if _FENCE.match(first):
        return "code"
    if _TABLE_ROW.match(first):
        return "table"
    if _LIST_ITEM.match(first):
        return "list"
    return "para"


def split_blocks(text: str) -> list[str]:
    """Split a document into raw blocks.

    Fenced code blocks are kept intact even if they contain blank lines;
    everything else splits on runs of blank lines. Consecutive table rows /
    list items form one atomic block each.
    """
    lines = text.split("\n")
    blocks: list[str] = []
    cur: list[str] = []
    in_fence = False
    fence_tok = None

    def flush() -> None:
        if cur:
            blk = "\n".join(cur).strip("\n")
            if blk.strip():
                blocks.append(blk)
            cur.clear()

    for ln in lines:
        stripped = ln.strip()
        if in_fence:
            cur.append(ln)
            if fence_tok and stripped.startswith(fence_tok):
                in_fence = False
                flush()
            continue
        m = _FENCE.match(stripped)
        if m:
            flush()
            in_fence = True
            fence_tok = m.group(1)
            cur.append(ln)
            continue
        if not stripped:
            flush()
            continue
        cur.append(ln)
    flush()

    # Merge consecutive table rows / list items that were split by the
    # blank-line rule into single atomic blocks.
    merged: list[str] = []
    for blk in blocks:
        kind = _classify_block(blk)
        if merged and kind in ("table", "list") and _classify_block(merged[-1]) == kind:
            merged[-1] = merged[-1] + "\n" + blk
        else:
            merged.append(blk)
    return merged


def chunk_document(text: str) -> list[Chunk]:
    """Chunk a document and content-address every chunk.

    Position is the block index — stable ordering enables the paper's
    positional CDC classification and structural reconstruction (§III-A4).
    """
    out: list[Chunk] = []
    for pos, blk in enumerate(split_blocks(text)):
        out.append(Chunk(text=blk, position=pos, chunk_id=chunk_hash(blk),
                         kind=_classify_block(blk)))
    return out


def reassemble(chunks: list[Chunk]) -> str:
    """Structural reconstruction: reassemble chunks in document order
    (paper §III-A4 'Structural reconstruction')."""
    return "\n\n".join(c.text for c in sorted(chunks, key=lambda c: c.position))
