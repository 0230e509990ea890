"""Content-addressable hashing (paper §III-A2, eq. 1).

    chunk_id = SHA256(normalize(content))

Normalization must be deterministic: identical semantics => identical bytes
=> identical hash. We apply, in order:
  1. Unicode NFC normalization (canonical composition),
  2. newline canonicalization (\r\n, \r -> \n),
  3. per-line trailing-whitespace strip + outer strip,
  4. case folding (full Unicode casefold, stronger than lower()),
  5. internal whitespace-run collapse (tabs/spaces -> single space).

Collision probability is 2^-256 — treated as zero (paper §III-A2).
"""
from __future__ import annotations

import hashlib
import re
import unicodedata

_WS_RUN = re.compile(r"[ \t\f\v]+")


def normalize(text: str) -> str:
    """Deterministic UTF-8 normalization used for content addressing."""
    t = unicodedata.normalize("NFC", text)
    t = t.replace("\r\n", "\n").replace("\r", "\n")
    lines = [_WS_RUN.sub(" ", ln).strip() for ln in t.split("\n")]
    return "\n".join(lines).strip().casefold()


def chunk_hash(text: str) -> str:
    """SHA-256 content address of a chunk (hex digest)."""
    return hashlib.sha256(normalize(text).encode("utf-8")).hexdigest()


def blob_checksum(data: bytes) -> str:
    """Checksum used for segment / checkpoint integrity verification."""
    return hashlib.sha256(data).hexdigest()


def file_checksum(path: str, chunk_bytes: int = 1 << 20) -> str:
    """Streamed ``blob_checksum`` of a file — verifies large sidecars
    without buffering the whole file in memory."""
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            chunk = f.read(chunk_bytes)
            if not chunk:
                break
            h.update(chunk)
    return h.hexdigest()
