"""KV-cache management for batched serving (PyTorch), repro's
``serve/kv_cache.py``.

Slot-based: a fixed (max_batch, L, KV, S, Dh) arena; requests claim a
slot at prefill, decode steps run over the whole arena (inactive slots
masked by per-slot length 0), slots free on completion. Mirrors the
hot-tier slot allocator — both are capacity-bounded device-resident
stores with free-list reuse.

Optional int8 quantization (KIVI/KVQuant-style, per (slot, layer, head)
scales): halves cache HBM vs bf16 — what makes qwen1.5-32b decode_32k fit
a single 16GB-chip pod (EXPERIMENTS.md §Perf).

The arena's tensors live on ``device`` (None = the card) and are written
in place; ``lengths`` and the free list stay on the host."""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..kernels.common import resolve_device


@dataclasses.dataclass
class CacheConfig:
    n_layers: int
    n_kv: int
    d_head: int
    max_seq: int
    max_batch: int
    dtype: torch.dtype = torch.bfloat16
    quantize_int8: bool = False


def quantize_kv(x: torch.Tensor):
    """(..., S, Dh) -> (int8 values, f32 scales over Dh)."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp(amax, min=1e-8) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor,
                  dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


class KVCacheArena:
    def __init__(self, cfg: CacheConfig, device=None):
        self.cfg = cfg
        dev = resolve_device(device)
        shape = (cfg.n_layers, cfg.max_batch, cfg.n_kv, cfg.max_seq,
                 cfg.d_head)
        if cfg.quantize_int8:
            self.k = torch.zeros(shape, dtype=torch.int8, device=dev)
            self.v = torch.zeros(shape, dtype=torch.int8, device=dev)
            sshape = shape[:-1] + (1,)
            self.k_scale = torch.zeros(sshape, dtype=torch.float32,
                                       device=dev)
            self.v_scale = torch.zeros(sshape, dtype=torch.float32,
                                       device=dev)
        else:
            self.k = torch.zeros(shape, dtype=cfg.dtype, device=dev)
            self.v = torch.zeros(shape, dtype=cfg.dtype, device=dev)
        self.lengths = np.zeros(cfg.max_batch, np.int32)
        self._free = list(range(cfg.max_batch - 1, -1, -1))
        self._active: set[int] = set()

    # -- slot lifecycle -------------------------------------------------
    def claim(self) -> Optional[int]:
        if not self._free:
            return None
        slot = self._free.pop()
        self._active.add(slot)
        self.lengths[slot] = 0
        return slot

    def release(self, slot: int) -> None:
        self._active.discard(slot)
        self.lengths[slot] = 0
        self._free.append(slot)

    @property
    def active_slots(self) -> list[int]:
        return sorted(self._active)

    # -- writes ----------------------------------------------------------
    def write_prefill(self, slot: int, k_new: torch.Tensor,
                      v_new: torch.Tensor) -> None:
        """k_new/v_new: (L, KV, S_prompt, Dh)."""
        s = k_new.shape[2]
        if self.cfg.quantize_int8:
            qk, sk = quantize_kv(k_new)
            qv, sv = quantize_kv(v_new)
            self.k[:, slot, :, :s] = qk
            self.v[:, slot, :, :s] = qv
            self.k_scale[:, slot, :, :s] = sk
            self.v_scale[:, slot, :, :s] = sv
        else:
            self.k[:, slot, :, :s] = k_new.to(self.k.dtype)
            self.v[:, slot, :, :s] = v_new.to(self.v.dtype)
        self.lengths[slot] = s

    def dequantized(self, slots: list[int]):
        """Materialize bf16 views of the given slots: (L, B', KV, S, Dh)."""
        ksel = self.k[:, slots]
        vsel = self.v[:, slots]
        if not self.cfg.quantize_int8:
            return ksel, vsel
        return (dequantize_kv(ksel, self.k_scale[:, slots], self.cfg.dtype),
                dequantize_kv(vsel, self.v_scale[:, slots], self.cfg.dtype))

    def memory_bytes(self) -> int:
        total = self.k.numel() * self.k.element_size() * 2
        if self.cfg.quantize_int8:
            total += self.k_scale.numel() * 4 * 2
        return total
