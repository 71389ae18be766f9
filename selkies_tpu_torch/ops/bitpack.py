"""Slot-event bit packing in PyTorch (the JPEG path's plain packer).

The counterpart of the parts of selkies_tpu/ops/bitpack.py that the JPEG
session runs: the JPEG 'size' and value bits of a coefficient, the
default scatter packer (``pack_slot_events_scatter``) and the host-side
word trim. Every (block, slot) position carries one codeword as
(``payload`` LSB-aligned, ``nbits``; 0 bits = no event), slot order is
stream order, stream offsets are an exclusive prefix sum of ``nbits``, and
each codeword adds its aligned bits into the <= 2 words it overlaps
(disjoint bit ranges, so the add is an OR). The CUDA kernel
(csrc/jpeg_pack.cu, wrapper ``ops/jpeg_pipeline.jpeg_pack``) does the
same per stripe.

The reference's other two packers (``pack_slot_events``, a compaction
gather, and ``pack_slot_events_bitmerge``, a hierarchical merge; chosen by
``SELKIES_PACKER``) compute the same words bit for bit; the tests hold
this one against all three.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

_M32 = 0xFFFFFFFF


class PackedStream(NamedTuple):
    words: torch.Tensor       # (..., W_cap) int32, uint32 bit patterns
    total_bits: torch.Tensor  # (...) int32
    n_events: torch.Tensor    # (...) int32
    overflow: torch.Tensor    # (...) bool — event or word capacity exceeded


def bit_category(v: torch.Tensor, max_cat: int = 11) -> torch.Tensor:
    """JPEG/JFIF 'size' of a value: bits in |v| (0 for 0), capped at
    ``max_cat`` (the reference sums ``|v| >= 2^b`` for b < max_cat)."""
    mag = v.to(torch.int32).abs()
    cat = torch.zeros_like(mag)
    for b in range(max_cat):
        cat = cat + (mag >= (1 << b)).to(torch.int32)
    return cat


def value_bits(v: torch.Tensor, cat: torch.Tensor) -> torch.Tensor:
    """Signed-magnitude value bits: v if v>=0 else v-1, masked to cat
    bits (int32 holding the uint32 value)."""
    v = v.to(torch.int32)
    raw = torch.where(v >= 0, v, v - 1)
    mask = (torch.ones_like(cat) << cat) - 1
    return raw & mask


def _to_i32_bits(w: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 with the same bit pattern."""
    return torch.where(w >= 1 << 31, w - (1 << 32), w).to(torch.int32)


def pack_slot_events_scatter(payload: torch.Tensor, nbits: torch.Tensor,
                             e_cap: int, w_cap: int) -> PackedStream:
    """Pack (..., M, S) slot events (row-major slot order = stream order)
    into MSB-first words, one stream per leading index. Words past
    ``w_cap`` are dropped, not wrapped (the reference's ``mode="drop"``);
    overflow is ``n_events > e_cap or total_bits > w_cap * 32``."""
    lead = payload.shape[:-2]
    b = int(np.prod(lead)) if lead else 1
    dev = payload.device
    nb = nbits.reshape(b, -1).to(torch.int64)
    active = nb > 0
    pay = torch.where(active, payload.reshape(b, -1).to(torch.int64) & _M32,
                      0)
    off = torch.cumsum(nb, 1) - nb
    total = nb.sum(1)
    n_ev = active.sum(1)
    rel = off & 31
    sh = 32 - (rel + nb)
    hi = torch.where(sh >= 0, (pay << sh.clamp(0, 31)) & _M32,
                     pay >> (-sh).clamp(0, 31))
    hi = torch.where(active, hi, 0)
    lo = torch.where((sh < 0) & active, (pay << (32 + sh).clamp(0, 31))
                     & _M32, 0)
    w0 = off >> 5
    # slot w_cap is the drop bin: inactive slots and words past capacity
    w0_t = torch.where(active, w0, w_cap).clamp(max=w_cap)
    w1_t = torch.where(active & (sh < 0), w0 + 1, w_cap).clamp(max=w_cap)
    words = torch.zeros((b, w_cap + 1), dtype=torch.int64, device=dev)
    words.scatter_add_(1, w0_t, hi)
    words.scatter_add_(1, w1_t, lo)
    words = _to_i32_bits(words[:, :w_cap] & _M32)
    overflow = (n_ev > e_cap) | (total > w_cap * 32)
    return PackedStream(words.reshape(*lead, w_cap),
                        total.to(torch.int32).reshape(lead),
                        n_ev.to(torch.int32).reshape(lead),
                        overflow.reshape(lead))


def words_to_bytes(words, total_bits: int, pad_ones: bool = True) -> bytes:
    """Host-side: trim the word buffer to the bitstream length.

    ``words`` is the (W_cap,) word array (host numpy, uint32 or int32 bit
    patterns). Pad bits in the final byte are set to 1 (JPEG convention)
    unless ``pad_ones=False``."""
    total_bits = int(total_bits)
    nbytes = (total_bits + 7) // 8
    raw = np.ascontiguousarray(np.asarray(words).view(np.uint32)) \
        .astype(">u4")
    by = np.frombuffer(raw.tobytes(), dtype=np.uint8)[:nbytes].copy()
    rem = total_bits % 8
    if rem and pad_ones:
        by[-1] |= (1 << (8 - rem)) - 1
    return by.tobytes()
