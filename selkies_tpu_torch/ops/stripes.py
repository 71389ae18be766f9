"""Stripe-stream byte framing: words -> bytes -> one ragged buffer.

The counterpart of selkies_tpu/ops/stripes.py. Each MB row's slice is a
byte string; the rows' bytes are concatenated into ONE fixed-capacity
buffer on the device so the host fetches a single prefix per frame. These
are the plain versions that the stream packer's CPU path uses
(ops/h264_planes.pack_stream); the CUDA kernel does the same in
csrc/pack_stream.cu.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class FrameBuffer(NamedTuple):
    data: torch.Tensor       # (out_cap,) uint8 — concatenated row bytes
    byte_lens: torch.Tensor  # (S,) int32 — per-row byte length
    overflow: torch.Tensor   # () bool


def words_to_bytes_device(words: torch.Tensor, total_bits: torch.Tensor
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """(S, Wc) words (int32 holding uint32 bit patterns) + (S,) bit
    lengths -> (S, Wc*4) uint8 + (S,) byte lengths. MSB-first within each
    word; the final partial byte keeps its zero padding (the H.264 form,
    the reference's ``pad_ones=False``)."""
    s, wc = words.shape
    shifts = torch.tensor([24, 16, 8, 0], dtype=torch.int64,
                          device=words.device)
    w = words.to(torch.int64) & 0xFFFFFFFF
    by = ((w[:, :, None] >> shifts) & 0xFF).reshape(s, wc * 4)
    nbytes = (total_bits.to(torch.int64) + 7) // 8
    return by.to(torch.uint8), nbytes.to(torch.int32)


def concat_stripe_bytes(stripe_bytes: torch.Tensor, byte_lens: torch.Tensor,
                        out_cap: int) -> FrameBuffer:
    """Ragged byte concat: (S, B) uint8 + (S,) lens -> (out_cap,) uint8.

    Output byte j belongs to row b = searchsorted(starts, j) with local
    offset j - starts[b]; bytes past the total are zero."""
    s, b = stripe_bytes.shape
    lens = byte_lens.to(torch.int64)
    starts = torch.cumsum(lens, 0) - lens
    total = lens.sum()
    j = torch.arange(out_cap, dtype=torch.int64, device=stripe_bytes.device)
    sb = torch.clamp(torch.searchsorted(starts, j, right=True) - 1, 0, s - 1)
    local = torch.clamp(j - starts[sb], 0, b - 1)
    data = torch.where(j < total, stripe_bytes[sb, local],
                       torch.zeros((), dtype=torch.uint8,
                                   device=stripe_bytes.device))
    return FrameBuffer(data.to(torch.uint8), byte_lens.to(torch.int32),
                       total > out_cap)
