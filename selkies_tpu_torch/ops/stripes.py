"""Stripe-stream byte framing: words -> bytes -> one ragged buffer.

The counterpart of selkies_tpu/ops/stripes.py. Each MB row's slice (H.264)
or stripe's scan (JPEG) is a byte string; they are concatenated into ONE
fixed-capacity buffer on the device so the host fetches a single prefix
per frame. These are the plain versions that the stream packers' CPU
paths use (ops/h264_planes.pack_stream, ops/jpeg_pipeline.jpeg_pack); the
CUDA kernels do the same in csrc/pack_stream.cu and csrc/jpeg_pack.cu.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class FrameBuffer(NamedTuple):
    data: torch.Tensor       # (out_cap,) uint8 — concatenated row bytes
    byte_lens: torch.Tensor  # (S,) int32 — per-row byte length
    overflow: torch.Tensor   # () bool


def words_to_bytes_device(words: torch.Tensor, total_bits: torch.Tensor,
                          pad_ones: bool = False
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """(S, Wc) words (int32 holding uint32 bit patterns) + (S,) bit
    lengths -> (S, Wc*4) uint8 + (S,) byte lengths. MSB-first within each
    word. The final partial byte keeps its zero padding (the H.264 form)
    unless ``pad_ones`` (the JPEG form, the reference's default) sets its
    pad bits to 1; a stream longer than its row has no last byte there to
    pad."""
    s, wc = words.shape
    shifts = torch.tensor([24, 16, 8, 0], dtype=torch.int64,
                          device=words.device)
    w = words.to(torch.int64) & 0xFFFFFFFF
    by = ((w[:, :, None] >> shifts) & 0xFF).reshape(s, wc * 4)
    bits = total_bits.to(torch.int64)
    nbytes = (bits + 7) // 8
    if pad_ones:
        rem = bits % 8
        pad = torch.where(rem > 0, (1 << (8 - rem)) - 1, 0)
        idx = torch.arange(wc * 4, device=words.device)
        by = torch.where(idx[None, :] == (nbytes - 1)[:, None],
                         by | pad[:, None], by)
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
