"""The JPEG step's device pipeline: forward, events, pack, byte buffer.

The counterpart of selkies_tpu/ops/jpeg_pipeline.py (``jpeg_encode_device``,
the plane path the step calls) plus the packing tail of the reference's
``build_step_fn``: per-stripe words (``pack_slot_events_scatter``), the
1-padded last byte (``words_to_bytes_device(pad_ones=True)``) and the
ragged concat into ONE fixed-capacity buffer (``concat_stripe_bytes``).

One JPEG frame runs four kernels (:data:`KERNEL_OPS`):

=========================  ============================================
``row_damage_probe`` (K6)  per-stripe damage flags (ops/h264_planes.py)
``jpeg_forward`` (K7)      CSC, DCT, quantisation, zigzag; prev <- frame
                           (ops/jpeg_planes.py)
``jpeg_events`` (K8)       Huffman (payload, nbits) slots
                           (ops/jpeg_entropy.py)
``jpeg_pack`` (K9)         per-stripe words, bit totals, event counts,
                           byte lengths, the byte buffer and the flags
=========================  ============================================

:data:`PLAIN_OPS` are their plain PyTorch versions.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .._device import resolve_device
from . import _cuda
from .bitpack import PackedStream, pack_slot_events_scatter
from .h264_encode import _check, _on_cpu
from .h264_planes import row_damage_probe, row_damage_probe_plain
from .jpeg_entropy import (jpeg_events, jpeg_events_plain, scan_layout,
                           scan_maps)
from .jpeg_planes import jpeg_forward, jpeg_forward_plain
from .stripes import concat_stripe_bytes, words_to_bytes_device


class JpegStream(NamedTuple):
    words: torch.Tensor       # (S, w_cap) int32, uint32 bit patterns
    total_bits: torch.Tensor  # (S,) int32
    n_events: torch.Tensor    # (S,) int32
    data: torch.Tensor        # (out_cap,) uint8, stripes back to back
    byte_lens: torch.Tensor   # (S,) int32
    flags: torch.Tensor       # (2,) int32: [e_cap/w_cap overflow of any
    #                                         stripe, out_cap overflow]
    # (the seat entries: data (n_seats, out_cap), flags (n_seats, 2))


def jpeg_pack_plain(payload, nbits, e_cap: int, w_cap: int,
                    out_cap: int) -> JpegStream:
    """(S, M, 64) slot events -> per-stripe words (the scatter packer),
    1-padded stripe bytes, and the ragged byte buffer."""
    ps = pack_slot_events_scatter(payload, nbits, e_cap, w_cap)
    sbytes, lens = words_to_bytes_device(ps.words, ps.total_bits,
                                         pad_ones=True)
    buf = concat_stripe_bytes(sbytes, lens, out_cap)
    flags = torch.stack([ps.overflow.any(), buf.overflow]).to(torch.int32)
    return JpegStream(ps.words, ps.total_bits, ps.n_events, buf.data,
                      buf.byte_lens, flags)


def _check_pack(payload, nbits) -> None:
    S, m = payload.shape[0], payload.shape[1]
    _check(payload, "payload", torch.int32, (S, m, 64), payload.device)
    _check(nbits, "nbits", torch.uint8, (S, m, 64), payload.device)


def _launch_pack(entry: str, n_seats, payload, nbits, e_cap: int,
                 w_cap: int, out_cap: int) -> JpegStream:
    """K9's outputs and launch; ``n_seats`` None is the single-frame
    entry (whose data and flags have no seat axis)."""
    S, m = payload.shape[0], payload.shape[1]
    dev = payload.device
    seats = () if n_seats is None else (n_seats,)
    words = torch.empty((S, w_cap), dtype=torch.int32, device=dev)
    total_bits = torch.empty((S,), dtype=torch.int32, device=dev)
    n_events = torch.empty((S,), dtype=torch.int32, device=dev)
    data = torch.empty(seats + (out_cap,), dtype=torch.uint8, device=dev)
    byte_lens = torch.empty((S,), dtype=torch.int32, device=dev)
    flags = torch.empty(seats + (2,), dtype=torch.int32, device=dev)
    _cuda.launch(entry, payload, nbits, *seats, S, m, e_cap, w_cap, out_cap,
                 words, total_bits, n_events, data, byte_lens, flags)
    return JpegStream(words, total_bits, n_events, data, byte_lens, flags)


def jpeg_pack(payload, nbits, e_cap: int, w_cap: int,
              out_cap: int) -> JpegStream:
    """K9 (csrc/jpeg_pack.cu) for CUDA tensors, else
    :func:`jpeg_pack_plain`; same contract."""
    _check_pack(payload, nbits)
    if _on_cpu(payload):
        return jpeg_pack_plain(payload, nbits, e_cap, w_cap, out_cap)
    return _launch_pack("jpeg_pack", None, payload, nbits, e_cap, w_cap,
                        out_cap)


def jpeg_pack_seats_plain(payload, nbits, e_cap: int, w_cap: int,
                          out_cap: int, n_seats: int) -> JpegStream:
    """The stripes of ``n_seats`` seats, back to back, each seat packed
    by :func:`jpeg_pack_plain` (the reference vmaps its step over seats).
    -> words, total_bits, n_events and byte_lens over all stripes, data
    (n_seats, out_cap), flags (n_seats, 2)."""
    n = payload.shape[0] // n_seats
    outs = [jpeg_pack_plain(payload[k * n:(k + 1) * n],
                            nbits[k * n:(k + 1) * n], e_cap, w_cap, out_cap)
            for k in range(n_seats)]
    return JpegStream(*(torch.cat([getattr(o, f) for o in outs])
                        for f in ("words", "total_bits", "n_events")),
                      torch.stack([o.data for o in outs]),
                      torch.cat([o.byte_lens for o in outs]),
                      torch.stack([o.flags for o in outs]))


def jpeg_pack_seats(payload, nbits, e_cap: int, w_cap: int, out_cap: int,
                    n_seats: int) -> JpegStream:
    """K9's seat entry (``jpeg_pack_seats`` in csrc/jpeg_pack.cu, one
    launch for every seat) for CUDA tensors, else
    :func:`jpeg_pack_seats_plain`. ``payload``/``nbits`` hold the stripes
    of ``n_seats`` seats back to back."""
    _check_pack(payload, nbits)
    if n_seats < 1 or payload.shape[0] % n_seats:
        raise ValueError(f"{payload.shape[0]} stripes do not split into "
                         f"{n_seats} seats")
    if _on_cpu(payload):
        return jpeg_pack_seats_plain(payload, nbits, e_cap, w_cap, out_cap,
                                     n_seats)
    return _launch_pack("jpeg_pack_seats", n_seats, payload, nbits, e_cap,
                        w_cap, out_cap)


class JpegOps(NamedTuple):
    """The kernels of the JPEG step, or their plain versions."""
    row_damage_probe: object
    jpeg_forward: object
    jpeg_events: object
    jpeg_pack: object


KERNEL_OPS = JpegOps(row_damage_probe, jpeg_forward, jpeg_events, jpeg_pack)
PLAIN_OPS = JpegOps(row_damage_probe_plain, jpeg_forward_plain,
                    jpeg_events_plain, jpeg_pack_plain)
#: the multi-seat step's sets (parallel/seats.py): K9's seat entry, which
#: takes ``n_seats``, in place of the single-frame one
SEAT_KERNEL_OPS = KERNEL_OPS._replace(jpeg_pack=jpeg_pack_seats)
SEAT_PLAIN_OPS = PLAIN_OPS._replace(jpeg_pack=jpeg_pack_seats_plain)


def jpeg_encode_device(rgb, qy, qc, subsampling: str, e_cap: int,
                       w_cap: int, device=None) -> PackedStream:
    """RGB frame -> PackedStream (scan bits) on the device: K7, K8 and
    K9 with the frame as one stripe. ``rgb`` (H, W, 3) uint8, numpy or a
    tensor; a tensor runs where it lies, numpy on ``device`` (None means
    ``cuda``)."""
    if not isinstance(rgb, torch.Tensor):
        rgb = torch.as_tensor(rgb, device=resolve_device(device))
    dev = rgb.device
    h, w = rgb.shape[:2]
    q = torch.stack([torch.as_tensor(t, device=dev).reshape(64)
                     for t in (qy, qc, qy, qc)]).to(torch.float32)
    tab = torch.zeros((1,), dtype=torch.int32, device=dev)
    planes = jpeg_forward(rgb.contiguous(), torch.empty_like(rgb), tab, q,
                          subsampling)
    scan = scan_maps(scan_layout(h // 8, w // 8, subsampling), dev)
    payload, nbits = jpeg_events(*planes, scan, 1)
    st = jpeg_pack(payload, nbits, e_cap, w_cap, 4 * w_cap)
    return PackedStream(st.words[0], st.total_bits[0], st.n_events[0],
                        st.flags[0] != 0)
