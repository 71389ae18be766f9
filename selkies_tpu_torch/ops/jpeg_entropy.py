"""JPEG Huffman entropy events in PyTorch, and their CUDA kernel.

The counterpart of selkies_tpu/ops/jpeg_entropy.py. Every (block,
zigzag-slot) pair of an interleaved scan emits at most one codeword,
decidable from per-block prefix statistics, and slot order is stream
order:

- slot 0: the DC codeword (category + value bits), differential against
  the previous block of the same component (a static gather index);
- a nonzero AC slot: the (run % 16, size) codeword + value bits;
- a zero AC slot that is the 16th/32nd/48th zero of a run with a later
  nonzero in the block: a ZRL (0xF0) codeword;
- slot 63 when the block's AC tail is zero: the EOB codeword.

Categories are capped as the reference caps them: 11 bits for DC
differences, 10 for AC values (at quality 100 an AC of magnitude >= 1024
is coded with 10 masked value bits, byte for byte as the reference does).

K8 ``jpeg_events`` (csrc/jpeg_events.cu) computes the (payload, nbits)
slots of every stripe; its plain version :func:`jpeg_events_plain` is the
reference's arithmetic over a (S, M, 64) batch.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ..codecs import jpeg as jtab
from . import _cuda
from .bitpack import (PackedStream, bit_category, pack_slot_events_scatter,
                      value_bits, words_to_bytes)
from .h264_encode import _check, _on_cpu


class ScanLayout(NamedTuple):
    """Static per-(shape, subsampling) gather maps."""
    comp: np.ndarray        # (M,) 0=Y 1=Cb 2=Cr in scan order
    gather: np.ndarray      # (M,) block index into the comp's plane array
    prev_same: np.ndarray   # (M,) scan index of previous same-comp block, -1

    @property
    def m(self) -> int:
        return len(self.comp)


@functools.cache
def scan_layout(blocks_h: int, blocks_w: int, subsampling: str) -> ScanLayout:
    comp, gather, _ = jtab._mcu_block_order(blocks_h, blocks_w, subsampling)
    prev_same = np.full(len(comp), -1, dtype=np.int32)
    last = {0: -1, 1: -1, 2: -1}
    for i, c in enumerate(comp):
        prev_same[i] = last[int(c)]
        last[int(c)] = i
    return ScanLayout(comp, gather, prev_same)


def scan_maps(layout: ScanLayout, device) -> torch.Tensor:
    """(3, M) int32 [comp, gather, prev_same] on ``device`` — what K8
    takes; a session puts it up once per geometry."""
    return torch.as_tensor(np.stack([layout.comp, layout.gather,
                                     layout.prev_same]).astype(np.int32),
                           device=device)


@functools.cache
def _host_luts() -> dict[str, np.ndarray]:
    """Huffman LUTs stacked [luma, chroma]."""
    out = {}
    for prefix, kinds in (("dc", ("dc_luma", "dc_chroma")),
                          ("ac", ("ac_luma", "ac_chroma"))):
        codes = np.stack([jtab._huff_lut(k)[0] for k in kinds])
        lens = np.stack([jtab._huff_lut(k)[1].astype(np.int32)
                         for k in kinds])
        out[prefix + "_code"] = codes.astype(np.int64)
        out[prefix + "_len"] = lens.astype(np.int64)
    return out


def jpeg_events_plain(y_zz, cb_zz, cr_zz, scan: torch.Tensor,
                      n_stripes: int):
    """Per-stripe slot events. Coefficient arrays are (N, 64) int16
    zigzag rows over the whole frame in plane-raster block order (each
    stripe's blocks one contiguous run); ``scan`` is :func:`scan_maps` of
    ONE stripe. -> payload (S, M, 64) int32 (uint32 codeword bits,
    LSB-aligned) and nbits (S, M, 64) uint8 (0 = no event)."""
    dev = y_zz.device
    S = n_stripes
    luts = {k: torch.as_tensor(v, device=dev) for k, v in _host_luts().items()}
    comp, gather, prev_same = (scan[i].to(torch.int64) for i in range(3))
    m = comp.shape[0]
    planes = [p.reshape(S, -1, 64).to(torch.int32)
              for p in (y_zz, cb_zz, cr_zz)]
    rows = [p[:, gather.clamp(0, p.shape[1] - 1)] for p in planes]
    c = comp[None, :, None]
    seq = torch.where(c == 0, rows[0], torch.where(c == 1, rows[1],
                                                   rows[2]))  # (S, M, 64)
    pos = torch.arange(64, device=dev)
    is_chroma = (comp != 0).to(torch.int64)[None, :]            # (1, M)

    # DC (slot 0)
    dc = seq[..., 0]
    prev_dc = torch.where(prev_same >= 0, dc[:, prev_same.clamp(0, m - 1)],
                          0)
    dcdiff = dc - prev_dc
    dccat = bit_category(dcdiff, max_cat=11).to(torch.int64)
    dc_pay = (luts["dc_code"][is_chroma, dccat] << dccat) \
        | value_bits(dcdiff, dccat.to(torch.int32))
    dc_nb = luts["dc_len"][is_chroma, dccat] + dccat

    # AC run statistics along the zigzag axis
    nz = (seq != 0) & (pos > 0)
    incl = torch.cummax(torch.where(nz, pos, 0), dim=-1).values
    prev_nz = torch.cat([torch.zeros_like(incl[..., :1]), incl[..., :-1]],
                        -1)
    last_nz = incl[..., -1:]
    run_total = pos - prev_nz - 1
    accat = bit_category(seq, max_cat=10).to(torch.int64)
    acsym = (run_total & 15) * 16 + accat
    ic = is_chroma[..., None]
    ac_pay = (luts["ac_code"][ic, acsym] << accat) \
        | value_bits(seq, accat.to(torch.int32))
    ac_nb = luts["ac_len"][ic, acsym] + accat

    zeros_since = pos - prev_nz
    is_zrl = (~nz) & (pos > 0) & (pos < last_nz) & (zeros_since > 0) \
        & ((zeros_since & 15) == 0)
    is_eob = (pos == 63) & (last_nz < 63)
    zrl_pay, zrl_nb = luts["ac_code"][ic, 0xF0], luts["ac_len"][ic, 0xF0]
    eob_pay, eob_nb = luts["ac_code"][ic, 0x00], luts["ac_len"][ic, 0x00]

    def select(dc_v, ac_v, zrl_v, eob_v):
        return torch.where(
            pos == 0, dc_v[..., None],
            torch.where(nz, ac_v, torch.where(
                is_zrl, zrl_v, torch.where(is_eob, eob_v, 0))))
    payload = select(dc_pay, ac_pay, zrl_pay, eob_pay).to(torch.int32)
    nbits = select(dc_nb, ac_nb, zrl_nb, eob_nb).to(torch.uint8)
    return payload, nbits


def jpeg_events(y_zz, cb_zz, cr_zz, scan: torch.Tensor, n_stripes: int):
    """K8 (csrc/jpeg_events.cu) for CUDA tensors, else
    :func:`jpeg_events_plain`; same contract."""
    dev = y_zz.device
    S = n_stripes
    m = scan.shape[1]
    ny, nc = y_zz.shape[0], cb_zz.shape[0]
    _check(y_zz, "y_zz", torch.int16, (ny, 64), dev)
    _check(cb_zz, "cb_zz", torch.int16, (nc, 64), dev)
    _check(cr_zz, "cr_zz", torch.int16, (nc, 64), dev)
    _check(scan, "scan", torch.int32, (3, m), dev)
    if ny % S or nc % S:
        raise ValueError("coefficient planes must split into stripes")
    if _on_cpu(y_zz):
        return jpeg_events_plain(y_zz, cb_zz, cr_zz, scan, S)
    payload = torch.empty((S, m, 64), dtype=torch.int32, device=dev)
    nbits = torch.empty((S, m, 64), dtype=torch.uint8, device=dev)
    _cuda.launch("jpeg_events", y_zz, cb_zz, cr_zz, scan, payload, nbits, S,
                 m, ny // S, nc // S)
    return payload, nbits


def jpeg_entropy_device(y_zz, cb_zz, cr_zz, layout: ScanLayout, e_cap: int,
                        w_cap: int) -> PackedStream:
    """Entropy-code one interleaved scan (the reference's signature):
    events then the scatter packer, both plain."""
    scan = scan_maps(layout, y_zz.device)
    payload, nbits = jpeg_events_plain(
        *(torch.as_tensor(p).to(torch.int16) for p in (y_zz, cb_zz, cr_zz)),
        scan, 1)
    return pack_slot_events_scatter(payload[0], nbits[0], e_cap, w_cap)


def finalize_scan_bytes(words_host: np.ndarray, total_bits: int) -> bytes:
    """Host tail: trim, 1-pad, and 0xFF-stuff the device bitstream."""
    by = np.frombuffer(words_to_bytes(words_host, total_bits, pad_ones=True),
                       dtype=np.uint8)
    return jtab.stuff_ff_bytes(by)
