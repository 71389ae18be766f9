"""Baseline JFIF tables and container for the port's JPEG session.

The subset of selkies_tpu/codecs/jpeg.py that the JPEG session needs,
copied so the port never imports the JAX package (the reference module
imports ``ops.dct``, which loads jax): the Annex K quantisation and
Huffman tables with libjpeg quality scaling, the canonical Huffman code
LUTs, the interleaved-MCU scan order, JPEG 0xFF byte stuffing and the
JFIF wrapper. Entropy coding itself runs on the device
(ops/jpeg_entropy.py, ops/jpeg_pipeline.py).
"""

from __future__ import annotations

import functools
import struct

import numpy as np

from ..ops.dct import zigzag_order

# --- Annex K quantisation tables (raster order) ----------------------------
STD_LUMA_QUANT = np.array([
    16, 11, 10, 16, 24, 40, 51, 61,
    12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56,
    14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77,
    24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101,
    72, 92, 95, 98, 112, 100, 103, 99,
], dtype=np.int32)

STD_CHROMA_QUANT = np.array([
    17, 18, 24, 47, 99, 99, 99, 99,
    18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99,
    47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99,
], dtype=np.int32)


def scale_qtable(base: np.ndarray, quality: int) -> np.ndarray:
    """libjpeg quality scaling: 1..100 -> scaled table clipped to [1, 255]."""
    quality = int(np.clip(quality, 1, 100))
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    t = (base * scale + 50) // 100
    return np.clip(t, 1, 255).astype(np.int32)


# --- Annex K Huffman tables ------------------------------------------------
# (bits, huffval): bits[i] = number of codes of length i+1.
DC_LUMA_BITS = [0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0]
DC_LUMA_VALS = list(range(12))
DC_CHROMA_BITS = [0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0]
DC_CHROMA_VALS = list(range(12))

AC_LUMA_BITS = [0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D]
AC_LUMA_VALS = [
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12,
    0x21, 0x31, 0x41, 0x06, 0x13, 0x51, 0x61, 0x07,
    0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xA1, 0x08,
    0x23, 0x42, 0xB1, 0xC1, 0x15, 0x52, 0xD1, 0xF0,
    0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0A, 0x16,
    0x17, 0x18, 0x19, 0x1A, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2A, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39,
    0x3A, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49,
    0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69,
    0x6A, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79,
    0x7A, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8A, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98,
    0x99, 0x9A, 0xA2, 0xA3, 0xA4, 0xA5, 0xA6, 0xA7,
    0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4, 0xB5, 0xB6,
    0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5,
    0xC6, 0xC7, 0xC8, 0xC9, 0xCA, 0xD2, 0xD3, 0xD4,
    0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA, 0xE1, 0xE2,
    0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA,
    0xF1, 0xF2, 0xF3, 0xF4, 0xF5, 0xF6, 0xF7, 0xF8,
    0xF9, 0xFA,
]

AC_CHROMA_BITS = [0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77]
AC_CHROMA_VALS = [
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21,
    0x31, 0x06, 0x12, 0x41, 0x51, 0x07, 0x61, 0x71,
    0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
    0xA1, 0xB1, 0xC1, 0x09, 0x23, 0x33, 0x52, 0xF0,
    0x15, 0x62, 0x72, 0xD1, 0x0A, 0x16, 0x24, 0x34,
    0xE1, 0x25, 0xF1, 0x17, 0x18, 0x19, 0x1A, 0x26,
    0x27, 0x28, 0x29, 0x2A, 0x35, 0x36, 0x37, 0x38,
    0x39, 0x3A, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48,
    0x49, 0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68,
    0x69, 0x6A, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78,
    0x79, 0x7A, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8A, 0x92, 0x93, 0x94, 0x95, 0x96,
    0x97, 0x98, 0x99, 0x9A, 0xA2, 0xA3, 0xA4, 0xA5,
    0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4,
    0xB5, 0xB6, 0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3,
    0xC4, 0xC5, 0xC6, 0xC7, 0xC8, 0xC9, 0xCA, 0xD2,
    0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA,
    0xE2, 0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9,
    0xEA, 0xF2, 0xF3, 0xF4, 0xF5, 0xF6, 0xF7, 0xF8,
    0xF9, 0xFA,
]


@functools.cache
def _huff_lut(kind: str) -> tuple[np.ndarray, np.ndarray]:
    """Canonical JPEG Huffman code LUTs: symbol -> (code, length)."""
    bits, vals = {
        "dc_luma": (DC_LUMA_BITS, DC_LUMA_VALS),
        "dc_chroma": (DC_CHROMA_BITS, DC_CHROMA_VALS),
        "ac_luma": (AC_LUMA_BITS, AC_LUMA_VALS),
        "ac_chroma": (AC_CHROMA_BITS, AC_CHROMA_VALS),
    }[kind]
    codes = np.zeros(256, dtype=np.uint32)
    lens = np.zeros(256, dtype=np.uint8)
    code = 0
    k = 0
    for length in range(1, 17):
        for _ in range(bits[length - 1]):
            sym = vals[k]
            codes[sym] = code
            lens[sym] = length
            code += 1
            k += 1
        code <<= 1
    return codes, lens


@functools.cache
def _mcu_block_order(blocks_h: int, blocks_w: int, subsampling: str
                     ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Scan-order gather indices for interleaved MCUs.

    Returns (comp_ids, luma_idx_or_-1, chroma_idx_or_-1) flattened per scan
    position: for 4:2:0 each MCU is [Y0 Y1 Y2 Y3 Cb Cr]; for 4:4:4 [Y Cb Cr].
    ``blocks_h/w`` are LUMA plane block counts.
    """
    if subsampling == "420":
        mh, mw = blocks_h // 2, blocks_w // 2
        my, mx = np.mgrid[0:mh, 0:mw]
        y00 = (2 * my) * blocks_w + 2 * mx
        y01 = y00 + 1
        y10 = y00 + blocks_w
        y11 = y10 + 1
        c = my * mw + mx
        per_mcu = np.stack([y00, y01, y10, y11, c, c], axis=-1).reshape(-1)
        comp = np.tile(np.array([0, 0, 0, 0, 1, 2]), mh * mw)
    elif subsampling == "444":
        n = blocks_h * blocks_w
        idx = np.arange(n)
        per_mcu = np.stack([idx, idx, idx], axis=-1).reshape(-1)
        comp = np.tile(np.array([0, 1, 2]), n)
    else:
        raise ValueError(subsampling)
    return comp.astype(np.int32), per_mcu.astype(np.int32), None


def stuff_ff_bytes(raw: np.ndarray) -> bytes:
    """JPEG 0xFF byte stuffing (0xFF -> 0xFF 0x00) over a uint8 array."""
    ff = np.flatnonzero(raw == 0xFF)
    return (np.insert(raw, ff + 1, 0) if len(ff) else raw).tobytes()


# --- JFIF container --------------------------------------------------------

def _marker(tag: int, payload: bytes) -> bytes:
    return struct.pack(">BBH", 0xFF, tag, len(payload) + 2) + payload


def _dqt(tid: int, table_raster: np.ndarray) -> bytes:
    zz = zigzag_order()
    return _marker(0xDB, bytes([tid]) + bytes(int(table_raster[i]) for i in zz))


def _dht(tclass: int, tid: int, bits: list[int], vals: list[int]) -> bytes:
    return _marker(0xC4, bytes([(tclass << 4) | tid]) + bytes(bits) + bytes(vals))


def assemble_jfif(height: int, width: int, scan: bytes,
                  qy: np.ndarray, qc: np.ndarray,
                  subsampling: str = "420") -> bytes:
    """Wrap an entropy-coded scan into a standalone baseline JFIF image."""
    samp = 0x22 if subsampling == "420" else 0x11
    out = bytearray(b"\xff\xd8")  # SOI
    out += _marker(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    out += _dqt(0, qy)
    out += _dqt(1, qc)
    sof = struct.pack(">BHHB", 8, height, width, 3)
    sof += bytes([1, samp, 0, 2, 0x11, 1, 3, 0x11, 1])
    out += _marker(0xC0, sof)
    out += _dht(0, 0, DC_LUMA_BITS, DC_LUMA_VALS)
    out += _dht(1, 0, AC_LUMA_BITS, AC_LUMA_VALS)
    out += _dht(0, 1, DC_CHROMA_BITS, DC_CHROMA_VALS)
    out += _dht(1, 1, AC_CHROMA_BITS, AC_CHROMA_VALS)
    sos = bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0])
    out += _marker(0xDA, sos)
    out += scan
    out += b"\xff\xd9"  # EOI
    return bytes(out)
