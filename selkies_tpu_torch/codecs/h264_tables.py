"""CAVLC code tables (ITU-T H.264 §9.2, Tables 9-5..9-10) + Exp-Golomb.

A copy of selkies_tpu/codecs/h264_tables.py (numpy only): the port keeps
its own tables so it never imports the JAX package. The reference's tests
validate every entry against x264 streams decoded by ffmpeg; the port's
tests hold the events built from this copy equal to the reference's.

Encoding convention: each entry is ``(length, value)`` with the codeword
in the LOW ``length`` bits of ``value`` (MSB-first when emitted).
"""

from __future__ import annotations

import numpy as np

# --------------------------------------------------------------------------
# Table 9-5: coeff_token. Indexed [ctx][total_coeff][trailing_ones] where
# ctx 0: 0<=nC<2, 1: 2<=nC<4, 2: 4<=nC<8 (ctx 3 = nC>=8 is a 6-bit FLC,
# handled in code), and CHROMA_DC_COEFF_TOKEN for nC==-1 (4:2:0).
# Layout below follows the JM reference tables: LEN[ctx][t1][tc],
# CODE[ctx][t1][tc]; len 0 = invalid combination.
# --------------------------------------------------------------------------
_CT_LEN = [
    [  # ctx 0 (0 <= nC < 2)
        [1, 6, 8, 9, 10, 11, 13, 13, 13, 14, 14, 15, 15, 16, 16, 16, 16],
        [0, 2, 6, 8, 9, 10, 11, 13, 13, 14, 14, 15, 15, 15, 16, 16, 16],
        [0, 0, 3, 7, 8, 9, 10, 11, 13, 13, 14, 14, 15, 15, 16, 16, 16],
        [0, 0, 0, 5, 6, 7, 8, 9, 10, 11, 13, 14, 14, 15, 15, 16, 16],
    ],
    [  # ctx 1 (2 <= nC < 4)
        [2, 6, 6, 7, 8, 8, 9, 11, 11, 12, 12, 12, 13, 13, 13, 14, 14],
        [0, 2, 5, 6, 6, 7, 8, 9, 11, 11, 12, 12, 13, 13, 14, 14, 14],
        [0, 0, 3, 6, 6, 7, 8, 9, 11, 11, 12, 12, 13, 13, 13, 14, 14],
        [0, 0, 0, 4, 4, 5, 6, 6, 7, 9, 11, 11, 12, 13, 13, 13, 14],
    ],
    [  # ctx 2 (4 <= nC < 8)
        [4, 6, 6, 6, 7, 7, 7, 7, 8, 8, 9, 9, 9, 10, 10, 10, 10],
        [0, 4, 5, 5, 5, 5, 6, 6, 7, 8, 8, 9, 9, 9, 10, 10, 10],
        [0, 0, 4, 5, 5, 5, 6, 6, 7, 7, 8, 8, 9, 9, 10, 10, 10],
        [0, 0, 0, 4, 4, 4, 4, 4, 5, 6, 7, 8, 8, 9, 10, 10, 10],
    ],
]
_CT_CODE = [
    [
        [1, 5, 7, 7, 7, 7, 15, 11, 8, 15, 11, 15, 11, 15, 11, 7, 4],
        [0, 1, 4, 6, 6, 6, 6, 14, 10, 14, 10, 14, 10, 1, 14, 10, 6],
        [0, 0, 1, 5, 5, 5, 5, 5, 13, 9, 13, 9, 13, 9, 13, 9, 5],
        [0, 0, 0, 3, 3, 4, 4, 4, 4, 4, 12, 12, 8, 12, 8, 12, 8],
    ],
    [
        [3, 11, 7, 7, 7, 4, 7, 15, 11, 15, 11, 8, 15, 11, 7, 9, 7],
        [0, 2, 7, 10, 6, 6, 6, 6, 14, 10, 14, 10, 14, 10, 11, 8, 6],
        [0, 0, 3, 9, 5, 5, 5, 5, 13, 9, 13, 9, 13, 9, 6, 10, 5],
        [0, 0, 0, 5, 4, 6, 8, 4, 4, 4, 12, 8, 12, 12, 8, 1, 4],
    ],
    [
        [15, 15, 11, 8, 15, 11, 9, 8, 15, 11, 15, 11, 8, 13, 9, 5, 1],
        [0, 14, 15, 12, 10, 8, 14, 10, 14, 14, 10, 14, 10, 7, 12, 8, 4],
        [0, 0, 13, 14, 11, 9, 13, 9, 13, 10, 13, 9, 13, 9, 11, 7, 3],
        [0, 0, 0, 12, 11, 10, 9, 8, 13, 12, 12, 12, 8, 12, 10, 6, 2],
    ],
]

# chroma DC (4:2:0, nC == -1): [t1][tc], tc 0..4
_CT_CDC_LEN = [
    [2, 6, 6, 6, 6],
    [0, 1, 6, 7, 8],
    [0, 0, 3, 7, 8],
    [0, 0, 0, 6, 7],
]
_CT_CDC_CODE = [
    [1, 7, 4, 3, 2],
    [0, 1, 6, 3, 3],
    [0, 0, 1, 2, 2],
    [0, 0, 0, 5, 0],
]


def coeff_token(nc: int, total_coeff: int, trailing_ones: int
                ) -> tuple[int, int]:
    """-> (length, code). ``nc`` is the derived context (-1 = chroma DC)."""
    if nc == -1:
        return (_CT_CDC_LEN[trailing_ones][total_coeff],
                _CT_CDC_CODE[trailing_ones][total_coeff])
    if nc >= 8:
        if total_coeff == 0:
            return 6, 3  # '000011'
        return 6, ((total_coeff - 1) << 2) | trailing_ones
    ctx = 0 if nc < 2 else (1 if nc < 4 else 2)
    return (_CT_LEN[ctx][trailing_ones][total_coeff],
            _CT_CODE[ctx][trailing_ones][total_coeff])


# --------------------------------------------------------------------------
# Table 9-7 / 9-8: total_zeros for 4x4 blocks (maxNumCoeff 15/16 share one
# table family). Indexed [total_coeff-1][total_zeros] -> (len, code).
# --------------------------------------------------------------------------
_TZ_LEN = [
    [1, 3, 3, 4, 4, 5, 5, 6, 6, 7, 7, 8, 8, 9, 9, 9],
    [3, 3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 6, 6, 6, 6],
    [4, 3, 3, 3, 4, 4, 3, 3, 4, 5, 5, 6, 5, 6],
    [5, 3, 4, 4, 3, 3, 3, 4, 3, 4, 5, 5, 5],
    [4, 4, 4, 3, 3, 3, 3, 3, 4, 5, 4, 5],
    [6, 5, 3, 3, 3, 3, 3, 3, 4, 3, 6],
    [6, 5, 3, 3, 3, 2, 3, 4, 3, 6],
    [6, 4, 5, 3, 2, 2, 3, 3, 6],
    [6, 6, 4, 2, 2, 3, 2, 5],
    [5, 5, 3, 2, 2, 2, 4],
    [4, 4, 3, 3, 1, 3],
    [4, 4, 2, 1, 3],
    [3, 3, 1, 2],
    [2, 2, 1],
    [1, 1],
]
_TZ_CODE = [
    [1, 3, 2, 3, 2, 3, 2, 3, 2, 3, 2, 3, 2, 3, 2, 1],
    [7, 6, 5, 4, 3, 5, 4, 3, 2, 3, 2, 3, 2, 1, 0],
    [5, 7, 6, 5, 4, 3, 4, 3, 2, 3, 2, 1, 1, 0],
    [3, 7, 5, 4, 6, 5, 4, 3, 3, 2, 2, 1, 0],
    [5, 4, 3, 7, 6, 5, 4, 3, 2, 1, 1, 0],
    [1, 1, 7, 6, 5, 4, 3, 2, 1, 1, 0],
    [1, 1, 5, 4, 3, 3, 2, 1, 1, 0],
    [1, 1, 1, 3, 3, 2, 2, 1, 0],
    [1, 0, 1, 3, 2, 1, 1, 1],
    [1, 0, 1, 3, 2, 1, 1],
    [0, 1, 1, 2, 1, 3],
    [0, 1, 1, 1, 1],
    [0, 1, 1, 1],
    [0, 1, 1],
    [0, 1],
]

# Table 9-9(a): total_zeros for chroma DC (4:2:0, maxNumCoeff 4):
# [total_coeff-1][total_zeros]
_TZ_CDC_LEN = [
    [1, 2, 3, 3],
    [1, 2, 2],
    [1, 1],
]
_TZ_CDC_CODE = [
    [1, 1, 1, 0],
    [1, 1, 0],
    [1, 0],
]


def total_zeros(total_coeff: int, tz: int, chroma_dc: bool = False
                ) -> tuple[int, int]:
    if chroma_dc:
        return (_TZ_CDC_LEN[total_coeff - 1][tz],
                _TZ_CDC_CODE[total_coeff - 1][tz])
    return _TZ_LEN[total_coeff - 1][tz], _TZ_CODE[total_coeff - 1][tz]


# --------------------------------------------------------------------------
# Table 9-10: run_before. Indexed [min(zeros_left,7)-1][run] -> (len, code);
# zeros_left >= 7 column also covers runs 7..14 with a unary tail.
# --------------------------------------------------------------------------
_RB_LEN = [
    [1, 1],
    [1, 2, 2],
    [2, 2, 2, 2],
    [2, 2, 2, 3, 3],
    [2, 2, 3, 3, 3, 3],
    [2, 3, 3, 3, 3, 3, 3],
    [3, 3, 3, 3, 3, 3, 3, 4, 5, 6, 7, 8, 9, 10, 11],
]
_RB_CODE = [
    [1, 0],
    [1, 1, 0],
    [3, 2, 1, 0],
    [3, 2, 1, 1, 0],
    [3, 2, 3, 2, 1, 0],
    [3, 0, 1, 3, 2, 5, 4],
    [7, 6, 5, 4, 3, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1],
]


def run_before(zeros_left: int, run: int) -> tuple[int, int]:
    zl = min(zeros_left, 7)
    return _RB_LEN[zl - 1][run], _RB_CODE[zl - 1][run]


# --------------------------------------------------------------------------
# Exp-Golomb (§9.1) for headers and mb syntax.
# --------------------------------------------------------------------------

def ue_bits(v: int) -> tuple[int, int]:
    """Unsigned Exp-Golomb -> (length, code)."""
    code_num = v + 1
    nbits = code_num.bit_length()
    return 2 * nbits - 1, code_num


def se_bits(v: int) -> tuple[int, int]:
    """Signed Exp-Golomb: v>0 -> 2v-1, v<=0 -> -2v."""
    return ue_bits(2 * v - 1 if v > 0 else -2 * v)


# numpy views of the tables for the device encoder (ops/h264_cavlc.py)
CT_LEN_NP = np.zeros((4, 4, 17), np.int32)
CT_CODE_NP = np.zeros((4, 4, 17), np.int32)
for _c in range(3):
    CT_LEN_NP[_c] = np.array(
        [r + [0] * (17 - len(r)) for r in _CT_LEN[_c]], np.int32)
    CT_CODE_NP[_c] = np.array(
        [r + [0] * (17 - len(r)) for r in _CT_CODE[_c]], np.int32)
# ctx 3 = FLC(6): tc 0 -> 3; else ((tc-1)<<2)|t1
for _t1 in range(4):
    for _tc in range(17):
        CT_LEN_NP[3, _t1, _tc] = 6
        CT_CODE_NP[3, _t1, _tc] = 3 if _tc == 0 else (((_tc - 1) << 2) | _t1)

CT_CDC_LEN_NP = np.array([r + [0] * (5 - len(r)) for r in _CT_CDC_LEN],
                         np.int32)
CT_CDC_CODE_NP = np.array([r + [0] * (5 - len(r)) for r in _CT_CDC_CODE],
                          np.int32)
TZ_LEN_NP = np.zeros((15, 16), np.int32)
TZ_CODE_NP = np.zeros((15, 16), np.int32)
for _i, _r in enumerate(_TZ_LEN):
    TZ_LEN_NP[_i, :len(_r)] = _r
for _i, _r in enumerate(_TZ_CODE):
    TZ_CODE_NP[_i, :len(_r)] = _r
TZ_CDC_LEN_NP = np.zeros((3, 4), np.int32)
TZ_CDC_CODE_NP = np.zeros((3, 4), np.int32)
for _i, _r in enumerate(_TZ_CDC_LEN):
    TZ_CDC_LEN_NP[_i, :len(_r)] = _r
for _i, _r in enumerate(_TZ_CDC_CODE):
    TZ_CDC_CODE_NP[_i, :len(_r)] = _r
RB_LEN_NP = np.zeros((7, 15), np.int32)
RB_CODE_NP = np.zeros((7, 15), np.int32)
for _i, _r in enumerate(_RB_LEN):
    RB_LEN_NP[_i, :len(_r)] = _r
for _i, _r in enumerate(_RB_CODE):
    RB_CODE_NP[_i, :len(_r)] = _r


# --------------------------------------------------------------------------
# Quant/rescale constants shared with ops/h264_transform.py, kept here in
# numpy so the reference decoder stays importable without jax.
# --------------------------------------------------------------------------
POS_CLS_NP = np.array([[0, 2, 0, 2],
                       [2, 1, 2, 1],
                       [0, 2, 0, 2],
                       [2, 1, 2, 1]], np.int32)
V_NP = np.array([[10, 16, 13],
                 [11, 18, 14],
                 [13, 20, 16],
                 [14, 23, 18],
                 [16, 25, 20],
                 [18, 29, 23]], np.int32)
MF_NP = np.array([[13107, 5243, 8066],
                  [11916, 4660, 7490],
                  [10082, 4194, 6554],
                  [9362, 3647, 5825],
                  [8192, 3355, 5243],
                  [7282, 2893, 4559]], np.int32)
V4_NP = V_NP[:, POS_CLS_NP]          # (6, 4, 4)
MF4_NP = MF_NP[:, POS_CLS_NP]
QPC_NP = np.concatenate([
    np.arange(30),
    np.array([29, 30, 31, 32, 32, 33, 34, 34, 35, 35, 36, 36, 37, 37, 37,
              38, 38, 38, 39, 39, 39, 39])]).astype(np.int32)
ZIGZAG4_NP = np.array([0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15],
                      np.int32)


# --------------------------------------------------------------------------
# Table 9-4: coded_block_pattern me(v) mapping, INTER column (P slices):
# code_num -> cbp. The encoder needs the inverse (cbp -> code_num).
# --------------------------------------------------------------------------
CBP_INTER_CODE2CBP = np.array([
    0, 16, 1, 2, 4, 8, 32, 3, 5, 10, 12, 15, 47, 7, 11, 13,
    14, 6, 9, 31, 35, 37, 42, 44, 33, 34, 36, 40, 39, 43, 45, 46,
    17, 18, 20, 24, 19, 21, 26, 28, 23, 27, 29, 30, 22, 25, 38, 41,
], np.int32)
CBP_INTER_CBP2CODE = np.zeros(48, np.int32)
for _code, _cbp in enumerate(CBP_INTER_CODE2CBP):
    CBP_INTER_CBP2CODE[_cbp] = _code

# Intra column (used when an I_16x16-less intra MB would appear in a P
# slice — our encoder never emits those, but the decoder may meet them in
# foreign streams).
CBP_INTRA_CODE2CBP = np.array([
    47, 31, 15, 0, 23, 27, 29, 30, 7, 11, 13, 14, 39, 43, 45, 46,
    16, 3, 5, 10, 12, 19, 21, 26, 28, 35, 37, 42, 44, 1, 2, 4,
    8, 17, 18, 20, 24, 6, 9, 22, 25, 32, 33, 34, 36, 40, 38, 41,
], np.int32)

# Table 9-4 me(v) mapping for ChromaArrayType 0 or 3 (monochrome /
# 4:4:4): 16 cbp values (luma groups only; the chroma part is absent).
# Inter column, cbp -> code_num. Derived empirically against libavcodec
# (tools/derive_cbp444.py re-runs the derivation as a conformance check).
CBP444_INTER_CBP2CODE = np.array(
    [0, 1, 2, 5, 3, 6, 14, 10, 4, 15, 7, 11, 8, 12, 13, 9], np.int32)
