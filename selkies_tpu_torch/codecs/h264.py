"""Host-side H.264 bitstream assembly for the port's sessions.

The subset of selkies_tpu/codecs/h264.py that the H.264 session needs,
copied so the port never imports the JAX package: the bit writer,
emulation prevention and NAL framing, SPS/PPS, the per-row slice header
prefixes that the device stream packer emits as events, and the all-skip
P slices that the band path stitches in for clean rows.
"""

from __future__ import annotations

import functools

import numpy as np

from .h264_tables import se_bits, ue_bits


class BitWriter:
    def __init__(self):
        self.bits: list[int] = []

    def put(self, length: int, code: int) -> None:
        for i in range(length - 1, -1, -1):
            self.bits.append((code >> i) & 1)

    def ue(self, v: int) -> None:
        self.put(*ue_bits(v))

    def se(self, v: int) -> None:
        self.put(*se_bits(v))

    def rbsp_trailing(self) -> None:
        self.bits.append(1)
        while len(self.bits) % 8:
            self.bits.append(0)

    def to_bytes(self) -> bytes:
        assert len(self.bits) % 8 == 0
        arr = np.array(self.bits, np.uint8)
        return np.packbits(arr).tobytes()


def emulation_prevent(rbsp: bytes) -> bytes:
    """Insert 0x03 after any 00 00 followed by 00/01/02/03 (§7.4.1.1)."""
    out = bytearray()
    zeros = 0
    for b in rbsp:
        if zeros >= 2 and b <= 3:
            out.append(3)
            zeros = 0
        out.append(b)
        zeros = zeros + 1 if b == 0 else 0
    return bytes(out)


def nal(nal_type: int, rbsp: bytes, ref_idc: int = 3) -> bytes:
    return b"\x00\x00\x00\x01" + bytes([(ref_idc << 5) | nal_type]) \
        + emulation_prevent(rbsp)


def write_sps(width: int, height: int, level_idc: int = 42,
              chroma_format: int = 1) -> bytes:
    """SPS for a ``width``x``height`` frame (16-px padded internally,
    cropped via frame_cropping). ``chroma_format`` 1 = 4:2:0
    Constrained-Baseline; 3 = 4:4:4 High 4:4:4 Predictive (profile 244,
    the reference's ``fullcolor`` f4001f munge, rtc.py:649-717)."""
    w_mbs = (width + 15) // 16
    h_mbs = (height + 15) // 16
    crop_r = w_mbs * 16 - width
    crop_b = h_mbs * 16 - height
    w = BitWriter()
    if chroma_format == 3:
        w.put(8, 244)     # profile_idc High 4:4:4 Predictive
        w.put(8, 0x00)
    else:
        w.put(8, 66)      # profile_idc baseline
        w.put(8, 0xC0)    # constraint_set0+1 flags
    w.put(8, level_idc)
    w.ue(0)               # sps_id
    if chroma_format == 3:
        w.ue(3)           # chroma_format_idc 4:4:4
        w.put(1, 0)       # separate_colour_plane_flag
        w.ue(0)           # bit_depth_luma_minus8
        w.ue(0)           # bit_depth_chroma_minus8
        w.put(1, 0)       # qpprime_y_zero_transform_bypass
        w.put(1, 0)       # seq_scaling_matrix_present
    w.ue(0)               # log2_max_frame_num_minus4
    w.ue(2)               # pic_order_cnt_type 2 (no POC syntax in slices)
    w.ue(1)               # max_num_ref_frames (P references the prior picture)
    w.put(1, 0)           # gaps_in_frame_num_value_allowed
    w.ue(w_mbs - 1)
    w.ue(h_mbs - 1)
    w.put(1, 1)           # frame_mbs_only
    w.put(1, 1)           # direct_8x8_inference
    if crop_r or crop_b:
        # CropUnitX/Y = 1 for 4:4:4 and monochrome, 2 for 4:2:0 (§7.4.2.1.1)
        cu = 1 if chroma_format == 3 else 2
        w.put(1, 1)
        w.ue(0); w.ue(crop_r // cu); w.ue(0); w.ue(crop_b // cu)
    else:
        w.put(1, 0)
    # VUI: the encoder feeds FULL-RANGE BT.601 YCbCr (rgb_to_yuv420);
    # without signalling it, WebCodecs assumes limited-range BT.709 and
    # every frame renders with crushed contrast and a hue shift.
    w.put(1, 1)           # vui_parameters_present
    w.put(1, 0)           # aspect_ratio_info_present
    w.put(1, 0)           # overscan_info_present
    w.put(1, 1)           # video_signal_type_present
    w.put(3, 5)           # video_format: unspecified
    w.put(1, 1)           # video_full_range_flag = 1
    w.put(1, 1)           # colour_description_present
    w.put(8, 6)           # colour_primaries: SMPTE 170M (BT.601)
    w.put(8, 6)           # transfer_characteristics: SMPTE 170M
    w.put(8, 6)           # matrix_coefficients: SMPTE 170M (BT.601)
    w.put(1, 0)           # chroma_loc_info_present
    w.put(1, 0)           # timing_info_present
    w.put(1, 0)           # nal_hrd_parameters_present
    w.put(1, 0)           # vcl_hrd_parameters_present
    w.put(1, 0)           # pic_struct_present
    w.put(1, 0)           # bitstream_restriction
    w.rbsp_trailing()
    return nal(7, w.to_bytes())


def write_pps() -> bytes:
    w = BitWriter()
    w.ue(0)               # pps_id
    w.ue(0)               # sps_id
    w.put(1, 0)           # entropy_coding_mode = CAVLC
    w.put(1, 0)           # bottom_field_pic_order
    w.ue(0)               # num_slice_groups_minus1
    w.ue(0)               # num_ref_idx_l0_default_active_minus1
    w.ue(0)               # num_ref_idx_l1_default_active_minus1
    w.put(1, 0)           # weighted_pred
    w.put(2, 0)           # weighted_bipred_idc
    w.se(0)               # pic_init_qp_minus26
    w.se(0)               # pic_init_qs_minus26
    w.se(0)               # chroma_qp_index_offset
    w.put(1, 1)           # deblocking_filter_control_present
    w.put(1, 0)           # constrained_intra_pred
    w.put(1, 0)           # redundant_pic_cnt_present
    w.rbsp_trailing()
    return nal(8, w.to_bytes())


def slice_header_prefix_bits(w: BitWriter, first_mb: int) -> None:
    """IDR I-slice header up to (excluding) idr_pic_id — the part that
    depends only on geometry; the device emits the rest as events."""
    w.ue(first_mb)
    w.ue(7)               # slice_type I (all slices)
    w.ue(0)               # pps_id
    w.put(4, 0)           # frame_num (log2_max_frame_num = 4), IDR -> 0


def slice_header_events(mb_w: int, n_rows: int):
    """Per-row slice-header PREFIX bits as two (payload, nbits) device
    events — everything up to but excluding idr_pic_id (the idr/qp/deblock
    tail is emitted as device events, so neither per-row qp nor per-stripe
    IDR ids ever need a host round-trip). Built through
    slice_header_prefix_bits, as in the reference."""
    pay = np.zeros((n_rows, 2), np.uint32)
    nb = np.zeros((n_rows, 2), np.int32)
    for r in range(n_rows):
        w = BitWriter()
        slice_header_prefix_bits(w, r * mb_w)
        bits = w.bits
        assert len(bits) <= 62, "slice header prefix exceeds two events"
        for slot, chunk in enumerate((bits[:31], bits[31:])):
            if chunk:
                val = 0
                for b in chunk:
                    val = (val << 1) | b
                pay[r, slot] = val
                nb[r, slot] = len(chunk)
    return pay, nb


def assemble_annexb(row_rbsp: list[bytes]) -> bytes:
    """Per-row slice RBSPs -> Annex-B (start codes + emulation prevention)."""
    return b"".join(nal(5, rb) for rb in row_rbsp)


def p_slice_header_events(mb_w: int, n_rows: int):
    """Per-row P-slice header PREFIX events: ue(first_mb), ue(5 P),
    ue(0 pps) — frame_num/flags/qp/deblock are device events."""
    pay = np.zeros((n_rows, 2), np.uint32)
    nb = np.zeros((n_rows, 2), np.int32)
    for r in range(n_rows):
        w = BitWriter()
        w.ue(r * mb_w)
        w.ue(5)
        w.ue(0)
        bits = w.bits
        assert len(bits) <= 62
        for slot, chunk in enumerate((bits[:31], bits[31:])):
            if chunk:
                val = 0
                for b in chunk:
                    val = (val << 1) | b
                pay[r, slot] = val
                nb[r, slot] = len(chunk)
    return pay, nb



def p_slice_header_bits(w: BitWriter, first_mb: int, qp: int,
                        frame_num: int) -> None:
    """Non-IDR P-slice header matching write_sps/write_pps choices."""
    w.ue(first_mb)
    w.ue(5)               # slice_type P (all slices)
    w.ue(0)               # pps_id
    w.put(4, frame_num & 0xF)
    # poc type 2: nothing
    w.put(1, 0)           # num_ref_idx_active_override_flag
    w.put(1, 0)           # ref_pic_list_modification_flag_l0
    w.put(1, 0)           # adaptive_ref_pic_marking_mode_flag (ref pic)
    w.se(qp - 26)         # slice_qp_delta
    w.ue(1)               # disable_deblocking_filter_idc = 1


def p_skip_slice_rbsp(first_mb: int, n_mbs: int, qp: int,
                      frame_num: int) -> bytes:
    """RBSP of an all-skip P slice: header + ``ue(mb_skip_run == n_mbs)``
    + stop bit, byte-identical to what the device P step emits for a row
    with no coded macroblock. Cached on the 16-value frame_num the header
    encodes (u(4)), so a clean row's bytes recycle every 16 frames."""
    return _p_skip_slice_cached(first_mb, n_mbs, qp, frame_num & 0xF)


@functools.lru_cache(maxsize=4096)
def _p_skip_slice_cached(first_mb: int, n_mbs: int, qp: int,
                         frame_num: int) -> bytes:
    w = BitWriter()
    p_slice_header_bits(w, first_mb, qp, frame_num)
    w.ue(n_mbs)
    w.rbsp_trailing()
    return w.to_bytes()
