"""The port's 4:4:4 (``fullcolor``) H.264 frames against the JAX package.

- The CSC (kernel K13's plain version) equals the reference's
  ``rgb_to_yuv444`` over all 2^24 RGB triples (one 4096x4096 frame), and
  over the triples where the two float orders of the 3-term dot differ,
  at a session's small geometry; its damage flags and ``prev`` update
  equal the reference step's.
- I frames (``h264_encode_yuv444``: K14 -> K16 -> K4 plain) at qp 16,
  28, 40 and per-row qp equal the reference in words, bit totals, the
  overflow flag and all three recon planes, and (single qp) the golden
  ``codecs.h264.I444Encoder`` byte for byte.
- Zero-MV P frames equal ``h264_encode_p_yuv444`` and the golden
  ``P444Encoder``; the all-skip frame is tiny.
- The motion search's 4:4:4 entry equals ``_motion_select444`` in the
  three prediction planes and the MV field (64x128, 32-row windows,
  vrange 4 / hrange 2; and a one-MB-wide frame with 16-row windows and
  the widest set it takes, 128 candidates reaching |dy|, |dx| = 64), and
  the P frame with motion equals the reference in words and recon; a
  precomputed search gives the same frame.
- libavcodec (the JAX package's avshim) decodes the port's Hi444PP rows
  to the port's recon; e_cap and w_cap overflows set the reference's
  flag and words.

Compiled JAX functions are built once per module. Tolerance: 0.
"""

import functools

import numpy as np
import pytest
import torch

import jax

from selkies_tpu.codecs import h264 as jcodec
from selkies_tpu.codecs import h264_ref_decoder as refdec
from selkies_tpu.native import avshim
from selkies_tpu.ops import h264_planes444 as J4
from selkies_tpu.ops.bitpack import words_to_bytes
from selkies_tpu_torch.codecs import h264 as tcodec
from selkies_tpu_torch.ops import h264_encode as TE
from selkies_tpu_torch.ops import h264_planes444 as T4
from selkies_tpu_torch.ops.colorspace import _CSC_601_FULL, _fma_f32

torch.set_num_threads(1)

H, W = 48, 64
R, M = H // 16, W // 16
E_CAP = 9 + M * T4.SLOTS_MB_444 + 2
W_CAP = 3072
HDR = jcodec.slice_header_events(M, R)
P_HDR = jcodec.p_slice_header_events(M, R)

_j_i = jax.jit(lambda y, u, v, qp, idr: J4.h264_encode_yuv444(
    y, u, v, qp, *HDR, E_CAP, W_CAP, idr_pic_id=idr, want_recon=True))
_j_p = jax.jit(lambda y, u, v, ry, ru, rv, qp, fn: J4.h264_encode_p_yuv444(
    y, u, v, ry, ru, rv, qp, *P_HDR, fn, E_CAP, W_CAP))

QPS = {"qp16": 16, "qp28": 28, "qp40": 40, "per_row": None}


def _qp(case):
    if QPS[case] is None:
        return np.array([18, 30, 44], np.int32)
    return np.full(R, QPS[case], np.int32)


def _planes(kind, seed, h=H, w=W):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    if kind == "texture":          # the reference tests' 4:4:4 planes
        y = (xx * 5 + yy * 11 + rng.integers(0, 48, (h, w))) % 256
        u = (xx * 3 + rng.integers(0, 64, (h, w))) % 256
        v = rng.integers(0, 256, (h, w))
    else:                          # gradient, text patch, flat chroma
        y = 40 + yy * 2 + xx
        y[8:30, 10:50] = rng.integers(0, 2, (22, 40)) * 200 + 20
        u = 100 + xx
        v = 160 - yy
        v[20:40, 30:60] = 90
    return [np.clip(a, 0, 255).astype(np.uint8) for a in (y, u, v)]


def _check_out(got, ref):
    assert np.array_equal(got.words.numpy().view(np.uint32),
                          np.asarray(ref.words))
    assert np.array_equal(got.total_bits.numpy(), np.asarray(ref.total_bits))
    assert bool(got.overflow) == bool(ref.overflow)


def _rows(out):
    """H264FrameOut -> per-row slice RBSPs."""
    w = out.words.numpy().view(np.uint32)
    b = out.total_bits.numpy()
    return [words_to_bytes(w[r], int(b[r]), pad_ones=False)
            for r in range(out.mb_rows)]


def _golden_rows(frame_bytes):
    return [refdec.remove_emulation_prevention(part[1:])
            for part in frame_bytes.split(b"\x00\x00\x00\x01")[1:]]


# --------------------------------------------------------------------- CSC
def test_csc_equals_reference_on_every_byte_triple():
    v = np.arange(1 << 24, dtype=np.uint32)
    rgb = np.stack([(v >> 16) & 255, (v >> 8) & 255, v & 255], -1).astype(
        np.uint8).reshape(4096, 4096, 3)
    del v
    want = jax.jit(J4.rgb_to_yuv444)(rgb)
    frame = torch.from_numpy(rgb)
    prev = torch.zeros_like(frame)
    y, u, v, damage = T4.csc444_damage_plain(frame, prev, 16)
    for got, ref in zip((y, u, v), want):
        assert np.array_equal(got.numpy(), np.asarray(ref).astype(np.uint8))
    assert damage.tolist() == [1] * 16
    assert torch.equal(prev, frame)


@functools.lru_cache(maxsize=1)
def _tie_triples():
    """Every RGB triple whose rounded Y, Cb or Cr differs between the
    all-rounded order ((r*m0 + g*m1) + b*m2) and the fused one
    fma(b, m2, fma(g, m1, r*m0)): the triples that tell the orders
    apart."""
    v = np.arange(1 << 24, dtype=np.uint32)
    rgb = np.stack([(v >> 16) & 255, (v >> 8) & 255, v & 255], -1).astype(
        np.uint8)
    x = torch.from_numpy(rgb).to(torch.float32)
    r, g, b = x[:, 0], x[:, 1], x[:, 2]
    m = _CSC_601_FULL
    ties = torch.zeros(len(rgb), dtype=torch.bool)
    for c, off in enumerate((0.0, 128.0, 128.0)):
        plain = ((r * float(m[c, 0]) + g * float(m[c, 1]))
                 + b * float(m[c, 2])) + off
        fused = _fma_f32(b, m[c, 2], _fma_f32(g, m[c, 1],
                                              r * float(m[c, 0]))) + off
        ties |= torch.round(plain) != torch.round(fused)
    return rgb[ties.numpy()]


@pytest.mark.parametrize("shape", [(48, 64), (64, 128)])
def test_csc_tie_triples_at_session_sizes(shape):
    t = _tie_triples()
    assert len(t) > 1000
    frame = np.resize(t, (shape[0] * shape[1], 3)).reshape(*shape, 3)
    want = jax.jit(J4.rgb_to_yuv444)(frame)
    got = T4.rgb_to_yuv444(torch.from_numpy(frame))
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))


def test_csc_damage_flags_and_prev():
    rng = np.random.default_rng(3)
    f0 = rng.integers(0, 256, (64, 128, 3), dtype=np.uint8)
    f1 = f0.copy()
    f1[20, 7, 1] ^= 4                                   # stripe 1 of 4
    f1[63, 127, 2] ^= 1                                 # stripe 3
    prev = torch.from_numpy(f0.copy())
    *_, damage = T4.csc444_damage(torch.from_numpy(f1), prev, 4)
    want = (f1 != f0).reshape(4, -1).any(1)
    assert damage.dtype == torch.int32
    assert damage.tolist() == want.astype(int).tolist() == [0, 1, 0, 1]
    assert np.array_equal(prev.numpy(), f1)
    with pytest.raises(ValueError):
        T4.csc444_damage(torch.from_numpy(f1), prev, 5)


# ------------------------------------------------------------------ frames
@pytest.mark.parametrize("kind", ["texture", "desktop"])
@pytest.mark.parametrize("case", list(QPS))
def test_i_frame(kind, case):
    y, u, v = _planes(kind, 1)
    qp = _qp(case)
    idr = np.array([0, 5, 15], np.int32)
    ref, jrec = _j_i(y, u, v, qp, idr)
    got, trec = T4.h264_encode_yuv444(y, u, v, qp, *HDR, E_CAP, W_CAP,
                                      idr_pic_id=idr, want_recon=True,
                                      device="cpu")
    _check_out(got, ref)
    for g, r in zip(trec, jrec):
        assert np.array_equal(g.numpy(), np.asarray(r))


@pytest.mark.parametrize("qp", [16, 28, 40])
def test_i_frame_equals_golden_encoder(qp):
    y, u, v = _planes("texture", 10 + qp)
    got, trec = T4.h264_encode_yuv444(y, u, v, qp, *HDR, E_CAP, W_CAP,
                                      want_recon=True, device="cpu")
    enc = jcodec.I444Encoder(W, H, qp)
    assert _rows(got) == _golden_rows(enc.encode_frame(y, u, v))
    for c in range(3):
        assert np.array_equal(trec[c].numpy(), enc.recon[c])


def _p_inputs(kind, seed, qp):
    y0, u0, v0 = _planes(kind, seed)
    _, rec = _j_i(y0, u0, v0, qp, np.zeros(R, np.int32))
    rec = [np.asarray(a) for a in rec]
    y1, u1, v1 = (a.copy() for a in (y0, u0, v0))
    y1[16:32] = np.roll(y0[16:32], 2, axis=1)          # MB row 1 changes
    v1[:16, :32] = 255 - v1[:16, :32]                  # chroma only
    return (y1, u1, v1), rec


@pytest.mark.parametrize("kind", ["texture", "desktop"])
@pytest.mark.parametrize("case", list(QPS))
def test_p_frame(kind, case):
    qp = _qp(case)
    cur, rec = _p_inputs(kind, 2, qp)
    fn = np.array([1, 2, 15], np.int32)
    ref, jrec = _j_p(*cur, *rec, qp, fn)
    got, trec = T4.h264_encode_p_yuv444(*cur, *rec, qp, *P_HDR, fn, E_CAP,
                                        W_CAP, device="cpu")
    _check_out(got, ref)
    for g, r in zip(trec, jrec):
        assert np.array_equal(g.numpy(), np.asarray(r))


def test_p_frame_equals_golden_encoder():
    qp = 28
    y0, u0, v0 = _planes("texture", 20)
    enc = jcodec.I444Encoder(W, H, qp)
    enc.encode_frame(y0, u0, v0)
    _, rec = T4.h264_encode_yuv444(y0, u0, v0, qp, *HDR, E_CAP, W_CAP,
                                   want_recon=True, device="cpu")
    y1 = y0.copy()
    y1[16:32] = np.roll(y0[16:32], 2, axis=1)
    v1 = v0.copy()
    v1[:16, :32] = 255 - v1[:16, :32]
    got, trec = T4.h264_encode_p_yuv444(y1, u0, v1, *rec, qp, *P_HDR, 1,
                                        E_CAP, W_CAP, device="cpu")
    penc = jcodec.P444Encoder(enc)
    assert _rows(got) == _golden_rows(penc.encode_frame(y1, u0, v1,
                                                        frame_num=1))
    for c in range(3):
        assert np.array_equal(trec[c].numpy(), enc.recon[c])


def test_all_skip_p_frame():
    qp = _qp("qp28")
    _, rec = _j_i(*_planes("desktop", 3), qp, np.zeros(R, np.int32))
    rec = [np.asarray(a) for a in rec]
    fn = np.ones(R, np.int32)
    ref, _ = _j_p(*rec, *rec, qp, fn)
    got, trec = T4.h264_encode_p_yuv444(*rec, *rec, qp, *P_HDR, fn, E_CAP,
                                        W_CAP, device="cpu")
    _check_out(got, ref)
    for g, r in zip(trec, rec):
        assert np.array_equal(g.numpy(), r)
    assert int(got.total_bits.max()) < 64


# ------------------------------------------------------------------ motion
MH, MW, WIN = 64, 128, 32
MR, MM = MH // 16, MW // 16
SMALL = TE.scroll_candidates(4, 2)
M_E_CAP = 9 + MM * T4.SLOTS_MB_444 + 2
M_P_HDR = jcodec.p_slice_header_events(MM, MR)
_j_select = jax.jit(J4._motion_select444, static_argnums=(5, 6))
_j_p_motion = jax.jit(lambda y, u, v, ry, ru, rv, qp, fn:
                      J4.h264_encode_p_yuv444(
                          y, u, v, ry, ru, rv, qp, *M_P_HDR, fn, M_E_CAP,
                          W_CAP, candidates=SMALL, stripe_rows=WIN // 16))


def _motion_frames(seed):
    """Reference planes and a current frame whose macroblocks moved by
    different vectors: a scroll, a pan, the other way, and a still MB
    row with new content."""
    ref = _planes("texture", seed, MH, MW)
    cur = []
    for p in ref:
        c = np.roll(p, -3, 0)
        c[:, 32:64] = np.roll(p, -2, 1)[:, 32:64]
        c[:, 64:96] = np.roll(p, 4, 0)[:, 64:96]
        c[48:64, 96:] = p[48:64, 96:] // 2
        cur.append(c)
    return ref, cur


@pytest.mark.parametrize("case", ["qp28", "per_row"])
def test_motion_select444_equals_reference(case):
    ref, cur = _motion_frames(5)
    qp = np.array([20, 28, 36, 44], np.int32) if case == "per_row" \
        else np.full(MR, 28, np.int32)
    want = _j_select(cur[0].astype(np.int32), *(p.astype(np.int32)
                                                for p in ref),
                     qp, SMALL, WIN)
    got = TE.motion_select444(*(torch.from_numpy(p) for p in
                                (cur[0], *ref)), torch.from_numpy(qp),
                              SMALL, WIN)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))
    mv = got[3]
    assert bool((mv != 0).any()) and bool((mv == 0).all(-1).any())


@pytest.mark.parametrize("case", ["qp28", "per_row"])
def test_p_frame_with_motion(case):
    ref, cur = _motion_frames(6)
    qp = np.array([20, 28, 36, 44], np.int32) if case == "per_row" \
        else np.full(MR, 28, np.int32)
    fn = np.full(MR, 3, np.int32)
    want, jrec = _j_p_motion(*cur, *ref, qp, fn)
    got, trec = T4.h264_encode_p_yuv444(*cur, *ref, qp, *M_P_HDR, fn,
                                        M_E_CAP, W_CAP, candidates=SMALL,
                                        stripe_rows=WIN // 16, device="cpu")
    _check_out(got, want)
    for g, r in zip(trec, jrec):
        assert np.array_equal(g.numpy(), np.asarray(r))
    # the search, handed over precomputed, gives the same frame
    motion = TE.motion_select444(*(torch.from_numpy(p) for p in
                                   (cur[0], *ref)), torch.from_numpy(qp),
                                 SMALL, WIN)
    again, arec = T4.h264_encode_p_yuv444(
        *cur, *ref, qp, *M_P_HDR, fn, M_E_CAP, W_CAP,
        precomputed_motion=motion, device="cpu")
    assert torch.equal(again.words, got.words)
    for a, t in zip(arec, trec):
        assert torch.equal(a, t)


def _widest_candidates(n=128, seed=13):
    """The widest set K5 takes: (0, 0), extremes at 64 and distinct random
    (dy, dx) with |dy|, |dx| <= 64."""
    rng = np.random.default_rng(seed)
    c = [(0, 0), (64, 0), (-64, 0), (0, 64), (0, -64), (-64, 64)]
    while len(c) < n:
        d = tuple(int(v) for v in rng.integers(-64, 65, 2))
        if d not in c:
            c.append(d)
    return tuple(c)


@pytest.mark.parametrize("case", ["texture", "flat", "qp_range"])
def test_motion_select444_widest_candidates_at_width_16(case):
    """The 4:4:4 search with 128 candidates reaching |dy|, |dx| = 64 on a
    one-MB-wide frame with 16-row windows (both width clamps at once, the
    chroma planes riding the same clamps); a flat frame where every SAD
    ties; per-row qp at 0, 51 and out of range."""
    rng = np.random.default_rng(4)
    h, w = 64, 16
    ref = [rng.integers(0, 256, (h, w)).astype(np.uint8) for _ in range(3)]
    cur = np.roll(np.roll(ref[0], -5, 0), 3, 1)
    qp = np.array([28, 20, 36, 12], np.int32)
    if case == "flat":
        ref[0] = np.full((h, w), 90, np.uint8)
        cur = np.full((h, w), 97, np.uint8)
    elif case == "qp_range":
        qp = np.array([0, 51, -9, 400], np.int32)
    cands = _widest_candidates()
    want = _j_select(cur.astype(np.int32),
                     *(p.astype(np.int32) for p in ref), qp, cands, 16)
    got = TE.motion_select444(*(torch.from_numpy(p) for p in (cur, *ref)),
                              torch.from_numpy(qp), cands, 16)
    for g, wv in zip(got, want):
        assert np.array_equal(g.numpy().astype(np.int64),
                              np.asarray(wv).astype(np.int64))


# --------------------------------------------------------------- libavcodec
needs_av = pytest.mark.skipif(not avshim.available(),
                              reason="libavcodec shim not available")


@needs_av
def test_libavcodec_decodes_port_rows_to_port_recon():
    """An IDR at per-row qp, then a P frame with motion, through
    libavcodec's Hi444PP decoder: the pictures equal the port's recon."""
    ref, cur = _motion_frames(7)
    qp = np.array([18, 30, 44, 26], np.int32)
    hdr = jcodec.slice_header_events(MM, MR)
    i_out, irec = T4.h264_encode_yuv444(*ref, qp, *hdr, M_E_CAP, W_CAP,
                                        want_recon=True, device="cpu")
    p_out, prec = T4.h264_encode_p_yuv444(*cur, *irec, qp, *M_P_HDR, 1,
                                          M_E_CAP, W_CAP, candidates=SMALL,
                                          stripe_rows=MR, device="cpu")
    headers = tcodec.write_sps(MW, MH, chroma_format=3) + tcodec.write_pps()
    sess = avshim.H264Session()
    got = []
    for au in (headers + tcodec.assemble_annexb(_rows(i_out)),
               b"".join(tcodec.nal(1, rb, ref_idc=2)
                        for rb in _rows(p_out))):
        out = sess.decode(au)
        if out is not None:
            got.append(out)
    out = sess.flush()
    if out is not None:
        got.append(out)
    sess.close()
    assert len(got) == 2
    for pic, rec in zip(got, (irec, prec)):
        for c in range(3):
            assert np.array_equal(pic[c], rec[c].numpy()), c


def test_sps_equals_reference():
    for w, h in ((64, 48), (1920, 1088), (1920, 64)):
        assert tcodec.write_sps(w, h, chroma_format=3) \
            == jcodec.write_sps(w, h, chroma_format=3)


# ---------------------------------------------------------------- overflow
_j_i_small = jax.jit(lambda y, u, v, qp: J4.h264_encode_yuv444(
    y, u, v, qp, *HDR, 300, 64))
_j_p_small = jax.jit(lambda y, u, v, ry, ru, rv, qp: J4.h264_encode_p_yuv444(
    y, u, v, ry, ru, rv, qp, *P_HDR, 1, E_CAP, 16))


def test_overflow_flags_equal_reference():
    """e_cap too small for the events of a row (I), w_cap too small for
    its bits (P): the reference's flag, words and bit totals."""
    y, u, v = _planes("texture", 8)
    qp = _qp("qp16")
    want = _j_i_small(y, u, v, qp)
    got = T4.h264_encode_yuv444(y, u, v, qp, *HDR, 300, 64, device="cpu")
    assert bool(want.overflow)
    _check_out(got, want)
    (y1, u1, v1), rec = _p_inputs("texture", 9, qp)
    want, _ = _j_p_small(y1, u1, v1, *rec, qp)
    got, _ = T4.h264_encode_p_yuv444(y1, u1, v1, *rec, qp, *P_HDR, 1, E_CAP,
                                     16, device="cpu")
    assert bool(want.overflow)
    _check_out(got, want)


# ---------------------------------------------------------------- contract
@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the raise "
                    "on a machine without CUDA")
def test_444_entry_points_default_to_the_card():
    y, u, v = _planes("desktop", 4)
    qp = _qp("qp28")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T4.h264_encode_yuv444(y, u, v, qp, *HDR, E_CAP, W_CAP)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T4.h264_encode_p_yuv444(y, u, v, y, u, v, qp, *P_HDR, 1, E_CAP,
                                W_CAP)


def test_444_wrappers_check_their_inputs():
    """The 4:4:4 wrappers take full-resolution chroma only, and the
    layouts of their own chroma format."""
    y = torch.zeros((32, 32), dtype=torch.uint8)
    half = torch.zeros((16, 16), dtype=torch.uint8)
    qp = torch.full((2,), 28, dtype=torch.int32)
    send = torch.ones((1,), dtype=torch.int32)
    with pytest.raises(ValueError, match="ref_u"):
        T4.mb_encode_i444(y, y, y, qp, send, 2, y, half, half)
    with pytest.raises(ValueError, match="ref_u"):
        TE.motion_select444(y, y, half, half, qp, SMALL, 32)
    lv27 = torch.zeros((2, 2, 27, 16), dtype=torch.int16)
    with pytest.raises(ValueError, match="lv"):
        T4.cavlc_events444(lv27, torch.zeros((2, 2), dtype=torch.int32),
                           True)
