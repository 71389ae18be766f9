"""The port's CUDA kernels against their plain PyTorch versions.

Needs a CUDA card (marker ``cuda``; skipped elsewhere, decided inside the
fixture). Run on the card with ``python -m pytest tests/test_torch_cuda.py
-m cuda``. Each kernel gets the same inputs as its plain version at small
geometries (one and several stripes, per-row qp, half the stripes sent,
scrolled and panned content for the motion search, neighbouring
macroblocks with different vectors, an unaligned probe input; for the
JPEG kernels 4:2:0 and 4:4:4, per-stripe tables at qualities 10 to 100
and tables of 1/16 that expose one ulp of a coefficient, values past the
category caps, and word and byte buffers too small; for the H.264 4:4:4
kernels K13-K16 and K5's 4:4:4 entry the same cases, the CSC over all
2^24 byte triples and the fullcolor session; for the seat entries of K4,
K9 and K10 one to four seats, one of whose rows overflows and spills,
and both multi-seat encoders through a one-seat overflow; for ROI QP's
K17 and K18 and K2-P's per-MB-QP entry random frames and planes at
1080p with QPs 0..51, an unaligned K17 input and the ROI session; for
split-frame K4's seat entry at 4:4:4's slot counts, K20 at widths that
are not multiples of 16 with halos past both frame edges, K19 at 4:2:0
and 4:4:4 with windows across the shard seams and odd negative vertical
candidates (equal to K5 on the whole frame as well), the sharded frame
entries and the sharded session at 4 shards; for K3 and K4 the edge
frame (45 MBs a row, an all-skip P row, a row coded in its last MB only,
a row ending on a word boundary) and each of its rows as a 1-row band,
bands of 1, 2, 4 and 5 rows at 45 and 63 MBs a row (as views, their nb
rows off 16-byte boundaries), 28-bit escapes at QP 0 on noise past K4's
shared words, e_cap overflow alone, spills into the next row and off a
seat's end at 1, 3 and 8 seats, out_cap at the total and one byte less,
4:4:4 through both K4 entries with K16, and a 1080p frame; for K16
rows of 1, 45 and 63 MBs, so a block of 4 MBs spans a row start, 28-bit
escapes at QP 0, P rows with every 8x8 group gated off and each group
bit alone, bands of 1, 2, 4 and 5 rows as views and a misaligned level
array, which is refused; for K5 and K19, all four entries, rows of 45
and 63 MBs at 4 and 2 MBs a block, row groups of 4 and 5 MB rows, W =
16, 16- and 64-row windows, 1, 57
and 128 candidates with |dy| and |dx| up to 64, a flat frame where the
lambda and then the lowest index decide, an exact tie between (3, 0) and
(-3, 0), per-row qp at 0, 51 and out of range, and a misaligned plane,
which is refused; for K2-P 13 MBs a row (odd, so chroma rows start off
16-byte boundaries, and not a multiple of its 4 MBs a block), bands as
views from a stripe boundary, send gates that cut across the stripes,
the prediction aliasing the reference and separate prediction planes
with vectors, planes 4 and 1 bytes into their storage, and per-MB QPs
0 and 51 inside one block; for K10 widths whose rows are not multiples
of 16 bytes at H <= 96, rows that are, and 3 seats of an odd frame) and
must match it exactly, overflow flags included. Tolerance: 0.
"""

import numpy as np
import pytest
import torch

from selkies_tpu_torch.codecs import h264 as hcodec
from selkies_tpu_torch.codecs import jpeg as jtab
from selkies_tpu_torch.ops import h264_encode as TE
from selkies_tpu_torch.ops import h264_planes as HP
from selkies_tpu_torch.ops import h264_planes444 as H4
from selkies_tpu_torch.ops import jpeg_entropy as JE
from selkies_tpu_torch.ops import jpeg_pipeline as JPP
from selkies_tpu_torch.ops import jpeg_planes as JPL

pytestmark = pytest.mark.cuda

torch.set_num_threads(1)

GEOMS = [(64, 80, 32), (48, 96, 16), (32, 32, 32)]


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _same(ks, ps):
    for k, p in zip(ks, ps):
        assert k.shape == p.shape and k.dtype == p.dtype
        assert torch.equal(k.cpu(), p.cpu())


def _frames(dev, H, W):
    rng = np.random.default_rng(H * W)
    f0 = torch.as_tensor(rng.integers(0, 256, (H, W, 3), dtype=np.uint8),
                         device=dev)
    f1 = f0.clone()
    f1[:16, :32] = 255 - f1[:16, :32]
    return f0, f1


def _stage(dev, H, W, sh):
    """K1..K2 outputs of a geometry (through the plain versions)."""
    S, rps, R = H // sh, sh // 16, H // 16
    f0, f1 = _frames(dev, H, W)
    y, u, v, _ = HP.csc420_damage_plain(f1, f0.clone(), S)
    qp = torch.full((R,), 26, dtype=torch.int32, device=dev)
    qp[::2] = 44
    send = torch.ones((S,), dtype=torch.int32, device=dev)
    send[1::2] = 0
    ref = [torch.zeros_like(p) for p in (y, u, v)]
    i_out = HP.mb_encode_i_plain(y, u, v, qp, send, rps, *ref)
    return S, rps, (y, u, v), qp, send, ref, i_out


@pytest.mark.parametrize("geom", GEOMS)
def test_csc420_damage(dev, geom):
    H, W, sh = geom
    f0, f1 = _frames(dev, H, W)
    pk, pp = f0.clone(), f0.clone()
    _same(list(HP.csc420_damage(f1, pk, H // sh)) + [pk],
          list(HP.csc420_damage_plain(f1, pp, H // sh)) + [pp])


def _p_call(p_fn, planes, qp, send, rps, ref, cands, send_rows=None,
            rows=None):
    """K2-P (kernel or plain) with the prediction of K5 (zero motion: the
    reference planes themselves, updated in place). ``send_rows``
    overrides the stripes' gate row by row; ``rows`` (a slice of MB rows)
    codes that band only, every plane, the prediction and the reference
    handed over as views, as the band step does."""
    if send_rows is None:
        send_rows = send.repeat_interleave(rps)
    if cands is None:
        pred, mv = ref, None
    else:
        *pred, mv = TE.motion_select_plain(planes[0], *ref, qp, cands,
                                           16 * rps)
    if rows is not None:
        def band(ts):
            return [t[16 * rows.start // c:16 * rows.stop // c]
                    for t, c in zip(ts, (1, 2, 2))]
        planes, pred, ref = band(planes), band(pred), band(ref)
        qp, send_rows = qp[rows], send_rows[rows]
        mv = None if mv is None else mv[rows]
    return p_fn(*planes, qp, send_rows, *pred, mv, *ref)


#: K2-P also at 13 MBs a row: odd (chroma rows off 16-byte boundaries)
#: and not a multiple of the 4 MBs a block takes; and at 8, a multiple,
#: which takes its kernel for whole blocks on 16-byte boundaries
P_GEOMS = GEOMS + [(64, 208, 32), (64, 128, 32)]


@pytest.mark.parametrize("geom", P_GEOMS)
@pytest.mark.parametrize("mode", ["i", "p0", "p", "p0_rows", "p_rows",
                                  "p0_band", "p_band"])
def test_mb_encode(dev, geom, mode):
    """K2 against plain: I, P with zero motion (the prediction is the
    reference, rewritten in place) and with K5's prediction; ``_rows``
    sends MB rows in a pattern that cuts across the stripes, ``_band``
    codes the MB rows of the second stripe on (views from a stripe
    boundary)."""
    S, rps, planes, qp, send, ref, _ = _stage(dev, *geom)
    if mode == "i":
        base = [torch.zeros_like(p) for p in planes]
    else:
        base = [p.clone() for p in ref]
        planes = tuple(255 - p for p in planes) if mode.startswith("p0") \
            else tuple(torch.roll(p, (-2, 1), (0, 1)) for p in planes)
    kref = [b.clone() for b in base]
    pref = [b.clone() for b in base]
    if mode == "i":
        ko = HP.mb_encode_i(*planes, qp, send, rps, *kref)
        po = HP.mb_encode_i_plain(*planes, qp, send, rps, *pref)
    else:
        cands = None if mode.startswith("p0") else TE.scroll_candidates(4, 2)
        R = geom[0] // 16
        kw = {}
        if mode.endswith("_rows"):
            kw["send_rows"] = torch.tensor([1, 0, 0, 1, 1, 0][:R] * 2,
                                           dtype=torch.int32,
                                           device=dev)[:R]
        if mode.endswith("_band"):
            kw["rows"] = slice(rps if S > 1 else 0, R)
        ko = _p_call(HP.mb_encode_p, planes, qp, send, rps, kref, cands,
                     **kw)
        po = _p_call(HP.mb_encode_p_plain, planes, qp, send, rps, pref,
                     cands, **kw)
    _same(list(ko) + kref, list(po) + pref)


@pytest.mark.parametrize("offset", [4, 1])
@pytest.mark.parametrize("motion", [False, True])
def test_mb_encode_p_on_unaligned_planes(dev, offset, motion):
    """K2-P on planes that start ``offset`` bytes into their storage (a
    4-byte and a byte-aligned view: the block's narrower staging pieces),
    at 13 MBs a row, equal to plain."""
    H, W, sh = 64, 208, 32
    S, rps, planes, qp, send, ref, _ = _stage(dev, H, W, sh)

    def shifted(t):
        buf = torch.zeros(t.numel() + 16, dtype=torch.uint8, device=dev)
        v = buf[offset:offset + t.numel()].view(t.shape)
        v.copy_(t)
        return v
    cur = [shifted(torch.roll(p, (-2, 1), (0, 1))) for p in planes]
    cands = TE.scroll_candidates(4, 2) if motion else None
    outs = []
    for fn in (HP.mb_encode_p, HP.mb_encode_p_plain):
        r = [shifted(p) for p in ref]
        outs.append(list(_p_call(fn, cur, qp, send, rps, r, cands)) + r)
    _same(outs[0], outs[1])


@pytest.mark.parametrize("geom", GEOMS)
@pytest.mark.parametrize("cands", ["small", "default"])
def test_motion_select(dev, geom, cands):
    """K5 against its plain version: a scrolled and a panned half, per-row
    qp, windows of one stripe (clamping at both window edges and the
    right picture edge)."""
    H, W, sh = geom
    cands = TE.scroll_candidates(4, 2) if cands == "small" \
        else TE.scroll_candidates()
    S, rps, planes, qp, send, ref, _ = _stage(dev, *geom)
    ref = [p.clone() for p in planes]
    cur = torch.roll(planes[0], -3, 0)
    cur[:, W // 2:] = torch.roll(planes[0], -2, 1)[:, W // 2:]
    _same(TE.motion_select(cur, *ref, qp, cands, sh),
          TE.motion_select_plain(cur, *ref, qp, cands, sh))


def test_motion_then_p_coder_with_neighbouring_vectors(dev):
    """Neighbouring macroblocks with different non-zero vectors: K5 then
    K2-P rewriting the reference in place equal the plain versions, in
    levels, headers and the reference planes after the frame."""
    H, W, sh = 64, 128, 32
    rng = np.random.default_rng(3)
    y = torch.as_tensor(rng.integers(0, 256, (H, W), dtype=np.uint8),
                        device=dev)
    u, v = (torch.as_tensor(rng.integers(0, 256, (H // 2, W // 2),
                                         dtype=np.uint8), device=dev)
            for _ in range(2))
    cur = torch.roll(y, -3, 0)
    cur[:, 32:64] = torch.roll(y, -2, 1)[:, 32:64]
    cur[:, 64:96] = torch.roll(y, 4, 0)[:, 64:96]
    qp = torch.full((H // 16,), 28, dtype=torch.int32, device=dev)
    send = torch.ones((H // 16,), dtype=torch.int32, device=dev)
    cands = TE.scroll_candidates(4, 2)
    outs = []
    for sel, p_fn in ((TE.motion_select, HP.mb_encode_p),
                      (TE.motion_select_plain, HP.mb_encode_p_plain)):
        ref = [y.clone(), u.clone(), v.clone()]
        *pred, mv = sel(cur, *ref, qp, cands, sh)
        outs.append(list(p_fn(cur, u, v, qp, send, *pred, mv, *ref))
                    + [mv] + ref)
    mv = outs[1][4]
    assert ((mv[:, 1:] != mv[:, :-1]).any(-1)
            & (mv[:, 1:] != 0).any(-1) & (mv[:, :-1] != 0).any(-1)).any()
    _same(outs[0], outs[1])


@pytest.mark.parametrize("geom", GEOMS)
def test_row_damage_probe(dev, geom):
    H, W, sh = geom
    f0, f1 = _frames(dev, H, W)
    for frame in (f0, f1, 255 - f0):
        _same([HP.row_damage_probe(frame, f0)],
              [HP.row_damage_probe_plain(frame, f0)])
    # a view 3 bytes into the frame takes the kernel's unaligned path
    a = f0.reshape(-1)[3:3 + H * W * 3 - 48 * W].reshape(H - 16, W, 3)
    b = f1.reshape(-1)[3:3 + H * W * 3 - 48 * W].reshape(H - 16, W, 3)
    _same([HP.row_damage_probe(a, b)], [HP.row_damage_probe_plain(a, b)])


@pytest.mark.parametrize("geom", GEOMS)
def test_cavlc_and_pack(dev, geom):
    H, W, sh = geom
    S, rps, planes, qp, send, ref, (lv, cbp, hp, hn) = _stage(dev, *geom)
    R, M = H // 16, W // 16
    ev = HP.cavlc_events(lv, cbp, True)
    _same(ev, HP.cavlc_events_plain(lv, cbp, True))
    pay, nb = hcodec.slice_header_events(M, rps)
    rhp = torch.as_tensor(np.tile(pay.astype(np.int32), (S, 1)), device=dev)
    rhn = torch.as_tensor(np.tile(nb, (S, 1)), device=dev)
    rid = torch.arange(R, dtype=torch.int32, device=dev)
    for w_cap, out_cap in ((2048, 1 << 16), (16, 1 << 16), (2048, 64)):
        args = (hp, hn, *ev, rhp, rhn, rid, qp, True, 10 ** 6, w_cap,
                out_cap)
        _same(HP.pack_stream(*args), HP.pack_stream_plain(*args))


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("W", [96, 208])
def test_chain_on_noise_at_random_qp(dev, seed, W):
    """Noise frames at per-row qp drawn from 0..51 (level escapes, large
    nC, long runs), I then P: every stage's kernel output equals the
    plain version's on the same inputs; also at 13 MBs a row (odd, not a
    multiple of K2-P's 4 MBs a block)."""
    H, sh = 64, 32
    S, rps, R, M = H // sh, sh // 16, H // 16, W // 16
    rng = np.random.default_rng(100 + seed)
    f0, f1 = (torch.as_tensor(rng.integers(0, 256, (H, W, 3),
                                           dtype=np.uint8), device=dev)
              for _ in range(2))
    qp = torch.as_tensor(rng.integers(0, 52, R).astype(np.int32), device=dev)
    send = torch.ones((S,), dtype=torch.int32, device=dev)
    ref = [torch.zeros((H, W), dtype=torch.uint8, device=dev)] + [
        torch.zeros((H // 2, W // 2), dtype=torch.uint8, device=dev)
        for _ in range(2)]
    for intra, frame in ((True, f0), (False, f1)):
        planes = HP.csc420_damage_plain(frame, f0.clone(), S)[:3]
        kref = [r.clone() for r in ref]
        if intra:
            ko = HP.mb_encode_i(*planes, qp, send, rps, *kref)
            po = HP.mb_encode_i_plain(*planes, qp, send, rps, *ref)
        else:
            ko = _p_call(HP.mb_encode_p, planes, qp, send, rps, kref, None)
            po = _p_call(HP.mb_encode_p_plain, planes, qp, send, rps, ref,
                         None)
        _same(list(ko) + kref, list(po) + ref)
        lv, cbp, hp, hn = ko
        ev = HP.cavlc_events(lv, cbp, intra)
        _same(ev, HP.cavlc_events_plain(lv, cbp, intra))
        fn = hcodec.slice_header_events if intra \
            else hcodec.p_slice_header_events
        pay, nb = fn(M, rps)
        args = (hp, hn, *ev,
                torch.as_tensor(np.tile(pay.astype(np.int32), (S, 1)),
                                device=dev),
                torch.as_tensor(np.tile(nb, (S, 1)), device=dev),
                torch.arange(R, dtype=torch.int32, device=dev), qp, intra,
                10 ** 6, 4096, 1 << 17)
        _same(HP.pack_stream(*args), HP.pack_stream_plain(*args))


def test_frame_entry_points_run_on_the_card(dev):
    """With numpy input and no device, h264_encode_yuv and
    h264_encode_p_yuv run on the card, equal to the plain CPU run."""
    H, W = 64, 80
    R, M = H // 16, W // 16
    rng = np.random.default_rng(11)
    y = rng.integers(0, 256, (H, W)).astype(np.int32)
    u, v = (rng.integers(0, 256, (H // 2, W // 2)).astype(np.int32)
            for _ in range(2))
    qp = np.array([8, 30, 51, 19], np.int32)
    e_cap, w_cap = 9 + M * 879 + 2, 2048
    hdr = hcodec.slice_header_events(M, R)
    p_hdr = hcodec.p_slice_header_events(M, R)
    outs = {}
    for d in (None, "cpu"):
        i_out, rec = HP.h264_encode_yuv(y, u, v, qp, *hdr, e_cap, w_cap,
                                        want_recon=True, device=d)
        p_out, _ = HP.h264_encode_p_yuv(255 - y, u, v, *rec, qp, *p_hdr,
                                        np.ones(R, np.int32), e_cap, w_cap,
                                        device=d)
        outs[d] = (i_out, p_out)
    assert outs[None][0].words.device.type == "cuda"
    for k, p in zip(outs[None], outs["cpu"]):
        _same([k.words, k.total_bits], [p.words, p.total_bits])
        assert bool(k.overflow) == bool(p.overflow)


# ---------------------------------------------------------------- JPEG
JPEG_GEOMS = [(64, 96, 16, "420"), (128, 64, 64, "420"), (48, 40, 8, "444"),
              (64, 64, 32, "444")]


def _jpeg_frame(dev, H, W, seed):
    """Noise over the top half, flat and gradient panels below."""
    rng = np.random.default_rng(seed)
    f = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
    f[H // 2:, : W // 2] = (200, 30, 90)
    f[H // 2:, W // 2:] = np.linspace(0, 255, W - W // 2,
                                      dtype=np.uint8)[None, :, None]
    return torch.as_tensor(f, device=dev)


def _qtables(dev, qm, qp):
    t = [jtab.scale_qtable(b, q) for q in (qm, qp)
         for b in (jtab.STD_LUMA_QUANT, jtab.STD_CHROMA_QUANT)]
    return torch.as_tensor(np.stack(t).astype(np.float32), device=dev)


def _jpeg_stage(dev, H, W, sh, sub, seed=0, q=(60, 90)):
    S = H // sh
    frame = _jpeg_frame(dev, H, W, seed)
    tab = torch.as_tensor(np.arange(S) % 2, dtype=torch.int32, device=dev)
    qt = _qtables(dev, *q)
    planes = JPL.jpeg_forward_plain(frame, torch.zeros_like(frame), tab, qt,
                                    sub)
    scan = JE.scan_maps(JE.scan_layout(sh // 8, W // 8, sub), dev)
    return S, frame, tab, qt, planes, scan


@pytest.mark.parametrize("geom", JPEG_GEOMS)
@pytest.mark.parametrize("q", [(10, 100), (60, 90), "ulp"])
def test_jpeg_forward(dev, geom, q):
    H, W, sh, sub = geom
    S = H // sh
    frame = _jpeg_frame(dev, H, W, 1)
    tab = torch.as_tensor(np.arange(S) % 2, dtype=torch.int32, device=dev)
    qt = torch.full((4, 64), 1 / 16, device=dev) if q == "ulp" \
        else _qtables(dev, *q)
    pk, pp = torch.zeros_like(frame), torch.zeros_like(frame)
    _same(list(JPL.jpeg_forward(frame, pk, tab, qt, sub)) + [pk],
          list(JPL.jpeg_forward_plain(frame, pp, tab, qt, sub)) + [pp])


@pytest.mark.parametrize("geom", JPEG_GEOMS)
def test_jpeg_events(dev, geom):
    H, W, sh, sub = geom
    S, _, _, _, planes, scan = _jpeg_stage(dev, H, W, sh, sub, q=(100, 100))
    # past the category caps: AC magnitudes >= 1024, DC steps >= 2048
    y = planes[0].clone()
    y[0, 5], y[1, 9] = 1500, -1100
    y[:8, 0] = torch.tensor([1024, -1024] * 4, dtype=torch.int16)
    _same(JE.jpeg_events(y, *planes[1:], scan, S),
          JE.jpeg_events_plain(y, *planes[1:], scan, S))


@pytest.mark.parametrize("geom", JPEG_GEOMS)
def test_jpeg_pack(dev, geom):
    H, W, sh, sub = geom
    S, _, _, _, planes, scan = _jpeg_stage(dev, H, W, sh, sub)
    ev = JE.jpeg_events_plain(*planes, scan, S)
    m = scan.shape[1]
    for e_cap, w_cap, out_cap in ((m * 64, sh * W // 2, 1 << 16),
                                  (m * 64, 16, 1 << 16),
                                  (100, sh * W // 2, 64)):
        args = (*ev, e_cap, w_cap, out_cap)
        _same(JPP.jpeg_pack(*args), JPP.jpeg_pack_plain(*args))


@pytest.mark.parametrize("geom", JPEG_GEOMS)
def test_row_damage_probe_at_stripes(dev, geom):
    """K6 at the JPEG step's granularity: one flag per stripe."""
    H, W, sh, _ = geom
    f0 = _jpeg_frame(dev, H, W, 2)
    f1 = f0.clone()
    f1[-1, -1, 2] ^= 1
    for frame in (f0, f1, 255 - f0):
        _same([HP.row_damage_probe(frame, f0, H // sh)],
              [HP.row_damage_probe_plain(frame, f0, H // sh)])


def test_jpeg_session_on_the_card(dev):
    """The session's step on the kernels equals it on the plain versions
    over a damaged, an idle and a paint-over frame."""
    from selkies_tpu_torch.engine.encoder import JpegEncoderSession
    from selkies_tpu_torch.engine.types import CaptureSettings
    s = CaptureSettings(capture_width=96, capture_height=60,
                        stripe_height=16, paint_over_delay_frames=1)
    kern, plain = JpegEncoderSession(s), JpegEncoderSession(s)
    plain._ops = JPP.PLAIN_OPS
    plain._rebuild_steps()
    f0 = _jpeg_frame(dev, 64, 96, 3)
    f1 = f0.clone()
    f1[:8, :16] = 255 - f1[:8, :16]
    for frame in (f0, f1, f1, f1):
        a = kern.finalize(kern.encode(frame))
        b = plain.finalize(plain.encode(frame))
        assert a == b
        _same([kern._prev, kern._age], [plain._prev, plain._age])


# ------------------------------------------------- the engine loop: K10-K12

#: (height, width): the 1080p capture and the grid, odd sizes whose byte
#: counts are not multiples of 4 (the kernels' ragged tails), widths
#: whose rows (3W bytes) are not multiples of 16 with H <= 96 (the block's
#: bounce period at its floor of 1), so K10's rows start off 16-byte
#: boundaries in every channel phase, and rows that are multiples of 16
#: bytes (K10's aligned path) with a height that is not a multiple of its
#: 8 rows a block, narrower than the block's columns or ending inside them
FRAME_GEOMS = [(1080, 1920), (1088, 1920), (37, 53), (5, 7), (96, 1366),
               (90, 250), (100, 208), (45, 16)]


@pytest.mark.parametrize("geom", FRAME_GEOMS)
@pytest.mark.parametrize("tick", [0, 95, 306783379, 429496730, 2**31 - 1])
def test_synthetic_frame(dev, geom, tick):
    from selkies_tpu_torch.ops import frames as FR
    H, W = geom
    _same([FR.synthetic_frame(H, W, tick, dev)],
          [FR.synthetic_frame_plain(H, W, tick, dev)])


@pytest.mark.parametrize("src,dst", [((1080, 1920), (1088, 1920)),
                                     ((37, 53), (48, 64)), ((5, 7), (5, 9)),
                                     ((64, 64), (64, 64))])
def test_pad_frame(dev, src, dst):
    from selkies_tpu_torch.ops import frames as FR
    f = _jpeg_frame(dev, *src, 4)
    _same([FR.pad_frame(f, *dst)], [FR.pad_frame_plain(f, *dst)])
    # an unaligned view of a contiguous source
    g = torch.empty(f.numel() + 1, dtype=torch.uint8, device=dev)[1:]
    g = g.view(f.shape).copy_(f)
    _same([FR.pad_frame(g, *dst)], [FR.pad_frame_plain(f, *dst)])


def _wm_inputs(dev, wh, ww, seed):
    rng = np.random.default_rng(seed)
    rgba = rng.integers(0, 256, (wh, ww, 4), dtype=np.uint8)
    rgb = torch.as_tensor(rgba[..., :3].astype(np.float32), device=dev)
    a = torch.as_tensor(rgba[..., 3:4].astype(np.float32) / 255.0,
                        device=dev)
    return rgb, a


@pytest.mark.parametrize("case", [
    (1088, 1920, 270, 480, 794, 1424),       # the largest, location 6
    (1088, 1920, 270, 480, 2000, -5),        # clamped anchors
    (37, 53, 9, 13, 3, 40), (37, 53, 37, 1, -1, 0)])
def test_watermark_blend(dev, case):
    from selkies_tpu_torch.ops import frames as FR
    H, W, wh, ww, y0, x0 = case
    f = _jpeg_frame(dev, H, W, 5)
    rgb, a = _wm_inputs(dev, wh, ww, H + wh)
    k, p = f.clone(), f.clone()
    FR.watermark_blend(k, rgb, a, y0, x0)
    FR.watermark_blend_plain(p, rgb, a, y0, x0)
    _same([k], [p])


def test_watermark_blend_on_every_byte_triple(dev):
    """All 2^24 (region, watermark, alpha) bytes: the kernel's float
    order against the plain version's."""
    from selkies_tpu_torch.ops import frames as FR
    q = -(-65536 // 3)
    pairs = np.arange(3 * q) % 65536
    region = torch.as_tensor((pairs >> 8).astype(np.uint8).reshape(q, 3),
                             device=dev).expand(256, q, 3).contiguous()
    rgb = torch.as_tensor((pairs & 255).astype(np.float32).reshape(q, 3),
                          device=dev).expand(256, q, 3).contiguous()
    # alpha formed on the host in float32, as the watermark forms it (a
    # division on the card may multiply by the reciprocal instead)
    a = torch.as_tensor(np.arange(256, dtype=np.float32) / 255.0,
                        device=dev)[:, None, None].expand(256, q, 1)
    a = a.contiguous()
    k, p = region.clone(), region.clone()
    FR.watermark_blend(k, rgb, a, 0, 0)
    FR.watermark_blend_plain(p, rgb, a, 0, 0)
    _same([k], [p])


@pytest.mark.parametrize("mode", ["jpeg", "h264"])
def test_capture_depth_two_equals_depth_one_on_the_card(dev, mode,
                                                         monkeypatch):
    """ScreenCapture on the card: the pipelined loop's chunks per frame
    equal the serial loop's, with a watermark and the padder running."""
    import time

    from selkies_tpu_torch.engine import CaptureSettings, ScreenCapture
    from selkies_tpu_torch.engine import encoder as T_enc
    from selkies_tpu_torch.engine import h264_encoder as T_h264
    from selkies_tpu_torch.engine.watermark import Watermark

    rgba = np.random.default_rng(8).integers(0, 256, (24, 40, 4),
                                             dtype=np.uint8)

    def from_array(settings, w, h, device):
        # the array watermark, as chip_smoke builds it (no PIL there)
        return Watermark.from_rgba(rgba, settings.watermark_location, w, h,
                                   device)
    for mod in (T_enc, T_h264):
        monkeypatch.setattr(mod, "maybe_load", from_array)
    runs = []
    for depth in (1, 2):
        got = []
        s = CaptureSettings(capture_width=256, capture_height=120,
                            stripe_height=64, target_fps=240.0,
                            output_mode=mode, use_cbr=False,
                            keyframe_interval_s=0,
                            h264_content_adaptive=False, pipeline_depth=depth,
                            watermark_path="seeded", watermark_location=6)
        cap = ScreenCapture("synthetic")
        cap.start_capture(got.append, s)
        deadline = time.monotonic() + 60
        while (not any(c.frame_id >= 12 for c in got)
               and time.monotonic() < deadline):
            time.sleep(0.01)
        cap.stop_capture()
        runs.append({fid: [c for c in got if c.frame_id == fid]
                     for fid in range(12)})
    assert runs[0] == runs[1] and all(runs[0].values())


# ------------------------------------------------------------ H.264 4:4:4
def _stage444(dev, H, W, sh, seed=0):
    """K13..K14 outputs of a geometry at 4:4:4 (through the plain
    versions): per-row qp, every other stripe sent."""
    S, rps, R = H // sh, sh // 16, H // 16
    f0, f1 = _frames(dev, H, W)
    planes = H4.csc444_damage_plain(f1, f0.clone(), S)[:3]
    qp = torch.full((R,), 26, dtype=torch.int32, device=dev)
    qp[::2] = 44
    send = torch.ones((S,), dtype=torch.int32, device=dev)
    send[1::2] = 0
    ref = [torch.zeros_like(p) for p in planes]
    i_out = H4.mb_encode_i444_plain(*planes, qp, send, rps, *ref)
    return S, rps, planes, qp, send, ref, i_out


@pytest.mark.parametrize("geom", GEOMS)
def test_csc444_damage(dev, geom):
    H, W, sh = geom
    f0, f1 = _frames(dev, H, W)
    pk, pp = f0.clone(), f0.clone()
    _same(list(H4.csc444_damage(f1, pk, H // sh)) + [pk],
          list(H4.csc444_damage_plain(f1, pp, H // sh)) + [pp])


def test_csc444_on_every_byte_triple(dev):
    """All 2^24 RGB triples as one 4096x4096 frame: K13's float order
    equals the plain version's (the reference's) on every one."""
    v = torch.arange(1 << 24, dtype=torch.int64, device=dev)
    rgb = torch.stack([(v >> 16) & 255, (v >> 8) & 255, v & 255], -1).to(
        torch.uint8).reshape(4096, 4096, 3)
    pk, pp = torch.zeros_like(rgb), torch.zeros_like(rgb)
    _same(list(H4.csc444_damage(rgb, pk, 16)) + [pk],
          list(H4.csc444_damage_plain(rgb, pp, 16)) + [pp])


def _p444_call(p_fn, sel, planes, qp, send_rows, ref, cands, win):
    if cands is None:
        return p_fn(*planes, qp, send_rows, *ref, None, *ref)
    *pred, mv = sel(planes[0], *ref, qp, cands, win)
    return p_fn(*planes, qp, send_rows, *pred, mv, *ref)


@pytest.mark.parametrize("geom", GEOMS)
@pytest.mark.parametrize("mode", ["i", "p0", "p"])
def test_mb_encode444(dev, geom, mode):
    S, rps, planes, qp, send, ref, _ = _stage444(dev, *geom)
    if mode == "i":
        base = [torch.zeros_like(p) for p in planes]
    else:
        base = [p.clone() for p in ref]
        planes = tuple(255 - p for p in planes) if mode == "p0" else tuple(
            torch.roll(p, (-2, 1), (0, 1)) for p in planes)
    kref = [b.clone() for b in base]
    pref = [b.clone() for b in base]
    if mode == "i":
        ko = H4.mb_encode_i444(*planes, qp, send, rps, *kref)
        po = H4.mb_encode_i444_plain(*planes, qp, send, rps, *pref)
    else:
        cands = None if mode == "p0" else TE.scroll_candidates(4, 2)
        send_rows = send.repeat_interleave(rps)
        ko = _p444_call(H4.mb_encode_p444, TE.motion_select444, planes, qp,
                        send_rows, kref, cands, 16 * rps)
        po = _p444_call(H4.mb_encode_p444_plain, TE.motion_select444_plain,
                        planes, qp, send_rows, pref, cands, 16 * rps)
    _same(list(ko) + kref, list(po) + pref)


@pytest.mark.parametrize("geom", GEOMS)
@pytest.mark.parametrize("cands", ["small", "default"])
def test_motion_select444(dev, geom, cands):
    H, W, sh = geom
    cands = TE.scroll_candidates(4, 2) if cands == "small" \
        else TE.scroll_candidates()
    S, rps, planes, qp, send, ref, _ = _stage444(dev, *geom)
    ref = [p.clone() for p in planes]
    cur = torch.roll(planes[0], -3, 0)
    cur[:, W // 2:] = torch.roll(planes[0], -2, 1)[:, W // 2:]
    _same(TE.motion_select444(cur, *ref, qp, cands, sh),
          TE.motion_select444_plain(cur, *ref, qp, cands, sh))


@pytest.mark.parametrize("geom", GEOMS)
def test_cavlc444_and_pack(dev, geom):
    H, W, sh = geom
    S, rps, planes, qp, send, ref, i_out = _stage444(dev, *geom)
    R, M = H // 16, W // 16
    p_planes = tuple(torch.roll(p, (-2, 1), (0, 1)) for p in planes)
    p_out = H4.mb_encode_p444_plain(*p_planes, qp, torch.ones(
        (R,), dtype=torch.int32, device=dev), *ref, None, *ref)
    for intra, (lv, cbp, hp, hn) in ((True, i_out), (False, p_out)):
        ev = H4.cavlc_events444(lv, cbp, intra)
        _same(ev, H4.cavlc_events444_plain(lv, cbp, intra))
        fn = hcodec.slice_header_events if intra \
            else hcodec.p_slice_header_events
        pay, nb = fn(M, rps)
        rhp = torch.as_tensor(np.tile(pay.astype(np.int32), (S, 1)),
                              device=dev)
        rhn = torch.as_tensor(np.tile(nb, (S, 1)), device=dev)
        rid = torch.arange(R, dtype=torch.int32, device=dev)
        for w_cap, out_cap in ((3072, 1 << 17), (16, 1 << 17), (3072, 64)):
            args = (hp, hn, *ev, rhp, rhn, rid, qp, intra, 10 ** 6, w_cap,
                    out_cap)
            _same(HP.pack_stream(*args), HP.pack_stream_plain(*args))


@pytest.mark.parametrize("seed", range(3))
def test_chain444_on_noise_at_random_qp(dev, seed):
    """Noise frames at per-row qp drawn from 0..51, I then P with
    motion: every 4:4:4 stage's kernel output equals the plain
    version's."""
    H, W, sh = 64, 96, 32
    S, rps, R, M = H // sh, sh // 16, H // 16, W // 16
    rng = np.random.default_rng(200 + seed)
    f0, f1 = (torch.as_tensor(rng.integers(0, 256, (H, W, 3),
                                           dtype=np.uint8), device=dev)
              for _ in range(2))
    qp = torch.as_tensor(rng.integers(0, 52, R).astype(np.int32), device=dev)
    send = torch.ones((S,), dtype=torch.int32, device=dev)
    ref = [torch.zeros((H, W), dtype=torch.uint8, device=dev)
           for _ in range(3)]
    cands = TE.scroll_candidates(4, 2)
    for intra, frame in ((True, f0), (False, f1)):
        planes = H4.csc444_damage_plain(frame, f0.clone(), S)[:3]
        kref = [r.clone() for r in ref]
        if intra:
            ko = H4.mb_encode_i444(*planes, qp, send, rps, *kref)
            po = H4.mb_encode_i444_plain(*planes, qp, send, rps, *ref)
        else:
            send_rows = send.repeat_interleave(rps)
            ko = _p444_call(H4.mb_encode_p444, TE.motion_select444, planes,
                            qp, send_rows, kref, cands, sh)
            po = _p444_call(H4.mb_encode_p444_plain,
                            TE.motion_select444_plain, planes, qp, send_rows,
                            ref, cands, sh)
        _same(list(ko) + kref, list(po) + ref)
        ev = H4.cavlc_events444(ko[0], ko[1], intra)
        _same(ev, H4.cavlc_events444_plain(ko[0], ko[1], intra))


def test_444_frame_entry_points_run_on_the_card(dev):
    H, W = 64, 80
    R, M = H // 16, W // 16
    rng = np.random.default_rng(12)
    y, u, v = (rng.integers(0, 256, (H, W)).astype(np.int32)
               for _ in range(3))
    qp = np.array([8, 30, 51, 19], np.int32)
    e_cap, w_cap = 9 + M * H4.SLOTS_MB_444 + 2, 3072
    hdr = hcodec.slice_header_events(M, R)
    p_hdr = hcodec.p_slice_header_events(M, R)
    outs = {}
    for d in (None, "cpu"):
        i_out, rec = H4.h264_encode_yuv444(y, u, v, qp, *hdr, e_cap, w_cap,
                                           want_recon=True, device=d)
        p_out, _ = H4.h264_encode_p_yuv444(
            np.roll(y, 3, 0), u, v, *rec, qp, *p_hdr, np.ones(R, np.int32),
            e_cap, w_cap, candidates=TE.scroll_candidates(4, 2), device=d)
        outs[d] = (i_out, p_out)
    assert outs[None][0].words.device.type == "cuda"
    for k, p in zip(outs[None], outs["cpu"]):
        _same([k.words, k.total_bits], [p.words, p.total_bits])
        assert bool(k.overflow) == bool(p.overflow)


@pytest.mark.parametrize("partial", [False, True])
def test_444_session_on_the_card(dev, partial):
    """The fullcolor session on the card against the same session on
    its plain versions (on the card), through a scroll and a typed band:
    equal chunks and state."""
    from selkies_tpu_torch.engine.h264_encoder import H264EncoderSession
    from selkies_tpu_torch.engine.types import CaptureSettings
    kw = dict(capture_width=128, capture_height=64, stripe_height=32,
              output_mode="h264", fullcolor=True, h264_motion_vrange=4,
              h264_motion_hrange=2, h264_partial_encode=partial,
              paint_over_delay_frames=2)
    kern = H264EncoderSession(CaptureSettings(**kw))
    plain = H264EncoderSession(CaptureSettings(**kw))
    plain._ops = H4.PLAIN_OPS_444
    plain._rebuild_steps()
    f0, _ = _frames(dev, 64, 128)
    typed = torch.roll(f0, 5, 0)
    typed[40:48, 8:40] = 20
    for frame in (f0, torch.roll(f0, 5, 0), typed, typed, typed, f0):
        a = kern.finalize(kern.encode(frame))
        b = plain.finalize(plain.encode(frame))
        assert [(c.stripe_y, c.is_idr, c.payload) for c in a] \
            == [(c.stripe_y, c.is_idr, c.payload) for c in b]
        for k in ("_ref_y", "_ref_u", "_ref_v", "_prev", "_sent", "_fnum"):
            assert torch.equal(getattr(kern, k), getattr(plain, k)), k


# ------------------------------------------------ multi-seat entries (K4,
# K9, K10 with a seat axis) and the multi-seat encoders
def _seat_pack_inputs(dev, rng, n_seats, rows, mb_w, intra, tables=HP):
    """K4 inputs for ``n_seats`` seats of ``rows`` MB rows: random slot
    events, with every slot of seat 0's last row carrying 16 bits, so
    that row overflows a small w_cap and spills into the words after it
    (never into seat 1's). P rows leave header slot 0 empty: K4 puts the
    skip run there (K2-P writes no bits into it). ``tables`` gives the
    block slots per MB: ``HP`` 4:2:0's, ``H4`` 4:4:4's."""
    R, sb = n_seats * rows, tables.SB_I if intra else tables.SB_P
    hdr_nb = rng.integers(0, 8, (R, mb_w, HP.HDR_SLOTS)).astype(np.int32)
    if not intra:
        hdr_nb[..., 0] = 0
    ev_nb = rng.integers(0, 3, (R, mb_w, sb)).astype(np.uint8)
    ev_nb[rows - 1] = 16
    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    hdr_pay = t(rng.integers(0, 256, hdr_nb.shape).astype(np.int32)) \
        & ((1 << t(hdr_nb)) - 1)
    pay = t(rng.integers(0, 1 << 16, ev_nb.shape).astype(np.int32)) \
        & ((1 << t(ev_nb).to(torch.int32)) - 1)
    return (hdr_pay, t(hdr_nb), pay, t(ev_nb),
            t(rng.integers(0, 64, (R, 2)).astype(np.int32)),
            t(np.full((R, 2), 6, np.int32)),
            t(rng.integers(0, 16, (R,)).astype(np.int32)),
            t(rng.integers(10, 40, (R,)).astype(np.int32)))


@pytest.mark.parametrize("n_seats", [1, 2, 3])
@pytest.mark.parametrize("intra", [True, False])
def test_pack_stream_seats(dev, n_seats, intra):
    rows, mb_w = 3, 4
    args = _seat_pack_inputs(dev, np.random.default_rng(n_seats), n_seats,
                             rows, mb_w, intra)
    for e_cap, w_cap, out_cap in ((10**6, 4096, 1 << 16),
                                  (10**6, 256, 1 << 16),
                                  (500, 4096, 64)):
        a = (*args, intra, e_cap, w_cap, out_cap)
        k = HP.pack_stream_seats(*a, n_seats=n_seats)
        p = HP.pack_stream_seats_plain(*a, n_seats=n_seats)
        _same(k, p)
        assert k.data.shape == (n_seats, out_cap)
    # the single-frame entry is the one-seat case
    a = (*(x[:rows] for x in args), intra, 10**6, 256, 1 << 16)
    k1, p1 = HP.pack_stream(*a), HP.pack_stream_seats_plain(*a, n_seats=1)
    _same([k1.words, k1.total_bits, k1.data, k1.byte_lens, k1.flags],
          [p1.words, p1.total_bits, p1.data[0], p1.byte_lens, p1.flags[0]])


@pytest.mark.parametrize("n_seats", [1, 2, 4])
@pytest.mark.parametrize("intra", [True, False])
def test_pack_stream_seats_at_444_slot_counts(dev, n_seats, intra):
    """K4's seat entry at 4:4:4's 1740 (I) / 1728 (P) block slots per MB,
    the layout of the split frame's 4:4:4 shards."""
    rows, mb_w = 2, 3
    args = _seat_pack_inputs(dev, np.random.default_rng(40 + n_seats),
                             n_seats, rows, mb_w, intra, H4)
    for e_cap, w_cap, out_cap in ((10**6, 8192, 1 << 17),
                                  (10**6, 512, 1 << 17),
                                  (900, 8192, 128)):
        a = (*args, intra, e_cap, w_cap, out_cap)
        k = HP.pack_stream_seats(*a, n_seats=n_seats)
        _same(k, HP.pack_stream_seats_plain(*a, n_seats=n_seats))
        assert k.data.shape == (n_seats, out_cap)


@pytest.mark.parametrize("geom", JPEG_GEOMS)
@pytest.mark.parametrize("n_seats", [1, 3])
def test_jpeg_pack_seats(dev, geom, n_seats):
    H, W, sh, sub = geom
    evs = []
    for k in range(n_seats):
        S, _, _, _, planes, scan = _jpeg_stage(dev, H, W, sh, sub,
                                               q=(10 + 40 * k, 90))
        evs.append(JE.jpeg_events_plain(*planes, scan, S))
    ev = [torch.cat([e[i] for e in evs]) for i in range(2)]
    m = scan.shape[1]
    for e_cap, w_cap, out_cap in ((m * 64, sh * W // 2, 1 << 16),
                                  (m * 64, 16, 1 << 16),
                                  (100, sh * W // 2, 64)):
        args = (*ev, e_cap, w_cap, out_cap)
        k = JPP.jpeg_pack_seats(*args, n_seats=n_seats)
        _same(k, JPP.jpeg_pack_seats_plain(*args, n_seats=n_seats))
        assert k.flags.shape == (n_seats, 2)


@pytest.mark.parametrize("geom", FRAME_GEOMS)
@pytest.mark.parametrize("n_seats", [1, 3, 4])
@pytest.mark.parametrize("tick", [0, 95, 2**31 - 100])
def test_synthetic_frames(dev, geom, n_seats, tick):
    """K10's seat entry: seat k at phase k * 37 + tick, wrapping int32; at
    an odd frame size the later seats start off 16-byte boundaries."""
    from selkies_tpu_torch.ops import frames as FR
    H, W = geom
    _same([FR.synthetic_frames(H, W, n_seats, tick, dev)],
          [FR.synthetic_frames_plain(H, W, n_seats, tick, dev)])


def _seat_script(dev, n, H, W, noisy_seat):
    from selkies_tpu_torch.ops import frames as FR
    base = FR.synthetic_frames(H, W, n, 0, dev)
    rng = np.random.default_rng(11)
    noise = torch.as_tensor(rng.integers(0, 256, (H, W, 3), dtype=np.uint8),
                            device=dev)
    t1 = base.clone()
    t1[1, 20:28, 8:40] = 20
    t1[2] = FR.synthetic_frame(H, W, 77, dev)
    t1[3] = torch.roll(base[3], 4, 0)
    t2 = t1.clone()
    t2[noisy_seat] = noise
    t3 = t2.clone()
    t3[noisy_seat] = base[noisy_seat]
    return [(base, True), (t1, False), (t1, False), (t2, False),
            (t3, False), (t3, True)]


@pytest.mark.parametrize("mode", ["jpeg", "h264"])
def test_multiseat_encoder_on_the_card(dev, mode):
    """Each multi-seat encoder on the kernels equals it on the plain
    versions (on the card) through damaged, idle, paint-over and forced
    ticks and an overflow of one seat's buffer: equal chunks and state."""
    from selkies_tpu_torch.engine.types import CaptureSettings
    from selkies_tpu_torch.parallel import (MultiSeatEncoder,
                                            MultiSeatH264Encoder)
    n, H, W = 4, 64, 128
    kw = dict(capture_width=W, capture_height=H, stripe_height=32,
              paint_over_delay_frames=2)
    if mode == "h264":
        kw.update(output_mode="h264", h264_motion_vrange=4,
                  h264_motion_hrange=2)
    cls = MultiSeatH264Encoder if mode == "h264" else MultiSeatEncoder
    plain_ops = HP.SEAT_PLAIN_OPS if mode == "h264" else JPP.SEAT_PLAIN_OPS
    encs = [cls(CaptureSettings(**kw), n) for _ in range(2)]
    encs[1]._ops = plain_ops
    for e in encs:
        e._out_cap = 3000
        e._rebuild_steps()
    for frames, force in _seat_script(dev, n, H, W, noisy_seat=2):
        outs = []
        for e in encs:
            out = e.encode(frames, force=force) if mode == "h264" \
                else e.encode(frames)
            outs.append([[(c.stripe_y, c.is_idr, c.payload) for c in s]
                         for s in e.finalize(out, force_all=force)])
        assert outs[0] == outs[1]
        for key in encs[0].STATE_KEYS.arrays:
            assert torch.equal(getattr(encs[0], key),
                               getattr(encs[1], key)), key
        assert (encs[0]._force_after_drop == encs[1]._force_after_drop).all()
    assert encs[0]._cap_gen == 1, "the noise seat did not overflow"


# ------------------------------------------- ROI QP: K17, K18, K2-P's plane
def _roi_frames(dev, H, W, seed):
    """A random frame and a copy with random MBs, single bytes and the
    last MB changed."""
    rng = np.random.default_rng(seed)
    prev = torch.as_tensor(rng.integers(0, 256, (H, W, 3), dtype=np.uint8),
                           device=dev)
    f = prev.clone()
    R, M = H // 16, W // 16
    for r, m in zip(*np.nonzero(rng.random((R, M)) < 0.3)):
        f[16 * r + 3, 16 * m + 7, 1] ^= 4
    f[-1, -1, 2] ^= 1
    f[0, 0, 0] ^= 1
    return f, prev


@pytest.mark.parametrize("bias", [0, 4, 12])
def test_roi_qp_plane_at_1080p(dev, bias):
    H, W = 1088, 1920
    f, prev = _roi_frames(dev, H, W, bias)
    rng = np.random.default_rng(bias + 1)
    qp = torch.as_tensor(rng.integers(0, 52, H // 16).astype(np.int32),
                         device=dev)
    _same([HP.roi_qp_plane(f, prev, qp, bias)],
          [HP.roi_qp_plane_plain(f, prev, qp, bias)])
    # a band 16 rows into the frame, and a view 3 bytes in (byte loop)
    _same([HP.roi_qp_plane(f[16:80], prev[16:80], qp[:4], bias)],
          [HP.roi_qp_plane_plain(f[16:80], prev[16:80], qp[:4], bias)])
    a = f.reshape(-1)[3:3 + 64 * W * 3].reshape(64, W, 3)
    b = prev.reshape(-1)[3:3 + 64 * W * 3].reshape(64, W, 3)
    _same([HP.roi_qp_plane(a, b, qp[:4], bias)],
          [HP.roi_qp_plane_plain(a, b, qp[:4], bias)])


def _qp_planes(dev, rng, R, M):
    qp = torch.as_tensor(rng.integers(0, 52, R).astype(np.int32), device=dev)
    qp_mb = torch.as_tensor(rng.integers(0, 52, (R, M)).astype(np.int32),
                            device=dev)
    return qp, qp_mb


@pytest.mark.parametrize("motion", [False, True])
@pytest.mark.parametrize("W", [1920, 208])
def test_mb_encode_p_with_qp_mb_at_1080p(dev, motion, W):
    """K2-P's per-MB-QP entry on noise against a moved reference, QPs
    0..51 per MB (the first block of each row holds 0, 51, 0, 51), half
    the rows sent; then K18 on its headers. Also 1088 rows of 13 MBs."""
    H = 1088
    R, M = H // 16, W // 16
    rng = np.random.default_rng(7 + motion)
    f0, f1 = (torch.as_tensor(rng.integers(0, 256, (H, W, 3),
                                           dtype=np.uint8), device=dev)
              for _ in range(2))
    f1[:, : W // 2] = torch.roll(f0, 3, 0)[:, : W // 2]
    ref = list(HP.csc420_damage_plain(f0, f0.clone(), 17)[:3])
    planes = HP.csc420_damage_plain(f1, f0.clone(), 17)[:3]
    qp, qp_mb = _qp_planes(dev, rng, R, M)
    qp_mb[:, :4] = torch.tensor([0, 51, 0, 51], dtype=torch.int32,
                                device=dev)
    send = (torch.arange(R, device=dev) % 2).to(torch.int32)
    if motion:
        *pred, mv = TE.motion_select_plain(planes[0], *ref, qp,
                                           TE.scroll_candidates(24, 8), 64)
    else:
        pred, mv = ref, None
    outs = []
    for fn in (HP.mb_encode_p, HP.mb_encode_p_plain):
        r = [p.clone() for p in ref]
        pr = [p.clone() for p in pred] if motion else r
        outs.append(list(fn(*planes, qp, send, *pr, mv, *r, qp_mb=qp_mb))
                    + r)
    _same(outs[0], outs[1])
    hp, hn = outs[0][2], outs[0][3]
    kd = HP.mb_qp_delta(hp.clone(), hn.clone(), qp_mb, qp)
    pd = HP.mb_qp_delta_plain(hp.clone(), hn.clone(), qp_mb, qp)
    _same(kd, pd)


@pytest.mark.parametrize("M", [1, 31, 32, 33, 120])
def test_mb_qp_delta(dev, M):
    """Random gates (motion-only MBs included) and QPs 0..51 on rows of
    1..120 MBs: chunks of 32 and the carry between them."""
    R = 68
    rng = np.random.default_rng(M)
    hp = torch.as_tensor(rng.integers(0, 99, (R, M, 6)).astype(np.int32),
                         device=dev)
    hn = torch.as_tensor(rng.integers(0, 9, (R, M, 6)).astype(np.int32),
                         device=dev)
    hn[..., 5] = torch.as_tensor((rng.random((R, M)) < 0.4).astype(np.int32),
                                 device=dev)
    hp[..., 5] = hn[..., 5]
    qp, qp_mb = _qp_planes(dev, rng, R, M)
    _same(HP.mb_qp_delta(hp.clone(), hn.clone(), qp_mb, qp),
          HP.mb_qp_delta_plain(hp.clone(), hn.clone(), qp_mb, qp))


@pytest.mark.parametrize("bias", [4, 12])
def test_roi_session_on_the_card(dev, bias):
    """The ROI QP band session on the card against the same session on
    its plain versions (on the card): scrolls, typing, idle and
    paint-over bands at qp 12 (so bias 12 meets the lower clip)."""
    from selkies_tpu_torch.engine.h264_encoder import H264EncoderSession
    from selkies_tpu_torch.engine.types import CaptureSettings
    from selkies_tpu_torch.ops import _cuda
    kw = dict(capture_width=128, capture_height=64, stripe_height=32,
              output_mode="h264", h264_motion_vrange=4, h264_motion_hrange=2,
              h264_partial_encode=True, h264_roi_qp=True,
              h264_roi_qp_bias=bias, paint_over_delay_frames=2)
    kern = H264EncoderSession(CaptureSettings(**kw))
    plain = H264EncoderSession(CaptureSettings(**kw))
    plain._ops = HP.PLAIN_OPS
    plain._rebuild_steps()
    for sess in (kern, plain):
        sess.set_qp(12)
    f0, _ = _frames(dev, 64, 128)
    typed = torch.roll(f0, 5, 0)
    typed[40:48, 8:40] = 20
    before = dict(_cuda.LAUNCHES)
    n_band = 0
    for frame in (f0, torch.roll(f0, 5, 0), typed, typed, typed, typed, f0):
        out = kern.encode(frame)
        n_band += out.get("band") is not None
        a = kern.finalize(out)
        b = plain.finalize(plain.encode(frame))
        assert [(c.stripe_y, c.is_idr, c.payload) for c in a] \
            == [(c.stripe_y, c.is_idr, c.payload) for c in b]
        for k in ("_ref_y", "_ref_u", "_ref_v", "_prev", "_sent", "_fnum"):
            assert torch.equal(getattr(kern, k), getattr(plain, k)), k
    n = {k: _cuda.LAUNCHES[k] - before[k] for k in
         ("roi_qp_plane", "mb_qp_delta", "mb_encode_p_qp", "mb_encode_p")}
    assert n_band > 0 and n == {"roi_qp_plane": n_band,
                                "mb_qp_delta": n_band,
                                "mb_encode_p_qp": n_band, "mb_encode_p": 0}


# ------------------------------------------ split frame (K19, K20 and the
# sharded frame entries and session)
@pytest.mark.parametrize("shape", [(64, 24), (64, 40), (48, 8), (32, 7),
                                   (1088, 960), (1088, 1920)])
@pytest.mark.parametrize("band,halo", [(16, 3), (16, 24), (8, 13), (32, 0)])
def test_halo_bands(dev, shape, band, halo):
    """K20 at widths that are and are not multiples of 16, 8 and 4, with
    halos that reach past both frame edges (24 rows around a 16-row
    band)."""
    H, W = shape
    if H % band:
        pytest.skip("band does not tile the plane")
    plane = torch.as_tensor(np.random.default_rng(W + band).integers(
        0, 256, (H, W), dtype=np.uint8), device=dev)
    from selkies_tpu_torch.parallel import stripes as ST
    _same([ST.halo_bands(plane, band, halo)],
          [ST.halo_bands_plain(plane, band, halo)])


def _halo_case(dev, H, W, full, n, seed):
    rng = np.random.default_rng(seed)
    cdiv = 1 if full else 2
    ref = [torch.as_tensor(rng.integers(0, 256, s, dtype=np.uint8),
                           device=dev)
           for s in ((H, W), (H // cdiv, W // cdiv), (H // cdiv, W // cdiv))]
    cur = torch.roll(ref[0], -3, 0)
    cur[:, W // 2:] = torch.roll(ref[0], 5, 0)[:, W // 2:]
    qp = torch.as_tensor(rng.integers(8, 48, H // 16).astype(np.int32),
                         device=dev)
    return cur, ref, qp


@pytest.mark.parametrize("full", [False, True])
@pytest.mark.parametrize("geom", [(64, 48, 4, 64), (64, 48, 4, 32),
                                  (128, 64, 2, 128), (128, 64, 4, 64),
                                  (96, 32, 3, 96)])
@pytest.mark.parametrize("cands", ["odd", "default"])
def test_motion_select_halo(dev, full, geom, cands):
    """K19 (4:2:0 and 4:4:4) against its plain version and against K5 on
    the whole frame, (H, W, shards, window rows): whole-frame windows over
    2, 3 and 4 shards and windows of two shards each; odd and negative
    vertical candidates, scrolls both ways across the seams."""
    from selkies_tpu_torch.parallel import stripes as ST
    H, W, n, win = geom
    cands = ((0, 0), (3, 0), (-3, 0), (-5, 1), (1, -1), (-1, 2)) \
        if cands == "odd" else TE.scroll_candidates()
    cur, ref, qp = _halo_case(dev, H, W, full, n, H + W + n)
    band = H // n
    vmax = max(abs(dy) for dy, _ in cands)
    halo_c = vmax if full else vmax // 2 + 1
    cband = band if full else band // 2
    bands = [ST.halo_bands(ref[0], band, vmax)] + [
        ST.halo_bands(p, cband, halo_c) for p in ref[1:]]
    if full:
        kern, plain = ST.motion_select_halo444, ST.motion_select_halo444_plain
        k5 = TE.motion_select444
    else:
        kern, plain = ST.motion_select_halo, ST.motion_select_halo_plain
        k5 = TE.motion_select
    got = kern(cur, *bands, qp, cands, win)
    _same(got, plain(cur, *bands, qp, cands, win))
    _same(got, k5(cur, *ref, qp, cands, win))


@pytest.mark.parametrize("full", [False, True])
def test_sharded_frames_on_the_card(dev, full, monkeypatch):
    """The sharded frame entries on the card (kernels) against their
    plain run on the card and the unsharded frame entries: I at 2 and 4
    shards, P with whole windows a shard, P across the halo, and 3 rows
    padded over 2 shards."""
    from selkies_tpu_torch.parallel import stripes as ST
    enc_i = H4.h264_encode_yuv444 if full else HP.h264_encode_yuv
    enc_p = H4.h264_encode_p_yuv444 if full else HP.h264_encode_p_yuv
    H, W = 128, 64
    cdiv = 1 if full else 2
    rng = np.random.default_rng(17)
    planes = [torch.as_tensor(rng.integers(0, 256, s, dtype=np.uint8),
                              device=dev)
              for s in ((H, W), (H // cdiv, W // cdiv),
                        (H // cdiv, W // cdiv))]
    R, M = H // 16, W // 16
    hdr = hcodec.slice_header_events(M, R)
    p_hdr = hcodec.p_slice_header_events(M, R)
    e_cap, w_cap = 10**6, 8192
    ref, rec = enc_i(*planes, 26, *hdr, e_cap, w_cap, want_recon=True)
    cur = [torch.roll(p, 3 if k == 0 or full else 1, 0)
           for k, p in enumerate(planes)]
    cands = TE.scroll_candidates(4, 2)
    for n in (2, 4):
        mesh = ST.stripe_mesh(R, devices=[dev] * n)
        out, rec_k = ST.h264_encode_sharded(*planes, 26, *hdr, e_cap, w_cap,
                                            mesh, fullcolor=full,
                                            want_recon=True)
        _same([out.words, out.total_bits, *rec_k],
              [ref.words, ref.total_bits, *rec])
        for sr in (2, R):
            want, want_rec = enc_p(*cur, *rec, 30, *p_hdr, 1, e_cap, w_cap,
                                   candidates=cands, stripe_rows=sr)
            got, got_rec = ST.h264_encode_p_sharded(
                *cur, *rec, 30, *p_hdr, 1, e_cap, w_cap, mesh,
                candidates=cands, stripe_rows=sr, fullcolor=full)
            with monkeypatch.context() as m:
                m.setattr(ST, "SHARD_OPS", ST.SHARD_PLAIN_OPS)
                pl, pl_rec = ST.h264_encode_p_sharded(
                    *cur, *rec, 30, *p_hdr, 1, e_cap, w_cap, mesh,
                    candidates=cands, stripe_rows=sr, fullcolor=full)
            _same([got.words, got.total_bits, *got_rec],
                  [want.words, want.total_bits, *want_rec])
            _same([got.words, got.total_bits, *got_rec],
                  [pl.words, pl.total_bits, *pl_rec])
    p3 = [p[:48 // cdiv if k else 48] for k, p in enumerate(planes)]
    hdr3 = hcodec.slice_header_events(M, 3)
    want = enc_i(*p3, 26, *hdr3, e_cap, w_cap)
    got = ST.h264_encode_sharded(*p3, 26, *hdr3, e_cap, w_cap,
                                 ST.stripe_mesh(4, [dev] * 2), fullcolor=full)
    _same([got.words, got.total_bits], [want.words, want.total_bits])


@pytest.mark.parametrize("full", [False, True])
def test_sharded_session_on_the_card(dev, full):
    """StripeShardedH264Session at 4 shards on the card against the same
    session on its plain versions and against H264EncoderSession, over
    an IDR, scrolls and typing, with one overflow episode."""
    from selkies_tpu_torch.engine.h264_encoder import (
        H264EncoderSession, StripeShardedH264Session)
    from selkies_tpu_torch.engine.types import CaptureSettings
    from selkies_tpu_torch.ops import _cuda
    kw = dict(capture_width=128, capture_height=128, stripe_height=32,
              output_mode="h264", h264_motion_vrange=4,
              h264_motion_hrange=2, fullcolor=full,
              paint_over_delay_frames=2)
    sh = StripeShardedH264Session(CaptureSettings(**kw, stripe_devices=4),
                                  devices=[dev] * 4)
    pl = StripeShardedH264Session(CaptureSettings(**kw, stripe_devices=4),
                                  devices=[dev] * 4)
    pl._ops = HP.SEAT_PLAIN_OPS if not full else H4.SEAT_PLAIN_OPS_444
    pl._rebuild_steps()
    one = H264EncoderSession(CaptureSettings(**kw), dev)
    assert sh.stripe_devices == 4 and not sh._partial
    f0, _ = _frames(dev, 128, 128)
    typed = torch.roll(f0, 5, 0)
    typed[40:48, 8:40] = 20
    # frame 4 repeats frame 0 as a forced IDR with each shard's buffer cut
    # to 2/3 of frame 0's largest stripe: it overflows, and the doubled
    # buffers hold frame 5's IDR
    frames = [f0, torch.roll(f0, 5, 0), typed, typed, f0, typed]
    before = dict(_cuda.LAUNCHES)
    for i, frame in enumerate(frames):
        if i == 4:
            for s in (sh, pl):
                s._out_cap = 4 * (largest * 2 // 3)
                s._rebuild_steps()
        got = [s.finalize(s.encode(frame, force=i == 4)) for s in (sh, pl)]
        tup = [[(c.stripe_y, c.is_idr, c.payload) for c in g] for g in got]
        if i < 4:
            want = list(one.finalize_stream(one.encode(frame)))
            tup.append([(c.stripe_y, c.is_idr, c.payload) for c in want])
            assert tup[0] == tup[2], i
        if i == 0:
            largest = max(len(c[2]) for c in tup[0])
        assert tup[0] == tup[1], i
        assert (tup[0] == []) == (i == 4) or i == 3, i
        for k in ("_ref_y", "_ref_u", "_ref_v", "_prev", "_sent", "_fnum"):
            assert torch.equal(getattr(sh, k), getattr(pl, k)), k
    assert sh._cap_gen == 1 and all(c.is_idr for c in got[0])
    assert _cuda.LAUNCHES["pack_stream_seats"] - before[
        "pack_stream_seats"] == len(frames)


# ----------------------------------------- K3 and K4 on their edge shapes
#: the K3 / K4 edge frame, shared with the CPU test that pins it to the
#: reference (tests/test_torch_h264_frames.py): 3 MB rows of 45 MBs (720
#: px, not a multiple of K4's 16 warps a block). As a P frame at QP 28
#: against ``ref``: row 0 is unchanged (every MB skipped: the tail skip
#: run only), row 1 changes in its last MB only, and row 2 changes
#: throughout, its bits ending on a word boundary (EDGE_SEED is a seed
#: for which they do)
EDGE_R, EDGE_M, EDGE_QP, EDGE_SEED = 3, 45, 28, 81


def _edge_planes(seed=EDGE_SEED):
    """-> (cur, ref): Y, U, V uint8 planes of the edge frame (numpy)."""
    rng = np.random.default_rng(seed)
    H, W = 16 * EDGE_R, 16 * EDGE_M
    yy, xx = np.mgrid[0:H, 0:W]
    ref = [(40 + 2 * yy + xx // 3) % 256, 100 + xx[::2, ::2] // 4,
           160 - yy[::2, ::2]]
    cur = [p.copy() for p in ref]
    cur[0][16:32, W - 16:] = rng.integers(0, 256, (16, 16))
    cur[0][32:48] = np.where(rng.random((16, W)) < 0.3, 20, cur[0][32:48])
    cur[1][16:24] = np.clip(cur[1][16:24]
                            + rng.integers(-20, 21, (8, W // 2)), 0, 255)
    return ([a.astype(np.uint8) for a in cur],
            [a.astype(np.uint8) for a in ref])


def _k2_plain(dev, planes, ref, qp, intra, tables=HP):
    """K2's plain outputs (lv, cbp, hdr_pay, hdr_nb) on the card: I as one
    stripe, P at zero motion against ``ref`` (``tables``: HP for 4:2:0,
    H4 for 4:4:4)."""
    t = [torch.as_tensor(p, device=dev) for p in planes]
    rf = [torch.as_tensor(p, device=dev) for p in ref]
    R = t[0].shape[0] // 16
    qp = torch.full((R,), qp, dtype=torch.int32, device=dev)
    if intra:
        fn = tables.mb_encode_i_plain if tables is HP \
            else tables.mb_encode_i444_plain
        return fn(*t, qp, torch.ones((1,), dtype=torch.int32, device=dev),
                  R, *rf)
    fn = tables.mb_encode_p_plain if tables is HP \
        else tables.mb_encode_p444_plain
    return fn(*t, qp, torch.ones((R,), dtype=torch.int32, device=dev), *rf,
              None, *[r.clone() for r in rf])


def _row_events(dev, M, R, intra, qp=EDGE_QP):
    """Slice-header rows, row ids and QPs of R rows of M MBs."""
    fn = hcodec.slice_header_events if intra \
        else hcodec.p_slice_header_events
    pay, nb = fn(M, R)
    return (torch.as_tensor(pay.astype(np.int32), device=dev),
            torch.as_tensor(nb.astype(np.int32), device=dev),
            torch.arange(R, dtype=torch.int32, device=dev) % 16,
            torch.full((R,), qp, dtype=torch.int32, device=dev))


def _k3_k4(dev, out, intra, rows=None, e_cap=10 ** 6, w_cap=4096,
           out_cap=1 << 16, qp=EDGE_QP):
    """K3 and K4 against their plain versions on K2's ``out`` (the rows
    ``rows`` of it and of the frame's slice-header rows, as views, as the
    band step hands them over); -> K4's output."""
    R, M = out[0].shape[:2]
    rows = slice(None) if rows is None else rows
    lv, cbp, hp, hn = (t[rows] for t in out)
    ev = HP.cavlc_events(lv, cbp, intra)
    _same(ev, HP.cavlc_events_plain(lv, cbp, intra))
    args = (hp, hn, *ev, *(t[rows] for t in _row_events(dev, M, R, intra,
                                                         qp)),
            intra, e_cap, w_cap, out_cap)
    k = HP.pack_stream(*args)
    _same(k, HP.pack_stream_plain(*args))
    return k


@pytest.mark.parametrize("intra", [True, False])
def test_k3_k4_edge_frame(dev, intra):
    """The edge frame: an all-skip P row, a P row whose last MB is the
    only one coded, a row ending on a word boundary, 45 MBs a row; then
    each row alone as a 1-row band, equal to its row of the frame."""
    cur, ref = _edge_planes()
    out = _k2_plain(dev, cur, ref, EDGE_QP, intra)
    k = _k3_k4(dev, out, intra)
    if not intra:
        coded = (out[3][..., 1] > 0).cpu().numpy()
        assert not coded[0].any()
        assert coded[1].tolist() == [False] * (EDGE_M - 1) + [True]
        assert int(k.total_bits[2]) % 32 == 0
    for r in range(EDGE_R):
        k1 = _k3_k4(dev, out, intra, slice(r, r + 1))
        _same([k1.words[0], k1.total_bits[0]], [k.words[r], k.total_bits[r]])


def _band_frame(dev, W, rows, intra, seed):
    """K2's plain outputs of a desktop-like frame of ``rows`` MB rows and
    width ``W`` with noise patches (I; P against it shifted)."""
    rng = np.random.default_rng(seed)
    H = 16 * rows
    yy, xx = np.mgrid[0:H, 0:W]
    y = (30 + yy + xx // 2) % 256
    y[:, W // 3:W // 2] = rng.integers(0, 256, (H, W // 2 - W // 3))
    planes = [y, 90 + xx[::2, ::2] // 8, 170 - yy[::2, ::2] // 2]
    ref = [np.roll(p, 3, 1) for p in planes]
    return _k2_plain(dev, [p.astype(np.uint8) for p in planes],
                     [p.astype(np.uint8) for p in ref], 24, intra)


@pytest.mark.parametrize("intra", [True, False])
@pytest.mark.parametrize("W", [720, 1008])
@pytest.mark.parametrize("rows", [1, 2, 4, 5])
def test_k3_k4_bands(dev, rows, W, intra):
    """Bands of 1, 2, 4 and 5 MB rows (rows 1.. of a 6-row frame, as
    views) at 45 and 63 MBs a row; K4 also on views of the whole frame's
    K3 output, whose nb rows start off 16-byte boundaries."""
    out = _band_frame(dev, W, 6, intra, rows)
    band = slice(1, 1 + rows)
    _k3_k4(dev, out, intra, band, qp=24)
    lv, cbp, hp, hn = out
    ev = HP.cavlc_events(lv, cbp, intra)
    M = W // 16
    args = (hp[band], hn[band], ev[0][band], ev[1][band],
            *(t[band] for t in _row_events(dev, M, 6, intra, 24)), intra,
            10 ** 6, 4096, 1 << 16)
    _same(HP.pack_stream(*args), HP.pack_stream_plain(*args))


@pytest.mark.parametrize("intra", [True, False])
def test_k3_k4_escapes_at_qp0_on_noise(dev, intra):
    """Noise at QP 0, 120 MBs a row: 28-bit level escapes, rows of over
    8192 words, at the stock 1080p w_cap (which some rows overflow) and
    at one they fit. (The blocks' shares of a row past K4's shared words
    are test_k4_block_shares_past_its_shared_words'.)"""
    rng = np.random.default_rng(7)
    H, W = 32, 1920
    planes = [rng.integers(0, 256, s, dtype=np.uint8)
              for s in ((H, W), (H // 2, W // 2), (H // 2, W // 2))]
    ref = [rng.integers(0, 256, p.shape, dtype=np.uint8) for p in planes]
    out = _k2_plain(dev, planes, ref, 0, intra)
    ev = HP.cavlc_events(out[0], out[1], intra)
    assert int(ev[1].max()) == 28
    for w_cap in (23040, 1 << 16):
        k = _k3_k4(dev, out, intra, w_cap=w_cap, out_cap=1 << 20, qp=0)
        assert int(k.total_bits.max()) > 8192 * 32
    assert int(k.flags[0]) == 0


#: pack_stream.cu: the words a block keeps in shared memory (kWords),
#: the blocks a row at most (kMaxRank), the MBs a block at most (kMaxMBs)
K4_WORDS, K4_MAX_RANK, K4_MAX_MBS = 2048, 8, 132


def _ue_bits(v):
    return 2 * (int(v) + 1).bit_length() - 1


def _rank_starts(hn, en, total, intra, P):
    """The bit where each of P blocks' MBs start in a row (and the row's
    end), from the row's header and slot bit counts (numpy, (M, 6) and
    (M, SB)) and its total bits: the row prefix, then each MB with the
    skip run before it (P), then the tail skip run and the stop bit."""
    M = hn.shape[0]
    bits = hn.sum(1).astype(np.int64) + en.sum(1).astype(np.int64)
    tail = 0
    if not intra:
        prev = -1
        for m in np.flatnonzero(hn[:, 1] > 0):
            bits[m] += _ue_bits(m - prev - 1)
            prev = m
        tail = _ue_bits(M - 1 - prev) if M - 1 - prev > 0 else 0
    prefix = total - int(bits.sum()) - tail - 1
    Mb = -(-M // P)
    cum = np.concatenate([[0], np.cumsum(bits)])
    return [0] + [prefix + int(cum[min(k * Mb, M)]) for k in range(1, P)] \
        + [total]


@pytest.mark.parametrize("intra", [True, False])
def test_k4_block_shares_past_its_shared_words(dev, intra):
    """One 3840 px row of noise at QP 0 (a one-row band: 8 blocks of 30
    MBs, whatever the card's SM count): every block but the last packs
    over 2048 words, so its words past its shared buffer take global
    atomics, and a block whose first bit lies inside a word hands that
    word to a block whose shared buffer it lies past."""
    rng = np.random.default_rng(5)
    H, W = 16, 3840
    planes = [rng.integers(0, 256, s, dtype=np.uint8)
              for s in ((H, W), (H // 2, W // 2), (H // 2, W // 2))]
    ref = [rng.integers(0, 256, p.shape, dtype=np.uint8) for p in planes]
    out = _k2_plain(dev, planes, ref, 0, intra)
    k = _k3_k4(dev, out, intra, w_cap=1 << 16, out_cap=1 << 19, qp=0)
    ev = HP.cavlc_events(out[0], out[1], intra)
    starts = _rank_starts(out[3][0].cpu().numpy(), ev[1][0].cpu().numpy(),
                          int(k.total_bits[0]), intra, K4_MAX_RANK)
    shares = np.diff(starts)
    assert shares[:-1].min() > 32 * (K4_WORDS + 1)
    assert any(b % 32 for b in starts[1:-1])
    assert int(k.total_bits[0]) < 32 * (1 << 16)


def _k4_both_entries(args, intra, n_seats, w_cap=1 << 16, out_cap=1 << 18):
    """K4's frame and seat entries on ``args``, each equal to its plain
    version (tolerance 0)."""
    a = (*args, intra, 10 ** 6, w_cap, out_cap)
    _same(HP.pack_stream(*a), HP.pack_stream_plain(*a))
    _same(HP.pack_stream_seats(*a, n_seats=n_seats),
          HP.pack_stream_seats_plain(*a, n_seats=n_seats))


@pytest.mark.parametrize("intra", [True, False])
def test_k3_k4_at_3840(dev, intra):
    """4:2:0 at 3840 px (240 MBs a row), 4 rows: K3, then K4 through both
    entries (the frame, and its rows as two seats)."""
    out = _band_frame(dev, 3840, 4, intra, 9)
    lv, cbp, hp, hn = out
    ev = HP.cavlc_events(lv, cbp, intra)
    _same(ev, HP.cavlc_events_plain(lv, cbp, intra))
    _k4_both_entries((hp, hn, *ev, *_row_events(dev, 240, 4, intra, 24)),
                     intra, 2)


@pytest.mark.parametrize("intra", [True, False])
def test_k16_k4_444_at_3840(dev, intra):
    """4:4:4 at 3840 px (240 MBs a row, 1740 / 1728 slots an MB: the row's
    nb is over 8 blocks' preferred share of shared memory), 4 rows: K16,
    then K4 through both entries."""
    rng = np.random.default_rng(12)
    H, W = 64, 3840
    planes = [rng.integers(0, 256, (H, W), dtype=np.uint8)
              for _ in range(3)]
    for p in planes:
        p[:, :2000] = 128 + (np.arange(2000) // 64) % 8
    ref = [np.roll(p, 2, 1) for p in planes]
    lv, cbp, hp, hn = _k2_plain(dev, planes, ref, 22, intra, H4)
    ev = H4.cavlc_events444(lv, cbp, intra)
    _same(ev, H4.cavlc_events444_plain(lv, cbp, intra))
    _k4_both_entries((hp, hn, *ev, *_row_events(dev, 240, 4, intra, 22)),
                     intra, 2)


@pytest.mark.parametrize("intra", [True, False])
@pytest.mark.parametrize("tables", [HP, H4], ids=["420", "444"])
@pytest.mark.parametrize("mb_w", [240, 480, 1056])
def test_pack_stream_wide_rows(dev, mb_w, tables, intra):
    """Rows of 240, 480 and 1056 MBs (3840, 7680 and 16896 px, the last
    past the widest row H.264 allows) at 4:2:0's and 4:4:4's slot counts,
    random slot events, through both K4 entries: each block's nb
    resident two blocks an SM, one block an SM, and (4:4:4 at 1056 MBs)
    read from device memory. Seat 0's last row spills off the seat."""
    args = _seat_pack_inputs(dev, np.random.default_rng(mb_w), 2, 2, mb_w,
                             intra, tables)
    _k4_both_entries(args, intra, 2)


def test_pack_stream_refuses_rows_past_its_widest(dev):
    """A row of 8 * 132 + 1 MBs is refused: the wrapper raises."""
    args = _seat_pack_inputs(dev, np.random.default_rng(1), 1, 1,
                             K4_MAX_RANK * K4_MAX_MBS + 1, True)
    with pytest.raises(RuntimeError, match="pack_stream"):
        HP.pack_stream(*args, True, 10 ** 6, 1 << 16, 1 << 16)


def test_pack_stream_e_cap_overflow_alone(dev):
    """More events than e_cap in rows that fit their words: flag 0 set,
    everything else as the plain version's."""
    cur, ref = _edge_planes()
    out = _k2_plain(dev, cur, ref, EDGE_QP, True)
    k = _k3_k4(dev, out, True, e_cap=200)
    assert k.flags.tolist() == [1, 0]
    assert int(k.total_bits.max()) <= 4096 * 32


@pytest.mark.parametrize("intra", [True, False])
def test_pack_stream_out_cap_at_the_total(dev, intra):
    """out_cap exactly the stream's bytes (flag 1 clear) and one byte
    less (set); neither a multiple of 16."""
    cur, ref = _edge_planes()
    out = _k2_plain(dev, cur, ref, EDGE_QP, intra)
    total = int(_k3_k4(dev, out, intra).byte_lens.sum())
    for cap, flag in ((total, 0), (total - 1, 1)):
        k = _k3_k4(dev, out, intra, out_cap=cap)
        assert int(k.flags[1]) == flag


def _spill_inputs(dev, rng, n_seats, rows, mb_w, intra):
    """K4 seat inputs whose first and last rows of every seat carry
    ~20 bits a slot: with a small w_cap the first row spills into the
    second and the last one off the seat's end."""
    args = list(_seat_pack_inputs(dev, rng, n_seats, rows, mb_w, intra))
    nb = args[3].clone()
    big = nb.view(n_seats, rows, mb_w, -1)
    big[:, 0] = 20
    big[:, -1] = 20
    pay = torch.as_tensor(rng.integers(0, 1 << 20, nb.shape).astype(
        np.int32), device=dev) & ((1 << nb.to(torch.int32)) - 1)
    args[2], args[3] = pay, nb
    return args


@pytest.mark.parametrize("n_seats", [1, 3, 8])
@pytest.mark.parametrize("intra", [True, False])
def test_pack_stream_spills_into_the_next_row_and_off_the_seat(
        dev, n_seats, intra):
    rows, mb_w = 3, 5
    args = _spill_inputs(dev, np.random.default_rng(60 + n_seats), n_seats,
                         rows, mb_w, intra)
    w_cap = 2048
    a = (*args, intra, 10 ** 6, w_cap, 1 << 16)
    k = HP.pack_stream_seats(*a, n_seats=n_seats)
    _same(k, HP.pack_stream_seats_plain(*a, n_seats=n_seats))
    tb = k.total_bits.view(n_seats, rows)
    assert bool((tb[:, 0] > w_cap * 32).all())
    assert bool((tb[:, -1] > w_cap * 32).all())
    assert bool((tb[:, 1] <= w_cap * 32).all())
    assert k.flags[:, 0].tolist() == [1] * n_seats
    if n_seats == 1:
        one = (*(x[:rows] for x in args), intra, 10 ** 6, w_cap, 1 << 16)
        _same(HP.pack_stream(*one), HP.pack_stream_plain(*one))


@pytest.mark.parametrize("intra", [True, False])
def test_k16_and_k4_at_444_slot_counts_odd_width(dev, intra):
    """4:4:4 at 45 MBs a row: K16 equal to its plain version, and K4
    through both entries (the frame, and its rows as two seats) at the
    1740 / 1728 slot counts."""
    rng = np.random.default_rng(11)
    H, W = 32, 720
    planes = [rng.integers(0, 256, (H, W), dtype=np.uint8)
              for _ in range(3)]
    planes[0][:, :300] = 128
    ref = [np.roll(p, 2, 1) for p in planes]
    lv, cbp, hp, hn = _k2_plain(dev, planes, ref, 22, intra, H4)
    ev = H4.cavlc_events444(lv, cbp, intra)
    _same(ev, H4.cavlc_events444_plain(lv, cbp, intra))
    args = (hp, hn, *ev, *_row_events(dev, 45, 2, intra, 22), intra,
            10 ** 6, 4096, 1 << 16)
    _same(HP.pack_stream(*args), HP.pack_stream_plain(*args))
    _same(HP.pack_stream_seats(*args, n_seats=2),
          HP.pack_stream_seats_plain(*args, n_seats=2))


@pytest.mark.parametrize("intra", [True, False])
def test_k3_k4_at_1080p(dev, intra):
    """A 1080p frame (68 rows of 120 MBs) through K3 and K4 at the stock
    caps, kernel == plain."""
    out = _band_frame(dev, 1920, 68, intra, 3)
    _k3_k4(dev, out, intra, w_cap=23040, out_cap=345600, qp=24)


# ------------------------------------------------ K16 and K5 (redesigned)
def _k16_case(dev, rng, R, M, intra, cbp=None, level_max=3):
    """Synthetic K16 inputs: sparse random levels and cbp (I: the AC flag
    and chroma bits, P: random 8x8 group bits unless ``cbp`` is given)."""
    nb = 51 if intra else 48
    lv = rng.integers(-level_max, level_max + 1, (R, M, nb, 16))
    lv *= rng.random((R, M, nb, 16)) < 0.3
    if cbp is None:
        cbp = rng.integers(0, 48, (R, M))
    return (torch.as_tensor(lv.astype(np.int16), device=dev),
            torch.as_tensor(np.asarray(cbp, np.int32), device=dev))


def _k16_same(lv, cbp, intra):
    ev = H4.cavlc_events444(lv, cbp, intra)
    _same(ev, H4.cavlc_events444_plain(lv, cbp, intra))
    return ev


@pytest.mark.parametrize("intra", [True, False])
@pytest.mark.parametrize("M", [1, 45, 63])
def test_k16_blocks_across_row_starts(dev, M, intra):
    """Rows of 1, 45 and 63 MBs (not multiples of K16's 4 MBs a block):
    a block spans a row start and must not take the MB before it as its
    left neighbour."""
    rng = np.random.default_rng(100 + M)
    lv, cbp = _k16_case(dev, rng, 5, M, intra)
    _k16_same(lv, cbp, intra)


@pytest.mark.parametrize("intra", [True, False])
def test_k16_escapes_at_qp0_on_noise(dev, intra):
    """4:4:4 noise at QP 0 through K14 / K15: 28-bit level escapes."""
    rng = np.random.default_rng(21)
    H, W = 32, 720
    planes = [rng.integers(0, 256, (H, W), dtype=np.uint8)
              for _ in range(3)]
    ref = [rng.integers(0, 256, (H, W), dtype=np.uint8) for _ in range(3)]
    lv, cbp, _, _ = _k2_plain(dev, planes, ref, 0, intra, H4)
    ev = _k16_same(lv, cbp, intra)
    assert int(ev[1].max()) == 28


def test_k16_p_gates_each_group_bit_alone(dev):
    """P rows whose MBs have every 8x8 group gated off, then each group
    bit alone, then all four (levels everywhere, so a gated-off block
    that leaked would show)."""
    rng = np.random.default_rng(31)
    M = 45
    cbp = np.zeros((6, M), np.int32)
    for g in range(4):
        cbp[1 + g] = 1 << g
    cbp[5] = 15 | 32
    lv, cbp = _k16_case(dev, rng, 6, M, False, cbp)
    ev = _k16_same(lv, cbp, False)
    assert int(ev[1][0].sum()) == 0


@pytest.mark.parametrize("intra", [True, False])
@pytest.mark.parametrize("W", [720, 1008])
@pytest.mark.parametrize("rows", [1, 2, 4, 5])
def test_k16_bands_as_views(dev, rows, W, intra):
    """Bands of 1, 2, 4 and 5 MB rows (rows 1.. of a 6-row 4:4:4 frame,
    as views, as the band step hands them over) at 45 and 63 MBs a row,
    each equal to its rows of the whole frame's events."""
    rng = np.random.default_rng(rows * W)
    lv, cbp = _k16_case(dev, rng, 6, W // 16, intra)
    whole = _k16_same(lv, cbp, intra)
    band = slice(1, 1 + rows)
    ev = _k16_same(lv[band], cbp[band], intra)
    _same(ev, [t[band] for t in whole])


def test_k16_refuses_misaligned_levels(dev):
    """16-byte staging: a level array off a 16-byte boundary raises."""
    rng = np.random.default_rng(3)
    lv, cbp = _k16_case(dev, rng, 2, 3, True)
    flat = torch.zeros(lv.numel() + 8, dtype=torch.int16, device=dev)
    off = flat[4:4 + lv.numel()].view(lv.shape)
    off.copy_(lv)
    with pytest.raises(RuntimeError, match="cavlc_events444"):
        H4.cavlc_events444(off, cbp, True)


def _k5_entries(dev, cur, ref, qp, cands, win, full):
    """K5 (or its 4:4:4 entry) against its plain version, then K19 on two
    shards' halo bands of the same reference (one for an odd number of
    MB rows) against its plain version and against K5 (tolerance 0).
    -> K5's outputs."""
    from selkies_tpu_torch.parallel import stripes as ST
    k5, p5 = (TE.motion_select444, TE.motion_select444_plain) if full \
        else (TE.motion_select, TE.motion_select_plain)
    got = k5(cur, *ref, qp, cands, win)
    _same(got, p5(cur, *ref, qp, cands, win))
    H = cur.shape[0]
    band = H // (2 - (H // 16) % 2)
    vmax = max(abs(dy) for dy, _ in cands)
    halo_c = vmax if full else vmax // 2 + 1
    bands = [ST.halo_bands(ref[0], band, vmax)] + [
        ST.halo_bands(p, band if full else band // 2, halo_c)
        for p in ref[1:]]
    kern, plain = (ST.motion_select_halo444, ST.motion_select_halo444_plain) \
        if full else (ST.motion_select_halo, ST.motion_select_halo_plain)
    hg = kern(cur, *bands, qp, cands, win)
    _same(hg, plain(cur, *bands, qp, cands, win))
    _same(hg, got)
    return got


def _k5_frame(dev, H, W, full, seed, qp=None):
    """Random reference planes; the current luma scrolled by 3 rows on
    the left half, by -5 rows and 2 columns on the right, noise in its
    second MB column (when it has one)."""
    rng = np.random.default_rng(seed)
    c = 1 if full else 2
    ref = [torch.as_tensor(rng.integers(0, 256, s, dtype=np.uint8),
                           device=dev)
           for s in ((H, W), (H // c, W // c), (H // c, W // c))]
    cur = torch.roll(ref[0], -3, 0)
    cur[:, W // 2:] = torch.roll(ref[0], (5, -2), (0, 1))[:, W // 2:]
    if W > 16:
        cur[:, 16:32] = torch.as_tensor(
            rng.integers(0, 256, (H, 16), dtype=np.uint8), device=dev)
    if qp is None:
        qp = rng.integers(0, 52, H // 16)
    return cur.contiguous(), ref, torch.as_tensor(
        np.asarray(qp, np.int32), device=dev)


def _wide_candidates(n, seed=13):
    """(0, 0), the four extremes at 64 and distinct random (dy, dx) with
    |dy|, |dx| <= 64: ``n`` candidates."""
    rng = np.random.default_rng(seed)
    c = [(0, 0), (64, 0), (-64, 0), (0, 64), (0, -64), (-64, 64)][:n]
    while len(c) < n:
        d = tuple(int(v) for v in rng.integers(-64, 65, 2))
        if d not in c:
            c.append(d)
    return tuple(c)


@pytest.mark.parametrize("full", [False, True])
@pytest.mark.parametrize("shape,ncand,win", [((288, 1008), 57, 32),
                                             ((1088, 1008), 57, 64),
                                             ((1408, 720), 57, 64),
                                             ((1088, 1056), 128, 1088)])
def test_k5_rows_not_a_multiple_of_the_blocks_mbs(dev, shape, ncand, win,
                                                  full):
    """Rows of 63 and 45 MBs at 2 and 4 MB columns a block (the launch
    policy's choice for these shapes on a 132-SM H100), so each row's
    last block is short; a whole-frame window of 68 MB rows (K5) and two
    shards of 34 (K19) cut into row groups of 4 and 5 rows, with 128
    candidates; all four entries."""
    H, W = shape
    cands = TE.scroll_candidates() if ncand == 57 \
        else _wide_candidates(ncand)
    cur, ref, qp = _k5_frame(dev, H, W, full, H + W + ncand)
    got = _k5_entries(dev, cur, ref, qp, cands, win, full)
    assert bool((got[3] != 0).any())


@pytest.mark.parametrize("full", [False, True])
@pytest.mark.parametrize("win", [16, 64])
@pytest.mark.parametrize("ncand", [1, 57, 128])
def test_k5_width_16_and_16_row_windows(dev, ncand, win, full):
    """W = 16 (one MB a row: both width clamps at once), 16- and 64-row
    windows, 1, 57 and 128 candidates (|dy| and |dx| up to 64)."""
    cands = {1: ((-5, 3),), 57: TE.scroll_candidates()}.get(
        ncand) or _wide_candidates(ncand)
    cur, ref, qp = _k5_frame(dev, 64, 16, full, ncand + win)
    _k5_entries(dev, cur, ref, qp, cands, win, full)


@pytest.mark.parametrize("full", [False, True])
def test_k5_flat_frame_ties(dev, full):
    """Every SAD equal: the lambda decides, then the lowest index (three
    candidates of 8 bits; at QP 0 the lambda is 0 and index 0 wins)."""
    H, W = 64, 96
    c = 1 if full else 2
    ref = [torch.full(s, 128, dtype=torch.uint8, device=dev)
           for s in ((H, W), (H // c, W // c), (H // c, W // c))]
    cur = torch.full((H, W), 131, dtype=torch.uint8, device=dev)
    cands = ((4, 0), (0, 1), (0, -1), (1, 0))
    qp = torch.as_tensor(np.array([0, 28, 51, 12], np.int32), device=dev)
    got = _k5_entries(dev, cur, ref, qp, cands, 32, full)
    mv = got[3].cpu().numpy()
    assert (mv[0] == [0, 16]).all()                  # (4, 0), index 0
    assert (mv[1:] == [4, 0]).all()                  # (0, 1), index 1


@pytest.mark.parametrize("full", [False, True])
@pytest.mark.parametrize("order", [1, -1])
def test_k5_exact_tie_of_two_vectors(dev, full, order):
    """A reference of period 6 rows and the frame scrolled by 3: (3, 0)
    and (-3, 0) both match exactly at equal bits, so the lower index of
    the two wins (either order)."""
    H, W = 128, 64
    rng = np.random.default_rng(8)
    c = 1 if full else 2
    per = rng.integers(0, 256, (6, W), dtype=np.uint8)
    ry = np.tile(per, (H // 6 + 1, 1))[:H]
    ref = [torch.as_tensor(ry, device=dev)] + [
        torch.as_tensor(rng.integers(0, 256, (H // c, W // c),
                                     dtype=np.uint8), device=dev)
        for _ in range(2)]
    cur = torch.as_tensor(np.roll(ry, -3, 0).copy(), device=dev)
    cands = ((0, 0), (3 * order, 0), (-3 * order, 0))
    qp = torch.full((H // 16,), 30, dtype=torch.int32, device=dev)
    got = _k5_entries(dev, cur, ref, qp, cands, H, full)
    mvy = got[3][2:-2, :, 1].cpu().numpy()
    assert (mvy == 12 * order).all()


@pytest.mark.parametrize("full", [False, True])
def test_k5_qp_at_and_out_of_its_range(dev, full):
    """Per-row qp at 0 and 51 and out of range (clipped to 0 .. 51)."""
    qp = [0, 51, -7, 60, 1000, -1000, 25, 51]
    cur, ref, qp = _k5_frame(dev, 128, 96, full, 4, qp)
    _k5_entries(dev, cur, ref, qp, TE.scroll_candidates(), 32, full)


def test_k5_refuses_misaligned_planes(dev):
    """16-byte loads and stores: a luma plane off a 16-byte boundary
    raises."""
    cur, ref, qp = _k5_frame(dev, 64, 64, False, 2)
    flat = torch.zeros(cur.numel() + 8, dtype=torch.uint8, device=dev)
    off = flat[4:4 + cur.numel()].view(cur.shape)
    off.copy_(cur)
    with pytest.raises(RuntimeError, match="motion_select"):
        TE.motion_select(off, *ref, qp, TE.scroll_candidates(), 32)
