"""The port's CUDA kernels against their plain PyTorch versions.

Needs a CUDA card (marker ``cuda``; skipped elsewhere, decided inside the
fixture). Run on the card with ``python -m pytest tests/test_torch_cuda.py
-m cuda``. Each kernel gets the same inputs as its plain version at small
geometries (one and several stripes, per-row qp, half the stripes sent,
scrolled and panned content for the motion search, neighbouring
macroblocks with different vectors, an unaligned probe input; for the
JPEG kernels 4:2:0 and 4:4:4, per-stripe tables at qualities 10 to 100
and tables of 1/16 that expose one ulp of a coefficient, values past the
category caps, and word and byte buffers too small) and must match it
exactly, overflow flags included. Tolerance: 0.
"""

import numpy as np
import pytest
import torch

from selkies_tpu_torch.codecs import h264 as hcodec
from selkies_tpu_torch.codecs import jpeg as jtab
from selkies_tpu_torch.ops import h264_encode as TE
from selkies_tpu_torch.ops import h264_planes as HP
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


def _p_call(p_fn, planes, qp, send, rps, ref, cands):
    """K2-P (kernel or plain) with the prediction of K5 (zero motion: the
    reference planes themselves, updated in place)."""
    send_rows = send.repeat_interleave(rps)
    if cands is None:
        return p_fn(*planes, qp, send_rows, *ref, None, *ref)
    *pred, mv = TE.motion_select_plain(planes[0], *ref, qp, cands, 16 * rps)
    return p_fn(*planes, qp, send_rows, *pred, mv, *ref)


@pytest.mark.parametrize("geom", GEOMS)
@pytest.mark.parametrize("mode", ["i", "p0", "p"])
def test_mb_encode(dev, geom, mode):
    S, rps, planes, qp, send, ref, _ = _stage(dev, *geom)
    if mode == "i":
        base = [torch.zeros_like(p) for p in planes]
    else:
        base = [p.clone() for p in ref]
        planes = tuple(255 - p for p in planes) if mode == "p0" else tuple(
            torch.roll(p, (-2, 1), (0, 1)) for p in planes)
    kref = [b.clone() for b in base]
    pref = [b.clone() for b in base]
    if mode == "i":
        ko = HP.mb_encode_i(*planes, qp, send, rps, *kref)
        po = HP.mb_encode_i_plain(*planes, qp, send, rps, *pref)
    else:
        cands = None if mode == "p0" else TE.scroll_candidates(4, 2)
        ko = _p_call(HP.mb_encode_p, planes, qp, send, rps, kref, cands)
        po = _p_call(HP.mb_encode_p_plain, planes, qp, send, rps, pref,
                     cands)
    _same(list(ko) + kref, list(po) + pref)


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
def test_chain_on_noise_at_random_qp(dev, seed):
    """Noise frames at per-row qp drawn from 0..51 (level escapes, large
    nC, long runs), I then P: every stage's kernel output equals the
    plain version's on the same inputs."""
    H, W, sh = 64, 96, 32
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

#: (height, width): the 1080p capture and the grid, and odd sizes whose
#: byte counts are not multiples of 4 (the kernels' ragged tails)
FRAME_GEOMS = [(1080, 1920), (1088, 1920), (37, 53), (5, 7)]


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
