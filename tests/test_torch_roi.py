"""ROI QP (``h264_roi_qp``) on the port against the JAX package.

Held byte for byte (tolerance 0):

- K17's plain version (``roi_qp_plane_plain``) against the reference
  band step's ``mb_dirty`` / ``qp_mb`` expression at QPs 8, 10, 30, 48
  and biases 0, 4, 6, 12, on random frames, single-byte changes and
  changes in the edge MBs;
- K18's plain version (``mb_qp_delta_plain``) against the reference's
  ``_assemble_p_frame`` carry chain, through the packed words of random
  coded / cbp / per-MB QP planes with motion-only MBs;
- the port's ``h264_encode_p_yuv(qp_mb=...)`` against the JAX one at
  per-MB QPs across 0..51, with and without motion candidates, bytes
  and recon; the mb_qp_delta of a damaged MB reaching the wire;
- the band session with ROI QP against the JAX session: the reference's
  ROI round-trip script (zero motion, bias 6) and the default
  configuration (motion, paint-over bands), chunk for chunk and state
  after every frame, every stripe's payloads decoding to the port's
  recon through the reference decoder and libavcodec, and a JAX ROI
  session's state carried into the port mid-script;
- what ROI QP must not change: bias 0 equals ROI off and launches
  neither K17 nor K18; the stock configuration and 4:4:4 ignore it.

The reference's band steps compile once per band bucket (64x64 and
64x128 frames, motion vrange 4 / hrange 2), built once per module.
"""

import dataclasses
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from selkies_tpu.codecs import h264 as jcodec
from selkies_tpu.codecs import h264_ref_decoder as refdec
from selkies_tpu.engine.h264_encoder import H264EncoderSession as JSession
from selkies_tpu.engine.types import CaptureSettings as JSettings
from selkies_tpu.ops import h264_encode as JE
from selkies_tpu.ops import h264_planes as JP
from selkies_tpu_torch.engine import state as port_state
from selkies_tpu_torch.engine.h264_encoder import H264EncoderSession
from selkies_tpu_torch.engine.types import CaptureSettings
from selkies_tpu_torch.ops import h264_planes as HP
from selkies_tpu_torch.ops.h264_encode import _se_event, _ue_event
from selkies_tpu_torch.ops.stripes import words_to_bytes_device

torch.set_num_threads(1)

STATE = ("_ref_y", "_ref_u", "_ref_v", "_age", "_sent", "_fnum", "_prev")
SCALARS = ("qp", "paint_qp", "frame_id", "_w_cap", "_out_cap", "_cap_gen",
           "_force_after_drop", "_roi_qp_bias")


@pytest.fixture(scope="module", autouse=True)
def no_threads_left_behind():
    """Nothing here may leave a thread running (a capture thread, a
    finalizer): tests that share a worker with this file measure the
    process."""
    start = threading.active_count()
    yield
    assert threading.active_count() == start


def _astuples(chunks):
    return [dataclasses.astuple(c) for c in chunks]


def _eq(got, want):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape
    assert np.array_equal(got.astype(np.int64), want.astype(np.int64))


# --------------------------------------------------------------- K17 plane
def _ref_qp_mb(band, prev_band, qp_rows, roi_qp):
    """The reference band step's ROI branch
    (selkies_tpu/engine/h264_encoder.py:317-330), as written there."""
    band_rows, width = band.shape[0] // 16, band.shape[1]
    mb_dirty = jnp.any((band != prev_band).reshape(
        band_rows, 16, width // 16, 48), axis=(1, 3))
    return jnp.clip(jnp.where(mb_dirty, qp_rows[:, None] - roi_qp,
                              qp_rows[:, None]), 8, 48)


def _k17_cases(seed):
    """(frame, prev) pairs of a 48x80 band (3 x 5 MBs): random halves,
    single bytes (first, last, an MB's last column, each channel) and
    the edge MBs."""
    rng = np.random.default_rng(seed)
    prev = rng.integers(0, 256, (48, 80, 3), dtype=np.uint8)
    cases = []
    f = prev.copy()
    mask = rng.random((3, 5)) < 0.5
    mask[0, 0] = True
    for r, m in zip(*np.nonzero(mask)):
        f[16 * r:16 * r + 16, 16 * m:16 * m + 16] = rng.integers(
            0, 256, (16, 16, 3), dtype=np.uint8)
    cases.append(f)
    for y, x, c in ((0, 0, 0), (47, 79, 2), (17, 31, 1), (33, 48, 0),
                    (15, 15, 2)):
        f = prev.copy()
        f[y, x, c] ^= 1
        cases.append(f)
    f = prev.copy()
    f[32:48, 64:80] = 255 - f[32:48, 64:80]              # bottom-right MB
    f[0, 64:80] ^= 128                                    # top-right MB row
    cases.append(f)
    cases.append(prev.copy())                             # nothing dirty
    return prev, cases


@pytest.mark.parametrize("bias", [0, 4, 6, 12])
@pytest.mark.parametrize("qp", [8, 10, 30, 48])
def test_roi_qp_plane_equals_reference(qp, bias):
    prev, cases = _k17_cases(qp * 13 + bias)
    qp_rows = np.array([qp, qp, min(48, qp + 3)], np.int32)
    for f in cases:
        want = _ref_qp_mb(jnp.asarray(f), jnp.asarray(prev),
                          jnp.asarray(qp_rows), bias)
        got = HP.roi_qp_plane(torch.from_numpy(f), torch.from_numpy(prev),
                              torch.from_numpy(qp_rows), bias)
        assert got.dtype == torch.int32
        _eq(got, want)


def test_roi_qp_plane_lower_clip_bites():
    """QP 10 and bias 6 give a dirty MB 8, not 4."""
    prev = np.zeros((16, 32, 3), np.uint8)
    f = prev.copy()
    f[5, 3, 1] = 1
    got = HP.roi_qp_plane(torch.from_numpy(f), torch.from_numpy(prev),
                          torch.tensor([10], dtype=torch.int32), 6)
    assert got.tolist() == [[8, 10]]


# ------------------------------------------------------------ K18 chain
def _chain_planes(seed, R, M):
    rng = np.random.default_rng(seed)
    cbp = rng.integers(1, 48, (R, M)).astype(np.int32)
    cbp[rng.random((R, M)) < 0.5] = 0
    mv_nz = rng.random((R, M)) < 0.4
    mvd = rng.integers(-6, 7, (R, M, 2)).astype(np.int32)
    mvd[~mv_nz] = 0
    mvd[mv_nz & (mvd == 0).all(-1), 0] = 1
    coded = (cbp != 0) | mv_nz
    qp = rng.integers(0, 52, (R,)).astype(np.int32)
    qp_mb = rng.integers(0, 52, (R, M)).astype(np.int32)
    if seed % 2:
        qp_mb = np.clip(qp[:, None] - rng.choice([0, 6], (R, M)), 8, 48
                        ).astype(np.int32)
    return cbp, coded, mvd, qp, qp_mb


def _k2p_headers(cbp, coded, mvd):
    """K2-P's header events for given cbp / coded / mvd planes."""
    R, M = cbp.shape
    cbp_t, coded_t = torch.from_numpy(cbp).long(), torch.from_numpy(coded)
    one = torch.ones((R, M), dtype=torch.int64)
    on = coded_t.long()
    cbp_pay, cbp_nb = _ue_event(torch.as_tensor(HP._CBP2CODE)[cbp_t])
    mx_pay, mx_nb = _se_event(torch.from_numpy(mvd[..., 0]))
    my_pay, my_nb = _se_event(torch.from_numpy(mvd[..., 1]))
    return HP._hdr_tensor([
        (one, torch.zeros_like(one)), (one, on),
        (mx_pay, torch.where(coded_t, mx_nb, 0)),
        (my_pay, torch.where(coded_t, my_nb, 0)),
        (cbp_pay, torch.where(coded_t, cbp_nb, 0)),
        (one, (coded_t & (cbp_t != 0)).long())], R, M, "cpu")


#: the chain's planes: R MB rows of M MBs (M = 40 crosses a 32-MB chunk)
CR, CM, CW = 4, 40, 256


@jax.jit
def _ref_headers_only(cbp, coded, mvd, qp, qp_mb, hp, hn, fn):
    """The reference's ``_assemble_p_frame(qp_mb=...)`` with no residual
    events: the words hold the slice headers, skip runs and MB headers."""
    R, M = CR, CM
    z = jnp.zeros
    return JP._assemble_p_frame(
        R, M, CW, 10_000, qp, fn, hp, hn, cbp, coded, mvd,
        z((36, 4 * R, 4 * M), jnp.int32), z((36, 4 * R, 4 * M), jnp.int32),
        z((12, R, M), jnp.int32), z((12, R, M), jnp.int32),
        z((12, R, M), jnp.int32), z((12, R, M), jnp.int32),
        z((34, 2 * R, 2 * M), jnp.int32), z((34, 2 * R, 2 * M), jnp.int32),
        z((34, 2 * R, 2 * M), jnp.int32), z((34, 2 * R, 2 * M), jnp.int32),
        qp_mb=qp_mb)


@pytest.mark.parametrize("seed", range(6))
def test_mb_qp_delta_equals_reference_chain(seed):
    """The packed rows of K2-P's headers after K18 equal the reference's
    ``_assemble_p_frame(qp_mb=...)`` on the same planes."""
    R, M, w_cap = CR, CM, CW
    cbp, coded, mvd, qp, qp_mb = _chain_planes(seed, R, M)
    hp, hn = jcodec.p_slice_header_events(M, R)
    fn = np.arange(R, dtype=np.int32)
    want = _ref_headers_only(cbp, coded, mvd, qp, qp_mb, hp, hn, fn)

    hdr_pay, hdr_nb = _k2p_headers(cbp, coded, mvd)
    out = HP.mb_qp_delta(hdr_pay, hdr_nb, torch.from_numpy(qp_mb),
                         torch.from_numpy(qp))
    assert out[0] is hdr_pay and out[1] is hdr_nb          # in place
    ev = torch.zeros((R, M, HP.SB_P), dtype=torch.int32)
    st = HP.pack_stream_plain(
        hdr_pay, hdr_nb, ev, ev.to(torch.uint8),
        torch.as_tensor(hp.astype(np.int64)).to(torch.int32),
        torch.as_tensor(hn).to(torch.int32), torch.from_numpy(fn),
        torch.from_numpy(qp), False, 10_000, w_cap, R * w_cap * 4)
    assert np.array_equal(st.words.numpy().view(np.uint32),
                          np.asarray(want.words).astype(np.uint32))
    _eq(st.total_bits, want.total_bits)
    gated = coded & (cbp != 0)
    assert gated.any() and (coded & (cbp == 0)).any()    # motion-only MBs
    assert (hdr_nb[..., 5].numpy() > 0).tolist() == gated.tolist()


def test_mb_qp_delta_chain_by_hand():
    """Row QP 30; MBs 0..4 at 30, 24, 24, 30, 26 with MB 2 motion-only:
    deltas 0, -6, (none), +6, -4 (MB 3 against MB 1, not MB 2)."""
    cbp = np.array([[1, 15, 0, 2, 16]], np.int32)
    coded = np.array([[True, True, True, True, True]])
    mvd = np.zeros((1, 5, 2), np.int32)
    mvd[0, 2, 0] = 4
    hdr_pay, hdr_nb = _k2p_headers(cbp, coded, mvd)
    HP.mb_qp_delta(hdr_pay, hdr_nb,
                   torch.tensor([[30, 24, 24, 30, 26]], dtype=torch.int32),
                   torch.tensor([30], dtype=torch.int32))
    want = [_se_event(torch.tensor(d)) for d in (0, -6, 6, -4)]
    got = [(int(hdr_pay[0, m, 5]), int(hdr_nb[0, m, 5]))
           for m in (0, 1, 3, 4)]
    assert got == [(int(p), int(n)) for p, n in want]
    assert int(hdr_nb[0, 2, 5]) == 0 and int(hdr_pay[0, 2, 5]) == 0


# ------------------------------------------------- frame-level P encoder
_J_ENCODE_P = jax.jit(JP.h264_encode_p_yuv, static_argnames=(
    "e_cap", "w_cap", "candidates", "stripe_rows"))


@pytest.mark.parametrize("motion", [False, True])
@pytest.mark.parametrize("seed", range(3))
def test_encode_p_yuv_with_qp_mb_equals_reference(seed, motion):
    """Per-MB QPs across 0..51 (the extremes in every row), with and
    without motion candidates: words, bit totals, overflow and recon."""
    rng = np.random.default_rng(100 + seed)
    R, M = 2, 4
    H, W = 16 * R, 16 * M
    ref = [rng.integers(0, 256, s, dtype=np.uint8)
           for s in ((H, W), (H // 2, W // 2), (H // 2, W // 2))]
    cur = [np.clip(np.roll(p, 1 + seed, 0).astype(np.int32)
                   + rng.integers(-12, 13, p.shape), 0, 255).astype(np.uint8)
           for p in ref]
    cur[0][:16, :16] = rng.integers(0, 256, (16, 16), dtype=np.uint8)
    qp = rng.integers(0, 52, (R,)).astype(np.int32)
    qp_mb = rng.integers(0, 52, (R, M)).astype(np.int32)
    qp_mb[:, 0], qp_mb[:, -1] = 0, 51
    cands = JE.scroll_candidates(4, 2) if motion else ((0, 0),)
    hp, hn = jcodec.p_slice_header_events(M, R)
    want, wrec = _J_ENCODE_P(*cur, *ref, qp, hp, hn, 3, e_cap=10_000,
                             w_cap=512, candidates=cands,
                             stripe_rows=R if motion else None, qp_mb=qp_mb)
    got, grec = HP.h264_encode_p_yuv(*cur, *ref, qp, hp, hn, 3, 10_000, 512,
                                     candidates=cands,
                                     stripe_rows=R if motion else None,
                                     qp_mb=qp_mb, device="cpu")
    assert np.array_equal(got.words.numpy().view(np.uint32),
                          np.asarray(want.words).astype(np.uint32))
    _eq(got.total_bits, want.total_bits)
    assert bool(got.overflow) == bool(want.overflow)
    for g, w in zip(grec, wrec):
        _eq(g, w)
    plain, _ = HP.h264_encode_p_yuv(*cur, *ref, qp, hp, hn, 3, 10_000, 512,
                                    candidates=cands,
                                    stripe_rows=R if motion else None,
                                    device="cpu")
    assert not torch.equal(plain.words, got.words)        # the plane bit


def test_roi_qp_emits_nonzero_mb_qp_delta():
    """tests/test_h264_bands.py:237 on the port: the slice of a mixed
    damaged / settled row carries a parsed mb_qp_delta of -6."""
    rng = np.random.default_rng(1234)
    Rr, M = 2, 4
    hh, ww = Rr * 16, M * 16
    cur = rng.integers(0, 256, (hh, ww), dtype=np.int32)
    ref_y = cur.copy()
    cur[0:16, 0:16] = rng.integers(0, 256, (16, 16), dtype=np.int32)
    cur[0:16, 32:64] = np.clip(ref_y[0:16, 32:64] + 40, 0, 255)
    ref_u = rng.integers(0, 256, (hh // 2, ww // 2), dtype=np.int32)
    ref_v = rng.integers(0, 256, (hh // 2, ww // 2), dtype=np.int32)
    pay, nb = jcodec.p_slice_header_events(M, Rr)
    qp = 30
    qp_mb = np.full((Rr, M), qp, np.int32)
    qp_mb[0, 0] = qp - 6
    out, _ = HP.h264_encode_p_yuv(cur, ref_u, ref_v, ref_y, ref_u, ref_v, qp,
                                  pay, nb, 1, 200, 2048, qp_mb=qp_mb,
                                  device="cpu")
    by, lens = words_to_bytes_device(out.words, out.total_bits)
    r = refdec.BitReader(bytes(by[0][:int(lens[0])].numpy()))
    r.ue(); r.ue(); r.ue(); r.u(4); r.u(1); r.u(1); r.u(1)
    assert r.se() == qp - 26
    r.ue()                                 # deblock idc
    assert r.ue() == 0                     # skip run 0 (MB 0 coded)
    assert r.ue() == 0                     # mb_type P_L0_16x16
    r.se(); r.se()                         # mvd
    assert refdec.T.CBP_INTER_CODE2CBP[r.ue()] != 0
    assert r.se() == -6                    # mb_qp_delta reaches the wire


# ------------------------------------------------------------- sessions
ORACLE_KW = dict(capture_width=64, capture_height=64, stripe_height=32,
                 output_mode="h264", video_crf=28, use_paint_over=False,
                 h264_motion_vrange=0, h264_motion_hrange=0,
                 h264_partial_encode=True, h264_roi_qp=True,
                 h264_roi_qp_bias=6)
DEFAULT_KW = dict(capture_width=128, capture_height=64, stripe_height=32,
                  output_mode="h264", paint_over_delay_frames=3,
                  h264_motion_vrange=4, h264_motion_hrange=2,
                  h264_partial_encode=True, h264_roi_qp=True)
CARRY_AT = 3


def _oracle_script():
    """tests/test_h264_bands.py's ``_partial_script``: a damaged MB row,
    an idle frame, the last MB row repainted."""
    rng = np.random.default_rng(1234)
    base = rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)
    f = base.copy()
    f[16:32, 0:32] = rng.integers(0, 256, (16, 32, 3), dtype=np.uint8)
    g = f.copy()
    g[48:64, :] = rng.integers(0, 256, (16, 64, 3), dtype=np.uint8)
    return [(base, True), (f, False), (f.copy(), False), (g, False)]


def _desktop(seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:64, 0:128]
    f = np.stack([40 + yy + xx // 2, 90 + yy // 2 + 0 * xx,
                  200 - yy - xx // 4], -1).astype(np.uint8)
    glyphs = rng.integers(0, 2, (32, 64), dtype=np.uint8)
    text = np.repeat(np.repeat(glyphs, 2, 0), 2, 1)[..., None] * 190 + 25
    f[6:58, 10:100] = text[6:58, 10:100]
    f[12:40, 104:124] = (230, 230, 240)                   # flat window
    return f


def _default_script():
    """IDR, a 5-row scroll, typing in MB row 3, idle, the paint-over of
    each stripe (a paint-over band at paint_qp), a full-frame pan, a
    forced IDR, typing in MB rows 0 and 2."""
    d0 = _desktop(3)
    d1 = np.concatenate([d0[5:], _desktop(4)[:5]])
    d2 = d1.copy()
    d2[52:58, 40:52] = 255 - d2[52:58, 40:52]
    d3 = np.roll(d2, -2, axis=1)
    d4 = d3.copy()
    d4[2:8, 60:70] = 0
    d4[40:46, 20:30] = 255
    return [(d0, False), (d1, False), (d2, False), (d2, False), (d2, False),
            (d2, False), (d3, False), (d3, True), (d4, False)]


def _run(sess, script, jax_side: bool):
    out = []
    for frame, force in script:
        res = sess.encode(jnp.asarray(frame) if jax_side else frame,
                          force=force)
        chunks = sess.finalize(res)
        st = {k: np.array(getattr(sess, k)) if jax_side
              else getattr(sess, k).numpy().copy() for k in STATE}
        st["_host_age"] = np.array(sess._host_age)
        st.update({k: getattr(sess, k) for k in SCALARS})
        out.append((chunks, st, res.get("band")))
    return out


def _pair(kw, script):
    js = JSession(JSettings(**kw))
    ts = H264EncoderSession(CaptureSettings(**kw), device="cpu")
    return {"jax": _run(js, script, True), "port": _run(ts, script, False)}


@pytest.fixture(scope="module")
def oracle_runs():
    return _pair(ORACLE_KW, _oracle_script())


@pytest.fixture(scope="module")
def default_runs():
    return _pair(DEFAULT_KW, _default_script())


def _assert_frame_equal(runs, i):
    jc, js, jband = runs["jax"][i]
    tc, ts, tband = runs["port"][i]
    assert _astuples(tc) == _astuples(jc)
    assert tband == jband
    for k in STATE + ("_host_age",) + SCALARS:
        assert np.array_equal(np.asarray(js[k]), np.asarray(ts[k])), k


@pytest.mark.parametrize("i", range(len(_oracle_script())))
def test_oracle_script_frame_equals_reference(oracle_runs, i):
    _assert_frame_equal(oracle_runs, i)


@pytest.mark.parametrize("i", range(len(_default_script())))
def test_default_roi_frame_equals_reference(default_runs, i):
    _assert_frame_equal(default_runs, i)


def test_the_scripts_cover_the_cases(oracle_runs, default_runs):
    """Band frames with ROI QP (one-row and stripe bands, a paint-over
    band, a full-frame band), idle frames, IDRs; and ROI QP changed the
    bytes of the band frames."""
    assert [b for _, _, b in oracle_runs["port"]] == [None, (1, 1), None,
                                                      (3, 1)]
    bands = [b for _, _, b in default_runs["port"]]
    assert bands == [None, (0, 4), (2, 2), None, (0, 2), (2, 2), (0, 4),
                     None, (0, 4)]
    off = H264EncoderSession(CaptureSettings(**dict(
        DEFAULT_KW, h264_roi_qp=False)), device="cpu")
    for (frame, force), (chunks, _, band) in zip(_default_script(),
                                                 default_runs["port"]):
        plain = off.finalize(off.encode(frame, force=force))
        if band is not None:
            assert _astuples(plain) != _astuples(chunks)


def _stripe_payloads(run, stripe):
    return [c.payload for chunks, _, _ in run for c in chunks
            if c.stripe_y == 32 * stripe]


def _assert_decodes_to_recon(run, stripe, planes):
    y, u, v = planes
    final = run[-1][1]
    assert np.array_equal(y, final["_ref_y"][32 * stripe:32 * stripe + 32])
    assert np.array_equal(u, final["_ref_u"][16 * stripe:16 * stripe + 16])
    assert np.array_equal(v, final["_ref_v"][16 * stripe:16 * stripe + 16])


@pytest.mark.parametrize("script", ["oracle", "default"])
@pytest.mark.parametrize("stripe", [0, 1])
def test_reference_decoder_reproduces_roi_recon(oracle_runs, default_runs,
                                                script, stripe):
    run = (oracle_runs if script == "oracle" else default_runs)["port"]
    _assert_decodes_to_recon(run, stripe, refdec.decode(
        b"".join(_stripe_payloads(run, stripe))))


@pytest.mark.parametrize("script", ["oracle", "default"])
@pytest.mark.parametrize("stripe", [0, 1])
def test_libavcodec_reproduces_roi_recon(oracle_runs, default_runs, script,
                                         stripe):
    from selkies_tpu.native import avshim
    if not avshim.available():
        pytest.skip("libavcodec shim not available")
    run = (oracle_runs if script == "oracle" else default_runs)["port"]
    ses = avshim.H264Session()
    out = None
    for payload in _stripe_payloads(run, stripe):
        out = ses.decode(payload) or out
    out = ses.flush() or out
    _assert_decodes_to_recon(run, stripe, out)


@pytest.fixture(scope="module")
def carried(default_runs):
    """A port ROI session loaded with the JAX ROI session's state after
    frame CARRY_AT (the state modules carry no ROI state: the reference
    keeps none across frames), run over the rest of the script."""
    ts = H264EncoderSession(CaptureSettings(**DEFAULT_KW), device="cpu")
    port_state.session_state_from_numpy(ts, default_runs["jax"][CARRY_AT][1])
    return _run(ts, _default_script()[CARRY_AT + 1:], False)


@pytest.mark.parametrize("i", range(CARRY_AT + 1, len(_default_script())))
def test_jax_roi_state_carries_into_the_port(default_runs, carried, i):
    jc, js, _ = default_runs["jax"][i]
    tc, ts, _ = carried[i - CARRY_AT - 1]
    assert _astuples(tc) == _astuples(jc)
    for k in STATE + ("_host_age",) + SCALARS:
        assert np.array_equal(np.asarray(js[k]), np.asarray(ts[k])), k


def test_roi_adds_no_session_state():
    ts = H264EncoderSession(CaptureSettings(**DEFAULT_KW), device="cpu")
    off = H264EncoderSession(CaptureSettings(**dict(
        DEFAULT_KW, h264_roi_qp=False)), device="cpu")
    assert ts.STATE_KEYS == off.STATE_KEYS == port_state.H264_STATE
    assert sorted(port_state.session_state_to_numpy(ts)) \
        == sorted(port_state.session_state_to_numpy(off))


class _Counting:
    """StepOps whose every function counts its calls."""

    def __init__(self, ops):
        self.calls = {}
        for name in ops._fields:
            setattr(self, name, self._wrap(name, getattr(ops, name)))

    def _wrap(self, name, fn):
        def call(*a, **k):
            self.calls[name] = self.calls.get(name, 0) + 1
            return fn(*a, **k)
        return call


def _counted_run(kw):
    sess = H264EncoderSession(CaptureSettings(**kw), device="cpu")
    ops = _Counting(sess._ops)
    sess._ops = ops
    sess._rebuild_steps()
    outs = []
    for frame, force in _default_script():
        res = sess.encode(frame, force=force)
        outs.append((_astuples(sess.finalize(res)), res.get("band")))
    return outs, ops.calls


def test_bias_zero_equals_roi_off_and_launches_neither_kernel():
    off, off_calls = _counted_run(dict(DEFAULT_KW, h264_roi_qp=False))
    zero, zero_calls = _counted_run(dict(DEFAULT_KW, h264_roi_qp_bias=0))
    assert zero == off and zero_calls == off_calls
    assert "roi_qp_plane" not in zero_calls
    assert "mb_qp_delta" not in zero_calls
    on, on_calls = _counted_run(DEFAULT_KW)
    n_band = sum(b is not None for _, b in on)
    assert n_band == 6
    assert on_calls["roi_qp_plane"] == on_calls["mb_qp_delta"] == n_band


@pytest.mark.parametrize("change", [{"h264_partial_encode": False},
                                    {"fullcolor": True}],
                         ids=["stock", "fullcolor"])
def test_roi_is_ignored_off_the_420_band_path(change):
    """The stock configuration and 4:4:4 never read ROI QP (the
    reference passes it to the 4:2:0 band step only)."""
    kw = dict(DEFAULT_KW, **change)
    on, on_calls = _counted_run(kw)
    off, _ = _counted_run(dict(kw, h264_roi_qp=False))
    assert on == off
    assert "roi_qp_plane" not in on_calls and "mb_qp_delta" not in on_calls
