"""The port's damage-proportional band path: geometry, skip slices, the
row probe and the band step.

``band_buckets``, ``plan_band``, ``dirty_fraction`` and
``p_skip_slice_rbsp`` (with its header writer) equal the JAX package's
copies; the probe's plain version (kernel K6's) equals the reference's
``_jitted_row_damage_probe``. Port-only contracts: a 100%-dirty band
frame gives the stock P step's bytes and reference planes, with motion
and without; a band whose damage sits on its first and last rows leaves
``prev`` equal to the frame (K1 updates only the band rows) and stitches
all-skip slices for the clean rows of sent stripes; an idle frame runs
the probe and nothing else; content profiles floor the band as the
reference's do. Tolerance: 0.
"""

import dataclasses

import numpy as np
import pytest
import torch

from selkies_tpu.codecs import h264 as jcodec
from selkies_tpu.engine.h264_encoder import _jitted_row_damage_probe
from selkies_tpu.ops import bands as jbands
from selkies_tpu_torch.codecs import h264 as tcodec
from selkies_tpu_torch.engine.h264_encoder import H264EncoderSession
from selkies_tpu_torch.engine.types import CaptureSettings
from selkies_tpu_torch.ops import bands as tbands
from selkies_tpu_torch.ops import h264_planes as HP

torch.set_num_threads(1)

H, W = 64, 128
KW = dict(capture_width=W, capture_height=H, stripe_height=32,
          output_mode="h264", h264_motion_hrange=2, use_paint_over=False)


@pytest.mark.parametrize("n,g", [(1, 1), (4, 1), (4, 2), (9, 1), (8, 2),
                                 (12, 4), (68, 1), (68, 4)])
def test_band_buckets_equal_reference(n, g):
    assert tbands.band_buckets(n, g) == jbands.band_buckets(n, g)


@pytest.mark.parametrize("seed", range(8))
@pytest.mark.parametrize("g,floor", [(1, 1), (2, 1), (4, 3), (1, 8)])
def test_plan_band_equals_reference(seed, g, floor):
    rng = np.random.default_rng(seed)
    rows = np.zeros(16, bool)
    rows[rng.integers(0, 16, rng.integers(0, 4))] = True
    assert tbands.plan_band(rows, granularity=g, floor_rows=floor) \
        == jbands.plan_band(rows, granularity=g, floor_rows=floor)
    assert tbands.dirty_fraction(rows) == jbands.dirty_fraction(rows)


@pytest.mark.parametrize("first_mb,n_mbs,qp,fnum", [
    (0, 8, 28, 1), (8, 8, 10, 15), (16, 120, 48, 17), (0, 1, 26, 0),
    (240, 120, 8, 33)])
def test_p_skip_slice_equals_reference(first_mb, n_mbs, qp, fnum):
    assert tcodec.p_skip_slice_rbsp(first_mb, n_mbs, qp, fnum) \
        == jcodec.p_skip_slice_rbsp(first_mb, n_mbs, qp, fnum)
    tw, jw = tcodec.BitWriter(), jcodec.BitWriter()
    tcodec.p_slice_header_bits(tw, first_mb, qp, fnum)
    jcodec.p_slice_header_bits(jw, first_mb, qp, fnum)
    assert tw.bits == jw.bits


def _frames():
    rng = np.random.default_rng(31)
    f0 = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
    f1 = f0.copy()
    f1[16, 5, 2] ^= 1                       # one byte of MB row 1
    f1[47, 120] = 0                         # MB row 2
    return f0, f1


@pytest.mark.parametrize("which", ["idle", "two_rows", "all"])
def test_probe_equals_reference(which):
    f0, f1 = _frames()
    if which == "idle":
        f1 = f0
    elif which == "all":
        f1 = 255 - f0
    want = np.asarray(_jitted_row_damage_probe(W, H)(f1, f0))
    got = HP.row_damage_probe(torch.from_numpy(f1), torch.from_numpy(f0))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy() != 0, want)
    assert torch.equal(got, HP.row_damage_probe_plain(
        torch.from_numpy(f1), torch.from_numpy(f0)))
    with pytest.raises(ValueError):
        HP.row_damage_probe(torch.from_numpy(f1[:40]),
                            torch.from_numpy(f0[:40]))


def _pair(**change):
    """A stock session and a band-path session, otherwise equal."""
    return tuple(H264EncoderSession(CaptureSettings(
        **KW, **change, h264_partial_encode=partial), device="cpu")
        for partial in (False, True))


def _astuples(chunks):
    return [dataclasses.astuple(c) for c in chunks]


def _planes(sess):
    return [getattr(sess, k).clone() for k in
            ("_ref_y", "_ref_u", "_ref_v", "_prev", "_sent", "_fnum")]


@pytest.mark.parametrize("vrange", [0, 4])
def test_full_dirty_band_equals_stock_p_step(vrange):
    f0, _ = _frames()
    f1 = np.roll(f0, 3, axis=0)             # every MB row changes
    stock, band = _pair(h264_motion_vrange=vrange)
    for f in (f0, f1):
        want = stock.finalize(stock.encode(f))
        got = band.finalize(band.encode(f))
        assert _astuples(got) == _astuples(want)
        for a, b in zip(_planes(stock), _planes(band)):
            assert torch.equal(a, b)
    assert band.last_band_rows == band.n_rows


def test_band_rows_update_prev_and_stitch_skip_slices():
    """Damage on the first and last row of a 2-row band (MB rows 1 and 2,
    one in each stripe): K1 updates prev over the band only, and prev
    equals the frame; the clean rows 0 and 3 of the two sent stripes are
    the host-built all-skip slices, and their reference rows keep the
    IDR's reconstruction."""
    f0, f1 = _frames()
    sess = H264EncoderSession(CaptureSettings(
        **KW, h264_motion_vrange=0, h264_partial_encode=True), device="cpu")
    sess.finalize(sess.encode(f0))
    idr = _planes(sess)
    out = sess.encode(f1)
    chunks = sess.finalize(out)
    assert out["band"] == (1, 2) and sess.last_band_rows == 2
    assert np.array_equal(sess._prev.numpy(), f1)
    assert len(chunks) == 2
    M = W // 16
    for chunk, row in zip(chunks, (0, 3)):
        skip = tcodec.nal(1, tcodec.p_skip_slice_rbsp(
            (row % 2) * M, M, sess.qp, 1), ref_idc=2)
        nals = chunk.payload.split(b"\x00\x00\x00\x01")[1:]
        assert b"\x00\x00\x00\x01" + nals[row % 2] == skip
    for k in (0, 3):
        rows = slice(16 * k, 16 * k + 16)
        assert torch.equal(sess._ref_y[rows], idr[0][rows])


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


def test_idle_frame_runs_only_the_probe():
    f0, _ = _frames()
    sess = H264EncoderSession(CaptureSettings(**KW), device="cpu")
    ops = _Counting(HP.KERNEL_OPS)
    sess._ops = ops
    sess._i_step = sess._build_step("i")
    sess._p_step = sess._build_step("p")
    sess.finalize(sess.encode(f0))
    ops.calls.clear()
    out = sess.encode(f0)
    assert out["idle"] and "data" not in out
    assert sess.finalize(out) == [] and list(sess.finalize_stream(out)) == []
    assert ops.calls == {"row_damage_probe": 1}
    assert sess.last_band_rows == 0 and sess.dirty_fraction == 0.0


@pytest.mark.parametrize("name", ["static", "scroll", "video", "gaming"])
def test_content_profile_floors_the_band(name):
    """``set_content_profile`` sets the reference session's band floor
    (a partial_encode=False profile floors at the whole frame), and a
    one-row frame then encodes the band plan_band gives for it."""
    from selkies_tpu.engine.content import CONTENT_PROFILES
    from selkies_tpu.engine.h264_encoder import H264EncoderSession as JS
    from selkies_tpu.engine.types import CaptureSettings as JSettings
    kw = dict(KW, h264_motion_vrange=0, h264_partial_encode=True)
    profile = CONTENT_PROFILES[name]
    js = JS(JSettings(**kw))
    js.set_content_profile(profile)
    sess = H264EncoderSession(CaptureSettings(**kw), device="cpu")
    sess.set_content_profile(profile)
    assert sess._band_floor == js._band_floor
    f0, _ = _frames()
    f1 = f0.copy()
    f1[20, 3] ^= 1                          # MB row 1 only
    sess.finalize(sess.encode(f0))
    out = sess.encode(f1)
    assert sess.finalize(out)
    rows = np.arange(H // 16) == 1
    assert out["band"] == jbands.plan_band(rows, floor_rows=js._band_floor)
