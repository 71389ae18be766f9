"""Boundary checks of the PyTorch/CUDA port (selkies_tpu_torch).

The port imports torch and numpy only: never jax, never the JAX package
(not even its jax-free modules), never triton at module level; it builds
no kernel at import; its entry points default to CUDA and refuse to fall
back to the CPU silently; settings outside the ported slice raise, and the
reference defaults (motion search, the band path) build and encode.
"""

import ast
import dataclasses
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from selkies_tpu_torch.codecs import h264 as port_codec
from selkies_tpu_torch.codecs import h264_tables as port_tables
from selkies_tpu_torch.engine import h264_encoder as port_enc
from selkies_tpu_torch.engine.types import CaptureSettings, EncodedChunk
from selkies_tpu_torch.ops import _cuda
from selkies_tpu_torch.ops import h264_planes as HP

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "selkies_tpu_torch"
PORT_FILES = sorted(p.relative_to(ROOT).as_posix()
                    for p in PKG.rglob("*.py"))
PORT_MODULES = sorted(
    p[:-3].replace("/", ".").removesuffix(".__init__") for p in PORT_FILES)


def test_import_leaves_jax_and_reference_out():
    code = ("import sys, importlib\n"
            f"for m in {PORT_MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'selkies_tpu' or "
            "m.startswith('selkies_tpu.') or m == 'triton']\n"
            "assert not bad, bad\n"
            "print('clean')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


#: the engine loop's modules and the stdlib copies it brought
LOOP_MODULES = [
    "selkies_tpu_torch.engine.capture", "selkies_tpu_torch.engine.pipeline",
    "selkies_tpu_torch.engine.sources", "selkies_tpu_torch.engine.content",
    "selkies_tpu_torch.engine.watermark", "selkies_tpu_torch.ops.frames",
    "selkies_tpu_torch.trace", "selkies_tpu_torch.trace.core",
    "selkies_tpu_torch.resilience", "selkies_tpu_torch.resilience.faults",
    "selkies_tpu_torch.obs", "selkies_tpu_torch.obs.health",
    "selkies_tpu_torch.obs.energy", "selkies_tpu_torch.server",
    "selkies_tpu_torch.server.metrics"]


def test_engine_loop_modules_are_checked():
    """Every module of the engine loop is among those the import check
    above imports (and the AST scan below reads)."""
    assert set(LOOP_MODULES) <= set(PORT_MODULES)


#: the multi-seat and split-frame modules
SEAT_MODULES = [
    "selkies_tpu_torch.parallel", "selkies_tpu_torch.parallel.seats",
    "selkies_tpu_torch.parallel.h264_seats",
    "selkies_tpu_torch.parallel.capture",
    "selkies_tpu_torch.parallel.stripes"]


def test_multiseat_modules_are_checked():
    """The multi-seat and split-frame modules are among those the import
    check imports (no jax, selkies_tpu or triton after importing them)
    and the AST scan reads."""
    assert set(SEAT_MODULES) <= set(PORT_MODULES)


def test_multiseat_entry_points_default_to_the_card():
    """The multi-seat encoders, their mesh, the capture facade and K10's
    seat entry run on the card unless the CPU is named: without CUDA
    each raises instead of running the plain versions on the host."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default resolves to it")
    from selkies_tpu_torch import parallel
    from selkies_tpu_torch.ops import frames
    jpeg = CaptureSettings(capture_width=64, capture_height=64,
                           stripe_height=32)
    h264 = dataclasses.replace(jpeg, output_mode="h264")
    calls = [lambda: parallel.MultiSeatEncoder(jpeg, 2),
             lambda: parallel.MultiSeatH264Encoder(h264, 2),
             lambda: parallel.MultiSeatCapture(2),
             lambda: parallel.seat_mesh(2),
             lambda: frames.synthetic_frames(48, 64, 2, 0)]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    enc = parallel.MultiSeatH264Encoder(h264, 2, devices=["cpu"])
    assert enc.device.type == "cpu"
    assert parallel.MultiSeatCapture(2, device="cpu").device.type == "cpu"


@pytest.mark.parametrize("path", PORT_FILES)
def test_no_forbidden_imports(path):
    """AST scan: no jax / selkies_tpu import anywhere, no triton at module
    level (a kernel module imports triton inside its launcher)."""
    tree = ast.parse((ROOT / path).read_text())
    top = set(id(n) for n in tree.body)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for name in names:
            root = name.split(".")[0]
            assert root not in ("jax", "jaxlib", "selkies_tpu"), (path, name)
            if root == "triton":
                assert id(node) not in top, (path, "top-level triton")


def test_no_build_at_import():
    assert _cuda._build_info == {}
    assert _cuda._fns == {}
    assert all(v == 0 for v in _cuda.LAUNCHES.values())


def test_session_defaults_to_cuda_and_refuses_cpu_fallback():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default resolves to it")
    s = CaptureSettings(capture_width=64, capture_height=64,
                        stripe_height=32, output_mode="h264")
    with pytest.raises(RuntimeError, match="CUDA"):
        port_enc.H264EncoderSession(s)
    sess = port_enc.H264EncoderSession(s, device="cpu")
    assert sess.device.type == "cpu"


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the raise "
                    "on a machine without CUDA")
def test_loop_entry_points_default_to_the_card(tmp_path, monkeypatch):
    """The frame sources, K10's wrapper and the watermark run on the card
    unless the caller names the CPU: without CUDA each raises instead of
    quietly running the plain version on the host. A PNG that decodes
    is put on the device, so its failure there is raised, not logged."""
    from PIL import Image

    from selkies_tpu_torch.engine import sources, watermark
    from selkies_tpu_torch.ops import frames
    rgba = np.full((8, 8, 4), 200, np.uint8)
    path = tmp_path / "wm.png"
    Image.fromarray(rgba, "RGBA").save(path)
    settings = CaptureSettings(watermark_path=str(path))
    monkeypatch.delenv("WAYLAND_DISPLAY", raising=False)
    calls = [
        lambda: sources.make_source("synthetic", 64, 48),
        lambda: sources.make_source("synthetic-static", 64, 48),
        lambda: sources.make_source("auto", 64, 48),
        lambda: sources.SyntheticSource(64, 48),
        lambda: sources.ArraySource([rgba[..., :3]]),
        lambda: sources.X11Source(),
        lambda: frames.synthetic_frame(48, 64, 3),
        lambda: watermark.Watermark(str(path), 6, 64, 48),
        lambda: watermark.Watermark.from_rgba(rgba, 6, 64, 48),
        lambda: watermark.maybe_load(settings, 64, 48)]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert sources.make_source("auto", 64, 48, device="cpu").device.type \
        == "cpu"
    assert watermark.maybe_load(settings, 64, 48, "cpu") is not None


@pytest.mark.parametrize("cls", ["H264EncoderSession",
                                 "StripeShardedH264Session"])
def test_stripe_devices_on_one_device_is_the_plain_session(cls):
    """``stripe_devices=2`` on one device: ``H264EncoderSession`` ignores
    the setting, as the reference's does, and ``StripeShardedH264Session``
    given one device resolves to one shard (gauged). Both equal the plain
    session at 1 over an IDR, a scrolled P frame (the band path), an idle
    frame and typing, chunk for chunk and state for state; the capture
    loop builds the sharded session."""
    from selkies_tpu_torch.engine import ScreenCapture
    from selkies_tpu_torch.engine import state as port_state
    from selkies_tpu_torch.server import metrics
    kw = dict(capture_width=64, capture_height=64, stripe_height=32,
              output_mode="h264", h264_motion_vrange=4,
              h264_motion_hrange=2)
    plain = port_enc.H264EncoderSession(CaptureSettings(**kw), device="cpu")
    two = CaptureSettings(**kw, stripe_devices=2)
    sess = getattr(port_enc, cls)(two, device="cpu")
    if cls == "StripeShardedH264Session":
        assert sess.stripe_devices == 1
        assert metrics._gauges.get(("selkies_stripe_devices", ())) == 1.0
    f = np.random.default_rng(5).integers(0, 256, (64, 64, 3),
                                          dtype=np.uint8)
    typed = np.roll(f, 3, axis=0)
    typed[40:46, 8:20] = 255
    for frame in (f, np.roll(f, 3, axis=0), np.roll(f, 3, axis=0), typed):
        a = plain.finalize(plain.encode(frame))
        b = sess.finalize(sess.encode(frame))
        assert [dataclasses.astuple(c) for c in a] \
            == [dataclasses.astuple(c) for c in b]
        assert plain.last_band_rows == sess.last_band_rows
    sa, sb = (port_state.session_state_to_numpy(x) for x in (plain, sess))
    for k in sa:
        assert np.array_equal(np.asarray(sa[k]), np.asarray(sb[k])), k
    cap = ScreenCapture("synthetic", device="cpu")
    cap.start_capture(lambda chunk: None, two)
    try:
        assert type(cap._session).__name__ == "StripeShardedH264Session"
        assert cap._session.stripe_devices == 1
    finally:
        cap.stop_capture()


def _encode_two_frames(settings):
    """An IDR and a P frame on the CPU -> the P frame's chunks."""
    sess = port_enc.H264EncoderSession(settings, device="cpu")
    f = np.random.default_rng(5).integers(0, 256, (64, 64, 3),
                                          dtype=np.uint8)
    assert all(c.is_idr for c in sess.finalize(sess.encode(f)))
    g = np.roll(f, 3, axis=0)
    return sess, sess.finalize(sess.encode(g))


@pytest.mark.parametrize("change", [{"h264_motion_vrange": 4},
                                    {"h264_partial_encode": True},
                                    {"watermark_path": "/nonexistent.png"},
                                    {"fullcolor": True},
                                    {"h264_roi_qp": True,
                                     "h264_partial_encode": True}])
def test_ported_settings_build_and_encode(change):
    """Motion search (ROADMAP A7), the band path (A8), the watermark
    (A5; an unreadable PNG degrades to none, as in the reference), 4:4:4
    (A10) and ROI QP on the band path (A16), which used to raise, now
    build and encode a P frame on the CPU."""
    kw = dict(capture_width=64, capture_height=64, stripe_height=32,
              output_mode="h264", h264_motion_vrange=0,
              h264_motion_hrange=2, h264_partial_encode=False)
    kw.update(change)
    sess, chunks = _encode_two_frames(CaptureSettings(**kw))
    assert chunks and not any(c.is_idr for c in chunks)
    assert sess._partial == kw["h264_partial_encode"]
    assert sess._watermark is None


def test_reference_defaults_are_kept():
    """The port's CaptureSettings keeps the reference defaults (motion
    search at vrange 24 / hrange 8, the band path), and a session built
    from them encodes on the CPU."""
    s = CaptureSettings(capture_width=64, capture_height=64,
                        stripe_height=32, output_mode="h264")
    assert (s.h264_motion_vrange, s.h264_motion_hrange,
            s.h264_partial_encode) == (24, 8, True)
    sess, chunks = _encode_two_frames(s)
    assert len(sess._candidates) == 57 and sess._partial
    assert chunks and sess.last_band_rows == sess.n_rows


def test_tables_header_is_rendered_from_the_tables():
    text = (PKG / "csrc" / "h264_tables.cuh").read_text()
    assert text == _cuda.render_tables_header()


@pytest.mark.parametrize("name", [
    "CT_LEN_NP", "CT_CODE_NP", "CT_CDC_LEN_NP", "CT_CDC_CODE_NP",
    "TZ_LEN_NP", "TZ_CODE_NP", "TZ_CDC_LEN_NP", "TZ_CDC_CODE_NP",
    "RB_LEN_NP", "RB_CODE_NP", "MF_NP", "V_NP", "QPC_NP", "POS_CLS_NP",
    "ZIGZAG4_NP", "CBP_INTER_CBP2CODE", "CBP444_INTER_CBP2CODE"])
def test_table_copy_equals_reference(name):
    from selkies_tpu.codecs import h264_tables as ref
    a, b = getattr(port_tables, name), getattr(ref, name)
    assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("mb_w,rows", [(4, 2), (5, 4), (120, 4)])
def test_codec_copy_equals_reference(mb_w, rows):
    from selkies_tpu.codecs import h264 as ref
    assert port_codec.write_sps(16 * mb_w, 16 * rows) \
        == ref.write_sps(16 * mb_w, 16 * rows)
    assert port_codec.write_pps() == ref.write_pps()
    for fn in ("slice_header_events", "p_slice_header_events"):
        for x, y in zip(getattr(port_codec, fn)(mb_w, rows),
                        getattr(ref, fn)(mb_w, rows)):
            assert x.dtype == y.dtype and np.array_equal(x, y)
    rb = [bytes([0, 0, 1, 5, 0, 0, 0, 3, 9])]
    assert port_codec.assemble_annexb(rb) == ref.assemble_annexb(rb)


def test_types_copy_equals_reference():
    from selkies_tpu.engine import types as ref
    assert dataclasses.asdict(CaptureSettings()) \
        == dataclasses.asdict(ref.CaptureSettings())
    assert [f.name for f in dataclasses.fields(EncodedChunk)] \
        == [f.name for f in dataclasses.fields(ref.EncodedChunk)]


def test_wrappers_check_their_inputs():
    f = torch.zeros((64, 64, 3), dtype=torch.uint8)
    with pytest.raises(TypeError):
        HP.csc420_damage(f.to(torch.int32), f, 2)
    with pytest.raises(ValueError):
        HP.csc420_damage(f, torch.zeros((64, 32, 3), dtype=torch.uint8), 2)
    with pytest.raises(ValueError):
        HP.csc420_damage(f[:, ::2], f[:, ::2], 2)
    lv = torch.zeros((4, 4, HP.N_BLOCKS, 16), dtype=torch.int16)
    with pytest.raises(ValueError):
        HP.cavlc_events(lv, torch.zeros((4, 5), dtype=torch.int32), True)
