"""The engine loop's device functions and host modules against the JAX
package's.

- K10 ``synthetic_frame``, K11 ``pad_frame`` and K12 ``watermark_blend``
  (their plain versions, selkies_tpu_torch/ops/frames.py) against the
  reference's jitted ``_synthetic_fn``, ``_padder`` and ``_blender``:
  geometries under and over 96 rows and 1080p, ticks whose int32
  products wrap, the blend over all 2^24 (region, watermark, alpha) byte
  triples, for every alpha byte at an odd width and an anchor off a
  4-byte word, and at clamped anchors; its (a, 1 - a) table against
  the reference's float32 alpha;
- the port's ``Watermark`` against the reference's, from PNGs written
  with PIL: all seven locations, a PNG larger than a quarter of the frame,
  the array constructor, a seeded RGBA through both packages;
- the frame sources (``SyntheticSource``, ``ArraySource``, ``make_source``
  and its refusal of the unported Wayland source);
- the copied stdlib modules (pipeline ring, content classifier, fault
  registry, metrics, health recorder, tracer, energy meter) on the same
  inputs as the reference's.

Every output is a byte or an integer: tolerance 0.
"""

import dataclasses
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from selkies_tpu.engine import capture as J_cap
from selkies_tpu.engine import content as J_content
from selkies_tpu.engine import pipeline as J_pipe
from selkies_tpu.engine import sources as J_src
from selkies_tpu.engine import watermark as J_wm
from selkies_tpu.obs import energy as J_energy
from selkies_tpu.obs import health as J_health
from selkies_tpu.resilience import faults as J_faults
from selkies_tpu.server import metrics as J_metrics
from selkies_tpu.trace import core as J_trace
from selkies_tpu_torch.engine import content as T_content
from selkies_tpu_torch.engine import pipeline as T_pipe
from selkies_tpu_torch.engine import sources as T_src
from selkies_tpu_torch.engine import watermark as T_wm
from selkies_tpu_torch.obs import energy as T_energy
from selkies_tpu_torch.obs import health as T_health
from selkies_tpu_torch.ops import _cuda
from selkies_tpu_torch.ops import frames as F
from selkies_tpu_torch.resilience import faults as T_faults
from selkies_tpu_torch.server import metrics as T_metrics
from selkies_tpu_torch.trace import core as T_trace

torch.set_num_threads(1)

# ---------------------------------------------------------------- K10

#: (height, width): under 96 rows (per_h floors at 1), a small desktop,
#: the 1080p capture
SYNTH_GEOMS = [(48, 64), (128, 256), (1080, 1920)]
#: 306783379 * 7 and 429496730 * 5 are the first ticks whose products
#: wrap int32 (the bar and the block); 2**31 - 1 wraps all three
SYNTH_TICKS = [0, 1, 95, 1000, 306783379, 429496730, 2**31 - 1]


@pytest.mark.parametrize("tick", SYNTH_TICKS)
@pytest.mark.parametrize("geom", SYNTH_GEOMS)
def test_synthetic_frame_equals_reference(geom, tick):
    h, w = geom
    want = np.asarray(J_src._synthetic_fn(h, w)(jnp.int32(tick)))
    got = F.synthetic_frame(h, w, tick, "cpu")
    assert got.dtype == torch.uint8 and got.shape == (h, w, 3)
    assert np.array_equal(got.numpy(), want)


def test_synthetic_ticks_cover_the_wraps():
    """The wrap ticks do wrap, and the bar and block land where the
    reference's floor modulo puts them (in range, not negative)."""
    assert 306783379 * 7 > 2**31 - 1 and 306783378 * 7 <= 2**31 - 1
    assert 429496730 * 5 > 2**31 - 1
    assert F._wrap32(306783379 * 7) < 0
    assert 0 <= F._wrap32(306783379 * 7) % 1920 < 1920


def test_synthetic_tick_out_of_int32_raises():
    with pytest.raises(OverflowError):
        J_src._synthetic_fn(48, 64)(jnp.int32(2**31))
    with pytest.raises(OverflowError):
        F.synthetic_frame(48, 64, 2**31, "cpu")


# ---------------------------------------------------------------- K11

PAD_CASES = [((1080, 1920), (1088, 1920)), ((60, 64), (64, 64)),
             ((50, 70), (64, 80)), ((64, 64), (64, 64))]


@pytest.mark.parametrize("src,dst", PAD_CASES)
def test_pad_frame_equals_reference(src, dst):
    rng = np.random.default_rng(src[0] * 7 + src[1])
    f = rng.integers(0, 256, (*src, 3), dtype=np.uint8)
    want = np.asarray(J_cap._padder(*src, *dst)(jnp.asarray(f)))
    got = F.pad_frame(torch.as_tensor(f), *dst)
    assert np.array_equal(got.numpy(), want)


def test_pad_frame_checks_its_input():
    f = torch.zeros((64, 64, 3), dtype=torch.uint8)
    with pytest.raises(ValueError):
        F.pad_frame(f, 32, 64)
    with pytest.raises(TypeError):
        F.pad_frame(f.to(torch.int32), 64, 64)
    with pytest.raises(ValueError):
        F.pad_frame(f[:, ::2], 64, 64)


# ---------------------------------------------------------------- K12

def _all_triples():
    """Every (region, watermark, alpha) byte triple once: row k carries
    alpha byte k; each pixel's three channels carry three consecutive
    (region, watermark) pairs of the 65536, the last pixel of a row
    wrapping to the first pairs."""
    q = -(-65536 // 3)
    pairs = np.arange(3 * q) % 65536
    region = (pairs >> 8).astype(np.uint8).reshape(q, 3)
    wm = (pairs & 255).astype(np.uint8).reshape(q, 3)
    frame = np.broadcast_to(region, (256, q, 3)).copy()
    rgba = np.empty((256, q, 4), np.uint8)
    rgba[..., :3] = wm
    rgba[..., 3] = np.arange(256, dtype=np.uint8)[:, None]
    return frame, rgba


def _blend_inputs(rgba):
    # formed exactly as the reference's Watermark forms them
    return (rgba[..., :3].astype(np.float32),
            rgba[..., 3:4].astype(np.float32) / 255.0)


def _table():
    return F.blend_table()


def test_blend_equals_reference_on_every_byte_triple():
    frame, rgba = _all_triples()
    rgb, a = _blend_inputs(rgba)
    assert a.dtype == np.float32
    want = np.asarray(J_wm._blender(0, 0, *rgb.shape[:2])(
        jnp.asarray(frame), jnp.asarray(rgb), jnp.asarray(a)))
    got = F.watermark_blend(torch.as_tensor(frame), torch.as_tensor(rgba),
                            _table(), 0, 0)
    assert np.array_equal(got.numpy(), want)


def test_blend_table_is_the_references_alpha():
    """Row A of the table is the reference's a = float32(A) / 255 and
    its 1 - a in float32, bit for bit."""
    rgba = np.zeros((1, 256, 4), np.uint8)
    rgba[0, :, 3] = np.arange(256)
    _, a = _blend_inputs(rgba)
    t = _table().numpy()
    assert t.dtype == np.float32 and t.shape == (256, 2)
    assert np.array_equal(t[:, 0].view(np.uint32), a[0, :, 0].view(np.uint32))
    oma = np.asarray(1.0 - jnp.asarray(a))[0, :, 0]
    assert np.array_equal(t[:, 1].view(np.uint32), oma.view(np.uint32))


@pytest.mark.parametrize("seed", [0, 1])
def test_table_blend_equals_reference_for_every_alpha(seed):
    """The table-based plain blend against the reference's ``_blender``
    on a seeded region and watermark, row A of the watermark at alpha A:
    every alpha byte over random region and watermark bytes, an odd
    width and an anchor whose bytes start off a 4-byte word."""
    rng = np.random.default_rng(seed)
    frame = rng.integers(0, 256, (300, 61, 3), dtype=np.uint8)
    rgba = rng.integers(0, 256, (256, 37, 4), dtype=np.uint8)
    rgba[..., 3] = np.arange(256, dtype=np.uint8)[:, None]
    y0, x0 = 23, 5 + seed
    want = np.asarray(J_wm._blender(y0, x0, 256, 37)(
        jnp.asarray(frame), *map(jnp.asarray, _blend_inputs(rgba))))
    got = F.watermark_blend(torch.as_tensor(frame.copy()),
                            torch.as_tensor(rgba), _table(), y0, x0)
    assert np.array_equal(got.numpy(), want)


#: anchors past the bottom/right edge, negative (counted from the end),
#: below minus the size, and inside
@pytest.mark.parametrize("y0,x0", [(48, 80), (-3, -7), (-60, -100),
                                   (40, 2), (5, 60), (10, 12)])
def test_blend_clamps_the_anchor_like_dynamic_slice(y0, x0):
    rng = np.random.default_rng(abs(y0 * 100 + x0))
    frame = rng.integers(0, 256, (48, 80, 3), dtype=np.uint8)
    rgba = rng.integers(0, 256, (12, 20, 4), dtype=np.uint8)
    rgb, a = _blend_inputs(rgba)
    want = np.asarray(J_wm._blender(y0, x0, 12, 20)(
        jnp.asarray(frame), jnp.asarray(rgb), jnp.asarray(a)))
    got = F.watermark_blend(torch.as_tensor(frame.copy()),
                            torch.as_tensor(rgba), _table(), y0, x0)
    assert np.array_equal(got.numpy(), want)


def test_blend_checks_its_input():
    frame = torch.zeros((16, 16, 3), dtype=torch.uint8)
    rgba = torch.zeros((20, 4, 4), dtype=torch.uint8)
    with pytest.raises(ValueError):
        F.watermark_blend(frame, rgba, _table(), 0, 0)
    with pytest.raises(TypeError):
        F.watermark_blend(frame, rgba[:8].float(), _table(), 0, 0)
    with pytest.raises(ValueError):
        F.watermark_blend(frame, rgba[:8], _table()[:128], 0, 0)


def test_plain_versions_launch_no_kernel():
    before = dict(_cuda.LAUNCHES)
    F.synthetic_frame(48, 64, 3, "cpu")
    F.pad_frame(torch.zeros((8, 8, 3), dtype=torch.uint8), 16, 16)
    F.watermark_blend(torch.zeros((8, 8, 3), dtype=torch.uint8),
                      torch.zeros((4, 4, 4), dtype=torch.uint8), _table(),
                      0, 0)
    assert _cuda.LAUNCHES == before and _cuda._build_info == {}


# ---------------------------------------------------------- Watermark

FRAME_W, FRAME_H = 96, 60          # visible size; the grid is 96x64


def _png(tmp_path, w, h, seed):
    rng = np.random.default_rng(seed)
    rgba = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
    rgba[: h // 2, :, 3] = 255            # an opaque half and a mixed one
    p = tmp_path / f"wm{w}x{h}.png"
    Image.fromarray(rgba, "RGBA").save(p)
    return str(p)


def _grid_frame(seed=1):
    return np.random.default_rng(seed).integers(0, 256, (64, 96, 3),
                                                dtype=np.uint8)


@pytest.mark.parametrize("loc", range(7))
def test_watermark_equals_reference_at_every_location(tmp_path, loc):
    path = _png(tmp_path, 20, 12, loc)
    ref = J_wm.Watermark(path, loc, FRAME_W, FRAME_H)
    port = T_wm.Watermark(path, loc, FRAME_W, FRAME_H, "cpu")
    assert (port.wh, port.ww, port._y0, port._x0) \
        == (ref.wh, ref.ww, ref._y0, ref._x0)
    frame = _grid_frame(loc)
    got = port.apply(torch.as_tensor(frame))
    assert np.array_equal(got.numpy(), np.asarray(ref.apply(
        jnp.asarray(frame))))
    assert np.array_equal(frame, _grid_frame(loc)), \
        "apply must leave the caller's frame as it is"


def test_watermark_larger_than_a_quarter_is_thumbnailed(tmp_path):
    path = _png(tmp_path, 70, 40, 9)
    ref = J_wm.Watermark(path, 6, FRAME_W, FRAME_H)
    port = T_wm.Watermark(path, 6, FRAME_W, FRAME_H, "cpu")
    assert (port.wh, port.ww) == (ref.wh, ref.ww)
    assert port.ww <= FRAME_W // 4 and port.wh <= FRAME_H // 4
    frame = _grid_frame(2)
    assert np.array_equal(port.apply(torch.as_tensor(frame)).numpy(),
                          np.asarray(ref.apply(jnp.asarray(frame))))


def test_watermark_from_rgba_equals_the_png(tmp_path):
    path = _png(tmp_path, 20, 12, 3)
    rgba = np.asarray(Image.open(path).convert("RGBA"), np.uint8)
    a = T_wm.Watermark(path, 6, FRAME_W, FRAME_H, "cpu")
    b = T_wm.Watermark.from_rgba(rgba, 6, FRAME_W, FRAME_H, "cpu")
    frame = torch.as_tensor(_grid_frame(4))
    assert torch.equal(a.apply(frame), b.apply(frame))
    with pytest.raises(ValueError):
        T_wm.Watermark.from_rgba(rgba[..., :3], 6, FRAME_W, FRAME_H,
                                 "cpu")


@pytest.mark.parametrize("loc", [0, 4, 6])
def test_watermark_from_seeded_rgba_equals_reference(tmp_path, loc):
    """A seeded RGBA (odd width, every alpha byte present) through both
    packages: the reference's ``Watermark`` from it as a PNG, the port's
    from the array; the same anchor and the same stamped frame."""
    rng = np.random.default_rng(40 + loc)
    rgba = rng.integers(0, 256, (13, 23, 4), dtype=np.uint8)
    rgba.reshape(-1, 4)[:256, 3] = np.arange(256, dtype=np.uint8)
    path = tmp_path / "seeded.png"
    Image.fromarray(rgba, "RGBA").save(path)
    ref = J_wm.Watermark(str(path), loc, FRAME_W, FRAME_H)
    port = T_wm.Watermark.from_rgba(rgba, loc, FRAME_W, FRAME_H, "cpu")
    assert (port.wh, port.ww, port._y0, port._x0) \
        == (ref.wh, ref.ww, ref._y0, ref._x0)
    assert port._rgba.dtype == torch.uint8 and torch.equal(
        port._rgba, torch.as_tensor(rgba))
    frame = _grid_frame(loc + 5)
    assert np.array_equal(port.apply(torch.as_tensor(frame)).numpy(),
                          np.asarray(ref.apply(jnp.asarray(frame))))


@pytest.mark.parametrize("path", ["", "/nonexistent.png", "not-a-png"])
def test_maybe_load_degrades_like_the_reference(path, tmp_path):
    if path == "not-a-png":
        path = str(tmp_path / "wm.png")
        pathlib.Path(path).write_bytes(b"this is no image")

    @dataclasses.dataclass
    class S:
        watermark_path: str
        watermark_location: int = 6
    assert T_wm.maybe_load(S(path), 64, 64, "cpu") is None
    assert J_wm.maybe_load(S(path), 64, 64) is None


def test_maybe_load_raises_what_the_device_raises(tmp_path, monkeypatch):
    """Only the PNG's reading degrades; a failure putting the decoded
    watermark on the device propagates."""
    @dataclasses.dataclass
    class S:
        watermark_path: str
        watermark_location: int = 6

    def fail(*a, **k):
        raise RuntimeError("device upload failed")
    path = _png(tmp_path, 8, 8, 5)
    monkeypatch.setattr(T_wm, "upload", fail)
    with pytest.raises(RuntimeError, match="upload failed"):
        T_wm.maybe_load(S(path), 64, 64, "cpu")


def test_watermark_apply_stamps_an_owned_frame_in_place(tmp_path):
    """``apply`` leaves a frame it does not own as it is and stamps a
    copy; an owned frame is stamped in place, with the same bytes."""
    port = T_wm.Watermark(_png(tmp_path, 12, 10, 6), 6, FRAME_W, FRAME_H,
                          "cpu")
    frame = torch.as_tensor(_grid_frame(3))
    before = frame.clone()
    copy = port.apply(frame)
    assert torch.equal(frame, before) and not torch.equal(copy, before)
    same = port.apply(frame, owned=True)
    assert same is frame and torch.equal(frame, copy)


# ------------------------------------------------------------ sources

def test_synthetic_source_and_static_after():
    def pattern(tick):
        return F.synthetic_frame(48, 64, tick, "cpu")
    src = T_src.SyntheticSource(64, 48, static_after=2, device="cpu")
    assert torch.equal(src.get_frame(7), pattern(2))
    moving = T_src.make_source("synthetic", 64, 48, device="cpu")
    assert torch.equal(moving.get_frame(5), pattern(5))
    static = T_src.make_source("synthetic-static", 64, 48,
                               device="cpu")
    assert torch.equal(static.get_frame(5), pattern(0))


def test_array_source_cycles_its_frames():
    frames = [np.full((4, 6, 3), k, np.uint8) for k in range(3)]
    src = T_src.ArraySource(frames, device="cpu")
    assert (src.width, src.height) == (6, 4)
    assert [int(src.get_frame(t)[0, 0, 0]) for t in range(5)] \
        == [0, 1, 2, 0, 1]
    with pytest.raises(ValueError):
        T_src.ArraySource([], device="cpu")


def test_make_source_refuses_the_unported_wayland_source(monkeypatch):
    with pytest.raises(NotImplementedError, match="A5b"):
        T_src.make_source("wayland", 64, 48)
    with pytest.raises(ValueError):
        T_src.make_source("nope", 64, 48)
    # no X server here: 'auto' falls through X11 ...
    monkeypatch.setattr(T_src, "X11Source", _no_x11)
    monkeypatch.delenv("WAYLAND_DISPLAY", raising=False)
    assert isinstance(T_src.make_source("auto", 64, 48, device="cpu"),
                      T_src.SyntheticSource)
    # ... and refuses to stand in for a compositor it cannot capture
    monkeypatch.setenv("WAYLAND_DISPLAY", "wayland-1")
    with pytest.raises(NotImplementedError, match="wayland-1"):
        T_src.make_source("auto", 64, 48, device="cpu")


def _no_x11(*a, **k):
    raise RuntimeError("cannot open X display")


# ----------------------------------------------- copied stdlib modules

def test_pipeline_ring_copy_delivers_like_the_reference():
    got = {}
    for name, mod in (("jax", J_pipe), ("port", T_pipe)):
        seen = []
        ring = mod.PipelineRing(lambda out: seen.append(
            (out["n"], out["slot"])), depth=3)
        for n in range(10):
            ring.submit({"n": n})
        ring.close(drain=True)
        got[name] = seen
    assert got["jax"] == got["port"] == [(n, n % 3) for n in range(10)]


@pytest.mark.parametrize("clamp,depth", [(None, 3), (1, 3), (4, 1),
                                         (None, 0)])
def test_effective_depth_copy(clamp, depth):
    @dataclasses.dataclass
    class S:
        pipeline_depth: int
    assert T_pipe.effective_depth(S(depth), clamp) \
        == J_pipe.effective_depth(S(depth), clamp)


def test_content_classifier_copy_tracks_the_reference():
    rng = np.random.default_rng(11)
    trace = np.concatenate([np.zeros(40), rng.uniform(0.1, 0.4, 60),
                            np.full(60, 0.9), rng.uniform(0.6, 1.0, 80)])
    a, b = J_content.ContentClassifier(), T_content.ContentClassifier()
    for f in trace:
        assert a.update(f) == b.update(f)
    assert a.snapshot() == b.snapshot() and a.transitions > 1
    assert T_content.CONTENT_PROFILES == {
        k: T_content.ContentProfile(**dataclasses.asdict(v))
        for k, v in J_content.CONTENT_PROFILES.items()}


def test_fault_registry_copy_parses_and_fires_like_the_reference():
    spec = ("readback.fetch:error:after=2,count=1;"
            "encoder.dispatch:slow:delay_s=0.5;capture.source:raise")
    assert [s.to_spec() for s in T_faults.parse_spec(spec)] \
        == [s.to_spec() for s in J_faults.parse_spec(spec)]
    assert T_faults.POINTS == J_faults.POINTS
    fired = []
    for mod in (J_faults, T_faults):
        reg = mod.FaultRegistry(seed=3)
        reg.arm("readback.fetch:error:after=2,count=2")
        fired.append([reg.pull("readback.fetch") is not None
                      for _ in range(6)])
    assert fired[0] == fired[1] == [False, False, True, True, False, False]
    with pytest.raises(ValueError):
        T_faults.parse_spec("readback.fetch:explode")


def test_metrics_copy_renders_like_the_reference():
    texts = []
    for mod in (J_metrics, T_metrics):
        mod.clear()
        mod.set_gauge("selkies_fps", 59.5, {"display": ":0"})
        mod.inc_counter("selkies_capture_abandoned_threads_total")
        mod.observe_hist("selkies_stage_ms", 3.0, {"stage": "packetize"})
        texts.append(mod.render_prometheus())
        mod.clear()
    assert texts[0] == texts[1]
    assert T_metrics.device_stats() == []


def test_health_recorder_copy():
    rec = T_health.FlightRecorder(capacity=2)
    for k in ("capture_death", "capture_death", "content_class_change"):
        rec.record(k, display=":0")
    assert rec.counts() == {"capture_death": 2, "content_class_change": 1}
    assert rec.dropped == 1 and len(rec.snapshot()) == 2
    assert all(e["host"] == T_health._host_id() for e in rec.snapshot())
    eng = T_health.HealthEngine()
    eng.register("boom", lambda: 1 / 0)
    assert eng.report()["failing"] == ["boom"]
    assert T_health.worst(["ok", "degraded"]) \
        == J_health.worst(["ok", "degraded"])


def test_host_id_honours_the_override(monkeypatch):
    monkeypatch.setenv("SELKIES_HOST_ID", "pod/7 a")
    assert T_health.host_id() == "pod_7_a"
    monkeypatch.delenv("SELKIES_HOST_ID")
    assert T_health.host_id() == T_health.host_id() != ""


def test_tracer_copy_records_like_the_reference():
    docs = []
    for mod in (J_trace, T_trace):
        tr = mod.FrameTracer(capacity=4)
        tr.enable()
        tr.stage_sink = None
        tl = tr.frame_begin(":0")
        with tr.span("encode.dispatch"):
            pass
        tr.bind(tl, 7)
        tr.record_span(tr.lookup(":0", 7), "encode.readback", tl.t0_ns,
                       lane="slot1")
        tr.frame_end(":0", 7)
        d = tl.to_dict()
        docs.append([(s["name"], s["lane"]) for s in d["spans"]]
                    + [d["frame_id"], tl.done, tr.stats()["frames"]])
    assert docs[0] == docs[1]


def test_energy_meter_copy_counts_frames():
    t = [100.0]
    ref = J_energy.EnergyMeter(clock=lambda: t[0])
    port = T_energy.EnergyMeter(clock=lambda: t[0])
    for _ in range(30):
        t[0] += 0.1
        ref.note_frame()
        port.note_frame()
    assert port.fps_estimate() == ref.fps_estimate() > 0
