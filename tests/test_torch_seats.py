"""The port's multi-seat JPEG encoder, seat frames and capture loop on the
CPU, against the JAX package's ``selkies_tpu.parallel`` (conftest gives
JAX 8 virtual devices; the port runs every seat on the one CPU device).

- ``MultiSeatEncoder`` at the reference tests' geometry (64x64, 32-row
  stripes, tests/test_parallel.py ``SMALL``) over 4 seats: a first full
  tick, ticks in which the seats differ (idle, typing in one stripe,
  fully damaged, scrolled), paint-over, a quality change between encode
  and finalize, a forced resend, and a planned overflow of ONE seat's
  byte buffer (``out_cap`` cut to 1 KiB, which only a noise frame
  exceeds) with the growth and that seat's full resend after it. Every
  tick's chunks per seat and every carried state array are equal,
  tolerance 0; a port encoder loaded with the JAX encoder's state
  mid-sequence continues equal. 16 seats (two per JAX device) as well.
- The seat-stacked step against independent single-seat port sessions.
- ``synthetic_seat_frames`` at ticks 0, 1, 5 and across the int32 wrap.
- ``MultiSeatCapture(device="cpu")``: the capture contracts of
  tests/test_parallel.py for both codecs, depth 2 equal to depth 1, the
  tracer's per-seat lanes and the tunables.

One JAX encoder is built per seat count and its sequence run once per
module (the stock and the grown caps: two compiles for 4 seats, one for
16).
"""

import dataclasses
import io
import time

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from selkies_tpu.engine.types import CaptureSettings as JSettings
from selkies_tpu.parallel import MultiSeatEncoder as JMulti
from selkies_tpu.parallel import seat_mesh as j_seat_mesh
from selkies_tpu.parallel import synthetic_seat_frames as j_frames
from selkies_tpu_torch.engine import state as port_state
from selkies_tpu_torch.engine.encoder import JpegEncoderSession
from selkies_tpu_torch.engine.types import CaptureSettings
from selkies_tpu_torch.ops import frames as F
from selkies_tpu_torch.ops import jpeg_pipeline as JPP
from selkies_tpu_torch.parallel import (MultiSeatCapture, MultiSeatEncoder,
                                        seat_mesh, synthetic_seat_frames)
from selkies_tpu_torch.trace import tracer

torch.set_num_threads(1)

SMALL = dict(capture_width=64, capture_height=64, stripe_height=32,
             jpeg_quality=70, paint_over_delay_frames=2)
N = 4
#: the planned overflow's byte buffer: a seat of the synthetic desktop
#: needs ~500 bytes a tick, a noise frame ~2.3 KB
OUT_CAP = 1024
DEADLINE_S = 30.0


def _frame(tick: int) -> np.ndarray:
    return F.synthetic_frame_plain(64, 64, tick).numpy()


def script() -> list:
    """[(name, (N, 64, 64, 3) frames, force_all, quality before finalize
    or None)]."""
    base = np.stack([_frame(37 * k) for k in range(N)])
    rng = np.random.default_rng(8)
    noise = rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)

    def typed(f, y0, v):
        f = f.copy()
        f[y0:y0 + 8, 8:24] = v
        return f
    t1 = base.copy()                       # seat 0 idle
    t1[1] = typed(base[1], 40, 20)         # typing in stripe 1
    t1[2] = _frame(200)                    # fully damaged
    t1[3] = np.roll(base[3], 8, axis=0)    # scrolled
    t2 = t1.copy()
    t2[2] = _frame(205)
    t3 = t2.copy()
    t3[3] = np.roll(base[3], 16, axis=0)
    t5 = t3.copy()
    t5[0] = typed(t3[0], 4, 250)
    t5[1] = typed(t3[1], 40, 90)
    t5[2] = noise                          # overflows seat 2 alone
    t6 = t5.copy()
    t6[2] = _frame(210)
    t6[3] = typed(t5[3], 12, 30)
    t7 = t6.copy()
    t7[0] = typed(t6[0], 44, 10)
    return [("first", base, True, None), ("mixed", t1, False, None),
            ("paint", t2, False, None), ("quality", t3, False, (40, 80)),
            ("forced", t3, True, None), ("overflow", t5, False, None),
            ("recovery", t6, False, None), ("grown", t7, False, None)]


def _astuples(per_seat):
    return [[dataclasses.astuple(c) for c in chunks] for chunks in per_seat]


def _jax_state(enc, keys=port_state.SEATS_JPEG_STATE) -> dict:
    d = {k: np.asarray(getattr(enc, k)) for k in keys.arrays}
    d.update({k: np.array(getattr(enc, k)) for k in keys.host_arrays})
    d.update({k: getattr(enc, k) for k in keys.scalars})
    return d


def _assert_state(port, want: dict, what: str) -> None:
    got = port_state.session_state_to_numpy(port)
    for k, v in want.items():
        assert np.array_equal(np.asarray(got[k]), np.asarray(v)), \
            f"{what}: {k}"


def _step(enc, frames, force_all, quality):
    out = enc.encode(frames)
    if quality is not None:
        enc.update_quality(*quality)
    return enc.finalize(out, force_all=force_all)


@pytest.fixture(scope="module")
def jax_run():
    """The script through the JAX encoder: [(chunks per seat, state)]."""
    enc = JMulti(JSettings(**SMALL), N, devices=jax.devices()[:N])
    enc._out_cap = OUT_CAP
    enc._step = enc._build_step()
    log = []
    for _, frames, force_all, quality in script():
        per = _step(enc, jax.device_put(frames, enc.input_sharding),
                    force_all, quality)
        log.append((_astuples(per), _jax_state(enc)))
    return enc, log


def _port(n=N, **over) -> MultiSeatEncoder:
    enc = MultiSeatEncoder(CaptureSettings(**dict(SMALL, **over)), n,
                           devices=["cpu"])
    enc._out_cap = OUT_CAP
    enc._rebuild_steps()
    return enc


def test_script_exercises_every_case(jax_run):
    _, log = jax_run
    sent = [[len(c) for c in per] for per, _ in log]
    assert sent[0] == [2] * N                       # first: everything
    assert sent[1][0] == 0 and sent[1][1] == 1 and sent[1][2] == 2
    assert sent[4] == [2] * N                       # forced
    assert sent[5][2] == 0 and all(sent[5][k] for k in (0, 1, 3))
    assert log[5][1]["_force_after_drop"].tolist() == [False] * 2 + \
        [True, False]
    assert log[5][1]["_cap_gen"] == 1 and sent[6][2] == 2
    assert log[6][1]["_out_cap"] == 2 * OUT_CAP
    # paint-over: seat 0, idle since the first tick, is repainted
    assert sent[2][0] == 2


def test_multiseat_equals_jax_tick_by_tick(jax_run):
    _, log = jax_run
    port = _port()
    for (name, frames, force_all, quality), (want, state) in zip(script(),
                                                                 log):
        got = _step(port, frames, force_all, quality)
        assert _astuples(got) == want, name
        _assert_state(port, state, name)


@pytest.mark.parametrize("at", [1, 4, 5])
def test_state_carry_from_jax_mid_sequence(jax_run, at):
    """A port encoder loaded with the JAX encoder's state after tick
    ``at`` continues equal (the caps, growth generation and per-seat drop
    flags included: at 5 the overflow has just grown the buffers)."""
    _, log = jax_run
    port = _port()
    port_state.session_state_from_numpy(port, log[at][1])
    port.update_quality(*((40, 80) if at >= 3 else (70, 90)))
    for (name, frames, force_all, quality), (want, state) in list(
            zip(script(), log))[at + 1:]:
        got = _step(port, frames, force_all, quality)
        assert _astuples(got) == want, name
        _assert_state(port, state, name)


def test_chunks_decode_and_name_their_seats():
    port = _port()
    per = port.finalize(port.encode(script()[0][1]), force_all=True)
    blobs = set()
    for seat, chunks in enumerate(per):
        for c in chunks:
            Image.open(io.BytesIO(c.payload)).load()
            assert c.seat_index == seat and c.display_id == f"seat{seat}"
        blobs.add(b"".join(c.payload for c in chunks))
    assert len(blobs) == N


def test_stacked_step_equals_independent_sessions():
    """The seat-stacked plain step against one single-seat port session
    per seat, through the same script (each session grows its own
    buffers when its seat overflows)."""
    port = _port()
    port._ops = JPP.SEAT_PLAIN_OPS
    port._rebuild_steps()
    sessions = []
    for _ in range(N):
        s = JpegEncoderSession(CaptureSettings(**SMALL), device="cpu")
        s._out_cap = OUT_CAP
        s._rebuild_steps()
        sessions.append(s)
    for name, frames, force_all, quality in script():
        got = _step(port, frames, force_all, quality)
        for k, s in enumerate(sessions):
            want = _step(s, frames[k], force_all, quality)
            want = [dataclasses.replace(c, seat_index=k,
                                        display_id=f"seat{k}") for c in want]
            assert _astuples([got[k]]) == _astuples([want]), (name, k)
            assert torch.equal(port._prev[k], s._prev), (name, k)
            assert torch.equal(port._age[k], s._age), (name, k)


def test_sixteen_seats_two_per_jax_device():
    """16 seats (the reference shards them two per device): first tick
    forced, then a tick where half the seats are idle."""
    kw = dict(SMALL, paint_over_delay_frames=15)
    jenc = JMulti(JSettings(**kw), 16)
    assert jenc.mesh.devices.size == 8
    port = MultiSeatEncoder(CaptureSettings(**kw), 16, devices=["cpu"])
    f0 = np.array(j_frames(jenc, 2))
    f1 = f0.copy()
    f1[8:] = np.asarray(j_frames(jenc, 3))[8:]
    for frames, force_all in ((f0, True), (f1, False)):
        want = jenc.finalize(jenc.encode(jax.device_put(
            frames, jenc.input_sharding)), force_all=force_all)
        got = port.finalize(port.encode(frames), force_all=force_all)
        assert _astuples(got) == _astuples(want)
    assert [len(c) for c in got] == [0] * 8 + [2] * 8
    _assert_state(port, _jax_state(jenc), "16 seats")


@pytest.mark.parametrize("n", [4, 16])
@pytest.mark.parametrize("tick", [0, 1, 5, 2**31 - 50, 2**31 - 1])
def test_synthetic_seat_frames_equal_the_reference(jax_run, n, tick):
    """Seat k at phase k * 37 + tick in int32, which wraps past 2**31 - 1
    (the last seats of the high ticks)."""
    jenc = jax_run[0] if n == N else JMulti(JSettings(**SMALL), n)
    want = np.asarray(j_frames(jenc, tick))
    got = synthetic_seat_frames(_port(n), tick)
    assert got.dtype == torch.uint8 and got.numpy().shape == want.shape
    assert np.array_equal(got.numpy(), want)


def test_synthetic_seat_frames_refuse_a_tick_outside_int32(jax_run):
    with pytest.raises(OverflowError):
        j_frames(jax_run[0], 2**31)
    with pytest.raises(OverflowError):
        synthetic_seat_frames(_port(), 2**31)


def test_seat_entry_plain_is_the_single_frame_per_seat():
    got = F.synthetic_frames(64, 48, 3, 2**31 - 40, device="cpu")
    for k, t in enumerate(F.seat_ticks(3, 2**31 - 40)):
        assert torch.equal(got[k], F.synthetic_frame_plain(64, 48, t))
    assert F.seat_ticks(3, 2**31 - 40)[2] == 2**31 - 40 + 74 - 2**32


@pytest.mark.parametrize("n", [3, 4, 5, 8, 16])
def test_seat_mesh_keeps_the_divide_rule(n):
    assert seat_mesh(n, ["cpu"] * 8).devices.size \
        == j_seat_mesh(n).devices.size


@pytest.mark.parametrize("n_dev", [2, 4])
def test_seats_over_a_device_list_equal_jax_on_as_many(jax_run, n_dev):
    """4 seats on ``["cpu"] * n_dev``: a mesh of ``n_dev`` entries, the
    seat groups one stacked batch on the one device, seat for seat equal
    to the reference encoder over ``n_dev`` devices (4: the whole script;
    2: its first two ticks, one program)."""
    if n_dev == N:
        log = jax_run[1]
    else:
        enc = JMulti(JSettings(**SMALL), N, devices=jax.devices()[:n_dev])
        assert enc.mesh.devices.size == n_dev
        enc._out_cap = OUT_CAP
        enc._step = enc._build_step()
        log = [(_astuples(_step(enc, jax.device_put(
            frames, enc.input_sharding), force_all, quality)),
            _jax_state(enc))
            for _, frames, force_all, quality in script()[:2]]
    port = MultiSeatEncoder(CaptureSettings(**SMALL), N,
                            devices=["cpu"] * n_dev)
    port._out_cap = OUT_CAP
    port._rebuild_steps()
    assert port.mesh.devices.size == n_dev and port.device.type == "cpu"
    for (name, frames, force_all, quality), (want, state) in zip(script(),
                                                                 log):
        got = _step(port, frames, force_all, quality)
        assert _astuples(got) == want, name
        _assert_state(port, state, name)


def test_seats_across_devices_raise():
    with pytest.raises(NotImplementedError, match="A11c"):
        MultiSeatEncoder(CaptureSettings(**SMALL), 4,
                         devices=["cpu", "meta"])
    with pytest.raises(ValueError, match="divide"):
        MultiSeatEncoder(CaptureSettings(**SMALL), 4,
                         mesh=seat_mesh(3, ["cpu"] * 3))


def test_explicit_prev_takes_the_tracked_buffers_place():
    """``encode(frames, prev)``: the reference donates ``prev``; the port
    diffs against it and updates it in place."""
    port = _port()
    frames = script()[0][1]
    prev = port.make_prev_buffer()
    prev[1:] = torch.as_tensor(frames[1:])
    per = port.finalize(port.encode(frames, prev))
    assert [len(c) for c in per] == [2, 0, 0, 0]
    assert port._prev is prev and torch.equal(prev, torch.as_tensor(frames))
    assert port.input_sharding == torch.device("cpu")


# ----------------------------------------------------------- capture loop
def _wait(pred, deadline_s=DEADLINE_S):
    deadline = time.monotonic() + deadline_s
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.01)
    return False


def _capture(n_seats, settings, until):
    got, died = [], []
    cap = MultiSeatCapture(n_seats, device="cpu")
    cap.on_death = died.append
    cap.start_capture(got.append, settings)
    try:
        assert _wait(lambda: until(got) or died)
    finally:
        cap.stop_capture()
    assert not died, died
    return cap, got


def test_multiseat_capture_thread_serves_all_seats():
    """tests/test_parallel.py:107 on the port: one encode loop emits
    decodable chunks for every seat display."""
    _, got = _capture(4, CaptureSettings(
        capture_width=64, capture_height=64, stripe_height=32,
        target_fps=60.0), lambda g: len({c.display_id for c in g}) == 4)
    assert {c.display_id for c in got} == {"seat0", "seat1", "seat2",
                                           "seat3"}
    for c in got[:4]:
        Image.open(io.BytesIO(c.payload)).load()


def test_multiseat_capture_h264_mode():
    """tests/test_parallel.py:181 on the port: the facade honours
    output_mode=h264 end to end; the IDR decodes (the JAX package's
    reference decoder)."""
    from selkies_tpu.codecs import h264_ref_decoder as refdec
    _, got = _capture(2, CaptureSettings(
        capture_width=48, capture_height=32, stripe_height=16,
        output_mode="h264", video_crf=28, use_paint_over=False,
        h264_motion_vrange=2, h264_motion_hrange=1, target_fps=30.0),
        lambda g: len(g) >= 8)
    assert all(c.output_mode == "h264" for c in got)
    assert {c.seat_index for c in got} == {0, 1}
    idr = next(c for c in got if c.is_idr and c.seat_index == 0)
    y, _, _ = refdec.Decoder().decode(idr.payload)
    assert y.shape[1] == 48


@pytest.mark.parametrize("mode", ["jpeg", "h264"])
def test_capture_depth2_equals_depth1_and_the_encoder(mode):
    """Unpaced, the ring at depth 2 delivers what depth 1 does, tick by
    tick in order, and both equal the encoder driven directly on the
    seat frames of each tick (the first JPEG tick is a full send)."""
    kw = dict(capture_width=64, capture_height=64, stripe_height=32,
              target_fps=1000.0)
    if mode == "h264":
        kw.update(output_mode="h264", h264_motion_vrange=2,
                  h264_motion_hrange=1)
    n_ticks = 6
    runs = {}
    for depth in (1, 2):
        _, got = _capture(3, CaptureSettings(pipeline_depth=depth, **kw),
                          lambda g: any(c.frame_id >= n_ticks for c in g))
        order = [c.frame_id for c in got]
        assert order == sorted(order)
        runs[depth] = [[dataclasses.astuple(c) for c in got
                        if c.frame_id == t] for t in range(n_ticks)]
    assert runs[1] == runs[2]
    from selkies_tpu_torch.parallel import MultiSeatH264Encoder
    cls = MultiSeatH264Encoder if mode == "h264" else MultiSeatEncoder
    enc = cls(CaptureSettings(**kw), 3, devices=["cpu"])
    for t in range(n_ticks):
        out = enc.encode(synthetic_seat_frames(enc, t))
        per = enc.finalize(out, force_all=t == 0)
        assert [dataclasses.astuple(c) for s in per for c in s] \
            == runs[1][t], t


def test_capture_traces_per_seat_lanes_and_takes_tunables():
    tracer.clear()
    tracer.enable()
    try:
        cap, _ = _capture(2, CaptureSettings(
            capture_width=64, capture_height=64, stripe_height=32,
            target_fps=1000.0, display_id="seats"), lambda g: len(g) >= 8)
        spans = [(name, lane) for tl in tracer.snapshot()
                 for name, lane, _, _ in tl.spans]
    finally:
        tracer.disable()
        tracer.clear()
    names = {n for n, _ in spans}
    assert {"capture", "encode.dispatch", "encode.readback",
            "packetize"} <= names
    assert {lane for n, lane in spans if n == "packetize"} \
        == {"seat0", "seat1"}
    cap.update_tunables(jpeg_quality=33, paint_over_quality=66)
    assert (cap._enc.settings.jpeg_quality,
            cap._enc.settings.paint_over_quality) == (33, 66)
    cap.set_pipeline_clamp(1)
    assert cap.effective_pipeline_depth() == 1
    with pytest.raises(RuntimeError):
        MultiSeatCapture(2, device="cpu").restart()
