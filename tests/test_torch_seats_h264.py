"""The port's multi-seat H.264 encoder on the CPU against the JAX
package's ``selkies_tpu.parallel.MultiSeatH264Encoder`` (4 seats; JAX on
4 of conftest's 8 virtual devices, the port on the one CPU device).

The reference test's geometry and candidates (tests/test_parallel.py:
48x32, 16-row stripes, motion vrange 2 / hrange 1, crf 28), with
paint-over after 2 idle frames, over a script of a first IDR batch, P
ticks in which the seats differ (idle, typing in one stripe, fully
damaged, scrolled), a paint-over tick, a qp change, a forced IDR batch,
a planned overflow of ONE seat's byte buffer (``out_cap`` cut to 768
bytes, which only a noise frame exceeds) and the IDR batch of every seat
that the overflowed seat's recovery forces, at grown caps. Each tick's
chunks per seat and every carried state array are equal, tolerance 0; a
port encoder loaded with the JAX encoder's state mid-sequence continues
equal. ``fullcolor`` and ``h264_roi_qp``, which the reference's seats do
not read, leave the seats 4:2:0 and equal. The seat-stacked plain step
equals one single-seat port session (the stock step) per seat.

The JAX encoder runs its script once per module: three compiles (the I
and P steps, the I step at the grown caps), and one more for the
fullcolor case.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from selkies_tpu.engine.types import CaptureSettings as JSettings
from selkies_tpu.parallel import MultiSeatH264Encoder as JMulti
from selkies_tpu_torch.engine import state as port_state
from selkies_tpu_torch.engine.h264_encoder import H264EncoderSession
from selkies_tpu_torch.engine.types import CaptureSettings
from selkies_tpu_torch.ops import frames as F
from selkies_tpu_torch.ops import h264_planes as HP
from selkies_tpu_torch.parallel import MultiSeatH264Encoder, seat_mesh

torch.set_num_threads(1)

H, W = 32, 48
SETTINGS = dict(capture_width=W, capture_height=H, stripe_height=16,
                output_mode="h264", video_crf=28, h264_motion_vrange=2,
                h264_motion_hrange=1, paint_over_delay_frames=2)
N = 4
#: the planned overflow's byte buffer: a seat of the synthetic desktop
#: needs ~100-350 bytes a tick, a noise P frame ~1.2 KB
OUT_CAP = 768
KEYS = port_state.SEATS_H264_STATE


def _frame(tick: int) -> np.ndarray:
    return F.synthetic_frame_plain(H, W, tick).numpy()


def script() -> list:
    """[(name, (N, 32, 48, 3) frames, force, qp or None)]."""
    base = np.stack([_frame(37 * k) for k in range(N)])
    noise = np.random.default_rng(9).integers(0, 256, (H, W, 3),
                                              dtype=np.uint8)

    def typed(f, y0, v):
        f = f.copy()
        f[y0:y0 + 6, 8:20] = v
        return f
    t1 = base.copy()                       # seat 0 idle
    t1[1] = typed(base[1], 20, 30)         # typing in stripe 1
    t1[2] = _frame(200)                    # fully damaged
    t1[3] = np.roll(base[3], 2, axis=0)    # scrolled 2 rows
    t2 = t1.copy()
    t2[2] = _frame(203)
    t3 = t2.copy()
    t3[1] = typed(t2[1], 2, 200)
    t3[3] = np.roll(t2[3], -1, axis=0)
    t5 = t3.copy()
    t5[0] = typed(t3[0], 4, 250)
    t5[1] = typed(t3[1], 22, 90)
    t5[2] = noise                          # overflows seat 2 alone
    t5[3] = typed(t3[3], 18, 10)
    t6 = t5.copy()
    t6[2] = _frame(210)
    return [("first", base, False, None), ("mixed", t1, False, None),
            ("paint", t2, False, None), ("qp", t3, False, 32),
            ("forced", t3, True, None), ("overflow", t5, False, None),
            ("recovery", t6, False, None)]


def _astuples(per_seat):
    return [[dataclasses.astuple(c) for c in chunks] for chunks in per_seat]


def _jax_state(enc) -> dict:
    d = {k: np.asarray(getattr(enc, k)) for k in KEYS.arrays}
    d.update({k: np.array(getattr(enc, k)) for k in KEYS.host_arrays})
    d.update({k: getattr(enc, k) for k in KEYS.scalars})
    return d


def _assert_state(port, want: dict, what: str) -> None:
    got = port_state.session_state_to_numpy(port)
    for k, v in want.items():
        assert np.array_equal(np.asarray(got[k]), np.asarray(v)), \
            f"{what}: {k}"


def _step(enc, frames, force, qp):
    if qp is not None:
        enc.qp = qp
        enc.paint_qp = min(enc.paint_qp, qp)
    return enc.finalize(enc.encode(frames, force=force))


def _shrink(enc, jax_side: bool):
    enc._out_cap = OUT_CAP
    if jax_side:
        enc._i_step, enc._p_step = enc._build("i"), enc._build("p")
    else:
        enc._rebuild_steps()
    return enc


@pytest.fixture(scope="module")
def jax_run():
    enc = _shrink(JMulti(JSettings(**SETTINGS), N,
                         devices=jax.devices()[:N]), True)
    log = []
    for _, frames, force, qp in script():
        per = _step(enc, jax.device_put(frames, enc.input_sharding), force,
                    qp)
        log.append((_astuples(per), _jax_state(enc)))
    return enc, log


def _port(**over) -> MultiSeatH264Encoder:
    return _shrink(MultiSeatH264Encoder(
        CaptureSettings(**dict(SETTINGS, **over)), N, devices=["cpu"]),
        False)


def test_script_exercises_every_case(jax_run):
    _, log = jax_run
    chunks = [per for per, _ in log]
    sent = [[len(c) for c in per] for per in chunks]
    idr = [all(c[5] for seat in per for c in seat) for per in chunks]
    assert idr == [True, False, False, False, True, False, True]
    assert sent[0] == [2] * N and sent[4] == [2] * N and sent[6] == [2] * N
    assert sent[1] == [0, 1, 2, 2]      # idle, typing, damaged, scrolled
    assert sent[2][0] == 2               # seat 0 repainted
    assert sent[5][2] == 0 and all(sent[5][k] for k in (0, 1, 3))
    assert log[5][1]["_force_after_drop"].tolist() == [False, False, True,
                                                       False]
    assert log[5][1]["_cap_gen"] == 1 and log[5][1]["_out_cap"] \
        == 2 * OUT_CAP
    assert not log[6][1]["_force_after_drop"].any()
    assert log[3][1]["qp"] == 32


def test_multiseat_h264_equals_jax_tick_by_tick(jax_run):
    _, log = jax_run
    port = _port()
    for (name, frames, force, qp), (want, state) in zip(script(), log):
        got = _step(port, frames, force, qp)
        assert _astuples(got) == want, name
        _assert_state(port, state, name)


@pytest.mark.parametrize("at", [1, 3, 4, 5])
def test_state_carry_from_jax_mid_sequence(jax_run, at):
    """A port encoder loaded with the JAX encoder's state after tick
    ``at`` (qp, caps, growth generation and per-seat drop flags
    included) continues equal."""
    _, log = jax_run
    port = _port()
    port_state.session_state_from_numpy(port, log[at][1])
    for (name, frames, force, qp), (want, state) in list(
            zip(script(), log))[at + 1:]:
        got = _step(port, frames, force, qp)
        assert _astuples(got) == want, name
        _assert_state(port, state, name)


def test_fullcolor_and_roi_qp_are_not_read(jax_run):
    """The reference's seats run the 4:2:0 stock step whatever
    ``fullcolor``, ``h264_partial_encode`` and ``h264_roi_qp`` say: the
    port builds (no NotImplementedError for ROI QP) with 4:2:0 caps,
    planes and SPS, and its IDR batch equals the JAX encoder's under the
    same settings."""
    over = dict(fullcolor=True, h264_roi_qp=True, h264_partial_encode=True)
    jenc = JMulti(JSettings(**dict(SETTINGS, **over)), N,
                  devices=jax.devices()[:N])
    port = MultiSeatH264Encoder(CaptureSettings(**dict(SETTINGS, **over)),
                                N, devices=["cpu"])
    assert (port._e_cap, port._w_cap, port._out_cap) \
        == (jenc._e_cap, jenc._w_cap, jenc._out_cap)
    assert port._sps_pps == jenc._sps_pps == jax_run[0]._sps_pps
    assert tuple(port._ref_u.shape) == (N, H // 2, W // 2)
    frames = script()[0][1]
    want = jenc.finalize(jenc.encode(jax.device_put(frames,
                                                    jenc.input_sharding)))
    assert _astuples(port.finalize(port.encode(frames))) == _astuples(want)
    assert _astuples(want) == jax_run[1][0][0]
    _assert_state(port, _jax_state(jenc), "fullcolor")


def test_stacked_step_equals_independent_sessions():
    """The seat-stacked plain step against one single-seat port session
    per seat in the stock configuration (what the seats run), each
    forced into the IDR batches the seats run, through the same script
    (each session grows its own buffers when its seat overflows)."""
    port = _port()
    port._ops = HP.SEAT_PLAIN_OPS
    port._rebuild_steps()
    sessions = []
    for _ in range(N):
        s = H264EncoderSession(CaptureSettings(**dict(
            SETTINGS, h264_partial_encode=False)), device="cpu")
        s._out_cap = OUT_CAP
        s._rebuild_steps()
        sessions.append(s)
    for name, frames, force, qp in script():
        if qp is not None:
            port.qp = qp
            for s in sessions:
                s.set_qp(qp)
        out = port.encode(frames, force=force)
        got = port.finalize(out)
        for k, s in enumerate(sessions):
            want = s.finalize(s.encode(frames[k], force=out["intra"]))
            want = [dataclasses.replace(c, seat_index=k,
                                        display_id=f"seat{k}") for c in want]
            assert _astuples([got[k]]) == _astuples([want]), (name, k)
            for key in ("_prev", "_age", "_sent", "_fnum", "_ref_y",
                        "_ref_u", "_ref_v"):
                assert torch.equal(getattr(port, key)[k],
                                   getattr(s, key)), (name, k, key)


@pytest.mark.parametrize("n_dev", [2, 4])
def test_seats_over_a_device_list_equal_jax_on_as_many(jax_run, n_dev):
    """4 seats on ``["cpu"] * n_dev``: a mesh of ``n_dev`` entries, the
    seat groups one stacked batch on the one device, seat for seat equal
    to the reference encoder over ``n_dev`` devices (4: the whole script;
    2: its first two ticks, one program)."""
    if n_dev == N:
        log = jax_run[1]
    else:
        enc = _shrink(JMulti(JSettings(**SETTINGS), N,
                             devices=jax.devices()[:n_dev]), True)
        assert enc.mesh.devices.size == n_dev
        log = [(_astuples(_step(enc, jax.device_put(frames,
                                                    enc.input_sharding),
                                force, qp)), _jax_state(enc))
               for _, frames, force, qp in script()[:2]]
    port = _shrink(MultiSeatH264Encoder(CaptureSettings(**SETTINGS), N,
                                        devices=["cpu"] * n_dev), False)
    assert port.mesh.devices.size == n_dev and port.device.type == "cpu"
    for (name, frames, force, qp), (want, state) in zip(script(), log):
        assert _astuples(_step(port, frames, force, qp)) == want, name
        _assert_state(port, state, name)


def test_seats_across_devices_raise():
    with pytest.raises(NotImplementedError, match="A11c"):
        MultiSeatH264Encoder(CaptureSettings(**SETTINGS), 4,
                             devices=["cpu", "meta"])
    with pytest.raises(ValueError, match="divide"):
        MultiSeatH264Encoder(CaptureSettings(**SETTINGS), 4,
                             mesh=seat_mesh(3, ["cpu"] * 3))


def _pack_inputs(rng, n_seats, rows, mb_w, w_cap_bits, intra):
    """Random K4 inputs for ``n_seats`` seats of ``rows`` MB rows: every
    slot of seat 0's last row carries bits, so it overflows
    ``w_cap_bits`` and spills into the words after it. P rows leave
    header slot 0 (the skip run K4 fills) empty, as K2-P does."""
    R = n_seats * rows
    hdr_nb = rng.integers(0, 8, (R, mb_w, HP.HDR_SLOTS)).astype(np.int32)
    if not intra:
        hdr_nb[..., 0] = 0
    ev_nb = rng.integers(0, 3, (R, mb_w, HP.SB_P)).astype(np.uint8)
    ev_nb[rows - 1] = 16
    assert ev_nb[rows - 1].sum() > w_cap_bits
    pay = rng.integers(0, 1 << 16, (R, mb_w, HP.SB_P)).astype(np.int32)
    hdr_pay = rng.integers(0, 1 << 8, (R, mb_w, HP.HDR_SLOTS)).astype(
        np.int32)
    t = torch.as_tensor
    return (t(hdr_pay) & ((1 << t(hdr_nb)) - 1), t(hdr_nb),
            t(pay) & ((1 << t(ev_nb).to(torch.int32)) - 1), t(ev_nb),
            t(rng.integers(0, 64, (R, 2)).astype(np.int32)),
            t(np.full((R, 2), 6, np.int32)),
            t(rng.integers(0, 16, (R,)).astype(np.int32)),
            t(rng.integers(10, 40, (R,)).astype(np.int32)))


@pytest.mark.parametrize("intra", [False, True])
def test_pack_stream_seats_keeps_each_seat_in_its_own_bounds(intra):
    """K4's seat entry on the CPU: each seat packed as its own frame —
    its own words (seat 0's overflowing last row spills no bits into
    seat 1), byte buffer and flags."""
    rows, mb_w, w_cap = 3, 4, 256
    args = _pack_inputs(np.random.default_rng(3), 2, rows, mb_w,
                        32 * w_cap, intra)
    st = HP.pack_stream_seats(*args, intra, 10**6, w_cap, 4096, n_seats=2)
    assert st.data.shape == (2, 4096) and st.flags.shape == (2, 2)
    assert st.flags[:, 0].tolist() == [1, 0]
    for k in range(2):
        one = HP.pack_stream(*(a[k * rows:(k + 1) * rows] for a in args),
                             intra, 10**6, w_cap, 4096)
        sl = slice(k * rows, (k + 1) * rows)
        assert torch.equal(st.words[sl], one.words)
        assert torch.equal(st.total_bits[sl], one.total_bits)
        assert torch.equal(st.byte_lens[sl], one.byte_lens)
        assert torch.equal(st.data[k], one.data)
        assert torch.equal(st.flags[k], one.flags)
    with pytest.raises(ValueError, match="seats"):
        HP.pack_stream_seats(*args, intra, 10**6, w_cap, 4096, n_seats=4)
