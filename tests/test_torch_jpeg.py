"""The port's JPEG slice against the JAX package, exact.

Every module of the JPEG stripe session (selkies_tpu_torch/ops/
jpeg_planes.py, jpeg_entropy.py, bitpack.py, stripes.py pad_ones,
jpeg_pipeline.py, codecs/jpeg.py, engine/encoder.py) is held against its
selkies_tpu counterpart on seeded numpy inputs, and the session against
the JAX ``JpegEncoderSession`` frame by frame: the first frame, damaged
stripes, idle frames, paint-over, a forced resend, a quality change
between encode and finalize, an overflow episode with growth and the
resend after it, 4:4:4, finalize_stream against finalize, and the state
carried across mid-sequence in both directions. PIL decodes every chunk.

Tolerance: 0 — every output is an integer or a byte. The forward is also
run with quantisation tables of 1/16, so a coefficient one ulp off would
show. Geometries are small (the JAX steps compile once per geometry and
buffer-cap pair, ~10 s each on the CPU).
"""

import dataclasses
import io

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from selkies_tpu.codecs import jpeg as J_codec
from selkies_tpu.engine import encoder as J_enc
from selkies_tpu.engine.types import CaptureSettings as JSettings
from selkies_tpu.ops import bitpack as J_bp
from selkies_tpu.ops import jpeg_entropy as J_ent
from selkies_tpu.ops import jpeg_planes as J_pl
from selkies_tpu.ops import stripes as J_st
from selkies_tpu_torch.codecs import jpeg as T_codec
from selkies_tpu_torch.engine import encoder as T_enc
from selkies_tpu_torch.engine import state as T_state
from selkies_tpu_torch.engine.types import CaptureSettings as TSettings
from selkies_tpu_torch.ops import _cuda
from selkies_tpu_torch.ops import bitpack as T_bp
from selkies_tpu_torch.ops import dct as T_dct
from selkies_tpu_torch.ops import jpeg_entropy as T_ent
from selkies_tpu_torch.ops import jpeg_pipeline as T_pipe
from selkies_tpu_torch.ops import jpeg_planes as T_pl
from selkies_tpu_torch.ops import stripes as T_st
from tests.test_torch_csc import _tie_frame

torch.set_num_threads(1)

_J_FWD = {"420": jax.jit(J_pl.jpeg_forward_420),
          "444": jax.jit(J_pl.jpeg_forward_444)}
_T_FWD = {"420": T_pl.jpeg_forward_420, "444": T_pl.jpeg_forward_444}


# ------------------------------------------------------------------ frames
def _frame(kind: str, seed: int, h: int = 64, w: int = 128) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "random":
        return rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    if kind == "flat":
        return np.broadcast_to(rng.integers(0, 256, 3, dtype=np.uint8),
                               (h, w, 3)).copy()
    if kind == "text":
        # dark 2x2-pixel glyph dots on a light background
        f = np.full((h, w, 3), 236, np.uint8)
        dots = rng.random((h // 2, w // 2)) < 0.3
        f[np.repeat(np.repeat(dots, 2, 0), 2, 1)] = (20, 24, 30)
        return f
    if kind == "noise":
        # low-amplitude noise over a gradient (camera-like content)
        g = np.linspace(40, 200, w)[None, :, None] + np.zeros((h, 1, 3))
        n = rng.normal(0, 6, (h, w, 3))
        return np.clip(g + n, 0, 255).astype(np.uint8)
    if kind == "ties":
        return _tie_frame(seed, h, w)
    raise ValueError(kind)


KINDS = ("random", "flat", "text", "noise", "ties")
QUALITIES = (10, 60, 90, 100, "ulp")


def _tables(q):
    """(qy, qc) float32 raster tables for a quality, or 1/16 tables."""
    if q == "ulp":
        t = np.full(64, 1 / 16, np.float32)
        return t, t
    return tuple(J_codec.scale_qtable(b, q).astype(np.float32)
                 for b in (J_codec.STD_LUMA_QUANT, J_codec.STD_CHROMA_QUANT))


# ----------------------------------------------------------- table copies
@pytest.mark.parametrize("name", [
    "STD_LUMA_QUANT", "STD_CHROMA_QUANT", "DC_LUMA_BITS", "DC_LUMA_VALS",
    "DC_CHROMA_BITS", "DC_CHROMA_VALS", "AC_LUMA_BITS", "AC_LUMA_VALS",
    "AC_CHROMA_BITS", "AC_CHROMA_VALS"])
def test_codec_tables_equal_reference(name):
    assert np.array_equal(np.asarray(getattr(T_codec, name)),
                          np.asarray(getattr(J_codec, name)))


def test_codec_functions_equal_reference():
    from selkies_tpu.ops import dct as J_dct
    assert np.array_equal(T_dct.dct8_matrix(), J_dct.dct8_matrix())
    assert np.array_equal(T_dct.zigzag_order(), J_dct.zigzag_order())
    for q in range(0, 102):
        for b in (J_codec.STD_LUMA_QUANT, J_codec.STD_CHROMA_QUANT):
            assert np.array_equal(T_codec.scale_qtable(b, q),
                                  J_codec.scale_qtable(b, q))
    for kind in ("dc_luma", "dc_chroma", "ac_luma", "ac_chroma"):
        for a, b in zip(T_codec._huff_lut(kind), J_codec._huff_lut(kind)):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    for args in ((4, 8, "420"), (2, 6, "444")):
        for a, b in zip(T_codec._mcu_block_order(*args)[:2],
                        J_codec._mcu_block_order(*args)[:2]):
            assert np.array_equal(a, b)
    raw = np.array([1, 0xFF, 0xFF, 7, 0xFF], np.uint8)
    assert T_codec.stuff_ff_bytes(raw) == J_codec.stuff_ff_bytes(raw)
    qy, qc = _tables(75)
    for sub in ("420", "444"):
        assert T_codec.assemble_jfif(16, 32, b"\x12\x34", qy, qc, sub) \
            == J_codec.assemble_jfif(16, 32, b"\x12\x34", qy, qc, sub)


def test_tables_header_is_rendered_from_the_tables():
    from pathlib import Path
    text = (Path(T_pl.__file__).parent.parent / "csrc"
            / "jpeg_tables.cuh").read_text()
    assert text == _cuda.render_jpeg_tables_header()


# ------------------------------------------------------------- the forward
@pytest.mark.parametrize("q", QUALITIES)
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("sub", ["420", "444"])
def test_forward_equals_reference(sub, kind, q):
    rgb = _frame(kind, 3)
    qy, qc = _tables(q)
    ref = [np.asarray(a) for a in _J_FWD[sub](jnp.asarray(rgb), qy, qc)]
    got = [a.numpy() for a in _T_FWD[sub](torch.from_numpy(rgb), qy, qc)]
    for r, g in zip(ref, got):
        assert g.dtype == np.int16 and g.shape == r.shape
        assert np.array_equal(r, g)


@pytest.mark.parametrize("sub", ["420", "444"])
def test_forward_plain_per_stripe_tables(sub):
    """K7's plain version: stripe s uses the paint tables where tab[s]
    is 1 — equal to the reference forward run stripe by stripe — and
    prev becomes the frame."""
    rgb = _frame("random", 4)
    S, sh = 4, 16
    tab = np.array([0, 1, 1, 0], np.int32)
    tabs = [_tables(60), _tables(90)]
    qt = np.stack([t for pair in tabs for t in pair])
    prev = torch.zeros((64, 128, 3), dtype=torch.uint8)
    got = T_pl.jpeg_forward(torch.from_numpy(rgb), prev, torch.from_numpy(tab),
                            torch.from_numpy(qt), sub)
    for s in range(S):
        ref = _J_FWD[sub](jnp.asarray(rgb[s * sh:(s + 1) * sh]),
                          *tabs[tab[s]])
        for r, g in zip(ref, got):
            n = len(r)
            assert np.array_equal(np.asarray(r), g.numpy()[s * n:(s + 1) * n])
    assert np.array_equal(prev.numpy(), rgb)


def test_fma_emulation_is_one_rounding():
    """The plain forward's float32 FMA: against exact rational arithmetic
    rounded once, including sums that land between two float32 values
    only after the product's low bits count."""
    from fractions import Fraction
    rng = np.random.default_rng(9)
    a = rng.normal(0, 100, 4000).astype(np.float32)
    b = rng.normal(0, 1, 4000).astype(np.float32)
    c = (-(a.astype(np.float64) * b) + rng.normal(0, 1e-4, 4000)) \
        .astype(np.float32)
    got = T_pl._fma32(torch.from_numpy(a), torch.from_numpy(b),
                      torch.from_numpy(c)).numpy()
    for x, y, z, g in zip(a, b, c, got):
        exact = Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z))
        # nearest float32, ties to even
        lo = np.float32(float(exact))
        cands = [np.nextafter(lo, np.float32(-np.inf)), lo,
                 np.nextafter(lo, np.float32(np.inf))]
        dist = [abs(Fraction(float(v)) - exact) for v in cands]
        best = min(dist)
        near = [v for v, d in zip(cands, dist) if d == best]
        want = near[0] if len(near) == 1 else \
            [v for v in near if (np.float32(v).view(np.uint32) & 1) == 0][0]
        assert g == want


# ----------------------------------------------------------- entropy events
def _jax_events(y, cb, cr, layout, monkeypatch):
    """The reference's (payload, nbits) slots: jpeg_entropy_device with
    its packer replaced by one that hands them back."""
    monkeypatch.setattr(J_ent, "default_packer",
                        lambda: lambda p, n, e_cap, w_cap: (p, n))
    p, n = jax.jit(lambda a, b, c: J_ent.jpeg_entropy_device(
        a, b, c, layout, 1, 1))(y, cb, cr)
    return np.asarray(p), np.asarray(n)


def _capped_planes(sub):
    """Coefficients of a random frame at quality 100, with AC values past
    the 10-bit cap and DC steps past the 11-bit cap."""
    rgb = _frame("random", 5, 32, 64)
    y, cb, cr = (a.numpy().copy() for a in _T_FWD[sub](
        torch.from_numpy(rgb), *_tables(100)))
    y[0, 5], y[1, 9], cb[0, 3] = 1500, -1100, 1024
    y[:8, 0] = [1024, -1024] * 4
    return y, cb, cr


@pytest.mark.parametrize("kind", ["random", "text", "capped"])
@pytest.mark.parametrize("sub", ["420", "444"])
def test_entropy_events_equal_reference(sub, kind, monkeypatch):
    if kind == "capped":
        planes = _capped_planes(sub)
    else:
        rgb = _frame(kind, 6, 32, 64)
        planes = [a.numpy() for a in _T_FWD[sub](torch.from_numpy(rgb),
                                                 *_tables(60))]
    layout = T_ent.scan_layout(4, 8, sub)
    jl = J_ent.scan_layout(4, 8, sub)
    for a, b in zip(layout, jl):
        assert np.array_equal(a, b)
    ref_p, ref_n = _jax_events(*planes, jl, monkeypatch)
    pay, nb = T_ent.jpeg_events(*(torch.from_numpy(p) for p in planes),
                                T_ent.scan_maps(layout, "cpu"), 1)
    assert pay.dtype == torch.int32 and nb.dtype == torch.uint8
    assert np.array_equal(pay[0].numpy().view(np.uint32), ref_p)
    assert np.array_equal(nb[0].numpy().astype(np.int32), ref_n)


def test_entropy_events_per_stripe():
    """Several stripes in one call equal one call per stripe."""
    rgb = _frame("text", 7, 64, 64)
    planes = _T_FWD["420"](torch.from_numpy(rgb), *_tables(60))
    scan = T_ent.scan_maps(T_ent.scan_layout(2, 8, "420"), "cpu")
    pay, nb = T_ent.jpeg_events_plain(*planes, scan, 4)
    for s in range(4):
        one = T_ent.jpeg_events_plain(
            *(p.reshape(4, -1, 64)[s] for p in planes), scan, 1)
        assert torch.equal(pay[s], one[0][0]) and torch.equal(nb[s],
                                                               one[1][0])


@pytest.mark.parametrize("sub", ["420", "444"])
def test_entropy_device_equals_reference(sub):
    """jpeg_entropy_device (events + the scatter packer) against the
    reference's, words and flags, with a word cap that overflows."""
    rgb = _frame("random", 8, 32, 64)
    planes = [a.numpy() for a in _T_FWD[sub](torch.from_numpy(rgb),
                                             *_tables(90))]
    layout = J_ent.scan_layout(4, 8, sub)
    for w_cap in (4096, 64):
        ref = J_ent.jpeg_entropy_device(*planes, layout, 10 ** 6, w_cap)
        got = T_ent.jpeg_entropy_device(*planes, layout, 10 ** 6, w_cap)
        assert np.array_equal(got.words.numpy().view(np.uint32),
                              np.asarray(ref.words))
        assert int(got.total_bits) == int(ref.total_bits)
        assert int(got.n_events) == int(ref.n_events)
        assert bool(got.overflow) == bool(ref.overflow) == (w_cap == 64)


def test_finalize_scan_bytes_equals_reference():
    rng = np.random.default_rng(10)
    words = rng.integers(0, 1 << 32, 40, dtype=np.uint64).astype(np.uint32)
    for bits in (0, 7, 8, 333, 1280):
        assert T_ent.finalize_scan_bytes(words, bits) \
            == J_ent.finalize_scan_bytes(words, bits)


# ------------------------------------------------------------------ packer
def _events(seed, m=24, s=64, max_bits=27, density=0.3):
    rng = np.random.default_rng(seed)
    nb = rng.integers(1, max_bits + 1, (m, s)).astype(np.int32)
    nb[rng.random((m, s)) > density] = 0
    pay = (rng.integers(0, 1 << 31, (m, s), dtype=np.int64)
           & ((1 << nb.astype(np.int64)) - 1)).astype(np.uint32)
    return pay, nb


PACKERS = {"gather": J_bp.pack_slot_events,
           "scatter": J_bp.pack_slot_events_scatter,
           "bitmerge": J_bp.pack_slot_events_bitmerge}


@pytest.mark.parametrize("w_cap", [512, 20])
@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("packer", list(PACKERS))
def test_plain_packer_equals_every_reference_packer(packer, seed, w_cap):
    pay, nb = _events(seed)
    e_cap = 24 * 64
    ref = jax.jit(lambda p, n: PACKERS[packer](p, n, e_cap=e_cap,
                                               w_cap=w_cap))(pay, nb)
    got = T_bp.pack_slot_events_scatter(torch.from_numpy(pay.view(np.int32)),
                                        torch.from_numpy(nb), e_cap, w_cap)
    assert np.array_equal(got.words.numpy().view(np.uint32),
                          np.asarray(ref.words))
    assert int(got.total_bits) == int(ref.total_bits)
    assert int(got.n_events) == int(ref.n_events)
    assert bool(got.overflow) == bool(ref.overflow) == (w_cap == 20)


def test_plain_packer_event_cap_flag():
    pay, nb = _events(3)
    n = int((nb > 0).sum())
    for e_cap in (n, n - 1):
        ref = J_bp.pack_slot_events_scatter(pay, nb, e_cap, 512)
        got = T_bp.pack_slot_events_scatter(
            torch.from_numpy(pay.view(np.int32)), torch.from_numpy(nb),
            e_cap, 512)
        assert bool(got.overflow) == bool(ref.overflow) == (e_cap < n)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_words_to_bytes_pad_ones(seed):
    s, wc = 5, 7
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 1 << 32, (s, wc), dtype=np.uint64) \
        .astype(np.uint32)
    bits = rng.integers(0, wc * 32 + 1, s).astype(np.int32)
    bits[0] = wc * 32 + 9          # longer than its row: nothing to pad
    jb, jl = jax.jit(lambda w, b: J_st.words_to_bytes_device(
        w, b, pad_ones=True))(words, bits)
    tb, tl = T_st.words_to_bytes_device(
        torch.from_numpy(words.view(np.int32)), torch.from_numpy(bits),
        pad_ones=True)
    assert np.array_equal(tb.numpy(), np.asarray(jb))
    assert np.array_equal(tl.numpy(), np.asarray(jl))


def test_words_to_bytes_host_equals_reference():
    rng = np.random.default_rng(4)
    words = rng.integers(0, 1 << 32, 9, dtype=np.uint64).astype(np.uint32)
    for bits in (0, 5, 64, 250):
        for pad in (True, False):
            assert T_bp.words_to_bytes(words, bits, pad) \
                == J_bp.words_to_bytes(words, bits, pad)


@pytest.mark.parametrize("caps", [(10 ** 6, 512, 4096), (10 ** 6, 40, 4096),
                                  (10 ** 6, 512, 300), (50, 512, 4096)])
def test_jpeg_pack_plain_equals_reference_tail(caps):
    """K9's plain version against the reference step's tail: the scatter
    packer per stripe, words_to_bytes_device(pad_ones=True) and
    concat_stripe_bytes."""
    e_cap, w_cap, out_cap = caps
    evs = [_events(20 + k, m=6) for k in range(3)]
    pay = np.stack([e[0] for e in evs])
    nb = np.stack([e[1] for e in evs])

    def ref_fn(p, n):
        ps = jax.vmap(lambda a, b: J_bp.pack_slot_events_scatter(
            a, b, e_cap, w_cap))(p, n)
        sb, sl = J_st.words_to_bytes_device(ps.words, ps.total_bits)
        buf = J_st.concat_stripe_bytes(sb, sl, out_cap)
        return ps, buf
    ps, buf = jax.jit(ref_fn)(pay, nb)
    got = T_pipe.jpeg_pack(torch.from_numpy(pay.view(np.int32)),
                           torch.from_numpy(nb.astype(np.uint8)), e_cap,
                           w_cap, out_cap)
    assert np.array_equal(got.words.numpy().view(np.uint32),
                          np.asarray(ps.words))
    assert np.array_equal(got.total_bits.numpy(), np.asarray(ps.total_bits))
    assert np.array_equal(got.n_events.numpy(), np.asarray(ps.n_events))
    assert np.array_equal(got.data.numpy(), np.asarray(buf.data))
    assert np.array_equal(got.byte_lens.numpy(), np.asarray(buf.byte_lens))
    assert got.flags.tolist() == [int(np.asarray(ps.overflow).any()),
                                  int(buf.overflow)]


def test_jpeg_encode_device_equals_reference():
    from selkies_tpu.ops import jpeg_pipeline as J_pipe
    rgb = _frame("text", 11, 32, 64)
    qy, qc = _tables(60)
    ref = J_pipe.jpeg_encode_device(jnp.asarray(rgb), qy, qc, "420",
                                    e_cap=4096, w_cap=1024)
    got = T_pipe.jpeg_encode_device(rgb, qy, qc, "420", 4096, 1024,
                                    device="cpu")
    assert np.array_equal(got.words.numpy().view(np.uint32),
                          np.asarray(ref.words))
    assert int(got.total_bits) == int(ref.total_bits)
    assert bool(got.overflow) == bool(ref.overflow)


# ----------------------------------------------------------------- session
PAINT_DELAY = 2
GEOMS = {"420": dict(capture_width=96, capture_height=60, stripe_height=16),
         "444": dict(capture_width=48, capture_height=40, stripe_height=16,
                     fullcolor=True)}


def _settings(cls, sub):
    return cls(**GEOMS[sub], paint_over_delay_frames=PAINT_DELAY)


def _session_frames(h, w):
    rng = np.random.default_rng(12)
    f0 = _frame("text", 13, h, w)
    f0[: h // 2, : w // 2] = rng.integers(0, 256, (h // 2, w // 2, 3))
    f1 = f0.copy()
    f1[2:6, 4:20] = (250, 10, 10)               # damage in stripe 0
    f2 = f1.copy()
    f2[-10:, :] = 255 - f2[-10:, :]              # damage in the last stripe
    f3 = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)   # all damaged
    f4 = f3.copy()
    f4[20:24, 8:12] = 0
    return f0, f1, f2, f3, f4


#: (frame index, action): "" plain frame, "force" finalize(force_all),
#: "quality" a quality change between encode and finalize, "shrink"
#: out_cap shrunk below the frame first (the overflow episode)
SCRIPT = [(0, ""), (1, ""), (1, ""), (1, ""), (1, ""), (1, "force"),
          (2, "quality"), (2, ""), (3, "shrink"), (3, ""), (4, ""),
          (4, ""), (4, "")]
CARRY_AT = 4


def _shrunk_cap(sub) -> int:
    """An out_cap below the all-damaged frame's bytes at the script's
    quality by then (from a plain run of the port), so that frame
    overflows and, once doubled, the next ones do not."""
    sess = T_enc.JpegEncoderSession(_settings(TSettings, sub), device="cpu")
    sess.update_quality(30, 30)
    frames = _session_frames(sess.grid.height, sess.grid.width)
    out = sess.encode(frames[3])
    lens = out["control"].wait()[0]
    return int(lens.sum()) * 2 // 3


def _step(sess, frame, action, jax_side, cap, stream=False):
    if action == "shrink":
        sess._out_cap = cap
        if jax_side:
            sess._step = sess._build_step()
        else:
            sess._rebuild_steps()
    out = sess.encode(jnp.asarray(frame) if jax_side else frame)
    if action == "quality":
        sess.update_quality(30, 30)
    fin = sess.finalize_stream if stream else sess.finalize
    chunks = list(fin(out, force_all=action == "force"))
    return [dataclasses.astuple(c) for c in chunks]


def _snap(sess):
    return {"prev": np.asarray(sess._prev).copy(),
            "age": np.asarray(sess._age).copy(),
            "caps": (sess._w_cap, sess._out_cap, sess._cap_gen),
            "force": sess._force_after_drop, "fid": sess.frame_id}


def _run(sess, frames, jax_side, cap, start=0, stream=False):
    return [(_step(sess, frames[fi], action, jax_side, cap, stream),
             _snap(sess)) for fi, action in SCRIPT[start:]]


@pytest.fixture(scope="module", params=["420", "444"])
def runs(request):
    sub = request.param
    cap = _shrunk_cap(sub)
    js = J_enc.JpegEncoderSession(_settings(JSettings, sub))
    ts = T_enc.JpegEncoderSession(_settings(TSettings, sub), device="cpu")
    frames = _session_frames(ts.grid.height, ts.grid.width)
    jlog, jstates = [], []
    for k, (fi, action) in enumerate(SCRIPT):
        jlog.append((_step(js, frames[fi], action, True, cap), _snap(js)))
        if k + 1 == CARRY_AT:
            jstates.append({"_prev": np.asarray(js._prev).copy(),
                            "_age": np.asarray(js._age).copy(),
                            **{k2: getattr(js, k2) for k2 in
                               T_state.JPEG_STATE.scalars}})
    tlog = _run(ts, frames, False, cap)
    return {"sub": sub, "cap": cap, "frames": frames, "jax": jlog,
            "port": tlog, "jax_state": jstates[0]}


@pytest.mark.parametrize("i", range(len(SCRIPT)))
def test_session_chunks_equal_reference(runs, i):
    assert runs["port"][i][0] == runs["jax"][i][0]


@pytest.mark.parametrize("i", range(len(SCRIPT)))
def test_session_state_equals_reference(runs, i):
    p, j = runs["port"][i][1], runs["jax"][i][1]
    assert np.array_equal(p["prev"], j["prev"])
    assert np.array_equal(p["age"], j["age"])
    assert (p["caps"], p["force"], p["fid"]) \
        == (j["caps"], j["force"], j["fid"])


def test_session_covers_the_cases(runs):
    """The script did what it was built for."""
    log = runs["port"]
    n = len(log[0][0])
    counts = [len(c) for c, _ in log]
    assert counts[0] == n > 1                     # the first frame
    assert 0 < counts[1] < n                      # damaged stripes
    assert counts[2] > 0 and counts[3] > 0        # paint-overs
    assert counts[4] == 0                         # idle
    assert counts[5] == n                         # forced resend
    assert counts[8] == 0 and log[8][1]["caps"][2] == 1   # overflow, grown
    assert log[8][1]["force"] and counts[9] == n  # resend after the drop
    assert log[10][1]["caps"][2] == 1             # grown once only
    assert counts[11] == 0                        # idle again
    # paint-overs carry the paint tables, motion frames the motion ones
    dqt = bytes([0xFF, 0xDB])
    motion = log[1][0][0][0]
    paint = log[2][0][0][0]
    assert motion[motion.index(dqt):][:70] != paint[paint.index(dqt):][:70]


def test_quality_change_uses_dispatch_tables(runs):
    """Frame 6 was encoded at quality 60 and finalized after the change
    to 30: its DQT is the quality-60 one (and its scan equals the
    reference's, which quantised with the tables of its dispatch);
    frame 9 uses quality 30."""
    qy60 = T_codec.scale_qtable(T_codec.STD_LUMA_QUANT, 60)
    qy30 = T_codec.scale_qtable(T_codec.STD_LUMA_QUANT, 30)
    zz = T_dct.zigzag_order()

    def dqt0(payload):
        i = payload.index(bytes([0xFF, 0xDB]))
        return np.frombuffer(payload[i + 5:i + 69], np.uint8)
    assert np.array_equal(dqt0(runs["port"][6][0][0][0]), qy60[zz])
    assert np.array_equal(dqt0(runs["port"][9][0][0][0]), qy30[zz])


def test_pipelined_overflow_grows_once(runs):
    """Two frames dispatched before either is finalized both overflow:
    the buffers double once (the second frame carries the old cap
    generation), both frames are dropped, and the next resends every
    stripe — as in the reference."""
    sub, cap, f3 = runs["sub"], runs["cap"], runs["frames"][3]
    res = []
    for jax_side in (True, False):
        sess = (J_enc.JpegEncoderSession(_settings(JSettings, sub))
                if jax_side else T_enc.JpegEncoderSession(
                    _settings(TSettings, sub), device="cpu"))
        sess.update_quality(30, 30)
        sess._out_cap = cap
        if jax_side:
            sess._step = sess._build_step()
        else:
            sess._rebuild_steps()
        frame = jnp.asarray(f3) if jax_side else f3
        a, b = sess.encode(frame), sess.encode(frame)
        dropped = [sess.finalize(a), sess.finalize(b)]
        after = _step(sess, f3, "", jax_side, cap)
        res.append((dropped, sess._cap_gen, sess._out_cap, after))
    assert res[0] == res[1]
    assert res[1][0] == [[], []] and res[1][1] == 1
    assert res[1][2] == 2 * cap and len(res[1][3]) > 0


@pytest.mark.parametrize("i", range(len(SCRIPT)))
def test_pil_decodes_every_chunk(runs, i):
    sess_grid = T_enc.plan_grid(_settings(TSettings, runs["sub"]))
    for c in runs["port"][i][0]:
        img = Image.open(io.BytesIO(c[0]))
        img.load()
        assert img.size == (sess_grid.width, sess_grid.stripe_h)
        assert img.mode == "RGB"


def test_decoded_stripe_is_close_to_the_frame(runs):
    """The first frame's stripes decode to the frame within JPEG's loss
    on the text half (a sanity check of the container, not a tolerance
    on the port; the other half is noise)."""
    g = T_enc.plan_grid(_settings(TSettings, runs["sub"]))
    f0 = runs["frames"][0].astype(np.int32)
    half = g.width // 2
    for c in runs["port"][0][0]:
        y0 = c[2]
        img = np.asarray(Image.open(io.BytesIO(c[0])).convert("RGB"),
                         np.int32)
        err = np.abs(img - f0[y0:y0 + g.stripe_h])[:, half:].mean()
        assert err < 12


def test_finalize_stream_matches_finalize(runs):
    sub = runs["sub"]
    ts = T_enc.JpegEncoderSession(_settings(TSettings, sub), device="cpu")
    log = _run(ts, runs["frames"], False, runs["cap"], stream=True)
    assert [c for c, _ in log] == [c for c, _ in runs["port"]]


@pytest.fixture(scope="module")
def carried(runs):
    """A fresh port session loaded with the JAX session's state after
    frame CARRY_AT - 1, run through the rest of the script."""
    ts = T_enc.JpegEncoderSession(_settings(TSettings, runs["sub"]),
                                  device="cpu")
    T_state.session_state_from_numpy(ts, runs["jax_state"])
    return _run(ts, runs["frames"], False, runs["cap"], start=CARRY_AT)


@pytest.mark.parametrize("i", range(len(SCRIPT) - CARRY_AT))
def test_state_carry_continues_identically(runs, carried, i):
    assert carried[i][0] == runs["jax"][CARRY_AT + i][0]
    assert np.array_equal(carried[i][1]["prev"],
                          runs["jax"][CARRY_AT + i][1]["prev"])


def test_state_round_trip_to_the_reference(runs):
    """Port -> numpy -> a JAX session continues identically; port ->
    numpy -> port reads back the same arrays."""
    sub = runs["sub"]
    ts = T_enc.JpegEncoderSession(_settings(TSettings, sub), device="cpu")
    frames = runs["frames"]
    for fi, action in SCRIPT[:CARRY_AT]:
        _step(ts, frames[fi], action, False, runs["cap"])
    d = T_state.session_state_to_numpy(ts)
    js = J_enc.JpegEncoderSession(_settings(JSettings, sub))
    js._prev = jnp.asarray(d["_prev"])
    js._age = jnp.asarray(d["_age"])
    for k in T_state.JPEG_STATE.scalars:
        setattr(js, k, d[k])
    js._step = js._build_step()
    fi, action = SCRIPT[CARRY_AT]
    assert _step(js, frames[fi], action, True, runs["cap"]) \
        == runs["jax"][CARRY_AT][0]
    back = T_enc.JpegEncoderSession(_settings(TSettings, sub), device="cpu")
    T_state.session_state_from_numpy(back, d)
    d2 = T_state.session_state_to_numpy(back)
    for k in d:
        assert np.array_equal(np.asarray(d[k]), np.asarray(d2[k]))


def test_state_load_checks_shapes():
    ts = T_enc.JpegEncoderSession(_settings(TSettings, "420"), device="cpu")
    d = T_state.session_state_to_numpy(ts)
    d["_age"] = np.zeros(9, np.int32)
    with pytest.raises(ValueError, match="_age"):
        T_state.session_state_from_numpy(ts, d)


def test_buffer_caps_and_grid_equal_reference():
    for kw in (dict(capture_width=1920, capture_height=1080),
               dict(capture_width=1920, capture_height=1080, fullcolor=True),
               dict(capture_width=100, capture_height=37, stripe_height=20)):
        jg = J_enc.plan_grid(JSettings(**kw))
        tg = T_enc.plan_grid(TSettings(**kw))
        assert dataclasses.asdict(jg) == dataclasses.asdict(tg)
        fc = kw.get("fullcolor", False)
        assert J_enc.jpeg_buffer_caps(jg, fc) \
            == T_enc.jpeg_buffer_caps(tg, fc)


def test_session_defaults_to_cuda_and_watermark_raises():
    s = _settings(TSettings, "420")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            T_enc.JpegEncoderSession(s)
    # the watermark is ported (ROADMAP A5): an unreadable PNG no longer
    # raises but degrades to no watermark, as in the reference
    sess = T_enc.JpegEncoderSession(dataclasses.replace(
        s, watermark_path="/nonexistent.png"), device="cpu")
    assert sess._watermark is None


def test_session_launches_no_kernel_on_the_cpu():
    """device='cpu' runs the plain versions: no kernel build, no launch."""
    sess = T_enc.JpegEncoderSession(_settings(TSettings, "420"),
                                    device="cpu")
    before = dict(_cuda.LAUNCHES)
    frame = _session_frames(sess.grid.height, sess.grid.width)[0]
    assert len(sess.finalize(sess.encode(frame))) == sess.grid.n_stripes
    assert _cuda.LAUNCHES == before
