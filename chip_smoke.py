"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the CUDA kernels of selkies_tpu_torch from csrc/ and drives two
1920x1080 H.264 4:2:0 sequences and one 1920x1080 JPEG sequence through
them, each beside the same sequence through the kernels' plain PyTorch
versions on the same card, requiring equal chunks and equal state frame
by frame, then the capture loop for both codecs:

1. the stock configuration (zero-MV P frames, no band path): IDR,
   damaged and idle P frames, paint-over, a forced IDR and one overflow
   episode;
2. the default configuration (scroll motion search at vrange 24 /
   hrange 8, the damage-proportional band path): IDR, vertical scrolls
   both ways, a horizontal pan, typing in one stripe, idle frames, the
   paint-over bands, a 100%-dirty frame (whose bytes must equal the
   stock P step with motion), a forced IDR and a P frame. An idle frame
   must launch the probe and nothing else;
3. the JPEG stripe session (the server's default encoder) at its
   defaults (quality 60, paint-over quality 90, damage gating and
   paint-over on, 64-row stripes; ``paint_over_delay_frames`` shortened
   to 4 as in the H.264 runs): the desktop's first frame, which needs
   more than the stock 256 KiB byte buffer and so is the overflow
   episode on purpose (dropped, buffers doubled), the full resend after
   it, damaged and idle frames, both paint-overs, a forced resend and a
   quality change between encode and finalize. An idle frame must still
   launch all four JPEG-path kernels and send nothing;
4. the capture loop (``ScreenCapture("synthetic")``) at 1920x1080 on a
   1088-row grid, so the padder runs on every frame, with a watermark
   built from a seeded RGBA array at location 6, CBR, the keyframe
   cadence and content adaptivity off: 30 frames through the depth-2
   pipeline ring for JPEG at its defaults and for the default H.264
   configuration, each equal, chunk for chunk per frame id, to a depth-1
   run of the same loop, delivered in order. It prints the delivered fps,
   the dispatch-to-delivery latency per frame (median and p99) and the
   share of finalize time that overlapped another frame's dispatch,
   unpaced and at the default 60 fps target.

Each run resets the launch counters first and requires every kernel of
its path to have launched. Then each kernel is held against its plain
version at the 1080p shapes of the main path (tolerance 0: every output
is an integer) and timed with CUDA events beside the plain version, its
bound and, where one exists, one PyTorch call computing the same
function. Exits non-zero on any mismatch, launch error or kernel a path
did not launch; the last line is the device record. Needs no network and
one card.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
import traceback
import warnings

import numpy as np
import torch

from selkies_tpu_torch.codecs import jpeg as jtab
from selkies_tpu_torch.engine import ScreenCapture
from selkies_tpu_torch.engine import encoder as port_encoder
from selkies_tpu_torch.engine import h264_encoder as port_h264
from selkies_tpu_torch.engine import state as port_state
from selkies_tpu_torch.engine.encoder import (JpegEncoderSession,
                                              jpeg_buffer_caps)
from selkies_tpu_torch.engine.h264_encoder import (H264EncoderSession,
                                                   h264_buffer_caps)
from selkies_tpu_torch.engine.types import CaptureSettings
from selkies_tpu_torch.engine.watermark import Watermark
from selkies_tpu_torch.ops import _cuda
from selkies_tpu_torch.ops import frames as FR
from selkies_tpu_torch.ops import h264_planes as HP
from selkies_tpu_torch.ops.dct import zigzag_order
from selkies_tpu_torch.ops import jpeg_entropy as JE
from selkies_tpu_torch.ops import jpeg_pipeline as JPP
from selkies_tpu_torch.ops import jpeg_planes as JPL
from selkies_tpu_torch.ops.h264_encode import (motion_select,
                                               motion_select_plain,
                                               scroll_candidates)
from selkies_tpu_torch.trace import tracer

SEED = 20261017
WIDTH, HEIGHT = 1920, 1080       # the capture size the sequences run at
HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3 (data sheet)
FP32_OPS_PER_S = 67e12           # H100 SXM non-tensor FP32 (data sheet)

#: C entry -> (source, the reference function(s) it replaces)
KERNELS = {
    "csc420_damage": ("selkies_tpu_torch/csrc/csc420_damage.cu",
                      "selkies_tpu/ops/h264_planes.py:494"),
    "mb_encode_i": ("selkies_tpu_torch/csrc/mb_encode.cu",
                    "selkies_tpu/ops/h264_planes.py:541"),
    "mb_encode_p": ("selkies_tpu_torch/csrc/mb_encode.cu",
                    "selkies_tpu/ops/h264_planes.py:875"),
    "cavlc_events": ("selkies_tpu_torch/csrc/cavlc_events.cu",
                     "selkies_tpu/ops/h264_planes.py:178"),
    "pack_stream": ("selkies_tpu_torch/csrc/pack_stream.cu",
                    "selkies_tpu/ops/h264_planes.py:324"),
    "motion_select": ("selkies_tpu_torch/csrc/motion_select.cu",
                      "selkies_tpu/ops/h264_encode.py:723"),
    "row_damage_probe": ("selkies_tpu_torch/csrc/row_damage_probe.cu",
                         "selkies_tpu/engine/h264_encoder.py:247"),
    "jpeg_forward": ("selkies_tpu_torch/csrc/jpeg_forward.cu",
                     "selkies_tpu/ops/jpeg_planes.py:88"),
    "jpeg_events": ("selkies_tpu_torch/csrc/jpeg_events.cu",
                    "selkies_tpu/ops/jpeg_entropy.py:81"),
    "jpeg_pack": ("selkies_tpu_torch/csrc/jpeg_pack.cu",
                  "selkies_tpu/ops/bitpack.py:134"),
    "synthetic_frame": ("selkies_tpu_torch/csrc/synthetic_frame.cu",
                        "selkies_tpu/engine/sources.py:49"),
    "pad_frame": ("selkies_tpu_torch/csrc/pad_frame.cu",
                  "selkies_tpu/engine/capture.py:63"),
    "watermark_blend": ("selkies_tpu_torch/csrc/watermark_blend.cu",
                        "selkies_tpu/engine/watermark.py:36"),
}
#: kernels each path launches
STOCK_PATH = ("csc420_damage", "mb_encode_i", "mb_encode_p", "cavlc_events",
              "pack_stream")
DEFAULT_PATH = STOCK_PATH + ("motion_select", "row_damage_probe")
JPEG_PATH = ("row_damage_probe", "jpeg_forward", "jpeg_events", "jpeg_pack")
CAPTURE_PATH = DEFAULT_PATH + JPEG_PATH + ("synthetic_frame", "pad_frame",
                                           "watermark_blend")
CAPTURE_FRAMES = 30              # frames of each capture-loop run
WM_LOCATION = 6                  # bottom-right, the setting's default


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


# ---------------------------------------------------------------- frames
def desktop_frames(H: int, W: int, vis_h: int):
    """Seeded desktop-like frames at the padded grid size: gradient
    background, flat windows, a text-like noise panel; each later frame
    changes a few stripes. Rows past ``vis_h`` repeat the last visible
    row (the capture padder's edge mode)."""
    rng = np.random.default_rng(SEED)
    yy = np.linspace(30, 210, H, dtype=np.float32)[:, None]
    xx = np.linspace(0, 50, W, dtype=np.float32)[None, :]
    base = np.stack([yy + xx, 0.7 * yy + 40 + 0 * xx, 240 - 0.5 * yy + xx],
                    -1).astype(np.uint8)

    def window(f, y0, x0, h, w, color):
        f[y0:y0 + h, x0:x0 + w] = color
        f[y0:y0 + 24, x0:x0 + w] = (60, 60, 70)            # title bar

    def text(f, y0, x0, h, w):
        # clipped to the frame (smaller sizes, for rehearsals)
        h = max(0, min(h, f.shape[0] - y0))
        w = max(0, min(w, f.shape[1] - x0))
        glyphs = rng.integers(0, 2, (h // 2, w // 2), dtype=np.uint8)
        f[y0:y0 + h, x0:x0 + w] = np.repeat(np.repeat(
            glyphs, 2, 0), 2, 1)[..., None] * 200 + 20

    def pad(f):
        f[vis_h:] = f[vis_h - 1]
        return f

    f0 = base.copy()
    window(f0, 100, 200, 500, 700, (235, 235, 235))
    text(f0, 140, 230, 300, 620)
    window(f0, 300, 1000, 600, 800, (250, 248, 240))
    text(f0, 340, 1030, 500, 700)
    f1 = f0.copy()                                         # window moves
    window(f1, 160, 240, 80, 300, (90, 140, 220))
    f2 = f1.copy()                                         # text scrolls
    text(f2, 660, 1030, 60, 700)
    f3 = f2.copy()
    text(f3, 900, 100, 100, 500)
    return [pad(f) for f in (f0, f1, f2, f3)]


# ------------------------------------------------------------ session run
def plain_session(settings) -> H264EncoderSession:
    """A session whose steps run the kernels' plain PyTorch versions on
    the card: the path the kernel session is held against."""
    sess = H264EncoderSession(settings)
    sess._ops = HP.PLAIN_OPS
    sess._rebuild_steps()
    return sess


STATE_KEYS = ("_ref_y", "_ref_u", "_ref_v", "_age", "_sent", "_fnum",
              "_prev")


def snapshot(sess) -> dict:
    snap = {k: getattr(sess, k).clone() for k in STATE_KEYS}
    if sess._scratch is not None:
        snap["mv"] = sess._scratch[3].clone()
    snap["_host_age"] = torch.as_tensor(sess._host_age.copy())
    return snap


def run_sequence(sess: H264EncoderSession, frames) -> list:
    """IDR -> damaged P -> idle -> paint-over -> forced IDR -> P ->
    overflow episode (out_cap shrunk below an IDR) -> forced IDR -> P.
    -> per frame (chunks, state snapshot)."""
    f0, f1, f2, f3 = frames
    script = [(f0, False), (f1, False), (f2, False), (f2, False),
              (f2, False), (f2, False), (f2, False), (f2, True), (f3, False)]
    log = []

    def step(frame, force):
        chunks = sess.finalize(sess.encode(frame, force=force))
        log.append((chunks, snapshot(sess)))
        return chunks

    idr_bytes = 0
    for i, (frame, force) in enumerate(script):
        chunks = step(frame, force)
        if i == 7:
            idr_bytes = sum(len(c.payload) for c in chunks)
    # overflow episode: shrink the byte buffer below the forced IDR
    sess._out_cap = idr_bytes * 2 // 3
    sess._rebuild_steps()
    gen = sess._cap_gen
    check(step(f2, True) == [], "shrunk out_cap did not overflow")
    check(sess._cap_gen == gen + 1, "overflow did not grow the buffers")
    check(all(c.is_idr for c in step(f2, False)),
          "frame after overflow was not an IDR")
    step(f3, False)
    return log


def compare_runs(a, b) -> None:
    check(len(a) == len(b), "runs differ in length")
    for i, (ra, rb) in enumerate(zip(a, b)):
        ca, sa, cb, sb = ra[0], ra[1], rb[0], rb[1]
        check([dataclasses.astuple(c) for c in ca]
              == [dataclasses.astuple(c) for c in cb],
              f"frame {i}: kernel chunks differ from the plain path's")
        for k in sa:
            check(torch.equal(sa[k], sb[k]),
                  f"frame {i}: {k} differs from the plain path's")
        check(ra[2:] == rb[2:], f"frame {i}: band geometry differs")


# ------------------------------------------- default configuration run
def scroll_canvas(H: int, W: int):
    """A desktop taller and wider than the frame (a document with text
    lines under a window frame), to cut scrolled and panned frames from:
    frame (oy, ox) is rows oy..oy+H, columns ox..ox+W."""
    rng = np.random.default_rng(SEED + 1)
    ch, cw = H + 160, W + 64
    yy = np.linspace(40, 200, ch, dtype=np.float32)[:, None]
    xx = np.linspace(0, 40, cw, dtype=np.float32)[None, :]
    c = np.stack([yy + xx, 0.5 * yy + 60 + 0 * xx, 230 - 0.6 * yy + xx],
                 -1).astype(np.uint8)
    # text: lines of 2x2-pixel dots (about a third inked), 6 pixels
    # high at a 20-pixel pitch, of random length
    for top in range(40, ch - 40, 20):
        n = int(rng.integers(100, cw // 2)) // 2
        glyphs = (rng.random((3, n)) < 0.35).astype(np.uint8)
        line = np.repeat(np.repeat(glyphs, 2, 0), 2, 1)[..., None]
        c[top:top + 6, 100:100 + 2 * n] = np.where(
            line > 0, 30, c[top:top + 6, 100:100 + 2 * n])
    return c


def default_frames(H: int, W: int, vis_h: int):
    """(name, frame, force) of the default-configuration sequence."""
    canvas = scroll_canvas(H, W)

    def at(oy, ox=32):
        f = canvas[oy:oy + H, ox:ox + W].copy()
        f[vis_h:] = f[vis_h - 1]
        return f
    seq = [("idr", at(80), False)]
    oy = 80
    for d in (7, 24, -13, 1, -24, 16):          # vertical scrolls
        oy += d
        seq.append((f"scroll{d:+d}", at(oy), False))
    pan = at(oy, 40)                             # content moves 8 px left
    seq.append(("pan8", pan, False))
    typing = pan.copy()
    typing[typing_rows(H), 300:420] = (20, 20, 20)
    seq.append(("typing", typing, False))
    seq += [("idle", typing, False), ("idle", typing, False),
            ("paint_others", typing, False), ("paint_typed", typing, False)]
    # a theme change: every row brightens
    bright = np.minimum(typing.astype(np.int32) + 12, 255).astype(np.uint8)
    seq.append(("full_dirty", bright, False))
    seq.append(("forced_idr", bright, True))
    after = bright.copy()
    after[100:110, 50:300] = (250, 250, 250)
    seq.append(("p_after_idr", after, False))
    return seq


def typing_rows(H: int) -> slice:
    """12 pixel rows inside the 64-row stripe at the middle of the frame:
    what a few typed characters dirty."""
    top = (H // 2) // 64 * 64 + 20
    return slice(top, top + 12)


def run_default_sequence(sess, seq, check_idle: bool = False) -> list:
    """-> per frame (chunks, state snapshot, band, last_band_rows). With
    ``check_idle`` the idle frames must launch the probe and nothing else
    (the launch counters of the kernel wrappers)."""
    log = []
    for name, frame, force in seq:
        before = dict(_cuda.LAUNCHES)
        out = sess.encode(frame, force=force)
        chunks = sess.finalize(out)
        if check_idle and name == "idle":
            delta = {k: v - before[k] for k, v in _cuda.LAUNCHES.items()
                     if v != before[k]}
            check(out.get("idle") and delta == {"row_damage_probe": 1},
                  f"idle frame launched {delta}")
            check(chunks == [], "idle frame sent chunks")
        log.append((chunks, snapshot(sess), out.get("band"),
                    sess.last_band_rows))
    return log


def check_default_log(log, seq, sess) -> None:
    """The sequence did what it was built for: scrolls chose non-zero
    vectors and whole-frame bands, typing a one-stripe band, the paint-
    overs their stripes, the full-dirty frame the full band."""
    g = sess.grid
    rps = g.rows_per_stripe
    names = [n for n, _, _ in seq]
    for i, n in enumerate(names):
        chunks, snap, band, _ = log[i]
        if n.startswith("scroll") or n == "pan8":
            check(band == (0, sess.n_rows), f"{n}: band {band}")
            check(bool((snap["mv"] != 0).any()), f"{n}: no motion chosen")
        elif n == "typing" or n == "paint_typed":
            row0 = typing_rows(g.height).start // 16 // rps * rps
            check(band == (row0, rps), f"{n}: band {band}")
            check(len(chunks) == 1, f"{n}: {len(chunks)} chunks")
        elif n == "full_dirty":
            check(band == (0, sess.n_rows) and len(chunks) == g.n_stripes,
                  f"{n}: band {band}")
        elif n in ("idr", "forced_idr"):
            check(band is None and all(c.is_idr for c in chunks)
                  and len(chunks) == g.n_stripes, f"{n}: not a full IDR")
    dy = {n: int(n[6:]) for n in names if n.startswith("scroll")}
    for n, d in dy.items():
        mv = log[names.index(n)][1]["mv"]
        check(bool((mv[..., 1] == 4 * d).any()),
              f"{n}: no macroblock chose dy {d}")


def full_dirty_equals_stock(settings, seq) -> None:
    """The 100%-dirty band frame's bytes equal the stock P step with
    motion on the same input and the same state: a stock session with
    motion is loaded with the band session's state from before that
    frame and encodes it."""
    names = [n for n, _, _ in seq]
    k = names.index("full_dirty")
    band = H264EncoderSession(settings)
    for _, frame, force in seq[:k]:
        band.finalize(band.encode(frame, force=force))
    d = port_state.session_state_to_numpy(band)
    stock = H264EncoderSession(dataclasses.replace(
        settings, h264_partial_encode=False))
    d["_age"] = np.minimum(d["_host_age"], 2**31 - 1).astype(np.int32)
    port_state.session_state_from_numpy(stock, d)
    frame = seq[k][1]
    want = stock.finalize(stock.encode(frame))
    got = band.finalize(band.encode(frame))
    check([dataclasses.astuple(c) for c in got]
          == [dataclasses.astuple(c) for c in want],
          "full-dirty band differs from the stock P step with motion")
    for key in ("_ref_y", "_ref_u", "_ref_v", "_prev", "_sent", "_fnum"):
        check(torch.equal(getattr(band, key), getattr(stock, key)),
              f"full-dirty band: {key} differs from the stock P step")


def check_stream(log, sess) -> None:
    """The repo's own output checks: every frame that sent stripes made
    chunks of the stripe geometry, IDRs carry SPS+PPS+one slice per MB
    row, P chunks one slice per row."""
    g = sess.grid
    n_idr = n_p = 0
    for chunks, _ in log:
        for c in chunks:
            check(c.width == g.width and c.height == g.stripe_h,
                  "chunk geometry")
            n_nal = c.payload.count(b"\x00\x00\x00\x01")
            if c.is_idr:
                n_idr += 1
                check(n_nal == 2 + g.rows_per_stripe, "IDR NAL count")
            else:
                n_p += 1
                check(n_nal == g.rows_per_stripe, "P NAL count")
    check(n_idr > 0 and n_p > 0, "sequence made no IDR or no P chunks")


# ------------------------------------------------------- kernel vs plain
def flush_l2(buf) -> None:
    buf.zero_()


def time_fn(fn, reps: int, restore=None, flush=None,
            hide_launch: bool = False) -> float:
    """Median per-call time (ms) between CUDA events; ``restore`` resets
    in-place inputs and ``flush`` evicts L2, both untimed. With
    ``hide_launch`` a spin kernel runs first so the host has enqueued the
    call before the first event fires: the time is then device time
    only (for the kernels; the plain versions wait on the host)."""
    times = []
    for _ in range(reps):
        if restore is not None:
            restore()
        if flush is not None:
            flush()
        if hide_launch:
            torch.cuda._sleep(2_000_000)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def max_abs_err(xs, ys) -> int:
    err = 0
    for x, y in zip(xs, ys):
        check(x.shape == y.shape and x.dtype == y.dtype,
              f"output shape/dtype {tuple(x.shape)}/{x.dtype} vs "
              f"{tuple(y.shape)}/{y.dtype}")
        if x.numel():
            err = max(err, int((x.to(torch.int64)
                                - y.to(torch.int64)).abs().max()))
    return err


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def kernel_checks(frames, sess, grown) -> dict:
    """Each kernel against its plain version at the main path's 1080p
    shapes, tolerance 0, then timed. ``sess`` holds the stock buffer
    caps, which K4 is timed at; ``grown`` = (w_cap, out_cap) after the
    overflow episode, checked as well. -> name -> record."""
    dev = sess.device
    g = sess.grid
    check((sess._e_cap, sess._w_cap, sess._out_cap) == h264_buffer_caps(g),
          "kernel checks need a session at the stock buffer caps")
    S, rps = g.n_stripes, g.rows_per_stripe
    R, M = g.height // 16, g.width // 16
    l2 = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    flush = (lambda: flush_l2(l2))
    out = {}
    f0, f1 = (torch.as_tensor(f).to(dev) for f in frames[:2])
    f2s = torch.roll(f1, -5, 0)                 # f1 scrolled by 5 rows

    # K1: csc420_damage (frame f1 against prev f0: some stripes damaged)
    pk, pp = f0.clone(), f0.clone()
    ko = HP.csc420_damage(f1, pk, S)
    po = HP.csc420_damage_plain(f1, pp, S)
    err = max_abs_err(list(ko) + [pk], list(po) + [pp])
    check(err == 0, f"csc420_damage differs from plain (max err {err})")
    check(0 < int(ko[3].sum()) < S, "K1 check frame should damage some "
          "stripes and not others")
    y, u, v = ko[:3]
    prev = f0.clone()
    ms = time_fn(lambda: HP.csc420_damage(f1, prev, S), 20,
                 restore=lambda: prev.copy_(f0), flush=flush,
                 hide_launch=True)
    pms = time_fn(lambda: HP.csc420_damage_plain(f1, prev, S), 3,
                  restore=lambda: prev.copy_(f0))
    by = nbytes(f1, prev, prev, y, u, v, ko[3])
    ops = 40 * (g.height * g.width // 4)          # ~40 flops per quad
    out["csc420_damage"] = (err, ms, pms, by, ops, None)

    # K2: both entries; every other stripe sent, so the gate shows. P
    # codes frame f2 against the I recon of f1 with K5's prediction
    qp = torch.full((R,), sess.qp, dtype=torch.int32, device=dev)
    qp[::3] = sess.paint_qp
    send = (torch.arange(S, device=dev) % 2 == 0).to(torch.int32)
    send_rows = send.repeat_interleave(rps)
    sent_frac = float(send.float().mean())
    zero_ref = [torch.zeros_like(p) for p in (y, u, v)]
    kref = [t.clone() for t in zero_ref]
    pref = [t.clone() for t in zero_ref]
    ko = HP.mb_encode_i(y, u, v, qp, send, rps, *kref)
    po = HP.mb_encode_i_plain(y, u, v, qp, send, rps, *pref)
    err = max_abs_err(list(ko) + kref, list(po) + pref)
    check(err == 0, f"mb_encode_i differs from plain (max err {err})")
    i_out, i_ref = ko, [t.clone() for t in kref]
    work = [t.clone() for t in zero_ref]

    def restore_i():
        for w, b in zip(work, zero_ref):
            w.copy_(b)
    ms = time_fn(lambda: HP.mb_encode_i(y, u, v, qp, send, rps, *work), 20,
                 restore=restore_i, flush=flush, hide_launch=True)
    pms = time_fn(lambda: HP.mb_encode_i_plain(y, u, v, qp, send, rps,
                                               *work), 3, restore=restore_i)
    # planes and levels move once; the reference planes are written for
    # the sent stripes only
    by = nbytes(y, u, v, qp, send, *ko) + int(nbytes(*kref) * sent_frac)
    out["mb_encode_i"] = (err, ms, pms, by, 1200 * 24 * R * M, None)

    # K5 at the main path's shapes: the 57 default candidates, stripe
    # windows, a frame scrolled by 5 rows against the I recon
    cands = scroll_candidates(24, 8)
    p_planes = HP.csc420_damage(f2s, f1.clone(), S)[:3]
    win = g.stripe_h
    ko = motion_select(p_planes[0], *i_ref, qp, cands, win)
    po = motion_select_plain(p_planes[0], *i_ref, qp, cands, win)
    err = max_abs_err(ko, po)
    check(err == 0, f"motion_select differs from plain (max err {err})")
    check(bool((ko[3] != 0).any()), "K5 check frame chose no motion")
    ms = time_fn(lambda: motion_select(p_planes[0], *i_ref, qp, cands, win,
                                       out=ko), 20, flush=flush,
                 hide_launch=True)
    pms = time_fn(lambda: motion_select_plain(p_planes[0], *i_ref, qp,
                                              cands, win), 3)
    # SAD: a subtract, an absolute value and an add per pixel and
    # candidate
    out["motion_select"] = (err, ms, pms,
                            nbytes(p_planes[0], *i_ref, qp, *ko),
                            3 * 256 * len(cands) * R * M, None)
    pred, mv = ko[:3], ko[3]

    # K2-P on K5's prediction, the reference rewritten for sent rows
    kref = [t.clone() for t in i_ref]
    pref = [t.clone() for t in i_ref]
    ko = HP.mb_encode_p(*p_planes, qp, send_rows, *pred, mv, *kref)
    po = HP.mb_encode_p_plain(*p_planes, qp, send_rows, *pred, mv, *pref)
    err = max_abs_err(list(ko) + kref, list(po) + pref)
    check(err == 0, f"mb_encode_p differs from plain (max err {err})")
    p_out = ko
    work = [t.clone() for t in i_ref]

    def restore_p():
        for w, b in zip(work, i_ref):
            w.copy_(b)
    ms = time_fn(lambda: HP.mb_encode_p(*p_planes, qp, send_rows, *pred, mv,
                                        *work), 20, restore=restore_p,
                 flush=flush, hide_launch=True)
    pms = time_fn(lambda: HP.mb_encode_p_plain(*p_planes, qp, send_rows,
                                               *pred, mv, *work), 3,
                  restore=restore_p)
    by = nbytes(*p_planes, qp, send_rows, *pred, mv, *ko) + int(
        nbytes(*kref) * sent_frac)
    out["mb_encode_p"] = (err, ms, pms, by, 1200 * 24 * R * M, None)
    res = {"mb_encode_i": (i_out, i_ref), "mb_encode_p": (p_out, kref)}

    # K6: the band path's probe, frame f1 against prev f0
    ko = HP.row_damage_probe(f1, f0)
    po = HP.row_damage_probe_plain(f1, f0)
    err = max_abs_err([ko], [po])
    check(err == 0, f"row_damage_probe differs from plain (err {err})")
    check(0 < int(ko.sum()) < R, "K6 check frame should dirty some rows")
    ms = time_fn(lambda: HP.row_damage_probe(f1, f0), 20, flush=flush,
                 hide_launch=True)
    pms = time_fn(lambda: HP.row_damage_probe_plain(f1, f0), 3)
    lib = time_fn(lambda: (f1 != f0).view(R, -1).any(1), 20, flush=flush,
                  hide_launch=True)
    out["row_damage_probe"] = (err, ms, pms, nbytes(f1, f0, ko),
                               f1.numel(), lib)

    # K3 and K4 on the K2 outputs of both modes
    for intra, key in ((True, "mb_encode_i"), (False, "mb_encode_p")):
        lv, cbp, hp, hn = res[key][0]
        ko = HP.cavlc_events(lv, cbp, intra)
        po = HP.cavlc_events_plain(lv, cbp, intra)
        err = max_abs_err(ko, po)
        check(err == 0, f"cavlc_events (intra={intra}) differs (err {err})")
        if intra:
            ms = time_fn(lambda: HP.cavlc_events(lv, cbp, True), 20,
                         flush=flush, hide_launch=True)
            pms = time_fn(lambda: HP.cavlc_events_plain(lv, cbp, True), 3)
            out["cavlc_events"] = (err, ms, pms, nbytes(lv, cbp, *ko),
                                   30 * 36 * 27 * R * M, None)
        row_hp = sess._hdr_pay if intra else sess._p_hdr_pay
        row_hn = sess._hdr_nb if intra else sess._p_hdr_nb
        row_id = torch.arange(R, dtype=torch.int32, device=dev) % 16
        for w_cap, out_cap, tag in ((sess._w_cap, sess._out_cap, "stock"),
                                    (*grown, "grown"),
                                    (64, 4096, "overflow")):
            args = (hp, hn, *ko, row_hp, row_hn, row_id, qp, intra,
                    sess._e_cap, w_cap, out_cap)
            k4 = HP.pack_stream(*args)
            p4 = HP.pack_stream_plain(*args)
            err = max_abs_err(k4, p4)
            check(err == 0, f"pack_stream ({tag}, intra={intra}) differs "
                  f"(err {err})")
            if tag == "overflow":
                check(int(k4.flags[0]) == 1 and int(k4.flags[1]) == 1,
                      "pack_stream overflow flags not raised")
            elif intra and tag == "stock":
                ms = time_fn(lambda: HP.pack_stream(*args), 20, flush=flush,
                             hide_launch=True)
                pms = time_fn(lambda: HP.pack_stream_plain(*args), 3)
                out["pack_stream"] = (err, ms, pms,
                                      nbytes(hp, hn, *ko, *k4),
                                      10 * ko[1].numel(), None)
    return out


def count_syncs(fn):
    """-> (fn(), the synchronizing CUDA calls it made, by torch's sync
    debug mode, each as the innermost line of this repository on the
    Python stack when it was made, and the torch line that made it)."""
    where, active = [], [False]

    def hook(message, category, filename, lineno, file=None, line=None):
        # only while fn runs: switching the mode may warn by itself
        if not active[0] or "synchroniz" not in str(message):
            return
        ours = [f for f in traceback.extract_stack()
                if ("selkies_tpu_torch" in f.filename
                    or f.filename.endswith("chip_smoke.py"))
                and f.name not in ("hook", "count_syncs")]
        at = ours[-1] if ours else None
        where.append(f"{at.filename.rsplit('/', 2)[-1]}:{at.lineno} "
                     f"({at.name}) via {filename.rsplit('/', 3)[-1]}:"
                     f"{lineno}" if at else f"{filename}:{lineno}")
    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = hook
        torch.cuda.set_sync_debug_mode("warn")
        active[0] = True
        try:
            res = fn()
        finally:
            active[0] = False
            torch.cuda.set_sync_debug_mode("default")
    return res, where


def sync_checks(settings, dsettings, base, typed) -> dict:
    """Host syncs inside encode(): none on the stock path (with or
    without motion), exactly one (the row probe) on every frame of the
    band path, idle and I frames included."""
    res = {}

    def encode(sess, frame, force=False):
        out, where = count_syncs(lambda: sess.encode(frame, force=force))
        sess.finalize(out)
        return where
    for name, s in (("stock", settings), ("stock_motion", dataclasses.replace(
            dsettings, h264_partial_encode=False))):
        sess = H264EncoderSession(s)
        sess.finalize(sess.encode(base))
        res[f"{name}_P"] = encode(sess, typed)
        res[f"{name}_I"] = encode(sess, typed, True)
    sess = H264EncoderSession(dsettings)
    sess.finalize(sess.encode(base))
    res["band_P"] = encode(sess, typed)
    res["band_idle"] = encode(sess, typed)
    res["band_I"] = encode(sess, typed, True)
    counts = {k: len(v) for k, v in res.items()}
    want = {k: 1 if k.startswith("band") else 0 for k in res}
    check(counts == want, f"syncs inside encode {res}, expected {want}")
    return res


def frame_times(settings, cases: dict, reps: int = 7) -> dict:
    """Host-clock encode and encode+finalize times (ms) at the stock
    buffer caps. ``cases``: kind -> (setup frame, timed frame, force).
    Each rep is a fresh session: an untimed IDR of the setup frame, then
    the timed frame, so no rep meets a paint-over or an overflow that an
    earlier rep caused."""
    res = {}
    for kind, (f_setup, f_timed, force) in cases.items():
        ts, enc = [], []
        for _ in range(reps):
            sess = H264EncoderSession(settings)
            sess.finalize(sess.encode(f_setup))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = sess.encode(f_timed, force=force)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            chunks = sess.finalize(out)
            t2 = time.perf_counter()
            check(chunks and all(c.is_idr == force for c in chunks),
                  f"timed {kind} frame sent no chunks of its kind")
            check((sess._w_cap, sess._out_cap)
                  == h264_buffer_caps(sess.grid)[1:],
                  "frame timing overflowed the stock buffers")
            enc.append((t1 - t0) * 1e3)
            ts.append((t2 - t0) * 1e3)
        res[kind] = {"encode_ms": statistics.median(enc),
                     "encode_finalize_ms": statistics.median(ts),
                     "band_rows": sess.last_band_rows}
    return res


# ------------------------------------------------------------- JPEG run
def plain_jpeg_session(settings) -> JpegEncoderSession:
    """A JPEG session whose step runs the plain versions on the card."""
    sess = JpegEncoderSession(settings)
    sess._ops = JPP.PLAIN_OPS
    sess._rebuild_steps()
    return sess


def jpeg_script(frames) -> list:
    """(name, frame, action) of the JPEG sequence. The desktop's first
    frame at quality 60 needs more than the stock 256 KiB byte buffer
    (every stripe is encoded every frame), so it overflows on purpose
    ("overflow": dropped, buffers doubled, the next frame resends every
    stripe). "force" finalizes with force_all; "quality" changes the
    quality tiers to 40 / 80 between encode and finalize."""
    f0, f1, f2, f3 = frames
    return [("first", f0, "overflow"), ("resend", f0, ""),
            ("damaged", f1, ""), ("idle", f1, ""), ("paint_others", f1, ""),
            ("idle", f1, ""), ("paint_damaged", f1, ""), ("idle", f1, ""),
            ("forced", f1, "force"), ("quality", f2, "quality"),
            ("damaged_q40", f3, "")]


def run_jpeg_sequence(sess, seq, check_idle: bool = False) -> list:
    """-> per frame (chunks, state snapshot). With ``check_idle`` an idle
    frame must launch each JPEG-path kernel once and send nothing."""
    log = []
    for name, frame, action in seq:
        gen = sess._cap_gen
        before = dict(_cuda.LAUNCHES)
        out = sess.encode(frame)
        if action == "quality":
            sess.update_quality(40, 80)
        chunks = sess.finalize(out, force_all=action == "force")
        if check_idle and name == "idle":
            delta = {k: v - before[k] for k, v in _cuda.LAUNCHES.items()
                     if v != before[k]}
            check(delta == {k: 1 for k in JPEG_PATH},
                  f"idle JPEG frame launched {delta}")
            check(chunks == [], "idle JPEG frame sent chunks")
        check((action == "overflow") == (sess._cap_gen == gen + 1)
              and (action != "overflow" or chunks == []),
              f"{name}: overflow episode where none was planned or none "
              "where one was")
        log.append((chunks, {k: getattr(sess, k).clone()
                             for k in ("_prev", "_age")}))
    return log


def check_jpeg_log(log, seq, sess) -> None:
    """The sequence did what it was built for, and every chunk is a
    well-formed baseline JFIF stripe: SOI, the quality's DQT, SOF0 of the
    stripe's size, a scan with every 0xFF stuffed, EOI."""
    g = sess.grid
    S = g.n_stripes
    n = {name: len(log[i][0]) for i, (name, _, _) in enumerate(seq)}
    check(n["first"] == 0 and n["forced"] == S and n["resend"] == S,
          f"full frames sent {n}")
    check(0 < n["damaged"] < S and n["idle"] == 0, f"damage gating {n}")
    check(n["paint_others"] + n["paint_damaged"] == S,
          f"paint-overs cover {n}")
    for i, (name, _, _) in enumerate(seq):
        for c in log[i][0]:
            p = c.payload
            check(p[:2] == b"\xff\xd8" and p[-2:] == b"\xff\xd9", "SOI/EOI")
            sof = p.index(b"\xff\xc0")
            check(p[sof + 5:sof + 9] == bytes([g.stripe_h >> 8,
                                               g.stripe_h & 255,
                                               g.width >> 8, g.width & 255]),
                  "SOF0 size")
            scan = p[p.index(b"\xff\xda") + 14:-2]
            ff = np.flatnonzero(np.frombuffer(scan, np.uint8) == 0xFF)
            check(all(scan[k + 1] == 0 for k in ff), "unstuffed 0xFF")
    q60 = jtab.scale_qtable(jtab.STD_LUMA_QUANT, 60)[zigzag_order()]
    dqt = log[[s[0] for s in seq].index("quality")][0][0].payload
    k = dqt.index(b"\xff\xdb")
    check(dqt[k + 5:k + 69] == bytes(q60.tolist()),
          "the quality-change frame lost its dispatch tables")


def jpeg_kernel_checks(frames, sess) -> dict:
    """K6 at stripe granularity and K7-K9 against their plain versions at
    the 1080p JPEG path's shapes (tolerance 0), then timed. ``sess`` holds
    the stock buffer caps."""
    dev = sess.device
    g = sess.grid
    S, sub = g.n_stripes, sess.subsampling
    e_cap, w_cap, out_cap = jpeg_buffer_caps(g, sub == "444")
    check((sess._e_cap, sess._w_cap, sess._out_cap)
          == (e_cap, w_cap, out_cap), "JPEG checks need the stock caps")
    l2 = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    flush = (lambda: flush_l2(l2))
    out = {}
    f0, f1 = (torch.as_tensor(f).to(dev) for f in frames[:2])

    # K6 at the JPEG step's granularity: one flag per stripe
    ko = HP.row_damage_probe(f1, f0, S)
    err = max_abs_err([ko], [HP.row_damage_probe_plain(f1, f0, S)])
    check(err == 0 and 0 < int(ko.sum()) < S, f"K6 per stripe (err {err})")
    ms = time_fn(lambda: HP.row_damage_probe(f1, f0, S), 20, flush=flush,
                 hide_launch=True)
    pms = time_fn(lambda: HP.row_damage_probe_plain(f1, f0, S), 3)
    lib = time_fn(lambda: (f1 != f0).view(S, -1).any(1), 20, flush=flush,
                  hide_launch=True)
    out["row_damage_probe"] = (err, ms, pms, nbytes(f1, f0, ko), f1.numel(),
                               lib)

    # K7: every third stripe on the paint tables; and tables of 1/16,
    # where one ulp of a coefficient changes the output
    tab = (torch.arange(S, device=dev) % 3 == 0).to(torch.int32)
    qt = sess._qtab
    for tables in (torch.full_like(qt, 1 / 16), qt):
        pk, pp = f0.clone(), f0.clone()
        ko = JPL.jpeg_forward(f1, pk, tab, tables, sub)
        po = JPL.jpeg_forward_plain(f1, pp, tab, tables, sub)
        err = max_abs_err(list(ko) + [pk], list(po) + [pp])
        check(err == 0, f"jpeg_forward differs from plain (err {err})")
    prev = f0.clone()
    ms = time_fn(lambda: JPL.jpeg_forward(f1, prev, tab, qt, sub), 20,
                 flush=flush, hide_launch=True)
    pms = time_fn(lambda: JPL.jpeg_forward_plain(f1, prev, tab, qt, sub), 3)
    n_blocks = sum(p.shape[0] for p in ko)
    n_chroma_px = ko[1].shape[0] * 64 * 2
    # two 8-term DCT passes (2 flops a multiply-add) and a divide, round
    # and add per coefficient; ~15 flops of CSC a pixel; 4 per chroma mean
    ops = (n_blocks * 64 * (2 * 8 * 2 + 3) + 15 * f1.numel() // 3
           + (4 * n_chroma_px if sub == "420" else 0))
    out["jpeg_forward"] = (err, ms, pms, nbytes(f1, tab, qt, *ko, prev), ops,
                           None)

    # K8 on K7's coefficients
    scan = sess._scan
    k8 = JE.jpeg_events(*ko, scan, S)
    err = max_abs_err(k8, JE.jpeg_events_plain(*ko, scan, S))
    check(err == 0, f"jpeg_events differs from plain (err {err})")
    ms = time_fn(lambda: JE.jpeg_events(*ko, scan, S), 20, flush=flush,
                 hide_launch=True)
    pms = time_fn(lambda: JE.jpeg_events_plain(*ko, scan, S), 3)
    out["jpeg_events"] = (err, ms, pms, nbytes(*ko, scan, *k8),
                          20 * k8[0].numel(), None)

    # K9 at the stock, the grown and too small caps
    for caps, tag in (((e_cap, w_cap, out_cap), "stock"),
                      ((e_cap, 2 * w_cap, 2 * out_cap), "grown"),
                      ((e_cap, 64, 4096), "overflow")):
        k9 = JPP.jpeg_pack(*k8, *caps)
        err = max_abs_err(k9, JPP.jpeg_pack_plain(*k8, *caps))
        check(err == 0, f"jpeg_pack ({tag}) differs from plain (err {err})")
        if tag == "overflow":
            check(k9.flags.tolist() == [1, 1], "jpeg_pack flags not raised")
        elif tag == "stock":
            ms = time_fn(lambda: JPP.jpeg_pack(*k8, *caps), 20, flush=flush,
                         hide_launch=True)
            pms = time_fn(lambda: JPP.jpeg_pack_plain(*k8, *caps), 3)
            # an exclusive scan, the shifts and two adds per slot
            out["jpeg_pack"] = (err, ms, pms, nbytes(*k8, *k9),
                                10 * k8[0].numel(), None)
    return out


def jpeg_frame_times(settings, cases: dict, reps: int = 7) -> dict:
    """Host-clock encode and encode+finalize times (ms) of the JPEG
    session at twice the stock caps (where a session runs after the
    desktop's first frame has grown them): each rep a fresh session, an
    untimed setup frame, then the timed frame."""
    res = {}
    grown = [2 * c for c in jpeg_buffer_caps(
        JpegEncoderSession(settings).grid, settings.fullcolor)[1:]]
    for kind, (f_setup, f_timed) in cases.items():
        enc, ts = [], []
        for _ in range(reps):
            sess = JpegEncoderSession(settings)
            sess._w_cap, sess._out_cap = grown
            sess._rebuild_steps()
            sess.finalize(sess.encode(f_setup))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = sess.encode(f_timed)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            chunks = sess.finalize(out)
            t2 = time.perf_counter()
            check(sess._cap_gen == 0,
                  "JPEG frame timing overflowed the grown buffers")
            enc.append((t1 - t0) * 1e3)
            ts.append((t2 - t0) * 1e3)
        res[kind] = {"encode_ms": statistics.median(enc),
                     "encode_finalize_ms": statistics.median(ts),
                     "chunks": len(chunks),
                     "bytes": sum(len(c.payload) for c in chunks)}
    return res


# ---------------------------------------------------------- capture loop
def watermark_rgba() -> np.ndarray:
    """A seeded RGBA watermark of the largest size a frame takes (a
    quarter of each side: 480x270 at 1080p): 30-pixel tiles of random
    colour, alpha rising left to right from 64 to 255."""
    h, w = HEIGHT // 4, WIDTH // 4
    rng = np.random.default_rng(SEED + 2)
    tiles = rng.integers(0, 256, (h // 30 + 1, w // 30 + 1, 4),
                         dtype=np.uint8)
    rgba = np.repeat(np.repeat(tiles, 30, 0), 30, 1)[:h, :w].copy()
    rgba[..., 3] = np.linspace(64, 255, w).astype(np.uint8)[None, :]
    return rgba


def capture_settings(mode: str, depth: int, fps: float) -> CaptureSettings:
    """The capture run's settings: the codec's defaults (JPEG quality 60;
    H.264 motion search and the band path), a watermark at location 6,
    and nothing that depends on the wall clock (CBR, the keyframe
    cadence and content adaptivity off), so a run's chunks depend on
    the tick alone."""
    return CaptureSettings(capture_width=WIDTH, capture_height=HEIGHT,
                           output_mode=mode, target_fps=fps,
                           pipeline_depth=depth, use_cbr=False,
                           keyframe_interval_s=0,
                           h264_content_adaptive=False,
                           watermark_path="seeded-array",
                           watermark_location=WM_LOCATION)


def seeded_watermark(settings, frame_w: int, frame_h: int, device):
    """Stands in for the sessions' PNG loader (the card's machine has no
    PIL): the seeded array, through the watermark's array constructor."""
    return Watermark.from_rgba(watermark_rgba(), settings.watermark_location,
                               frame_w, frame_h, device)


def capture_run(mode: str, depth: int, fps: float) -> dict:
    """``ScreenCapture("synthetic")`` until CAPTURE_FRAMES frames were
    delivered. -> {"chunks": frame_id -> chunks, "order": frame ids in
    delivery order, "dispatch": frame_id -> (t0, t1) of the encode
    dispatch (the tracer's span), "deliver": frame_id -> (t0, t1) of the
    finalize + callback, "stages": frame_id -> {stage: ns}, the tracer's
    spans summed per frame}."""
    got, deliver, died = [], {}, []
    cap = ScreenCapture("synthetic")
    cap.on_death = died.append
    inner = cap._deliver

    def timed_deliver(out):
        t0 = time.perf_counter_ns()
        n = inner(out)
        deliver[out["frame_id"]] = (t0, time.perf_counter_ns())
        return n
    cap._deliver = timed_deliver
    tracer.clear()
    tracer.enable()
    try:
        cap.start_capture(got.append, capture_settings(mode, depth, fps))
        deadline = time.monotonic() + 120
        while len(deliver) < CAPTURE_FRAMES and not died \
                and time.monotonic() < deadline:
            time.sleep(0.005)
        cap.stop_capture()
        dispatch, stages = {}, {}
        for tl in tracer.snapshot():
            if tl.frame_id is None:
                continue
            per = stages.setdefault(tl.frame_id, {})
            for name, _, t0, dur in tl.spans:
                per[name] = per.get(name, 0) + dur
                if name == "encode.dispatch":
                    dispatch[tl.frame_id] = (t0, t0 + dur)
    finally:
        tracer.disable()
        tracer.clear()
    check(not died, f"{mode} capture (depth {depth}) died: {died[:1]!r}")
    check(len(deliver) >= CAPTURE_FRAMES,
          f"{mode} capture (depth {depth}) delivered {len(deliver)} frames "
          "in 120 s")
    order = list(dict.fromkeys(c.frame_id for c in got))
    chunks = {fid: [dataclasses.astuple(c) for c in got
                    if c.frame_id == fid] for fid in order}
    return {"chunks": chunks, "order": order, "dispatch": dispatch,
            "deliver": deliver, "stages": stages}


def capture_stats(run: dict) -> dict:
    """Delivered fps over the run, dispatch-to-delivery latency per frame
    (ms; from the start of the frame's encode dispatch to the end of its
    delivery), the share of finalize time that overlapped another
    frame's dispatch, the median finalize (readback, packetize and the
    callback) and the median per-frame time of each traced stage (ms;
    a pipelined slot's encode.readback starts when it is submitted, so
    it holds its wait in the ring). Host clock."""
    fids = sorted(set(run["dispatch"]) & set(run["deliver"]))
    lat = [(run["deliver"][f][1] - run["dispatch"][f][0]) / 1e6
           for f in fids]
    ends = sorted(t1 for _, t1 in run["deliver"].values())
    fps = (len(ends) - 1) / ((ends[-1] - ends[0]) / 1e9)
    busy = over = 0
    for f, (a, b) in run["deliver"].items():
        busy += b - a
        for g, (c, d) in run["dispatch"].items():
            if g != f:
                over += max(0, min(b, d) - max(a, c))
    names = sorted({k for per in run["stages"].values() for k in per})
    stage_ms = {k: statistics.median(per.get(k, 0) / 1e6 for per in
                                     run["stages"].values())
                for k in names}
    return {"frames": len(ends), "fps": fps,
            "latency_ms_median": statistics.median(lat),
            "latency_ms_p99": float(np.percentile(lat, 99)),
            "finalize_overlap": over / busy if busy else 0.0,
            "finalize_ms_median": statistics.median(
                (b - a) / 1e6 for a, b in run["deliver"].values()),
            "stage_ms_median": stage_ms}


def check_capture_chunks(mode: str, run: dict) -> None:
    """Every frame of the synthetic desktop changes, so every frame sent
    chunks; JPEG chunks are JFIF stripes, H.264 chunks carry one slice
    per MB row (IDR: SPS and PPS too), the first frame an IDR."""
    plan = port_encoder.plan_grid if mode == "jpeg" \
        else port_h264.plan_h264_grid
    g = plan(capture_settings(mode, 1, 60.0))
    for fid, chunks in run["chunks"].items():
        check(bool(chunks), f"{mode} capture: frame {fid} sent nothing")
        for c in chunks:
            payload, width, height, is_idr = c[0], c[3], c[4], c[5]
            check((width, height) == (g.width, g.stripe_h),
                  f"{mode} capture: chunk geometry")
            if mode == "jpeg":
                check(payload[:2] == b"\xff\xd8" and payload[-2:]
                      == b"\xff\xd9", "capture: JPEG chunk SOI/EOI")
            else:
                n_nal = payload.count(b"\x00\x00\x00\x01")
                want = g.rows_per_stripe + (2 if is_idr else 0)
                check(n_nal == want, "capture: H.264 NAL count")
    if mode == "h264":
        check(all(c[5] for c in run["chunks"][0]),
              "capture: the first H.264 frame is not an IDR")


def capture_path() -> tuple:
    """The fourth path: both codecs through the capture loop, depth 2
    against depth 1 (unpaced), then depth 2 at the default 60 fps
    target. -> ({mode: {run: stats}}, launches of the path)."""
    saved = {m: m.maybe_load for m in (port_encoder, port_h264)}
    for m in saved:
        m.maybe_load = seeded_watermark
    try:
        stats = {}
        _cuda.reset_launches()
        for mode in ("jpeg", "h264"):
            serial = capture_run(mode, 1, 1000.0)
            piped = capture_run(mode, 2, 1000.0)
            paced = capture_run(mode, 2, 60.0)
            for name, run in (("depth1", serial), ("depth2", piped),
                              ("depth2_60fps", paced)):
                check(run["order"] == sorted(run["order"])
                      and run["order"][0] == 0,
                      f"{mode} capture ({name}): frames out of order")
                check_capture_chunks(mode, run)
            for fid in range(CAPTURE_FRAMES):
                check(piped["chunks"].get(fid) == serial["chunks"].get(fid)
                      == paced["chunks"].get(fid),
                      f"{mode} capture: frame {fid} at depth 2 differs from "
                      "depth 1")
            stats[mode] = {"depth1": capture_stats(serial),
                           "depth2": capture_stats(piped),
                           "depth2_60fps": capture_stats(paced)}
        torch.cuda.synchronize()
        launches = dict(_cuda.LAUNCHES)
    finally:
        for m, fn in saved.items():
            m.maybe_load = fn
    for k in CAPTURE_PATH:
        check(launches[k] > 0, f"capture path never launched {k}")
    return stats, launches


def frame_kernel_checks(dev) -> dict:
    """K10-K12 against their plain versions at the capture path's 1080p
    shapes (tolerance 0), then timed beside the plain version, the bound
    and, for K11, ``F.pad``."""
    l2 = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    flush = (lambda: flush_l2(l2))
    out = {}
    H, W = HEIGHT, WIDTH
    GH = (HEIGHT + 63) // 64 * 64            # the 64-row stripe grid

    # K10 at a tick whose bar and block products wrap int32, and at 7
    for tick in (7, 306783379, 429496730):
        ko = FR.synthetic_frame(H, W, tick, dev)
        err = max_abs_err([ko], [FR.synthetic_frame_plain(H, W, tick, dev)])
        check(err == 0, f"synthetic_frame (tick {tick}) differs (err {err})")
    ms = time_fn(lambda: FR.synthetic_frame(H, W, 7, dev), 20, flush=flush,
                 hide_launch=True)
    pms = time_fn(lambda: FR.synthetic_frame_plain(H, W, 7, dev), 3)
    # ~12 integer operations a byte (compares, selects, a divide)
    out["synthetic_frame"] = (err, ms, pms, nbytes(ko), 12 * ko.numel(),
                              None)

    # K11: the 1080p capture into the 1088-row grid
    frame = FR.synthetic_frame(H, W, 7, dev)
    ko = FR.pad_frame(frame, GH, W)
    err = max_abs_err([ko], [FR.pad_frame_plain(frame, GH, W)])
    lib_out = torch.nn.functional.pad(frame, (0, 0, 0, 0, 0, GH - H))
    check(err == 0 and torch.equal(ko, lib_out),
          f"pad_frame differs from plain or F.pad (err {err})")
    ms = time_fn(lambda: FR.pad_frame(frame, GH, W), 20, flush=flush,
                 hide_launch=True)
    pms = time_fn(lambda: FR.pad_frame_plain(frame, GH, W), 3)
    lib = time_fn(lambda: torch.nn.functional.pad(
        frame, (0, 0, 0, 0, 0, GH - H)), 20, flush=flush, hide_launch=True)
    out["pad_frame"] = (err, ms, pms, nbytes(frame, ko), 0, lib)

    # K12: the seeded 480x270 watermark at its location-6 anchor
    wm = Watermark.from_rgba(watermark_rgba(), WM_LOCATION, W, H, dev)
    args = (wm._rgb, wm._a, wm._y0, wm._x0)
    k, p = ko.clone(), ko.clone()
    FR.watermark_blend(k, *args)
    FR.watermark_blend_plain(p, *args)
    err = max_abs_err([k], [p])
    check(err == 0 and not torch.equal(k, ko),
          f"watermark_blend differs from plain (err {err})")
    work = ko.clone()
    ms = time_fn(lambda: FR.watermark_blend(work, *args), 20,
                 restore=lambda: work.copy_(ko), flush=flush,
                 hide_launch=True)
    pms = time_fn(lambda: FR.watermark_blend_plain(work, *args), 3,
                  restore=lambda: work.copy_(ko))
    region = 3 * wm.wh * wm.ww
    # the region read and written, rgb and alpha read; 5 flops a byte
    out["watermark_blend"] = (err, ms, pms,
                              2 * region + nbytes(wm._rgb, wm._a),
                              5 * region, None)
    return out



def run_path(name: str, path: tuple, run) -> tuple:
    """Counters to 0, ``run()``, counters read: every kernel of ``path``
    must have launched. -> (run's result, launches)."""
    _cuda.reset_launches()
    t0 = time.perf_counter()
    log = run()
    torch.cuda.synchronize()
    launches = dict(_cuda.LAUNCHES)
    print(f"{name} sequence: {len(log)} frames in "
          f"{time.perf_counter() - t0:.2f} s; launches {launches}")
    for k in path:
        check(launches[k] > 0, f"{name} path never launched {k}")
    return log, launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(smi.splitlines()[0] if smi else "nvidia-smi: no output")
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    info = _cuda.build()
    print(f"kernel build: {info['seconds']:.1f} s -> {info['dir']}")
    for name, text in info["ptxas"].items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas[{name}]: {line.strip()}")

    # 1. the stock configuration
    settings = CaptureSettings(capture_width=WIDTH, capture_height=HEIGHT,
                               output_mode="h264", h264_motion_vrange=0,
                               h264_partial_encode=False,
                               paint_over_delay_frames=4)
    kern = H264EncoderSession(settings)
    plain = plain_session(dataclasses.replace(settings))
    g = kern.grid
    frames = desktop_frames(g.height, g.width, settings.capture_height)
    dev_frames = [torch.as_tensor(f).to(kern.device) for f in frames]
    klog, stock_launches = run_path("stock", STOCK_PATH,
                                    lambda: run_sequence(kern, dev_frames))
    check(stock_launches["motion_select"] == 0
          and stock_launches["row_damage_probe"] == 0,
          "the stock path launched K5 or K6")
    check_stream(klog, kern)
    plog = run_sequence(plain, dev_frames)
    compare_runs(klog, plog)
    print("stock: kernel path == plain path: chunks and state, "
          f"{len(klog)} frames")

    # 2. the default configuration: motion search and the band path
    dsettings = dataclasses.replace(settings, h264_motion_vrange=24,
                                    h264_motion_hrange=8,
                                    h264_partial_encode=True)
    dkern = H264EncoderSession(dsettings)
    dplain = plain_session(dsettings)
    seq = [(n, torch.as_tensor(f).to(dkern.device), force)
           for n, f, force in default_frames(g.height, g.width,
                                             settings.capture_height)]
    dlog, launches = run_path(
        "default", DEFAULT_PATH,
        lambda: run_default_sequence(dkern, seq, check_idle=True))
    check_default_log(dlog, seq, dkern)
    dplog = run_default_sequence(dplain, seq)
    compare_runs(dlog, dplog)
    print("default: kernel path == plain path: chunks, state, mv fields, "
          f"bands, {len(dlog)} frames: "
          + json.dumps([[n, b, len(c)] for (n, _, _), (c, _, b, _)
                        in zip(seq, dlog)]))
    full_dirty_equals_stock(dsettings, seq)
    print("default: the full-dirty band equals the stock P step with motion")

    # 3. the JPEG stripe session at its defaults (paint delay 4)
    jsettings = CaptureSettings(capture_width=WIDTH, capture_height=HEIGHT,
                                paint_over_delay_frames=4)
    jkern = JpegEncoderSession(jsettings)
    jplain = plain_jpeg_session(dataclasses.replace(jsettings))
    jg = jkern.grid
    jframes = [torch.as_tensor(f).to(jkern.device) for f in desktop_frames(
        jg.height, jg.width, jsettings.capture_height)]
    jseq = jpeg_script(jframes)
    jlog, jpeg_launches = run_path(
        "jpeg", JPEG_PATH,
        lambda: run_jpeg_sequence(jkern, jseq, check_idle=True))
    check_jpeg_log(jlog, jseq, jkern)
    compare_runs(jlog, run_jpeg_sequence(jplain, jseq))
    print("jpeg: kernel path == plain path: chunks, prev and age, "
          f"{len(jlog)} frames: "
          + json.dumps([[n, len(c)] for (n, _, _), (c, _) in zip(jseq, jlog)]))

    # 4. the capture loop, both codecs, depth 2 against depth 1
    t0 = time.perf_counter()
    cstats, capture_launches = capture_path()
    print(f"capture sequence: {CAPTURE_FRAMES} frames a run, 3 runs a codec "
          f"in {time.perf_counter() - t0:.2f} s; launches "
          f"{json.dumps(capture_launches)}")
    print("capture: depth 2 == depth 1 (and depth 2 at 60 fps), chunk for "
          f"chunk, frames 0..{CAPTURE_FRAMES - 1}, in order, both codecs")
    for mode, runs in cstats.items():
        for name, st in runs.items():
            print(f"capture loop {mode} {name} ({WIDTH}x{HEIGHT}, host "
                  f"clock): " + json.dumps(st))

    # the overflow episodes grew the buffers: the kernels are checked and
    # timed at the stock caps
    stock = H264EncoderSession(settings)
    recs = kernel_checks(frames, stock, (kern._w_cap, kern._out_cap))
    jstock = JpegEncoderSession(jsettings)
    jrecs = jpeg_kernel_checks(desktop_frames(jg.height, jg.width,
                                              jsettings.capture_height),
                               jstock)
    k6_stripes = jrecs.pop("row_damage_probe")
    recs.update(jrecs)
    recs.update(frame_kernel_checks(stock.device))
    f2, f3 = (torch.as_tensor(f).cuda() for f in frames[2:4])
    times = frame_times(settings, {"I": (f3, f2, True),
                                   "P": (f3, f2, False)})
    base = seq[0][1]
    typed = base.clone()
    typed[typing_rows(g.height), 300:420] = 20
    dtimes = frame_times(dsettings, {"I": (base, base, True),
                                     "scroll_P": (base, seq[1][1], False),
                                     "typing_P": (base, typed, False)})
    jf0, jf1 = jframes[:2]
    jtimes = jpeg_frame_times(jsettings, {"full": (255 - jf0, jf0),
                                          "damaged": (jf0, jf1),
                                          "idle": (jf1, jf1)})
    syncs = sync_checks(settings, dsettings, base, typed)
    jsess = JpegEncoderSession(jsettings)
    jsess.finalize(jsess.encode(jf0))
    jsyncs = {}
    for kind, frame in (("damaged", jf1), ("idle", jf1)):
        out, jsyncs[kind] = count_syncs(lambda: jsess.encode(frame))
        jsess.finalize(out)
    check(all(not v for v in jsyncs.values()),
          f"syncs inside the JPEG encode(): {jsyncs}")
    print(f"host syncs inside encode(): {json.dumps(syncs)}; "
          f"jpeg: {json.dumps(jsyncs)}")
    print(f"buffer caps: stock w_cap {stock._w_cap} out_cap "
          f"{stock._out_cap}; after the overflow episode w_cap "
          f"{kern._w_cap} out_cap {kern._out_cap}; jpeg stock w_cap "
          f"{jstock._w_cap} out_cap {jstock._out_cap}, after its episode "
          f"{jkern._w_cap} / {jkern._out_cap}")
    print(f"frame times, stock configuration (ms, host clock, "
          f"{g.width}x{g.height}, stock caps): " + json.dumps(times))
    print(f"frame times, default configuration (ms, host clock, "
          f"{g.width}x{g.height}, stock caps): " + json.dumps(dtimes))
    print(f"frame times, jpeg (ms, host clock, {jg.width}x{jg.height}, "
          f"2x stock caps, median of 7): " + json.dumps(jtimes))
    print(f"stock path launches: {json.dumps(stock_launches)}")
    print(f"jpeg path launches: {json.dumps(jpeg_launches)}")
    err, ms, pms, by, ops, lib = k6_stripes
    print(f"  row_damage_probe at stripe granularity ({jg.n_stripes} "
          f"stripes): {ms:.4f} ms (plain {pms:.2f} ms, bound "
          f"{max(by / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S) * 1e3:.4f} ms, "
          f"library {lib:.4f} ms)")
    # library_ms: K6's one-expression torch counterpart and F.pad for
    # K11; null elsewhere, since no single PyTorch call does CSC +
    # subsampling + damage (K1), the H.264 transforms, CAVLC or bit
    # packing (K2-K5), CSC + DCT + quantisation + zigzag (K7), Huffman
    # events (K8), bit packing (K9), the synthetic pattern (K10) or a
    # blend rounded half to even, clipped and written back (K12)
    rows = []
    for name, (src, replaces) in KERNELS.items():
        err, ms, pms, by, ops, lib = recs[name]
        t_bytes = by / HBM_BYTES_PER_S * 1e3
        t_ops = ops / FP32_OPS_PER_S * 1e3
        n = launches[name] if name in DEFAULT_PATH else 0
        n += jpeg_launches[name] if name in JPEG_PATH else 0
        n += capture_launches[name]
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces, "launches": n,
                     "max_abs_err": err, "ms": ms, "plain_ms": pms,
                     "bound_ms": max(t_bytes, t_ops),
                     "bound_by": "bytes" if t_bytes >= t_ops
                     else "operations",
                     "library_ms": lib})
        print(f"  {name}: launches {n}, {ms:.4f} ms "
              f"(plain {pms:.2f} ms, bound {max(t_bytes, t_ops):.4f} ms"
              + (f", library {lib:.4f} ms" if lib is not None else "")
              + ")")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
