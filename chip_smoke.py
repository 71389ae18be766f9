"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the CUDA kernels of selkies_tpu_torch from csrc/ and drives two
1920x1080 H.264 4:2:0 sequences and one 1920x1080 JPEG sequence through
them, each beside the same sequence through the kernels' plain PyTorch
versions on the same card, requiring equal chunks and equal state frame
by frame, then the capture loop for both codecs, then both H.264
sequences and the H.264 capture loop again at 4:4:4, then four seats of
each codec through the multi-seat encoders and their capture loop, then
the default H.264 sequence again with ROI QP, then split-frame H.264:

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
   unpaced and at the default 60 fps target;
5. fullcolor (4:4:4, High 4:4:4 Predictive): the stock sequence of 1 and
   the default sequence of 2 (its full-dirty band again equal to the
   stock P step with motion) at ``fullcolor=True``, kernels against plain,
   where K13-K16 and K5's 4:4:4 entry replace K1, K2, K3 and K5's 4:2:0
   entry, which must not launch; then the capture loop of 4 for H.264
   at fullcolor, depth 2 against depth 1;
6. seats (multi-seat, the ``tpu_seats`` path): ``MultiSeatEncoder``
   (JPEG) and ``MultiSeatH264Encoder`` (4:2:0, motion vrange 24 /
   hrange 8) at 4 seats of 1920x1080, every kernel launched once a tick
   for all seats (K4, K9 and K10 through their seat entries), over a
   script of a full first tick, seats that differ (idle, typing, fully
   damaged, scrolling), idle and paint-over ticks, a forced tick and a
   planned overflow of one seat's byte buffer with the growth and that
   seat's recovery. The kernel path must equal the plain path (chunks
   and state), each seat its own single-seat session (so the seats that
   did not overflow are untouched by the one that did), and
   ``MultiSeatCapture`` at depth 2 its depth-1 run. Launches per tick
   are counted at 1, 2, 4 and 8 seats (each kernel once, whatever the
   seat count), and a full-damage tick is timed at each;
7. roi (``h264_roi_qp``): the sequence of 2 with ROI QP, once at the
   default bias 4 and once at bias 12 after ``set_qp(12)``, where the
   lower clip to QP 8 bites, kernels against plain; every band frame
   must launch K17 ``roi_qp_plane``, K2-P's per-MB-QP entry and K18
   ``mb_qp_delta`` once each (and K2-P's row-QP entry never), and the
   other six paths none of them;
8. stripes (split-frame, ``stripe_devices``), shards on ``cuda:0``: the
   sharded frame entries (I at 2 and 4 shards and 3 shards padded over
   the 68 MB rows, P with 17-row windows and across the halo with the
   whole frame as the window, 4:4:4 I and halo P; 57 candidates), each
   equal to the unsharded frame entry and to its plain run, every halo
   frame launching K20 ``halo_bands`` three times and K19
   ``motion_select_halo`` once; then ``StripeShardedH264Session`` at
   272-row stripes (4 stripes, 4 shards) over the stock sequence of 1,
   its overflow episode cutting each shard's buffer, and the default
   sequence of 2, at 4:2:0 and 4:4:4, read by ``finalize`` and
   ``finalize_stream`` in turn, every frame launching each kernel of its
   step once (K4 through its seat entry), equal to its plain run and
   to ``H264EncoderSession`` chunk for chunk; then ``stripe_devices=4``
   with no device list, which resolves to one shard on one card and
   must equal path 2, band path included.

Each run resets the launch counters first and requires every kernel of
its path to have launched. Then each kernel is held against its plain
version at the 1080p shapes of the main path (tolerance 0: every output
is an integer) and timed with CUDA events beside the plain version, its
bound and, where one exists, one PyTorch call computing the same
function. K3 and K4 are also timed on the P inputs, on bands of 4 and 16
rows of them, at 4:4:4, at 1, 2, 4 and 8 seats and on 4 split-frame
shards; K16 on the 4:4:4 I and P inputs, on bands of 4 and 16 rows of
the P events (views) and on the 4 shards' I events; K5 and its 4:4:4
entry at 1080p and on bands of 4 and 16 rows (views at a stripe
boundary, each band equal to the plain version); K19 and its 4:4:4
entry at 4 shards; K2-P through both entries at 1080p, with zero motion
(the prediction the reference planes themselves) and on bands of 4 and
16 rows (views at a stripe boundary, each equal to the plain version,
reference planes included); K10 at 1080p and its seat entry at 1, 2, 4
and 8 seats, each seat count beside a ``fill_`` of the same bytes (the
card's write rate under the same protocol, a yardstick); K9 at 1080p at
the stock and twice the stock caps and its seat entry at 1, 2, 4 and 8
seats; K15 at 1080p, with zero motion and on 4:4:4 bands of 4 and 16
rows (views at a stripe boundary, each equal to the plain version,
reference planes included); K1 at 1080p, on an idle frame (prev equal
to the frame) and on bands of 4 and 16 rows of a scrolled frame (views
at a stripe boundary, one stripe), its bound counted from the bytes it
must move on the run's data (the 16-byte pieces of prev that differ, not
all of prev; the all-bytes bound printed beside it), and a
torch.profiler trace showing that one K1 launch is one device
operation; K7 at 1080p at 4:2:0 and 4:4:4 and on the stacked frame of 4
seats, each equal to the plain version; K2-I at 1080p (qp mixed by row,
every other stripe sent), at qp 0 and 51 and on 4 stacked seats (272 MB
rows); K6 at 1080p MB rows, at the JPEG step's 17 stripes, on 4 stacked
seats (68 stripes), on an idle and on a fully damaged frame, each equal
to the plain version, and a torch.profiler trace showing that one K6
launch is one device operation; K8 at 1080p 4:2:0 on K7's coefficients
at quality 60 and at 90, at 4:4:4 and on 4 stacked seats (68 stripes);
K11 at 1080p into the 1088-row grid, at 3840x2160 into 3840x2176, at
1366x768 into 1376x768 and from a 1080p source view one byte into its
storage, each beside ``F.pad`` of the same frame; each equal to the
plain version, with torch.profiler traces showing that one K8 and one
K11 launch are one device operation each; K14 at 1080p (qp mixed by row,
every other stripe sent), at qp 0 and 51 and on 4 stacked frames (272 MB
rows); K13 at 1080p, on an idle and a fully damaged frame and on bands
of 4 and 16 rows (K1 on the fully damaged frame as well), its bound
counted as K1's, and a torch.profiler trace showing that one K13 launch
is one device operation; K12 with the seeded 480x270 watermark at
location 6 of the 1080p grid and of 1366x768 in its 1376-wide grid
(where the region's bytes start off a 4-byte word); K17 at bias 4 on
the 1080p frame, an idle and a fully dirty one and on bands of 4 and 16
rows; each equal to the plain version, with torch.profiler traces
showing that one K12 and one K17 launch are one device operation each
(the "K3 / K4 / K16 / K5 / K19 / K2-P / K10 / K9 / K15 / K1 / K7 / K2-I
/ K6 / K8 / K11 / K14 / K13 / K12 / K17 timing points" line).
The main path's three step shapes (stock I, full-frame P band,
one-stripe P band) are timed on the device between CUDA events, the
host's enqueue hidden behind a spin kernel, for the default session
and for the fullcolor default session, the two band steps again with
ROI QP at bias 4, and the JPEG step (K6-K9) on a full 1080p frame and
an idle one (the four "step device times" lines). Exits non-zero on any mismatch, launch error or kernel a path
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

from selkies_tpu_torch.codecs import h264 as hcodec
from selkies_tpu_torch.codecs import jpeg as jtab
from selkies_tpu_torch.engine import ScreenCapture
from selkies_tpu_torch.engine import encoder as port_encoder
from selkies_tpu_torch.engine import h264_encoder as port_h264
from selkies_tpu_torch.engine import state as port_state
from selkies_tpu_torch.engine.encoder import (JpegEncoderSession,
                                              jpeg_buffer_caps)
from selkies_tpu_torch.engine.h264_encoder import (H264EncoderSession,
                                                   StripeShardedH264Session,
                                                   h264_buffer_caps,
                                                   plan_h264_grid)
from selkies_tpu_torch.engine.types import CaptureSettings
from selkies_tpu_torch.engine.watermark import Watermark
from selkies_tpu_torch.ops import _cuda
from selkies_tpu_torch.ops import frames as FR
from selkies_tpu_torch.ops import h264_planes as HP
from selkies_tpu_torch.ops import h264_planes444 as H4
from selkies_tpu_torch.ops.dct import zigzag_order
from selkies_tpu_torch.ops import jpeg_entropy as JE
from selkies_tpu_torch.ops import jpeg_pipeline as JPP
from selkies_tpu_torch.ops import jpeg_planes as JPL
from selkies_tpu_torch.ops.h264_encode import (motion_select,
                                               motion_select444,
                                               motion_select444_plain,
                                               motion_select_plain,
                                               scroll_candidates)
from selkies_tpu_torch.parallel import (MultiSeatCapture, MultiSeatEncoder,
                                        MultiSeatH264Encoder,
                                        synthetic_seat_frames)
from selkies_tpu_torch.parallel import stripes as ST
from selkies_tpu_torch.server import metrics
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
    "csc444_damage": ("selkies_tpu_torch/csrc/csc444_damage.cu",
                      "selkies_tpu/ops/h264_planes444.py:53"),
    "mb_encode_i444": ("selkies_tpu_torch/csrc/mb_encode444.cu",
                       "selkies_tpu/ops/h264_planes444.py:89"),
    "mb_encode_p444": ("selkies_tpu_torch/csrc/mb_encode444.cu",
                       "selkies_tpu/ops/h264_planes444.py:277"),
    "cavlc_events444": ("selkies_tpu_torch/csrc/cavlc_events.cu",
                        "selkies_tpu/ops/h264_planes444.py:109"),
    "motion_select444": ("selkies_tpu_torch/csrc/motion_select.cu",
                         "selkies_tpu/ops/h264_planes444.py:242"),
    "pack_stream_seats": ("selkies_tpu_torch/csrc/pack_stream.cu",
                          "selkies_tpu/parallel/h264_seats.py:98"),
    "jpeg_pack_seats": ("selkies_tpu_torch/csrc/jpeg_pack.cu",
                        "selkies_tpu/parallel/seats.py:93"),
    "synthetic_frames": ("selkies_tpu_torch/csrc/synthetic_frame.cu",
                         "selkies_tpu/parallel/seats.py:267"),
    "roi_qp_plane": ("selkies_tpu_torch/csrc/roi_qp_plane.cu",
                     "selkies_tpu/engine/h264_encoder.py:317"),
    "mb_encode_p_qp": ("selkies_tpu_torch/csrc/mb_encode.cu",
                       "selkies_tpu/ops/h264_planes.py:875"),
    "mb_qp_delta": ("selkies_tpu_torch/csrc/mb_qp_delta.cu",
                    "selkies_tpu/ops/h264_planes.py:1089"),
    "motion_select_halo": ("selkies_tpu_torch/csrc/motion_select.cu",
                           "selkies_tpu/parallel/stripes.py:234"),
    "motion_select_halo444": ("selkies_tpu_torch/csrc/motion_select.cu",
                              "selkies_tpu/parallel/stripes.py:234"),
    "halo_bands": ("selkies_tpu_torch/csrc/halo_bands.cu",
                   "selkies_tpu/parallel/stripes.py:218"),
    # K4's seat entry at 4:4:4's slot counts (the split frame's shards)
    "pack_stream_seats444": ("selkies_tpu_torch/csrc/pack_stream.cu",
                             "selkies_tpu/parallel/stripes.py:156"),
}
#: kernels each path launches
STOCK_PATH = ("csc420_damage", "mb_encode_i", "mb_encode_p", "cavlc_events",
              "pack_stream")
DEFAULT_PATH = STOCK_PATH + ("motion_select", "row_damage_probe")
JPEG_PATH = ("row_damage_probe", "jpeg_forward", "jpeg_events", "jpeg_pack")
CAPTURE_PATH = DEFAULT_PATH + JPEG_PATH + ("synthetic_frame", "pad_frame",
                                           "watermark_blend")
STOCK444_PATH = ("csc444_damage", "mb_encode_i444", "mb_encode_p444",
                 "cavlc_events444", "pack_stream")
DEFAULT444_PATH = STOCK444_PATH + ("motion_select444", "row_damage_probe")
CAPTURE444_PATH = DEFAULT444_PATH + ("synthetic_frame", "pad_frame",
                                     "watermark_blend")
#: the 4:2:0 kernels whose places the 4:4:4 ones take
NOT_ON_444 = ("csc420_damage", "mb_encode_i", "mb_encode_p", "cavlc_events",
              "motion_select")
#: one tick of the seats path, by codec and mode
SEATS_JPEG_TICK = ("row_damage_probe", "jpeg_forward", "jpeg_events",
                   "jpeg_pack_seats")
SEATS_H264_I = ("csc420_damage", "mb_encode_i", "cavlc_events",
                "pack_stream_seats")
SEATS_H264_P = ("csc420_damage", "motion_select", "mb_encode_p",
                "cavlc_events", "pack_stream_seats")
SEATS_PATH = tuple(dict.fromkeys(SEATS_JPEG_TICK + SEATS_H264_I
                                 + SEATS_H264_P + ("synthetic_frames",)))
#: the default path with ROI QP: K17 and K18, and K2-P's per-MB-QP entry
#: in place of its row-QP one on the band frames (I frames keep K2-I)
ROI_KERNELS = ("roi_qp_plane", "mb_qp_delta", "mb_encode_p_qp")
ROI_PATH = tuple(k for k in DEFAULT_PATH if k != "mb_encode_p") + ROI_KERNELS
ROI_RUNS = ((4, None), (12, 12))  # (bias, set_qp) of the seventh path
#: the split frame's kernels (eighth path), by chroma format: the stock
#: step's with K4's seat entry, and on halo frames K20 and K19
STRIPES_PATH = ("csc420_damage", "mb_encode_i", "mb_encode_p",
                "cavlc_events", "pack_stream_seats", "motion_select",
                "halo_bands", "motion_select_halo")
STRIPES444_PATH = ("csc444_damage", "mb_encode_i444", "mb_encode_p444",
                   "cavlc_events444", "pack_stream_seats", "motion_select444",
                   "halo_bands", "motion_select_halo444")
STRIPE_SHARDS = 4                # shards of the eighth path's session
STRIPE_HEIGHT = 272              # its stripes: 4 over the 1088-row grid
SEATS = 4                        # seats of the sixth path
SEAT_COUNTS = (1, 2, 4, 8)       # seat counts of the launch and time rows
NOISY_SEAT = 2                   # the seat whose buffer the script overflows
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
    the card (of its chroma format): the path the kernel session is held
    against."""
    sess = H264EncoderSession(settings)
    sess._ops = H4.PLAIN_OPS_444 if settings.fullcolor else HP.PLAIN_OPS
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


def finish(sess, out, i: int, stream: bool) -> list:
    """Frame ``i``'s chunks: ``finalize``, or with ``stream`` every other
    frame through ``finalize_stream`` (byte-identical)."""
    if stream and i % 2:
        return list(sess.finalize_stream(out))
    return sess.finalize(out)


def shrunk_cap(chunks) -> int:
    """Two thirds of an IDR's bytes: a byte buffer it overflows and whose
    double holds it."""
    return sum(len(c.payload) for c in chunks) * 2 // 3


def run_sequence(sess: H264EncoderSession, frames, shrink=shrunk_cap,
                 stream: bool = False) -> list:
    """IDR -> damaged P -> idle -> paint-over -> forced IDR -> P ->
    overflow episode (out_cap shrunk to ``shrink`` of the forced IDR's
    chunks) -> forced IDR -> P; with ``stream`` every other frame is
    read by ``finalize_stream``. -> per frame (chunks, state snapshot)."""
    f0, f1, f2, f3 = frames
    script = [(f0, False), (f1, False), (f2, False), (f2, False),
              (f2, False), (f2, False), (f2, False), (f2, True), (f3, False)]
    log = []

    def step(frame, force):
        chunks = finish(sess, sess.encode(frame, force=force), len(log),
                        stream)
        log.append((chunks, snapshot(sess)))
        return chunks

    idr_chunks = []
    for i, (frame, force) in enumerate(script):
        chunks = step(frame, force)
        if i == 7:
            idr_chunks = chunks
    # overflow episode: shrink the byte buffer below the forced IDR
    sess._out_cap = shrink(idr_chunks)
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


def run_default_sequence(sess, seq, check_idle: bool = False,
                         stream: bool = False) -> list:
    """-> per frame (chunks, state snapshot, band, last_band_rows). With
    ``check_idle`` the idle frames must launch the probe and nothing else
    (the launch counters of the kernel wrappers); with ``stream`` every
    other frame is read by ``finalize_stream``."""
    log = []
    for name, frame, force in seq:
        before = dict(_cuda.LAUNCHES)
        out = sess.encode(frame, force=force)
        chunks = finish(sess, out, len(log), stream)
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
            hide_launch: bool = False, spin: int = 2_000_000) -> float:
    """Median per-call time (ms) between CUDA events; ``restore`` resets
    in-place inputs and ``flush`` evicts L2, both untimed. With
    ``hide_launch`` a spin kernel of ``spin`` cycles runs first so the
    host has enqueued the call before the first event fires: the time is
    then device time only (for the kernels; the plain versions wait on
    the host)."""
    times = []
    for _ in range(reps):
        if restore is not None:
            restore()
        if flush is not None:
            flush()
        if hide_launch:
            torch.cuda._sleep(spin)
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


def k9_bytes(nbits, outs) -> int:
    """The bytes K9 must move on these inputs: all of nbits, only the
    16-byte payload pieces (4 slots) that hold an event, and its
    outputs."""
    pieces = int((nbits.reshape(-1, 4) != 0).any(dim=1).sum())
    return nbytes(nbits, *outs) + 16 * pieces


def bound_ms(by: int, ops: int) -> float:
    """The least time the card could take: bytes over the memory rate or
    operations over the fp32 rate, whichever is larger (ms)."""
    return max(by / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S) * 1e3


#: K3 / K4 / K16 / K5 / K19 / K2-P / K10 / K9 / K15 / K1 / K7 / K2-I / K6
#: / K8 / K11 / K14 / K13 / K12 / K17 timing points beyond the kernels
#: line:
#: shape -> record
POINTS: dict = {}


def point(name: str, ms: float, by: int, ops: int, pms=None,
          lib=None) -> None:
    POINTS[name] = {"ms": ms, "bound_ms": bound_ms(by, ops),
                    "plain_ms": pms}
    if lib is not None:
        POINTS[name]["library_ms"] = lib


def one_op_a_launch(name: str, call) -> None:
    """Print the device operations of 4 launches of ``call`` (one kernel
    launch each, by torch.profiler) and require one a launch."""
    n = 4
    dops = device_ops(call, n)
    print(f"{name} device operations per launch (torch.profiler, {n} "
          f"launches traced): {len(dops) / n:g} "
          f"{json.dumps(sorted(set(dops)))}")
    check(len(dops) == n and len(set(dops)) == 1,
          f"{n} {name} launches made {len(dops)} device operations")


def motion_points(name: str, kern, plain, cur, ref, qp, cands, win: int,
                  rps: int, cdiv: int, flush) -> None:
    """K5 entry ``kern`` on bands of ``rps`` and ``4 * rps`` MB rows of
    the frame (views at a stripe boundary, as the band step hands them
    over), each equal to ``plain`` (tolerance 0), timed as timing
    points."""
    R, M = cur.shape[0] // 16, cur.shape[1] // 16
    r0 = (R // 2) // rps * rps
    for n in (rps, 4 * rps):
        band = [t.narrow(0, 16 * r0 // c, 16 * n // c)
                for t, c in zip((cur, *ref), (1, 1, cdiv, cdiv))]
        bqp = qp.narrow(0, r0, n)
        ko = kern(*band, bqp, cands, win)
        err = max_abs_err(ko, plain(*band, bqp, cands, win))
        check(err == 0, f"{name} ({n}-row band) differs (err {err})")
        ms = time_fn(lambda: kern(*band, bqp, cands, win, out=ko), 20,
                     flush=flush, hide_launch=True)
        point(f"{name} band{n}", ms, nbytes(*band, bqp, *ko),
              3 * 256 * len(cands) * n * M)


def p_coder_points(planes, qp, send_rows, pred, mv, i_ref, rps: int,
                   flush, name: str = "mb_encode_p", kern=HP.mb_encode_p,
                   plain=HP.mb_encode_p_plain, cdiv: int = 2,
                   blocks: int = 24) -> None:
    """A P coder (K2-P's row-QP entry; K15 with ``cdiv`` 1, its chroma
    planes at full resolution, and 48 blocks an MB) on the 1080p P inputs
    with zero motion (mv null, the prediction the reference planes
    themselves, as the stock step runs it), then on bands of ``rps`` and
    ``4 * rps`` MB rows (views at a stripe boundary of the planes, the
    prediction and the reference, as the band step hands them over), each
    equal to the plain version (tolerance 0, the whole reference planes
    included), timed as timing points. The reference is restored,
    untimed, before each call."""
    R, M = qp.shape[0], planes[0].shape[1] // 16
    ops = 1200 * blocks * M
    divs = (1, cdiv, cdiv)

    def rows(t, r0, n, c):
        return t.narrow(0, 16 * r0 // c, 16 * n // c)
    r0 = (R // 2) // rps * rps
    cases = [("zero-mv", 0, R)] + [(f"band{n}", r0, n)
                                   for n in (rps, 4 * rps)]
    for tag, b0, n in cases:
        def args(work, b0=b0, n=n, tag=tag):
            bp = [rows(t, b0, n, c) for t, c in zip(planes, divs)]
            bref = [rows(t, b0, n, c) for t, c in zip(work, divs)]
            if tag == "zero-mv":
                return (*bp, qp, send_rows, *bref, None, *bref)
            bpred = [rows(t, b0, n, c) for t, c in zip(pred, divs)]
            return (*bp, qp.narrow(0, b0, n), send_rows.narrow(0, b0, n),
                    *bpred, mv.narrow(0, b0, n), *bref)
        outs = []
        for fn in (kern, plain):
            work = [t.clone() for t in i_ref]
            outs.append(list(fn(*args(work))) + work)
        err = max_abs_err(outs[0], outs[1])
        check(err == 0, f"{name} ({tag}) differs from plain (err {err})")
        work = [t.clone() for t in i_ref]
        a = args(work)

        def restore():
            for w, b in zip(work, i_ref):
                w.copy_(b)
        ms = time_fn(lambda: kern(*a), 20, restore=restore,
                     flush=flush, hide_launch=True)
        frac = float(send_rows.narrow(0, b0, n).float().mean())
        # inputs (the prediction read once, also where it is the
        # reference) and outputs once, the reference written where sent
        by = nbytes(*(t for t in a[:9] if t is not None),
                    *outs[0][:4]) + int(nbytes(*a[9:]) * frac)
        point(f"{name} {'1080p ' if tag == 'zero-mv' else ''}{tag}",
              ms, by, ops * n)


def k1_bytes(frame, prev, outs) -> int:
    """The bytes K1 must move on these inputs: the frame and prev read,
    Y, U, V and the flags written, and the 16-byte pieces of prev that
    differ from the frame (its rows are whole 16-byte pieces at the
    shapes timed here)."""
    pieces = int((frame.reshape(-1, 16) != prev.reshape(-1, 16))
                 .any(dim=1).sum())
    return nbytes(frame, prev, *outs) + 16 * pieces


def k1_points(f1, f0, S: int, rps: int, flush, f2s, name="csc420_damage",
              kern=HP.csc420_damage, plain=HP.csc420_damage_plain,
              tag="K1", ops_px: float = 10.0):
    """A CSC + damage kernel (K1; K13 with ``name`` csc444_damage and its
    functions) at 1080p (f1 over prev f0), on an idle frame (prev ==
    frame), on a fully damaged one (every piece of prev differs) and on
    bands of ``rps`` and ``4 * rps`` MB rows of a scrolled frame (views at
    a stripe boundary, one stripe, as the band step hands them over), each
    equal to the plain version (tolerance 0, prev included), timed as
    timing points with prev restored, untimed, before each call.
    ``ops_px``: operations a pixel. -> (1080p ms, plain ms, bytes) for
    the kernels line."""
    R = f1.shape[0] // 16
    r0 = (R // 2) // rps * rps
    cases = [("1080p", f1, f0, S), ("idle", f1, f1, S),
             ("full", 255 - f0, f0, S)]
    cases += [(f"band{n}", f2s.narrow(0, 16 * r0, 16 * n),
               f1.narrow(0, 16 * r0, 16 * n), 1) for n in (rps, 4 * rps)]
    rec = None
    for case, frame, base, n_str in cases:
        pk, pp = base.clone(), base.clone()
        ko = kern(frame, pk, n_str)
        err = max_abs_err(list(ko) + [pk],
                          list(plain(frame, pp, n_str)) + [pp])
        check(err == 0, f"{name} ({case}) differs from plain (err {err})")
        if case == "idle":
            check(int(ko[3].sum()) == 0, f"{tag} flagged an idle frame")
        if case == "full":
            check(int(ko[3].sum()) == n_str, f"{tag} missed a damaged stripe")
        prev = base.clone()
        ms = time_fn(lambda: kern(frame, prev, n_str), 20,
                     restore=lambda: prev.copy_(base), flush=flush,
                     hide_launch=True)
        pms = time_fn(lambda: plain(frame, prev, n_str), 3,
                      restore=lambda: prev.copy_(base))
        by = k1_bytes(frame, base, ko)
        point(f"{name} {case}", ms, by,
              int(ops_px * frame.shape[0] * frame.shape[1]), pms)
        if case == "1080p":
            rec = (ms, pms, by)
    return rec


def device_ops(call, launches: int = 4) -> list:
    """The names of the device operations of ``launches`` calls of
    ``call`` (one kernel launch each), from a torch.profiler trace (a
    memset would show beside a kernel). A trace that holds no device
    operation at all is taken again, up to three more times: the
    profiler's device tracing, first started here, has come up empty on
    the card."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile
    call()
    torch.cuda.synchronize()
    ops = []
    for _ in range(4):
        with tprofile(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) as prof:
            for _ in range(launches):
                call()
            torch.cuda.synchronize()
        ops = [e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
        if ops:
            break
    return ops


def k2i_points(planes, qp, send, rps: int, flush, sent_frac: float,
               seats: int = 4, name: str = "mb_encode_i",
               kern=HP.mb_encode_i, plain=HP.mb_encode_i_plain,
               blocks: int = 24) -> None:
    """An Intra16x16 coder (K2-I; K14 with ``name`` mb_encode_i444, its
    functions and 48 blocks an MB) at qp 0 and 51 on the 1080p planes and
    on ``seats`` stacked copies of them (qp mixed by row, every other
    stripe sent), each equal to the plain version (tolerance 0, the whole
    reference planes included), timed as timing points with the reference
    restored, untimed, before each call."""
    stacked = [torch.cat([p] * seats) for p in planes]
    cases = [(f"qp{q}", planes, torch.full_like(qp, q), send)
             for q in (0, 51)]
    cases.append((f"{seats} seats", stacked, qp.repeat(seats),
                  send.repeat(seats)))
    for tag, pl, q, sd in cases:
        zero = [torch.zeros_like(p) for p in pl]
        kref = [t.clone() for t in zero]
        pref = [t.clone() for t in zero]
        ko = kern(*pl, q, sd, rps, *kref)
        po = plain(*pl, q, sd, rps, *pref)
        err = max_abs_err(list(ko) + kref, list(po) + pref)
        check(err == 0, f"{name} ({tag}) differs from plain (err {err})")
        work = [t.clone() for t in zero]

        def restore():
            for w, z in zip(work, zero):
                w.copy_(z)
        ms = time_fn(lambda: kern(*pl, q, sd, rps, *work), 20,
                     restore=restore, flush=flush, hide_launch=True)
        R, M = q.shape[0], pl[0].shape[1] // 16
        point(f"{name} {tag}", ms,
              nbytes(*pl, q, sd, *ko) + int(nbytes(*kref) * sent_frac),
              1200 * blocks * R * M)


def k6_points(f1, f0, flush, seats: int = 4) -> None:
    """K6 on the 1080p frame against prev at the band path's MB rows, at
    the JPEG step's 17 stripes, on ``seats`` stacked frames (17 stripes
    each), on an idle frame (prev equal) and on a fully damaged one, each
    equal to the plain version, timed as timing points (its bound: every
    byte of both frames read, the flags written: no early exit)."""
    H = f1.shape[0]
    s1, s0 = torch.cat([f1] * seats), torch.cat([f0] * seats)
    cases = [("1080p rows", f1, f0, H // 16), ("17 stripes", f1, f0, 17),
             (f"{seats} seats", s1, s0, 17 * seats),
             ("idle", f1, f1, H // 16), ("full", 255 - f0, f0, H // 16)]
    for tag, a, b, n in cases:
        ko = HP.row_damage_probe(a, b, n)
        err = max_abs_err([ko], [HP.row_damage_probe_plain(a, b, n)])
        check(err == 0, f"row_damage_probe ({tag}) differs (err {err})")
        if tag == "idle":
            check(int(ko.sum()) == 0, "K6 flagged an idle frame")
        if tag == "full":
            check(int(ko.sum()) == n, "K6 missed a damaged band")
        ms = time_fn(lambda: HP.row_damage_probe(a, b, n), 20, flush=flush,
                     hide_launch=True)
        point(f"row_damage_probe {tag}", ms, nbytes(a, b, ko), a.numel())


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

    # K1: csc420_damage (frame f1 against prev f0: some stripes damaged),
    # then its timing points
    pk, pp = f0.clone(), f0.clone()
    ko = HP.csc420_damage(f1, pk, S)
    po = HP.csc420_damage_plain(f1, pp, S)
    err = max_abs_err(list(ko) + [pk], list(po) + [pp])
    check(err == 0, f"csc420_damage differs from plain (max err {err})")
    check(0 < int(ko[3].sum()) < S, "K1 check frame should damage some "
          "stripes and not others")
    y, u, v = ko[:3]
    ms, pms, by = k1_points(f1, f0, S, rps, flush, f2s)
    ops = 40 * (g.height * g.width // 4)          # ~40 flops per quad
    out["csc420_damage"] = (err, ms, pms, by, ops, None)
    print(f"  csc420_damage bound: {bound_ms(by, ops):.4f} ms (the bytes it "
          f"must move on this run's data: frame and prev read, Y/U/V and the "
          f"flags written, and the 16-byte pieces of prev that differ); "
          f"all-bytes bound {bound_ms(nbytes(f1, pk, pk, *ko), ops):.4f} ms")
    kp = f0.clone()
    one_op_a_launch("K1", lambda: HP.csc420_damage(f1, kp, S))

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
    point("mb_encode_i 1080p", ms, by, 1200 * 24 * R * M, pms)
    k2i_points((y, u, v), qp, send, rps, flush, sent_frac)

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
    point("motion_select 1080p", ms, *out["motion_select"][3:5], pms)
    pred, mv = ko[:3], ko[3]
    motion_points("motion_select", motion_select, motion_select_plain,
                  p_planes[0], i_ref, qp, cands, win, rps, 2, flush)

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
    point("mb_encode_p 1080p", ms, by, 1200 * 24 * R * M, pms)
    p_coder_points(p_planes, qp, send_rows, pred, mv, i_ref, rps, flush)
    res = {"mb_encode_i": (i_out, i_ref), "mb_encode_p": (p_out, kref)}
    out.update(roi_kernel_checks(f0, f1, p_planes, qp, send_rows, pred, mv,
                                 i_ref, sent_frac, flush, rps))

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
    k6_points(f1, f0, flush)
    one_op_a_launch("K6", lambda: HP.row_damage_probe(f1, f0))

    # K3 and K4 on the K2 outputs of both modes, timed at both; the P
    # inputs also through bands of 4 and 16 rows (the band step's
    # one-stripe and four-stripe shapes: fresh K2/K3 outputs, the
    # session's header rows sliced)
    for intra, key in ((True, "mb_encode_i"), (False, "mb_encode_p")):
        mode = "I" if intra else "P"
        lv, cbp, hp, hn = res[key][0]
        ko = HP.cavlc_events(lv, cbp, intra)
        po = HP.cavlc_events_plain(lv, cbp, intra)
        err = max_abs_err(ko, po)
        check(err == 0, f"cavlc_events (intra={intra}) differs (err {err})")
        ms = time_fn(lambda: HP.cavlc_events(lv, cbp, intra), 20,
                     flush=flush, hide_launch=True)
        pms = time_fn(lambda: HP.cavlc_events_plain(lv, cbp, intra), 3)
        rec = (err, ms, pms, nbytes(lv, cbp, *ko), 30 * 36 * 27 * R * M,
               None)
        point(f"cavlc_events {mode}", ms, *rec[3:5], pms)
        if intra:
            out["cavlc_events"] = rec
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
            elif tag == "stock":
                ms = time_fn(lambda: HP.pack_stream(*args), 20, flush=flush,
                             hide_launch=True)
                pms = time_fn(lambda: HP.pack_stream_plain(*args), 3)
                rec = (err, ms, pms, nbytes(hp, hn, *ko, *k4),
                       10 * ko[1].numel(), None)
                point(f"pack_stream {mode}", ms, *rec[3:5], pms)
                if intra:
                    out["pack_stream"] = rec
        if intra:
            continue
        for n in (rps, 4 * rps):
            r0 = (R // 2) // rps * rps
            band = slice(r0, r0 + n)
            blv, bcbp, bhp, bhn = (t[band].clone() for t in res[key][0])
            bev = HP.cavlc_events(blv, bcbp, False)
            err = max_abs_err(bev, HP.cavlc_events_plain(blv, bcbp, False))
            check(err == 0, f"cavlc_events ({n}-row band) differs "
                  f"(err {err})")
            ms = time_fn(lambda: HP.cavlc_events(blv, bcbp, False), 20,
                         flush=flush, hide_launch=True)
            point(f"cavlc_events P band{n}", ms, nbytes(blv, bcbp, *bev),
                  30 * 36 * 27 * n * M)
            args = (bhp, bhn, *bev, row_hp[band], row_hn[band],
                    row_id[band], qp[band], False, sess._e_cap,
                    sess._w_cap, sess._out_cap)
            k4 = HP.pack_stream(*args)
            err = max_abs_err(k4, HP.pack_stream_plain(*args))
            check(err == 0, f"pack_stream ({n}-row band) differs "
                  f"(err {err})")
            ms = time_fn(lambda: HP.pack_stream(*args), 20, flush=flush,
                         hide_launch=True)
            point(f"pack_stream P band{n}", ms,
                  nbytes(bhp, bhn, *bev, *k4), 10 * bev[1].numel())
    return out


def roi_kernel_checks(f0, f1, p_planes, qp, send_rows, pred, mv, i_ref,
                      sent_frac, flush, rps: int) -> dict:
    """ROI QP's kernels at the 1080p shapes, tolerance 0, then timed:
    K2-P's per-MB-QP entry on :func:`kernel_checks`' P inputs with a
    seeded QP plane over 0..51, K18 on its headers, K17 on frame f1
    against f0 (whole frame: the band of a full-dirty frame) beside one
    torch expression of the same damage, and at :func:`k17_points`'
    other shapes."""
    dev = f1.device
    R, M = qp.shape[0], f1.shape[1] // 16
    rng = np.random.default_rng(SEED + 7)
    qp_mb = torch.as_tensor(rng.integers(0, 52, (R, M)).astype(np.int32),
                            device=dev)
    out = {}
    kref = [t.clone() for t in i_ref]
    pref = [t.clone() for t in i_ref]
    ko = HP.mb_encode_p(*p_planes, qp, send_rows, *pred, mv, *kref,
                        qp_mb=qp_mb)
    po = HP.mb_encode_p_plain(*p_planes, qp, send_rows, *pred, mv, *pref,
                              qp_mb=qp_mb)
    err = max_abs_err(list(ko) + kref, list(po) + pref)
    check(err == 0, f"mb_encode_p with qp_mb differs from plain (err {err})")
    work = [t.clone() for t in i_ref]

    def restore_p():
        for w, b in zip(work, i_ref):
            w.copy_(b)
    ms = time_fn(lambda: HP.mb_encode_p(*p_planes, qp, send_rows, *pred, mv,
                                        *work, qp_mb=qp_mb), 20,
                 restore=restore_p, flush=flush, hide_launch=True)
    pms = time_fn(lambda: HP.mb_encode_p_plain(
        *p_planes, qp, send_rows, *pred, mv, *work, qp_mb=qp_mb), 3,
        restore=restore_p)
    by = nbytes(*p_planes, qp, send_rows, *pred, mv, qp_mb, *ko) + int(
        nbytes(*kref) * sent_frac)
    out["mb_encode_p_qp"] = (err, ms, pms, by, 1200 * 24 * R * M, None)
    point("mb_encode_p_qp 1080p", ms, by, 1200 * 24 * R * M, pms)

    # K18 on those headers (it rewrites slot 5 in place: each call starts
    # from K2-P's output)
    hp, hn = ko[2], ko[3]
    wk = [hp.clone(), hn.clone()]
    wp = [hp.clone(), hn.clone()]
    err = max_abs_err(HP.mb_qp_delta(*wk, qp_mb, qp),
                      HP.mb_qp_delta_plain(*wp, qp_mb, qp))
    check(err == 0, f"mb_qp_delta differs from plain (err {err})")
    check(bool((wk[1][..., 5] > 1).any()), "K18 check wrote no non-zero "
          "delta")

    def restore_h():
        wk[0].copy_(hp)
        wk[1].copy_(hn)
    ms = time_fn(lambda: HP.mb_qp_delta(*wk, qp_mb, qp), 20,
                 restore=restore_h, flush=flush, hide_launch=True)
    pms = time_fn(lambda: HP.mb_qp_delta_plain(*wk, qp_mb, qp), 3,
                  restore=restore_h)
    # slot 5 of hdr_nb read, of hdr_pay and hdr_nb written (4 bytes each)
    out["mb_qp_delta"] = (err, ms, pms, nbytes(qp_mb, qp) + 12 * R * M,
                          10 * R * M, None)

    # K17: the whole frame as the band, QP 25 rows less bias 4
    qp_rows = torch.full((R,), 25, dtype=torch.int32, device=dev)
    ko = HP.roi_qp_plane(f1, f0, qp_rows, 4)
    check(0 < int((ko == 21).sum()) < R * M, "K17 check frame should dirty "
          "some MBs and not others")
    out["roi_qp_plane"] = k17_points(f1, f0, qp_rows, flush, rps)
    one_op_a_launch("K17", lambda: HP.roi_qp_plane(f1, f0, qp_rows, 4))
    return out


def k17_points(f1, f0, qp_rows, flush, rps: int) -> tuple:
    """K17 at bias 4 on the whole 1080p frame f1 against f0, on an idle
    frame (prev equal), on a fully dirty one and on bands of ``rps`` and
    ``4 * rps`` MB rows of f1 against f0 (views at a stripe boundary, as
    the band step hands them over), each equal to the plain version
    (tolerance 0), timed as timing points; the whole frame beside one
    torch expression of the same damage. -> the kernels line's
    record."""
    R, M = qp_rows.shape[0], f1.shape[1] // 16
    r0 = (R // 2) // rps * rps
    cases = [("1080p", f1, f0, qp_rows), ("idle", f1, f1, qp_rows),
             ("full", 255 - f0, f0, qp_rows)]
    cases += [(f"band{n}", f1.narrow(0, 16 * r0, 16 * n),
               f0.narrow(0, 16 * r0, 16 * n), qp_rows.narrow(0, r0, n))
              for n in (rps, 4 * rps)]
    rec = None
    for tag, a, b, q in cases:
        ko = HP.roi_qp_plane(a, b, q, 4)
        err = max_abs_err([ko], [HP.roi_qp_plane_plain(a, b, q, 4)])
        check(err == 0, f"roi_qp_plane ({tag}) differs from plain "
              f"(err {err})")
        if tag in ("idle", "full"):
            want = 25 if tag == "idle" else 21
            check(bool((ko == want).all()), f"K17 on the {tag} frame")
        ms = time_fn(lambda: HP.roi_qp_plane(a, b, q, 4), 20, flush=flush,
                     hide_launch=True)
        pms = time_fn(lambda: HP.roi_qp_plane_plain(a, b, q, 4), 3)
        by = nbytes(a, b, q, ko)
        point(f"roi_qp_plane {tag}", ms, by, a.numel(), pms)
        if tag == "1080p":
            n = q.shape[0]
            lib = time_fn(lambda: (a != b).view(n, 16, M, 48).any(3).any(1),
                          20, flush=flush, hide_launch=True)
            rec = (err, ms, pms, by, a.numel(), lib)
    return rec


def kernel444_checks(frames, sess, grown) -> dict:
    """K13-K16 and K5's 4:4:4 entry against their plain versions at the
    1080p shapes of the fullcolor path, tolerance 0, then timed; K4 is
    checked at the 4:4:4 slot counts (stock, grown and too small caps).
    ``sess`` is a fullcolor session at the stock caps. -> name -> record
    (as :func:`kernel_checks`) and K4's 4:4:4 times under "pack_stream444"."""
    dev = sess.device
    g = sess.grid
    check((sess._e_cap, sess._w_cap, sess._out_cap)
          == h264_buffer_caps(g, True), "4:4:4 checks need the stock caps")
    S, rps = g.n_stripes, g.rows_per_stripe
    R, M = g.height // 16, g.width // 16
    l2 = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    flush = (lambda: flush_l2(l2))
    out = {}
    f0, f1 = (torch.as_tensor(f).to(dev) for f in frames[:2])
    f2s = torch.roll(f1, -5, 0)

    # K13 (frame f1 against prev f0: some stripes damaged), then its
    # timing points
    pk, pp = f0.clone(), f0.clone()
    ko = H4.csc444_damage(f1, pk, S)
    po = H4.csc444_damage_plain(f1, pp, S)
    err = max_abs_err(list(ko) + [pk], list(po) + [pp])
    check(err == 0, f"csc444_damage differs from plain (max err {err})")
    check(0 < int(ko[3].sum()) < S, "K13 check frame should damage some "
          "stripes and not others")
    y, u, v = ko[:3]
    # ~15 flops a pixel: 9 multiply-adds and the rounding
    ops = 15 * g.height * g.width
    ms, pms, by = k1_points(f1, f0, S, rps, flush, f2s, "csc444_damage",
                            H4.csc444_damage, H4.csc444_damage_plain, "K13",
                            15)
    out["csc444_damage"] = (err, ms, pms, by, ops, None)
    print(f"  csc444_damage bound: {bound_ms(by, ops):.4f} ms (the bytes it "
          f"must move on this run's data: frame and prev read, Y/U/V and the "
          f"flags written, and the 16-byte pieces of prev that differ); "
          f"all-bytes bound {bound_ms(nbytes(f1, pk, pk, *ko), ops):.4f} ms")
    kp = f0.clone()
    one_op_a_launch("K13", lambda: H4.csc444_damage(f1, kp, S))

    # K14: every other stripe sent, per-row qp
    qp = torch.full((R,), sess.qp, dtype=torch.int32, device=dev)
    qp[::3] = sess.paint_qp
    send = (torch.arange(S, device=dev) % 2 == 0).to(torch.int32)
    send_rows = send.repeat_interleave(rps)
    sent_frac = float(send.float().mean())
    zero_ref = [torch.zeros_like(p) for p in (y, u, v)]
    kref = [t.clone() for t in zero_ref]
    pref = [t.clone() for t in zero_ref]
    ko = H4.mb_encode_i444(y, u, v, qp, send, rps, *kref)
    po = H4.mb_encode_i444_plain(y, u, v, qp, send, rps, *pref)
    err = max_abs_err(list(ko) + kref, list(po) + pref)
    check(err == 0, f"mb_encode_i444 differs from plain (max err {err})")
    i_out, i_ref = ko, [t.clone() for t in kref]
    work = [t.clone() for t in zero_ref]

    def restore_i():
        for w, b in zip(work, zero_ref):
            w.copy_(b)
    ms = time_fn(lambda: H4.mb_encode_i444(y, u, v, qp, send, rps, *work),
                 20, restore=restore_i, flush=flush, hide_launch=True)
    pms = time_fn(lambda: H4.mb_encode_i444_plain(y, u, v, qp, send, rps,
                                                  *work), 3,
                  restore=restore_i)
    by = nbytes(y, u, v, qp, send, *ko) + int(nbytes(*kref) * sent_frac)
    # ~1200 integer operations a 4x4 block (transforms, quant, dequant,
    # recon), 48 blocks an MB
    out["mb_encode_i444"] = (err, ms, pms, by, 1200 * 48 * R * M, None)
    point("mb_encode_i444 1080p", ms, by, 1200 * 48 * R * M, pms)
    k2i_points((y, u, v), qp, send, rps, flush, sent_frac,
               name="mb_encode_i444", kern=H4.mb_encode_i444,
               plain=H4.mb_encode_i444_plain, blocks=48)

    # K5's 4:4:4 entry: the 57 default candidates, stripe windows, a frame
    # scrolled by 5 rows against the I recon
    cands = scroll_candidates(24, 8)
    p_planes = H4.csc444_damage(f2s, f1.clone(), S)[:3]
    win = g.stripe_h
    ko = motion_select444(p_planes[0], *i_ref, qp, cands, win)
    po = motion_select444_plain(p_planes[0], *i_ref, qp, cands, win)
    err = max_abs_err(ko, po)
    check(err == 0, f"motion_select444 differs from plain (max err {err})")
    check(bool((ko[3] != 0).any()), "K5 4:4:4 check frame chose no motion")
    ms = time_fn(lambda: motion_select444(p_planes[0], *i_ref, qp, cands,
                                          win, out=ko), 20, flush=flush,
                 hide_launch=True)
    pms = time_fn(lambda: motion_select444_plain(p_planes[0], *i_ref, qp,
                                                 cands, win), 3)
    out["motion_select444"] = (err, ms, pms,
                               nbytes(p_planes[0], *i_ref, qp, *ko),
                               3 * 256 * len(cands) * R * M, None)
    point("motion_select444 1080p", ms, *out["motion_select444"][3:5], pms)
    pred, mv = ko[:3], ko[3]
    motion_points("motion_select444", motion_select444,
                  motion_select444_plain, p_planes[0], i_ref, qp, cands, win,
                  rps, 1, flush)

    # K15 on that prediction, the reference rewritten for sent rows
    kref = [t.clone() for t in i_ref]
    pref = [t.clone() for t in i_ref]
    ko = H4.mb_encode_p444(*p_planes, qp, send_rows, *pred, mv, *kref)
    po = H4.mb_encode_p444_plain(*p_planes, qp, send_rows, *pred, mv, *pref)
    err = max_abs_err(list(ko) + kref, list(po) + pref)
    check(err == 0, f"mb_encode_p444 differs from plain (max err {err})")
    p_out = ko
    work = [t.clone() for t in i_ref]

    def restore_p():
        for w, b in zip(work, i_ref):
            w.copy_(b)
    ms = time_fn(lambda: H4.mb_encode_p444(*p_planes, qp, send_rows, *pred,
                                           mv, *work), 20, restore=restore_p,
                 flush=flush, hide_launch=True)
    pms = time_fn(lambda: H4.mb_encode_p444_plain(*p_planes, qp, send_rows,
                                                  *pred, mv, *work), 3,
                  restore=restore_p)
    by = nbytes(*p_planes, qp, send_rows, *pred, mv, *ko) + int(
        nbytes(*kref) * sent_frac)
    out["mb_encode_p444"] = (err, ms, pms, by, 1200 * 48 * R * M, None)
    point("mb_encode_p444 1080p", ms, by, 1200 * 48 * R * M, pms)
    p_coder_points(p_planes, qp, send_rows, pred, mv, i_ref, rps, flush,
                   name="mb_encode_p444", kern=H4.mb_encode_p444,
                   plain=H4.mb_encode_p444_plain, cdiv=1, blocks=48)

    # K16 and K4 on the K14 / K15 outputs
    for intra, (lv, cbp, hp, hn) in ((True, i_out), (False, p_out)):
        ko = H4.cavlc_events444(lv, cbp, intra)
        po = H4.cavlc_events444_plain(lv, cbp, intra)
        err = max_abs_err(ko, po)
        check(err == 0, f"cavlc_events444 (intra={intra}) differs "
              f"(err {err})")
        mode = "I" if intra else "P"
        ms = time_fn(lambda: H4.cavlc_events444(lv, cbp, intra), 20,
                     flush=flush, hide_launch=True)
        pms = time_fn(lambda: H4.cavlc_events444_plain(lv, cbp, intra), 3)
        rec = (err, ms, pms, nbytes(lv, cbp, *ko),
               30 * 36 * (51 if intra else 48) * R * M, None)
        point(f"cavlc_events444 {mode}", ms, *rec[3:5], pms)
        if intra:
            out["cavlc_events444"] = rec
        else:
            # the P events of bands of 4 and 16 rows (views, as the band
            # step hands them over)
            for n in (rps, 4 * rps):
                r0 = (R // 2) // rps * rps
                blv, bcbp = lv.narrow(0, r0, n), cbp.narrow(0, r0, n)
                bev = H4.cavlc_events444(blv, bcbp, False)
                err = max_abs_err(bev, H4.cavlc_events444_plain(blv, bcbp,
                                                                False))
                check(err == 0, f"cavlc_events444 ({n}-row band) differs "
                      f"(err {err})")
                ms = time_fn(lambda: H4.cavlc_events444(blv, bcbp, False),
                             20, flush=flush, hide_launch=True)
                point(f"cavlc_events444 P band{n}", ms,
                      nbytes(blv, bcbp, *bev), 30 * 36 * 48 * n * M)
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
            check(err == 0, f"pack_stream 4:4:4 ({tag}, intra={intra}) "
                  f"differs (err {err})")
            if tag == "overflow":
                check(int(k4.flags[0]) == 1 and int(k4.flags[1]) == 1,
                      "pack_stream 4:4:4 overflow flags not raised")
            elif tag == "stock":
                ms = time_fn(lambda: HP.pack_stream(*args), 20, flush=flush,
                             hide_launch=True)
                out[f"pack_stream444_{'i' if intra else 'p'}"] = (
                    err, ms, None, nbytes(hp, hn, *ko, *k4),
                    10 * ko[1].numel(), None)
    return out


def fullcolor_path(settings, dsettings, frames, seq) -> dict:
    """The fifth path: the stock and the default sequences at fullcolor,
    kernels against plain, then the H.264 capture loop at fullcolor.
    -> {"launches": per run, "capture": stats, "stock_session": the
    kernel session of the stock run (grown caps)}."""
    fs = dataclasses.replace(settings, fullcolor=True)
    fds = dataclasses.replace(dsettings, fullcolor=True)
    kern = H264EncoderSession(fs)
    plain = plain_session(fs)
    dev_frames = [torch.as_tensor(f).to(kern.device) for f in frames]
    klog, stock_l = run_path("fullcolor stock", STOCK444_PATH,
                             lambda: run_sequence(kern, dev_frames))
    check_stream(klog, kern)
    compare_runs(klog, run_sequence(plain, dev_frames))
    print("fullcolor stock: kernel path == plain path: chunks and state, "
          f"{len(klog)} frames; caps after its overflow episode: w_cap "
          f"{kern._w_cap} out_cap {kern._out_cap}")
    dkern = H264EncoderSession(fds)
    dlog, default_l = run_path(
        "fullcolor default", DEFAULT444_PATH,
        lambda: run_default_sequence(dkern, seq, check_idle=True))
    check_default_log(dlog, seq, dkern)
    compare_runs(dlog, run_default_sequence(plain_session(fds), seq))
    print("fullcolor default: kernel path == plain path: chunks, state, mv "
          f"fields, bands, {len(dlog)} frames: "
          + json.dumps([[n, b, len(c)] for (n, _, _), (c, _, b, _)
                        in zip(seq, dlog)]))
    full_dirty_equals_stock(fds, seq)
    print("fullcolor default: the full-dirty band equals the stock P step "
          "with motion")
    t0 = time.perf_counter()
    cstats, capture_l = capture_path(("h264_444",), CAPTURE444_PATH,
                                     paced=False)
    print(f"fullcolor capture: {CAPTURE_FRAMES} frames a run, depth 1 and "
          f"2, in {time.perf_counter() - t0:.2f} s; depth 2 == depth 1 "
          f"chunk for chunk; launches {json.dumps(capture_l)}")
    launches = {"stock": stock_l, "default": default_l,
                "capture": capture_l}
    for run, lc in launches.items():
        bad = {k: lc[k] for k in NOT_ON_444 if lc[k]}
        check(not bad, f"fullcolor {run} run launched 4:2:0 kernels {bad}")
    return {"launches": launches, "capture": cstats["h264_444"],
            "grown": (kern._w_cap, kern._out_cap)}


def roi_path(dsettings, seq, dlog) -> dict:
    """The seventh path: the default sequence with ROI QP for each of
    ``ROI_RUNS``, kernels against plain (chunks and state, frame by
    frame); K17, K2-P's per-MB-QP entry and K18 once per band frame. At
    the default bias the band frames' bytes must differ from the default
    path's ``dlog``. -> {"launches": {run: launches}, "bands": n}."""
    res = {"launches": {}}
    for bias, qp in ROI_RUNS:
        rs = dataclasses.replace(dsettings, h264_roi_qp=True,
                                 h264_roi_qp_bias=bias)
        kern, plain = H264EncoderSession(rs), plain_session(rs)
        if qp is not None:
            kern.set_qp(qp)
            plain.set_qp(qp)
        name = f"roi bias {bias}" + (f" qp {qp}" if qp else "")
        log, lc = run_path(name, ROI_PATH, lambda: run_default_sequence(
            kern, seq, check_idle=True))
        if kern._cap_gen:
            # at QP 8 the full-dirty frame outgrows the stock byte buffer:
            # an overflow episode on the band path (dropped, buffers
            # doubled, the next frame an IDR), on both paths alike
            dropped = [n for (n, _, _), (c, _, band, _) in zip(seq, log)
                       if band is not None and not c]
            check(dropped == ["full_dirty"] and kern._cap_gen == 1,
                  f"{name}: dropped band frames {dropped}, "
                  f"{kern._cap_gen} growths")
            print(f"{name}: the full-dirty frame overflowed the stock "
                  "buffers and was dropped; the buffers grew once")
        else:
            check_default_log(log, seq, kern)
        compare_runs(log, run_default_sequence(plain, seq))
        n_band = sum(band is not None for _, _, band, _ in log)
        check(all(lc[k] == n_band for k in ROI_KERNELS)
              and lc["mb_encode_p"] == 0,
              f"{name}: {n_band} band frames, launches "
              f"{ {k: lc[k] for k in ROI_KERNELS + ('mb_encode_p',)} }")
        if qp is None:
            differ = [i for i, (a, b) in enumerate(zip(log, dlog))
                      if a[2] is not None
                      and [c.payload for c in a[0]]
                      != [c.payload for c in b[0]]]
            check(differ, f"{name}: no band frame differs from the path "
                  "without ROI QP")
        print(f"{name}: kernel path == plain path: chunks, state, mv "
              f"fields, bands, {len(log)} frames, {n_band} band frames, "
              "each launching K17, K2-P's per-MB-QP entry and K18 once")
        res["launches"][name] = lc
        res["bands"] = n_band
    return res


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


def sync_checks(settings, dsettings, base, typed, rsettings=None) -> dict:
    """Host syncs inside encode(): none on the stock path (with or
    without motion), exactly one (the row probe) on every frame of the
    band path, idle and I frames included, and with ROI QP
    (``rsettings``) too."""
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
    bands = {"band": dsettings}
    if rsettings is not None:
        bands["roi_band"] = rsettings
    for name, s in bands.items():
        sess = H264EncoderSession(s)
        sess.finalize(sess.encode(base))
        res[f"{name}_P"] = encode(sess, typed)
        res[f"{name}_idle"] = encode(sess, typed)
        res[f"{name}_I"] = encode(sess, typed, True)
    counts = {k: len(v) for k, v in res.items()}
    want = {k: 0 if k.startswith("stock") else 1 for k in res}
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
                  == h264_buffer_caps(sess.grid, sess.fullcolor)[1:],
                  "frame timing overflowed the stock buffers")
            enc.append((t1 - t0) * 1e3)
            ts.append((t2 - t0) * 1e3)
        res[kind] = {"encode_ms": statistics.median(enc),
                     "encode_finalize_ms": statistics.median(ts),
                     "band_rows": sess.last_band_rows}
    return res


def step_device_times(dsettings, base, scroll, typed, reps: int = 7
                      ) -> dict:
    """Device time (ms between CUDA events, median of ``reps``) of the
    main path's three step shapes at 1080p: the stock I step, the
    full-frame P band (a scroll) and the one-stripe P band (typing), on a
    default session that has sent ``base`` as its IDR, its state restored
    and L2 flushed before each rep. A spin kernel of about 11 ms runs
    first, so the host has enqueued the whole step before the first
    event fires; the host's enqueue time is returned beside it to show
    that it fits under the spin."""
    sess = H264EncoderSession(dsettings)
    sess.finalize(sess.encode(base, force=True))
    torch.cuda.synchronize()
    g, dev = sess.grid, sess.device
    rps, S, R = g.rows_per_stripe, g.n_stripes, sess.n_rows
    keys = ("_prev", "_age", "_sent", "_fnum", "_ref_y", "_ref_u", "_ref_v")
    saved = {k: getattr(sess, k).clone() for k in keys}

    def restore():
        for k in keys:
            getattr(sess, k).copy_(saved[k])
    l2 = torch.empty(64 << 20, dtype=torch.uint8, device=dev)

    # the band steps' control inputs, made before the timing (an upload
    # inside the timed call would wait for the spin)
    def ints(n, v=1):
        return torch.full((n,), v, dtype=torch.int32, device=dev)
    stripe = typing_rows(g.height).start // g.stripe_h
    one = ints(S, 0)
    one[stripe] = 1
    full_step, band_step = sess._band_step(R), sess._band_step(rps)
    st = (sess._prev, sess._sent, sess._fnum, sess._ref_y, sess._ref_u,
          sess._ref_v)
    full_ctl = (ints(R, sess.qp), ints(S), ints(R))
    stripe_ctl = (ints(rps, sess.qp), one, ints(rps))
    cases = {
        "stock_I": lambda: sess._i_step(
            base, sess._prev, sess._age, sess._sent, sess._fnum,
            sess._ref_y, sess._ref_u, sess._ref_v, sess.qp, sess.paint_qp,
            True, sess._hdr_pay, sess._hdr_nb),
        "full_P_band": lambda: full_step(
            scroll, *st, *full_ctl, 0, sess._p_hdr_pay, sess._p_hdr_nb),
        "stripe_P_band": lambda: band_step(
            typed, *st, *stripe_ctl, stripe * rps, sess._p_hdr_pay,
            sess._p_hdr_nb)}
    res = {}
    for name, fn in cases.items():
        restore()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        host = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        ms = time_fn(fn, reps, restore=restore,
                     flush=lambda: flush_l2(l2), hide_launch=True,
                     spin=20_000_000)
        res[name] = {"device_ms": ms, "host_enqueue_ms": host}
    restore()
    return res


def jpeg_step_device_times(settings, cases: dict, reps: int = 7) -> dict:
    """Device time (ms between CUDA events, median of ``reps``) of the
    JPEG step (K6-K9) at 1080p on each (frame, prev) case, at the stock
    caps, ``prev`` and the stripe ages restored and L2 flushed before
    each rep, the host's enqueue hidden behind a spin kernel as in
    :func:`step_device_times` (its enqueue time returned beside it)."""
    sess = JpegEncoderSession(settings)
    l2 = torch.empty(64 << 20, dtype=torch.uint8, device=sess.device)
    age0 = sess._age.clone()
    res = {}
    for name, (frame, prev) in cases.items():
        def restore(prev=prev):
            sess._prev.copy_(prev)
            sess._age.copy_(age0)

        def fn(frame=frame):
            return sess._step(frame, sess._prev, sess._age, sess._qtab)
        restore()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        host = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        ms = time_fn(fn, reps, restore=restore,
                     flush=lambda: flush_l2(l2), hide_launch=True,
                     spin=20_000_000)
        res[name] = {"device_ms": ms, "host_enqueue_ms": host}
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


def k7_point(name: str, frame, base, tab, qt, sub: str, flush):
    """K7 on ``frame`` over prev ``base`` (restored, untimed, before each
    call), equal to its plain version (tolerance 0, prev included), timed
    as a timing point. -> (ms, plain ms, bytes, operations)."""
    pk, pp = base.clone(), base.clone()
    ko = JPL.jpeg_forward(frame, pk, tab, qt, sub)
    err = max_abs_err(list(ko) + [pk],
                      list(JPL.jpeg_forward_plain(frame, pp, tab, qt, sub))
                      + [pp])
    check(err == 0, f"{name} differs from plain (err {err})")
    prev = base.clone()
    ms = time_fn(lambda: JPL.jpeg_forward(frame, prev, tab, qt, sub), 20,
                 restore=lambda: prev.copy_(base), flush=flush,
                 hide_launch=True)
    pms = time_fn(lambda: JPL.jpeg_forward_plain(frame, prev, tab, qt, sub),
                  3)
    n_blocks = sum(p.shape[0] for p in ko)
    n_chroma_px = ko[1].shape[0] * 64 * 2
    # two 8-term DCT passes (2 flops a multiply-add) and a divide, round
    # and add per coefficient; ~15 flops of CSC a pixel; 4 per chroma mean
    ops = (n_blocks * 64 * (2 * 8 * 2 + 3) + 15 * frame.numel() // 3
           + (4 * n_chroma_px if sub == "420" else 0))
    by = nbytes(frame, tab, qt, *ko, prev)
    point(name, ms, by, ops, pms)
    return ms, pms, by, ops


def k8_points(frame, sess, flush) -> None:
    """K8 on K7's coefficients of the 1080p ``frame`` (every stripe on the
    quality 60 table, then on the 90 one), at 4:4:4, and on ``SEATS``
    stacked frames (17 stripes each), each equal to the plain version
    (tolerance 0), timed as timing points."""
    g, dev = sess.grid, frame.device
    S = g.n_stripes
    qt = sess._qtab
    zero = torch.zeros((S,), dtype=torch.int32, device=dev)
    scan444 = JE.scan_maps(JE.scan_layout(g.stripe_h // 8, g.width // 8,
                                          "444"), dev)
    stack = torch.cat([torch.roll(frame, 37 * k, 1) for k in range(SEATS)])
    cases = [("1080p q60", frame, zero, "420", sess._scan, S),
             ("1080p q90", frame, zero + 1, "420", sess._scan, S),
             ("1080p 4:4:4", frame, zero, "444", scan444, S),
             (f"seats S={SEATS * S}", stack, zero.repeat(SEATS), "420",
              sess._scan, SEATS * S)]
    for tag, f, tab, sub, scan, n in cases:
        planes = JPL.jpeg_forward(f, torch.zeros_like(f), tab, qt, sub)
        ko = JE.jpeg_events(*planes, scan, n)
        err = max_abs_err(ko, JE.jpeg_events_plain(*planes, scan, n))
        check(err == 0, f"jpeg_events ({tag}) differs from plain "
              f"(err {err})")
        ms = time_fn(lambda: JE.jpeg_events(*planes, scan, n), 20,
                     flush=flush, hide_launch=True)
        point(f"jpeg_events {tag}", ms, nbytes(*planes, scan, *ko),
              20 * ko[0].numel())


def k11_points(dev, flush) -> None:
    """K11 at 1080p into the 1088-row grid, at 3840x2160 into 3840x2176,
    at 1366x768 into its 1376-wide grid and from a 1080p source view one
    byte into its storage, each equal to the plain version and to
    ``F.pad``, timed as timing points beside ``F.pad``."""
    F = torch.nn.functional
    for tag, (h, w), (H, W), off in (
            ("1080p", (1080, 1920), (1088, 1920), 0),
            ("2160p", (2160, 3840), (2176, 3840), 0),
            ("1366x768", (768, 1366), (768, 1376), 0),
            ("1080p source +1 byte", (1080, 1920), (1088, 1920), 1)):
        src = FR.synthetic_frame(h, w, 11, dev)
        buf = torch.empty(src.numel() + off, dtype=torch.uint8, device=dev)
        frame = buf[off:].view(src.shape).copy_(src)
        ko = FR.pad_frame(frame, H, W)
        lib_out = F.pad(frame, (0, 0, 0, W - w, 0, H - h))
        err = max_abs_err([ko], [FR.pad_frame_plain(frame, H, W)])
        check(err == 0 and torch.equal(ko, lib_out),
              f"pad_frame ({tag}) differs from plain or F.pad (err {err})")
        ms = time_fn(lambda: FR.pad_frame(frame, H, W), 20, flush=flush,
                     hide_launch=True)
        lib = time_fn(lambda: F.pad(frame, (0, 0, 0, W - w, 0, H - h)), 20,
                      flush=flush, hide_launch=True)
        point(f"pad_frame {tag}", ms, nbytes(frame, ko), 0, lib=lib)


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
    ms, pms, by, ops = k7_point("jpeg_forward 1080p", f1, f0, tab, qt, sub,
                                flush)
    out["jpeg_forward"] = (err, ms, pms, by, ops, None)
    # 4:4:4, and the seat step's stacked frame of 4 seats (4:2:0)
    k7_point("jpeg_forward 1080p 4:4:4", f1, f0, tab, qt, "444", flush)
    n = SEATS
    stack = torch.cat([torch.roll(f1, 37 * k, 1) for k in range(n)])
    k7_point(f"jpeg_forward seats S={n}", stack, torch.cat([f0] * n),
             tab.repeat(n), qt, sub, flush)

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
    k8_points(f1, sess, flush)
    one_op_a_launch("K8", lambda: JE.jpeg_events(*ko, scan, S))

    # K9 at the stock, the grown and too small caps
    for caps, tag in (((e_cap, w_cap, out_cap), "stock"),
                      ((e_cap, 2 * w_cap, 2 * out_cap), "grown"),
                      ((e_cap, 64, 4096), "overflow")):
        k9 = JPP.jpeg_pack(*k8, *caps)
        err = max_abs_err(k9, JPP.jpeg_pack_plain(*k8, *caps))
        check(err == 0, f"jpeg_pack ({tag}) differs from plain (err {err})")
        if tag == "overflow":
            check(k9.flags.tolist() == [1, 1], "jpeg_pack flags not raised")
            continue
        ms = time_fn(lambda: JPP.jpeg_pack(*k8, *caps), 20, flush=flush,
                     hide_launch=True)
        pms = time_fn(lambda: JPP.jpeg_pack_plain(*k8, *caps), 3)
        # an exclusive scan, the shifts and two adds per slot
        rec = (err, ms, pms, k9_bytes(k8[1], k9), 10 * k8[0].numel(), None)
        point("jpeg_pack 1080p" + (" 2x caps" if tag == "grown" else ""),
              ms, *rec[3:5], pms)
        if tag == "stock":
            out["jpeg_pack"] = rec
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
    H.264 motion search and the band path; ``h264_444`` is H.264 at
    ``fullcolor``), a watermark at location 6, and nothing that depends
    on the wall clock (CBR, the keyframe cadence and content adaptivity
    off), so a run's chunks depend on the tick alone."""
    return CaptureSettings(capture_width=WIDTH, capture_height=HEIGHT,
                           output_mode=mode.removesuffix("_444"),
                           fullcolor=mode.endswith("_444"), target_fps=fps,
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
    delivered; the record of :func:`traced_capture`."""
    return traced_capture(ScreenCapture("synthetic"),
                          capture_settings(mode, depth, fps),
                          f"{mode} capture (depth {depth})")


def traced_capture(cap, settings, what: str) -> dict:
    """Run the capture loop ``cap`` until CAPTURE_FRAMES frames were
    delivered. -> {"chunks": frame_id -> chunks, "order": frame ids in
    delivery order, "dispatch": frame_id -> (t0, t1) of the encode
    dispatch (the tracer's span), "deliver": frame_id -> (t0, t1) of the
    finalize + callback, "stages": frame_id -> {stage: ns}, the tracer's
    spans summed per frame}."""
    got, deliver, died = [], {}, []
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
        cap.start_capture(got.append, settings)
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
    check(not died, f"{what} died: {died[:1]!r}")
    check(len(deliver) >= CAPTURE_FRAMES,
          f"{what} delivered {len(deliver)} frames in 120 s")
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
    if mode != "jpeg":
        check(all(c[5] for c in run["chunks"][0]),
              "capture: the first H.264 frame is not an IDR")


def capture_path(modes=("jpeg", "h264"), path=CAPTURE_PATH,
                 paced: bool = True) -> tuple:
    """The fourth path (and the fifth's loop, ``h264_444``): each mode
    through the capture loop, depth 2 against depth 1 (unpaced), then,
    with ``paced``, depth 2 at the default 60 fps target. -> ({mode:
    {run: stats}}, launches of the path)."""
    saved = {m: m.maybe_load for m in (port_encoder, port_h264)}
    for m in saved:
        m.maybe_load = seeded_watermark
    try:
        stats = {}
        _cuda.reset_launches()
        for mode in modes:
            runs = {"depth1": capture_run(mode, 1, 1000.0),
                    "depth2": capture_run(mode, 2, 1000.0)}
            if paced:
                runs["depth2_60fps"] = capture_run(mode, 2, 60.0)
            for name, run in runs.items():
                check(run["order"] == sorted(run["order"])
                      and run["order"][0] == 0,
                      f"{mode} capture ({name}): frames out of order")
                check_capture_chunks(mode, run)
            for fid in range(CAPTURE_FRAMES):
                check(all(r["chunks"].get(fid) == runs["depth1"]["chunks"]
                          .get(fid) for r in runs.values()),
                      f"{mode} capture: frame {fid} at depth 2 differs from "
                      "depth 1")
            stats[mode] = {k: capture_stats(r) for k, r in runs.items()}
        torch.cuda.synchronize()
        launches = dict(_cuda.LAUNCHES)
    finally:
        for m, fn in saved.items():
            m.maybe_load = fn
    for k in path:
        check(launches[k] > 0, f"capture path never launched {k}")
    return stats, launches


def k12_points(frame, wm, tag: str, flush) -> tuple:
    """K12 blending ``wm`` into ``frame`` (a copy), equal to the plain
    version (tolerance 0), timed as a timing point with the frame
    restored, untimed, before each call. -> the kernels line's record."""
    args = (wm._rgba, wm._table, wm._y0, wm._x0)
    k, p = frame.clone(), frame.clone()
    FR.watermark_blend(k, *args)
    FR.watermark_blend_plain(p, *args)
    err = max_abs_err([k], [p])
    check(err == 0 and not torch.equal(k, frame),
          f"watermark_blend ({tag}) differs from plain (err {err})")
    work = frame.clone()
    ms = time_fn(lambda: FR.watermark_blend(work, *args), 20,
                 restore=lambda: work.copy_(frame), flush=flush,
                 hide_launch=True)
    pms = time_fn(lambda: FR.watermark_blend_plain(work, *args), 3,
                  restore=lambda: work.copy_(frame))
    region = 3 * wm.wh * wm.ww
    # the region read and written, the RGBA image and the table read;
    # 5 flops a byte
    by = 2 * region + nbytes(wm._rgba, wm._table)
    point(f"watermark_blend {tag}", ms, by, 5 * region, pms)
    return (err, ms, pms, by, 5 * region, None)


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
    point("synthetic_frame 1080p", ms, nbytes(ko), 12 * ko.numel(), pms)

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
    k11_points(dev, flush)
    one_op_a_launch("K11", lambda: FR.pad_frame(frame, GH, W))

    # K12: the seeded 480x270 watermark at its location-6 anchor
    wm = Watermark.from_rgba(watermark_rgba(), WM_LOCATION, W, H, dev)
    rec = k12_points(ko, wm, "1080p", flush)
    out["watermark_blend"] = rec
    # 1366x768 into its 1376-wide grid: the region's bytes start off a word
    wm768 = Watermark.from_rgba(watermark_rgba(), WM_LOCATION, 1366, 768,
                                dev)
    check((wm768._y0, wm768._x0) == (482, 870), "the 1366x768 anchor moved")
    k12_points(FR.pad_frame(FR.synthetic_frame(768, 1366, 7, dev), 768,
                            1376), wm768, "1366x768", flush)
    work = ko.clone()
    one_op_a_launch("K12", lambda: FR.watermark_blend(
        work, wm._rgba, wm._table, wm._y0, wm._x0))
    return out



# ------------------------------------------------------------ seats path
def seat_settings(mode: str, **over) -> CaptureSettings:
    """The sixth path's settings: 1920x1080 a seat at the codec's
    defaults (H.264: motion vrange 24 / hrange 8, 4:2:0 stock step; the
    seats read no band path), paint-over after 4 idle frames."""
    kw = dict(capture_width=WIDTH, capture_height=HEIGHT,
              paint_over_delay_frames=4)
    if mode == "h264":
        kw["output_mode"] = "h264"
    kw.update(over)
    return CaptureSettings(**kw)


def seat_encoder(mode: str, n: int, plain: bool = False, **over):
    """A multi-seat encoder on the card; ``plain`` puts it on the plain
    versions (on the card)."""
    if mode == "h264":
        enc = MultiSeatH264Encoder(seat_settings(mode, **over), n)
        ops = HP.SEAT_PLAIN_OPS
    else:
        enc = MultiSeatEncoder(seat_settings(mode, **over), n)
        ops = JPP.SEAT_PLAIN_OPS
    if plain:
        enc._ops = ops
        enc._rebuild_steps()
    return enc


def seat_noise(dev, GH: int, W: int) -> torch.Tensor:
    rng = np.random.default_rng(SEED + 5)
    return torch.as_tensor(rng.integers(0, 256, (GH, W, 3), dtype=np.uint8),
                           device=dev)


def seat_script(dev, GH: int, W: int) -> list:
    """The sixth path's ticks, [(name, (SEATS, GH, W, 3) frames, force)]:
    a full first tick (K10's seat entry); seats that differ (0 idle, 1
    typing in one stripe, 2 fully damaged, 3 scrolled by 24 rows, then
    by 7 more); idle ticks until the paint-overs (seats 0 and 1 at the
    fifth tick, 2 and 3 at the seventh); a forced tick; a noise frame on
    seat NOISY_SEAT alone (the others typing), which overflows its byte
    buffer; that seat's
    recovery (H.264: an IDR batch of every seat; JPEG: its full resend);
    a P tick at the grown caps."""
    base = FR.synthetic_frames(GH, W, SEATS, 0, dev)

    def pattern(tick):                  # one frame, by the seat entry
        return FR.synthetic_frames(GH, W, 1, tick, dev)[0]

    def typed(f, y0, x0, v):
        f = f.clone()
        f[y0:y0 + 16, x0:x0 + 120] = v
        return f
    t1 = base.clone()
    t1[1] = typed(base[1], 300, 300, 20)
    t1[2] = pattern(500)
    t1[3] = torch.roll(base[3], 24, 0)
    t2 = t1.clone()
    t2[1] = typed(t1[1], 700, 900, 220)
    t2[2] = pattern(507)
    t2[3] = torch.roll(t1[3], 7, 0)
    t8 = t2.clone()
    t8[0] = typed(t2[0], 200, 200, 120)
    t8[1] = typed(t2[1], 100, 100, 90)
    t8[3] = typed(t2[3], 900, 1200, 60)
    t8[NOISY_SEAT] = seat_noise(dev, GH, W)
    t9 = t8.clone()
    t9[NOISY_SEAT] = pattern(600)
    t10 = t9.clone()
    t10[0] = typed(t9[0], 500, 1500, 40)
    return [("first", base, True), ("differ", t1, False),
            ("differ2", t2, False), ("idle", t2, False),
            ("paint01", t2, False), ("idle2", t2, False),
            ("paint23", t2, False), ("forced", t2, True),
            ("overflow", t8, False), ("recovery", t9, False),
            ("grown", t10, False)]


def seat_tick(enc, mode: str, frames, force: bool):
    """One tick: encode (H.264: ``force`` forces the IDR batch) and
    finalize (JPEG: ``force`` resends every stripe). -> (chunks[seat],
    the dispatched slot)."""
    out = enc.encode(frames, force=force) if mode == "h264" \
        else enc.encode(frames)
    return enc.finalize(out, force_all=force), out


def run_seat_script(enc, mode: str, script) -> list:
    """-> [(chunks as tuples per seat, state as numpy, intra)]."""
    log = []
    for _, frames, force in script:
        per, out = seat_tick(enc, mode, frames, force)
        log.append(([[dataclasses.astuple(c) for c in s] for s in per],
                    port_state.session_state_to_numpy(enc),
                    out.get("intra")))
    return log


def compare_seat_logs(mode: str, script, a, b) -> None:
    check(len(a) == len(b), f"seats {mode}: runs differ in length")
    for (name, _, _), (ca, sa, ia), (cb, sb, ib) in zip(script, a, b):
        check(ca == cb and ia == ib,
              f"seats {mode}: tick {name} chunks differ from plain")
        for k in sa:
            check(np.array_equal(np.asarray(sa[k]), np.asarray(sb[k])),
                  f"seats {mode}: tick {name} state {k} differs from plain")


def check_seat_log(mode: str, script, log, enc) -> dict:
    """The script did what it says: -> chunks per seat per tick."""
    sent = {name: [len(c) for c in per]
            for (name, _, _), (per, _, _) in zip(script, log)}
    n = enc.grid.n_stripes
    check(sent["first"] == [n] * SEATS and sent["forced"] == [n] * SEATS,
          f"seats {mode}: a first or forced tick missed stripes {sent}")
    d = sent["differ"]
    check(d[0] == 0 and 0 < d[1] < n and d[2] == n and d[3] > 0,
          f"seats {mode}: the differing seats sent {d}")
    check(sent["idle"] == [0] * SEATS, f"seats {mode}: idle tick {sent}")
    check(sent["paint01"][0] == n and sent["paint23"][2] == n,
          f"seats {mode}: paint-over ticks {sent}")
    ov = sent["overflow"]
    check(ov[NOISY_SEAT] == 0 and all(ov[k] for k in range(SEATS)
                                      if k != NOISY_SEAT),
          f"seats {mode}: the overflow tick sent {ov}")
    check(enc._cap_gen == 1, f"seats {mode}: {enc._cap_gen} growths")
    rec = sent["recovery"]
    if mode == "h264":
        intra = [i for _, _, i in log]
        check(intra == [True] + [False] * 6 + [True, False, True, False],
              f"seats h264: I/P ticks {intra}")
        check(rec == [n] * SEATS, f"seats h264: recovery IDR batch {rec}")
    else:
        check(rec[NOISY_SEAT] == n, f"seats jpeg: recovery resend {rec}")
    return sent


def single_seat_gate(mode: str, script, log) -> None:
    """Each seat's chunks equal a single-seat port session fed that
    seat's frames (H.264: the stock configuration, which the seats run,
    forced into the seats' IDR batches), tick by tick; on the overflow
    tick the seats that did not overflow deliver exactly what their own
    sessions deliver."""
    for k in range(SEATS):
        if mode == "h264":
            sess = H264EncoderSession(seat_settings(
                mode, h264_partial_encode=False))
        else:
            sess = JpegEncoderSession(seat_settings(mode))
        for (name, frames, force), (per, _, intra) in zip(script, log):
            out = sess.encode(frames[k], force=bool(intra)) \
                if mode == "h264" else sess.encode(frames[k])
            got = [dataclasses.astuple(dataclasses.replace(
                c, seat_index=k, display_id=f"seat{k}"))
                for c in sess.finalize(out, force_all=force)]
            check(got == per[k], f"seats {mode}: seat {k} tick {name} "
                  "differs from its single-seat session")


def seats_capture_run(mode: str, depth: int) -> dict:
    """``MultiSeatCapture(SEATS)`` unpaced until CAPTURE_FRAMES ticks
    were delivered, in order, every tick to every seat; the record of
    :func:`traced_capture`."""
    what = f"seats {mode} capture (depth {depth})"
    run = traced_capture(MultiSeatCapture(SEATS), seat_settings(
        mode, target_fps=1000.0, pipeline_depth=depth), what)
    order, chunks = run["order"], run["chunks"]
    check(order == sorted(order) and order[0] == 0,
          f"{what}: ticks out of order")
    check(all({c[7] for c in chunks[f]} == set(range(SEATS))
              for f in range(CAPTURE_FRAMES)), f"{what}: a tick missed a "
          "seat")
    return run


def seats_capture(modes=("jpeg", "h264")) -> dict:
    """Depth 1 and 2, unpaced, each codec; depth 2 equal to depth 1. ->
    {mode: {run: stats}}."""
    stats = {}
    for mode in modes:
        runs = {f"depth{d}": seats_capture_run(mode, d) for d in (1, 2)}
        for fid in range(CAPTURE_FRAMES):
            check(runs["depth2"]["chunks"].get(fid)
                  == runs["depth1"]["chunks"].get(fid),
                  f"seats {mode} capture: tick {fid} at depth 2 differs "
                  "from depth 1")
        stats[mode] = {}
        for name, run in runs.items():
            st = capture_stats(run)
            st["ticks_per_s"] = st.pop("fps")
            st["seat_frames_per_s"] = st["ticks_per_s"]
            st["frames_per_s_all_seats"] = SEATS * st["ticks_per_s"]
            stats[mode][name] = st
    return stats


def seats_path() -> dict:
    """The sixth path: both multi-seat encoders through the script on the
    kernels (launch counters reset first), then the capture facade at
    depth 1 and 2; afterwards, uncounted, the same script on the plain
    versions and through one single-seat session per seat."""
    res = {"sent": {}, "capture": None}
    encs, scripts, logs = {}, {}, {}
    _cuda.reset_launches()
    t0 = time.perf_counter()
    for mode in ("h264", "jpeg"):
        encs[mode] = seat_encoder(mode, SEATS)
        g = encs[mode].grid
        scripts[mode] = seat_script(encs[mode].device, g.height, g.width)
        logs[mode] = run_seat_script(encs[mode], mode, scripts[mode])
    res["capture"] = seats_capture()
    torch.cuda.synchronize()
    res["launches"] = dict(_cuda.LAUNCHES)
    res["seconds"] = time.perf_counter() - t0
    for k in SEATS_PATH:
        check(res["launches"][k] > 0, f"seats path never launched {k}")
    for k in ("pack_stream", "jpeg_pack", "synthetic_frame"):
        check(res["launches"][k] == 0,
              f"seats path launched the single-frame entry {k}")
    for mode in ("h264", "jpeg"):
        script, log = scripts[mode], logs[mode]
        res["sent"][mode] = check_seat_log(mode, script, log, encs[mode])
        compare_seat_logs(mode, script, log, run_seat_script(
            seat_encoder(mode, SEATS, plain=True), mode, script))
        single_seat_gate(mode, script, log)
    return res


def seat_launch_counts() -> dict:
    """Launches of each kernel in one tick at every seat count: the
    tick's frames from K10's seat entry, then a first (I) tick and a
    full-damage (P) tick; each kernel of the tick must launch exactly
    once, whatever the seat count. -> {S: {tick: launches}}."""
    want = {"jpeg": {"first": SEATS_JPEG_TICK, "full": SEATS_JPEG_TICK},
            "h264": {"first": SEATS_H264_I, "full": SEATS_H264_P}}
    res = {}
    for n in SEAT_COUNTS:
        res[n] = {}
        for mode in ("jpeg", "h264"):
            enc = seat_encoder(mode, n)
            for tick, (name, force) in enumerate((("first", True),
                                                  ("full", False))):
                torch.cuda.synchronize()
                _cuda.reset_launches()
                frames = synthetic_seat_frames(enc, tick)
                per, _ = seat_tick(enc, mode, frames, force)
                torch.cuda.synchronize()
                got = {k: v for k, v in _cuda.LAUNCHES.items() if v}
                res[n][f"{mode}_{name}"] = got
                expect = dict.fromkeys(want[mode][name]
                                       + ("synthetic_frames",), 1)
                check(got == expect, f"seats {mode} {name} tick at {n} "
                      f"seats launched {got}, expected once each")
                check(all(len(c) == enc.grid.n_stripes for c in per),
                      f"seats {mode} {name} tick at {n} seats: a seat "
                      "missed stripes")
    return res


def seat_tick_times(reps: int = 7) -> dict:
    """Host-clock encode + finalize (ms, median of ``reps``) of a
    full-damage tick at every seat count: H.264 the IDR batch and a P
    tick, JPEG a tick; consecutive reps alternate between two seat
    frame batches, so every stripe of every seat changes."""
    res = {}
    for n in SEAT_COUNTS:
        res[n] = {}
        for mode, kinds in (("h264", (("I", True), ("P", False))),
                            ("jpeg", (("full", False),))):
            enc = seat_encoder(mode, n)
            batches = [synthetic_seat_frames(enc, t) for t in (0, 1)]
            seat_tick(enc, mode, batches[1], True)
            tick = 0
            for kind, force in kinds:
                ts, nbytes_ = [], 0
                for _ in range(reps):
                    frames = batches[tick % 2]
                    tick += 1
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    per, _ = seat_tick(enc, mode, frames, force)
                    ts.append((time.perf_counter() - t0) * 1e3)
                    nbytes_ = sum(len(c.payload) for s in per for c in s)
                    check(all(len(c) == enc.grid.n_stripes for c in per),
                          f"seats {mode} timing: a tick was not full")
                check(enc._cap_gen == 0, f"seats {mode} timing overflowed")
                res[n][f"{mode}_{kind}"] = {
                    "encode_finalize_ms": statistics.median(ts),
                    "bytes": nbytes_}
    return res


def seat_kernel_checks(dev, h264_caps, jpeg_caps) -> dict:
    """K4, K9 and K10's seat entries against their plain versions
    (tolerance 0) at every seat count, at the seats path's 1080p shapes
    (K4 on K1-K3's I events, K9 on K6-K8's events of the stacked seat
    frames), at the stock caps and with seat 0 a noise frame that
    overflows (K4: its rows spill past a cut w_cap; K9: its byte buffer)
    while the other seats do not; then timed (median of 20 after an L2
    flush) beside the plain version and the bytes bound. -> {entry: {S:
    record}}."""
    l2 = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    flush = (lambda: flush_l2(l2))
    out = {"synthetic_frames": {}, "pack_stream_seats": {},
           "jpeg_pack_seats": {}}
    GH, W = (HEIGHT + 63) // 64 * 64, WIDTH
    e_cap, w_cap, out_cap = h264_caps
    je_cap, jw_cap, jout_cap = jpeg_caps
    for n in SEAT_COUNTS:
        # K10: n seats in one launch
        ko = FR.synthetic_frames(GH, W, n, 7, dev)
        err = max_abs_err([ko], [FR.synthetic_frames_plain(GH, W, n, 7,
                                                           dev)])
        wrap = FR.synthetic_frames(GH, W, n, 2**31 - 40, dev)
        err = max(err, max_abs_err([wrap], [FR.synthetic_frames_plain(
            GH, W, n, 2**31 - 40, dev)]))
        check(err == 0, f"synthetic_frames ({n} seats) differs (err {err})")
        ms = time_fn(lambda: FR.synthetic_frames(GH, W, n, 7, dev), 20,
                     flush=flush, hide_launch=True)
        pms = time_fn(lambda: FR.synthetic_frames_plain(GH, W, n, 7, dev), 3)
        out["synthetic_frames"][n] = (err, ms, pms, nbytes(ko),
                                      12 * ko.numel(), None)
        point(f"synthetic_frames S={n}", ms, nbytes(ko), 12 * ko.numel(),
              pms)
        # the card's write rate under the same protocol, as a yardstick
        # for K10 (fill_ writes the same bytes and computes nothing)
        ms = time_fn(lambda: ko.fill_(7), 20, flush=flush, hide_launch=True)
        point(f"fill_ yardstick S={n}", ms, nbytes(ko), 0)

        frames = FR.synthetic_frames(GH, W, n, 3, dev)
        noisy = frames.clone()
        noisy[0] = seat_noise(dev, GH, W)
        # K4 on the I events of the stacked frames (K1, K2-I, K3)
        enc = seat_encoder("h264", n)
        g = enc.grid
        S, rps, R = n * g.n_stripes, g.rows_per_stripe, n * g.height // 16
        qp = torch.full((R,), enc.qp, dtype=torch.int32, device=dev)
        row_id = torch.arange(R, dtype=torch.int32, device=dev) % 16
        send = torch.ones((S,), dtype=torch.int32, device=dev)
        for tag, fr in (("stock", frames), ("overflow", noisy)):
            flat = fr.view(-1, W, 3)
            y, u, v, _ = HP.csc420_damage(flat, torch.zeros_like(flat), S)
            ref = [torch.empty_like(p) for p in (y, u, v)]
            lv, cbp, hp, hn = HP.mb_encode_i(y, u, v, qp, send, rps, *ref)
            ev = HP.cavlc_events(lv, cbp, True)
            caps = (e_cap, w_cap, out_cap) if tag == "stock" \
                else (e_cap, 4096, out_cap)
            args = (hp, hn, *ev, enc._hdr_pay, enc._hdr_nb, row_id, qp,
                    True, *caps)
            k4 = HP.pack_stream_seats(*args, n_seats=n)
            err = max_abs_err(k4, HP.pack_stream_seats_plain(*args,
                                                             n_seats=n))
            check(err == 0, f"pack_stream_seats ({tag}, {n} seats) "
                  f"differs from plain (err {err})")
            flags = k4.flags.tolist()
            if tag == "overflow":
                check(flags == [[1, 1]] + [[0, 0]] * (n - 1),
                      f"pack_stream_seats overflow flags {flags}")
                continue
            check(not any(f for fl in flags for f in fl),
                  f"pack_stream_seats stock flags {flags}")
            ms = time_fn(lambda: HP.pack_stream_seats(*args, n_seats=n), 20,
                         flush=flush, hide_launch=True)
            pms = time_fn(lambda: HP.pack_stream_seats_plain(
                *args, n_seats=n), 3)
            out["pack_stream_seats"][n] = (err, ms, pms,
                                           nbytes(hp, hn, *ev, *k4),
                                           10 * ev[1].numel(), None)

        # K9 on the events of the stacked frames (K6-K8)
        jenc = seat_encoder("jpeg", n)
        jg = jenc.grid
        S = n * jg.n_stripes
        for tag, fr in (("stock", frames), ("overflow", noisy)):
            flat = fr.view(-1, W, 3)
            tab = torch.zeros((S,), dtype=torch.int32, device=dev)
            planes = JPL.jpeg_forward(flat, torch.zeros_like(flat), tab,
                                      jenc._qtab, jenc.subsampling)
            k8 = JE.jpeg_events(*planes, jenc._scan, S)
            caps = (je_cap, jw_cap, jout_cap)
            k9 = JPP.jpeg_pack_seats(*k8, *caps, n_seats=n)
            err = max_abs_err(k9, JPP.jpeg_pack_seats_plain(*k8, *caps,
                                                            n_seats=n))
            check(err == 0, f"jpeg_pack_seats ({tag}, {n} seats) differs "
                  f"from plain (err {err})")
            flags = k9.flags.tolist()
            if tag == "overflow":
                check(flags == [[0, 1]] + [[0, 0]] * (n - 1),
                      f"jpeg_pack_seats overflow flags {flags}")
                continue
            check(not any(f for fl in flags for f in fl),
                  f"jpeg_pack_seats stock flags {flags}")
            ms = time_fn(lambda: JPP.jpeg_pack_seats(*k8, *caps, n_seats=n),
                         20, flush=flush, hide_launch=True)
            pms = time_fn(lambda: JPP.jpeg_pack_seats_plain(
                *k8, *caps, n_seats=n), 3)
            out["jpeg_pack_seats"][n] = (err, ms, pms, k9_bytes(k8[1], k9),
                                         10 * k8[0].numel(), None)
    return out


# ----------------------------------------------------------- stripes path
def stripe_planes(frame, fullcolor: bool):
    """The Y/U/V planes of a frame (through the CSC kernel)."""
    csc = H4.csc444_damage if fullcolor else HP.csc420_damage
    return list(csc(frame, torch.zeros_like(frame), 1)[:3])


def stripe_frame_cases(frames, dev, fullcolor: bool) -> list:
    """The eighth path's frame cases at 1920x1088 (68 MB rows), shards on
    ``dev``: (name, sharded() -> (out, recon), unsharded() -> (out,
    recon), the launches of one sharded call). 4:2:0: I at 2 and 4 shards
    and 3 shards padded over 68 rows, P with whole windows a shard (4
    shards, 17-row windows) and across the halo (4 shards, the whole frame
    as the window, so halo_y 24 and halo_c 13); 4:4:4: I and halo P. The P
    frame is the I frame scrolled by 7 rows, which moves content across
    every seam, coded against the I recon, with per-row QPs."""
    cands = scroll_candidates(24, 8)
    g = plan_h264_grid(CaptureSettings(capture_width=WIDTH,
                                       capture_height=HEIGHT))
    R, M = g.height // 16, g.mb_w
    e_cap, w_cap, _ = h264_buffer_caps(g, fullcolor)
    hdr = hcodec.slice_header_events(M, R)
    p_hdr = hcodec.p_slice_header_events(M, R)
    qp = np.random.default_rng(SEED + 11).integers(18, 40, R).astype(
        np.int32)
    f0 = torch.as_tensor(frames[0]).to(dev)
    planes = stripe_planes(f0, fullcolor)
    cur = stripe_planes(torch.roll(f0, -7, 0), fullcolor)
    enc_i = H4.h264_encode_yuv444 if fullcolor else HP.h264_encode_yuv
    enc_p = H4.h264_encode_p_yuv444 if fullcolor else HP.h264_encode_p_yuv
    # the P frames' reference: the unsharded I recon (not counted)
    rec = enc_i(*planes, qp, *hdr, e_cap, w_cap, want_recon=True)[1]
    sfx = "444" if fullcolor else ""
    k_i = {f"mb_encode_i{sfx}": 1, f"cavlc_events{sfx}": 1,
           "pack_stream_seats": 1}
    k_p = {f"mb_encode_p{sfx}": 1, f"cavlc_events{sfx}": 1,
           "pack_stream_seats": 1}

    def i_case(name, mesh):
        return (name, lambda: ST.h264_encode_sharded(
            *planes, qp, *hdr, e_cap, w_cap, mesh, fullcolor=fullcolor,
            want_recon=True),
            lambda: enc_i(*planes, qp, *hdr, e_cap, w_cap, want_recon=True),
            k_i)

    def p_case(name, sr, want):
        mesh = ST.stripe_mesh(R, [dev] * 4)
        return (name, lambda: ST.h264_encode_p_sharded(
            *cur, *rec, qp, *p_hdr, 3, e_cap, w_cap, mesh, candidates=cands,
            stripe_rows=sr, fullcolor=fullcolor),
            lambda: enc_p(*cur, *rec, qp, *p_hdr, 3, e_cap, w_cap,
                          candidates=cands, stripe_rows=sr), want)
    halo = p_case(f"P{sfx} 4 shards, halo ({R}-row windows)", R,
                  {"halo_bands": 3, f"motion_select_halo{sfx}": 1, **k_p})
    if fullcolor:
        return [i_case("I444 4 shards", ST.stripe_mesh(R, [dev] * 4)), halo]
    return [i_case(f"I {n} shards", ST.stripe_mesh(R, [dev] * n))
            for n in (2, 4)] + [
        p_case(f"P 4 shards, {R // 4}-row windows", R // 4,
               {"motion_select": 1, **k_p}), halo,
        i_case("I 3 shards padded",
               ST.StripeMesh(np.array([dev] * 3, object)))]


def run_stripe_frames(cases) -> list:
    """The sharded calls of ``cases``, each launching exactly its kernels
    once (K20 once a plane). -> (out, recon) per case."""
    outs = []
    for name, sharded, _, want in cases:
        before = dict(_cuda.LAUNCHES)
        outs.append(sharded())
        delta = {k: v - before[k] for k, v in _cuda.LAUNCHES.items()
                 if v != before[k]}
        check(delta == want, f"stripes {name}: launches {delta}, want {want}")
    return outs


def plain_shards(run):
    """``run()`` with the sharded frame entries on their plain versions
    (on the card)."""
    kern = dict(ST.SHARD_OPS)
    ST.SHARD_OPS.update(ST.SHARD_PLAIN_OPS)
    try:
        return run()
    finally:
        ST.SHARD_OPS.update(kern)


def check_stripe_frames(cases, outs) -> list:
    """Each sharded call against the unsharded frame entry (row words,
    total_bits, overflow, recon) and its plain run. -> names."""
    for (name, sharded, unsharded, _), (out, rec) in zip(cases, outs):
        want, want_rec = unsharded()
        check(torch.equal(out.words, want.words)
              and torch.equal(out.total_bits, want.total_bits)
              and bool(out.overflow) == bool(want.overflow)
              and not bool(out.overflow),
              f"stripes {name}: rows differ from the unsharded frame")
        check(all(torch.equal(a, b) for a, b in zip(rec, want_rec)),
              f"stripes {name}: recon differs from the unsharded frame")
        p_out, p_rec = plain_shards(sharded)
        err = max_abs_err([out.words, out.total_bits, *rec],
                          [p_out.words, p_out.total_bits, *p_rec])
        check(err == 0, f"stripes {name}: kernels differ from plain "
              f"(err {err})")
    return [c[0] for c in cases]


def count_frame_launches(sess) -> list:
    """Wraps ``sess.encode`` to log (intra, launches of the call)."""
    calls, encode = [], sess.encode

    def counted(frame, force=False):
        before = dict(_cuda.LAUNCHES)
        out = encode(frame, force=force)
        calls.append((out["intra"], {k: v - before[k] for k, v in
                                     _cuda.LAUNCHES.items()
                                     if v != before[k]}))
        return out
    sess.encode = counted
    return calls


def stripe_sessions(settings, fullcolor: bool, dev):
    """(sharded kernel session, its plain twin, the unsharded session) at
    ``STRIPE_HEIGHT`` stripes, 4 shards on the card, all starting at four
    times the stock byte buffer, so that a shard holds as much as the
    stock frame buffer (the planned overflow episode is the one
    overflow)."""
    s = dataclasses.replace(settings, stripe_height=STRIPE_HEIGHT,
                            fullcolor=fullcolor)
    sharded = dataclasses.replace(s, stripe_devices=STRIPE_SHARDS)
    kern = StripeShardedH264Session(sharded, devices=[dev] * STRIPE_SHARDS)
    plain = StripeShardedH264Session(sharded,
                                     devices=[dev] * STRIPE_SHARDS)
    plain._ops = H4.SEAT_PLAIN_OPS_444 if fullcolor else HP.SEAT_PLAIN_OPS
    one = H264EncoderSession(s, dev)
    check(kern.stripe_devices == STRIPE_SHARDS and not kern._partial,
          f"sharded session resolved {kern.stripe_devices} shards")
    for sess in (kern, plain, one):
        sess._out_cap *= 4
        sess._rebuild_steps()
    return kern, plain, one


def shard_shrunk_cap(chunks) -> int:
    """The sharded overflow plan: each shard's buffer two thirds of the
    largest stripe of the IDR (one stripe a shard)."""
    return STRIPE_SHARDS * (max(len(c.payload) for c in chunks) * 2 // 3)


def stripes_path(settings, dsettings, frames, seq, dev) -> dict:
    """The eighth path (split-frame, ``stripe_devices``): the frame cases
    of :func:`stripe_frame_cases`, then ``StripeShardedH264Session`` at 4
    shards over the stock sequence (its overflow episode shrinking each
    shard's buffer) and the default sequence, at 4:2:0 and 4:4:4, each
    frame launching each kernel of its step once; every frame is also
    read by ``finalize_stream`` every other frame. Held, outside the
    counted runs, against the unsharded entries and sessions and the
    plain runs. -> {"launches": {"4:2:0", "4:4:4"}, "sessions": chunks
    a frame and the shard buffers' caps}."""
    dev_frames = [torch.as_tensor(f).to(dev) for f in frames]
    res = {"launches": {}, "sessions": {}}
    for fullcolor in (False, True):
        tag = "4:4:4" if fullcolor else "4:2:0"
        mine = stripe_frame_cases(frames, dev, fullcolor)
        stock = stripe_sessions(settings, fullcolor, dev)
        default = stripe_sessions(dsettings, fullcolor, dev)
        calls = {k: count_frame_launches(s[0]) for k, s in
                 (("stock", stock), ("default", default))}

        def run():                      # one entry a frame
            return (run_stripe_frames(mine)
                    + run_sequence(stock[0], dev_frames, shard_shrunk_cap,
                                   stream=True)
                    + run_default_sequence(default[0], seq, stream=True))
        log, lc = run_path(f"stripes {tag}",
                           STRIPES444_PATH if fullcolor else STRIPES_PATH,
                           run)
        outs, slog = log[:len(mine)], log[len(mine):-len(seq)]
        dlog = log[-len(seq):]
        res["launches"][tag] = lc
        sfx = "444" if fullcolor else ""
        for kind, log in calls.items():
            for i, (intra, delta) in enumerate(log):
                want = {f"csc{'444' if fullcolor else '420'}_damage": 1,
                        f"cavlc_events{sfx}": 1, "pack_stream_seats": 1,
                        f"mb_encode_{'i' if intra else 'p'}{sfx}": 1}
                if kind == "default" and not intra:
                    want[f"motion_select{sfx}"] = 1
                check(delta == want, f"stripes {tag} {kind} frame {i}: "
                      f"launches {delta}, want {want}")
        check_stripe_frames(mine, outs)
        # the overflow episode: dropped, the shard buffers doubled once
        check(slog[9][0] == [] and stock[0]._cap_gen == 1
              and all(c.is_idr for c in slog[10][0]),
              f"stripes {tag}: the planned overflow episode did not run")
        check_stream(slog, stock[0])
        compare_runs(slog, run_sequence(stock[1], dev_frames,
                                        shard_shrunk_cap))
        compare_runs(dlog, run_default_sequence(default[1], seq))
        # against the unsharded session: the stock run in full (its own
        # overflow plan drops the same frame), the default run in chunks
        # and the state both paths keep (the unsharded one takes the band
        # path)
        compare_runs(slog, run_sequence(stock[2], dev_frames))
        one = run_default_sequence(default[2], seq)
        for i, (a, b) in enumerate(zip(dlog, one)):
            check([dataclasses.astuple(c) for c in a[0]]
                  == [dataclasses.astuple(c) for c in b[0]],
                  f"stripes {tag} default frame {i}: chunks differ from "
                  "the unsharded session's")
            for k in ("_ref_y", "_ref_u", "_ref_v", "_prev", "_sent",
                      "_fnum"):
                check(torch.equal(a[1][k], b[1][k]),
                      f"stripes {tag} default frame {i}: {k} differs from "
                      "the unsharded session's")
        res["sessions"][tag] = {
            "stock": [len(c) for c, _ in slog],
            "default": [len(c) for c, *_ in dlog],
            "local_cap": [stock[0]._out_cap_local, default[0]._out_cap_local]}
        print(f"stripes {tag}: {len(mine)} frame cases == the unsharded "
              "frame entries (rows, total_bits, recon) and their plain "
              f"runs: {json.dumps([c[0] for c in mine])}; the sharded "
              f"session (4 shards) == its plain run (chunks and state) and "
              f"== H264EncoderSession chunk for chunk, stock and default "
              f"sequences, finalize and finalize_stream: "
              + json.dumps(res["sessions"][tag]))
    return res


def stripes_c1(dsettings, seq, dlog) -> None:
    """``stripe_devices=4`` with no device list on the one card: the count
    resolves to 1 (gauged) and the session is the default path's, band
    path included (``dlog``: path 2's log)."""
    sess = StripeShardedH264Session(dataclasses.replace(
        dsettings, stripe_devices=4))
    gauge = metrics._gauges.get(("selkies_stripe_devices", ()))
    check(sess.stripe_devices == 1 and gauge == 1.0 and sess._partial,
          f"one card: {sess.stripe_devices} shards, gauge {gauge}")
    compare_runs(run_default_sequence(sess, seq), dlog)
    print("stripes: stripe_devices=4 on the one card resolves to 1 shard "
          "(gauge 1) and equals the default path, band path included")


def stripe_kernel_checks(frames, dev) -> dict:
    """K19 (both entries) and K20 against their plain versions at the halo
    frames' 1080p shapes (4 shards of 272 rows, 57 candidates, a
    whole-frame window; K20 on the three planes of a frame), and K4's
    seat entry at 4:4:4's slot counts on the 4:4:4 I events of 4 shards;
    tolerance 0, then timed (median of 20 after an L2 flush) beside the
    plain version, the bound and, for K20, ``index_select``."""
    l2 = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    flush = (lambda: flush_l2(l2))
    cands = scroll_candidates(24, 8)
    out = {}
    f0 = torch.as_tensor(frames[0]).to(dev)
    R = f0.shape[0] // 16
    M = f0.shape[1] // 16
    band = f0.shape[0] // STRIPE_SHARDS
    qp = torch.full((R,), 28, dtype=torch.int32, device=dev)
    for fullcolor in (False, True):
        sfx = "444" if fullcolor else ""
        cdiv = 1 if fullcolor else 2
        ref = stripe_planes(f0, fullcolor)
        cur = stripe_planes(torch.roll(f0, -7, 0), fullcolor)[0]
        halos = (24, 24 if fullcolor else 13)
        bands = [ST.halo_bands(ref[0], band, halos[0])] + [
            ST.halo_bands(p, band // cdiv, halos[1]) for p in ref[1:]]
        if not fullcolor:
            plain_b = [ST.halo_bands_plain(ref[0], band, halos[0])] + [
                ST.halo_bands_plain(p, band // cdiv, halos[1])
                for p in ref[1:]]
            err = max_abs_err(bands, plain_b)
            check(err == 0, f"halo_bands differs from plain (err {err})")
            idx = [ST._halo_index(STRIPE_SHARDS, b, h, p.shape[0], dev)
                   .reshape(-1) for p, b, h in zip(
                       ref, (band, band // 2, band // 2),
                       (halos[0], halos[1], halos[1]))]
            lib_b = [p.index_select(0, i).view_as(b)
                     for p, i, b in zip(ref, idx, bands)]
            check(max_abs_err(bands, lib_b) == 0,
                  "halo_bands differs from index_select")

            def k20():
                ST.halo_bands(ref[0], band, halos[0])
                for p in ref[1:]:
                    ST.halo_bands(p, band // 2, halos[1])

            def p20():
                ST.halo_bands_plain(ref[0], band, halos[0])
                for p in ref[1:]:
                    ST.halo_bands_plain(p, band // 2, halos[1])
            ms = time_fn(k20, 20, flush=flush, hide_launch=True)
            pms = time_fn(p20, 3)
            lib = time_fn(lambda: [p.index_select(0, i)
                                   for p, i in zip(ref, idx)], 20,
                          flush=flush, hide_launch=True)
            out["halo_bands"] = (err, ms, pms,
                                 nbytes(*ref) + nbytes(*bands), 0, lib)
        kern = ST.motion_select_halo444 if fullcolor \
            else ST.motion_select_halo
        plain = ST.motion_select_halo444_plain if fullcolor \
            else ST.motion_select_halo_plain
        k5 = motion_select444 if fullcolor else motion_select
        ko = kern(cur, *bands, qp, cands, f0.shape[0])
        err = max_abs_err(ko, plain(cur, *bands, qp, cands, f0.shape[0]))
        check(err == 0 and max_abs_err(ko, k5(cur, *ref, qp, cands,
                                              f0.shape[0])) == 0,
              f"motion_select_halo{sfx} differs from plain or K5 "
              f"(err {err})")
        check(bool((ko[3][..., 1] == 28).any()),
              f"motion_select_halo{sfx} chose no 7-row scroll")
        ms = time_fn(lambda: kern(cur, *bands, qp, cands, f0.shape[0],
                                  out=ko), 20, flush=flush, hide_launch=True)
        pms = time_fn(lambda: plain(cur, *bands, qp, cands, f0.shape[0]), 3)
        out[f"motion_select_halo{sfx}"] = (
            err, ms, pms, nbytes(cur, *bands, qp, *ko),
            3 * 256 * len(cands) * R * M, None)
        point(f"motion_select_halo{sfx} {STRIPE_SHARDS} shards",
              *(out[f"motion_select_halo{sfx}"][k] for k in (1, 3, 4, 2)))
    # K4's seat entry on the 4:4:4 I events of the four shards
    y, u, v = stripe_planes(f0, True)
    g = plan_h264_grid(CaptureSettings(capture_width=WIDTH,
                                       capture_height=HEIGHT))
    e_cap, w_cap, _ = h264_buffer_caps(g, True)
    send = torch.ones((1,), dtype=torch.int32, device=dev)
    rec = [torch.empty_like(p) for p in (y, u, v)]
    lv, cbp, hp, hn = H4.mb_encode_i444(y, u, v, qp, send, R, *rec)
    ev = H4.cavlc_events444(lv, cbp, True)
    err = max_abs_err(ev, H4.cavlc_events444_plain(lv, cbp, True))
    check(err == 0, f"cavlc_events444 on {STRIPE_SHARDS} shards differs "
          f"(err {err})")
    ms = time_fn(lambda: H4.cavlc_events444(lv, cbp, True), 20, flush=flush,
                 hide_launch=True)
    point(f"cavlc_events444 I {STRIPE_SHARDS} shards", ms,
          nbytes(lv, cbp, *ev), 30 * 36 * 51 * R * M)
    row_hp, row_hn = (torch.as_tensor(a.astype(np.int32), device=dev)
                      for a in hcodec.slice_header_events(M, R))
    row_id = torch.arange(R, dtype=torch.int32, device=dev) % 16
    out_cap = (R // STRIPE_SHARDS) * w_cap * 4
    args = (hp, hn, *ev, row_hp, row_hn, row_id, qp, True, e_cap, w_cap,
            out_cap)
    k4 = HP.pack_stream_seats(*args, n_seats=STRIPE_SHARDS)
    err = max_abs_err(k4, HP.pack_stream_seats_plain(
        *args, n_seats=STRIPE_SHARDS))
    check(err == 0 and not bool(k4.flags.any()),
          f"pack_stream_seats at 4:4:4 differs from plain (err {err})")
    ms = time_fn(lambda: HP.pack_stream_seats(*args,
                                              n_seats=STRIPE_SHARDS), 20,
                 flush=flush, hide_launch=True)
    pms = time_fn(lambda: HP.pack_stream_seats_plain(
        *args, n_seats=STRIPE_SHARDS), 3)
    out["pack_stream_seats444"] = (err, ms, pms, nbytes(hp, hn, *ev, *k4),
                                   10 * ev[1].numel(), None)
    # the same at 4:2:0: K4's seat entry on the four shards' I events
    y, u, v = stripe_planes(f0, False)
    e_cap, w_cap, _ = h264_buffer_caps(g)
    rec = [torch.empty_like(p) for p in (y, u, v)]
    lv, cbp, hp, hn = HP.mb_encode_i(y, u, v, qp, send, R, *rec)
    ev = HP.cavlc_events(lv, cbp, True)
    args = (hp, hn, *ev, row_hp, row_hn, row_id, qp, True, e_cap, w_cap,
            (R // STRIPE_SHARDS) * w_cap * 4)
    k4 = HP.pack_stream_seats(*args, n_seats=STRIPE_SHARDS)
    err = max_abs_err(k4, HP.pack_stream_seats_plain(
        *args, n_seats=STRIPE_SHARDS))
    check(err == 0 and not bool(k4.flags.any()),
          f"pack_stream_seats at 4:2:0 shards differs from plain (err {err})")
    ms = time_fn(lambda: HP.pack_stream_seats(*args,
                                              n_seats=STRIPE_SHARDS), 20,
                 flush=flush, hide_launch=True)
    point(f"pack_stream_seats {STRIPE_SHARDS} shards", ms,
          nbytes(hp, hn, *ev, *k4), 10 * ev[1].numel())
    point(f"pack_stream_seats444 {STRIPE_SHARDS} shards",
          *(out["pack_stream_seats444"][k] for k in (1, 3, 4, 2)))
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
    t_start = time.perf_counter()
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
            if any(w in line for w in ("entry function", "registers",
                                       "spill")):
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

    # 5. fullcolor: both H.264 sequences and the H.264 capture loop
    fc = fullcolor_path(settings, dsettings, frames, seq)
    fc_launches = {k: sum(lc[k] for lc in fc["launches"].values())
                   for k in _cuda.LAUNCHES}
    for name, st in fc["capture"].items():
        print(f"capture loop h264_444 {name} ({WIDTH}x{HEIGHT}, host "
              f"clock): " + json.dumps(st))

    # 6. seats: both multi-seat encoders, 4 seats, and their capture loop
    seats = seats_path()
    print(f"seats sequence: {SEATS} seats, {len(seats['sent']['h264'])} "
          f"ticks a codec and the capture loop at depth 1 and 2 in "
          f"{seats['seconds']:.2f} s; launches "
          f"{json.dumps(seats['launches'])}")
    for mode, sent in seats["sent"].items():
        print(f"seats {mode}: kernel path == plain path (chunks and state), "
              "each seat == its single-seat session, and on the overflow "
              f"tick seats other than {NOISY_SEAT} equal their own "
              f"sessions; stripes sent per seat: {json.dumps(sent)}")
    for mode, runs in seats["capture"].items():
        for name, st in runs.items():
            print(f"seats capture loop {mode} {name} ({SEATS} seats of "
                  f"{WIDTH}x{HEIGHT}, host clock): " + json.dumps(st))
    print("seats capture: depth 2 == depth 1, chunk for chunk, ticks "
          f"0..{CAPTURE_FRAMES - 1}, both codecs")
    seat_counts = seat_launch_counts()
    for n, ticks in seat_counts.items():
        print(f"seats launches per tick at {n} seats: "
              + json.dumps(ticks))
    seat_times = seat_tick_times()
    for n, kinds in seat_times.items():
        print(f"seats full-damage tick at {n} seats (encode + finalize, "
              f"ms, host clock, median of 7): " + json.dumps(kinds))

    # 7. roi: the default sequence with ROI QP, at bias 4 and at bias 12
    roi = roi_path(dsettings, seq, dlog)
    roi_launches = {k: sum(lc[k] for lc in roi["launches"].values())
                    for k in _cuda.LAUNCHES}

    # 8. stripes: split-frame frames and the sharded session, 4 shards
    stripes = stripes_path(settings, dsettings, frames, seq,
                           torch.device("cuda", 0))
    stripes_c1(dsettings, seq, dlog)
    others = {"stock": stock_launches, "default": launches,
              "jpeg": jpeg_launches, "capture": capture_launches,
              **{f"fullcolor {k}": v for k, v in fc["launches"].items()},
              "seats": seats["launches"],
              **{f"stripes {k}": v for k, v in stripes["launches"].items()}}
    for run, lc in others.items():
        bad = {k: lc[k] for k in ROI_KERNELS if lc.get(k)}
        check(not bad, f"the {run} path launched ROI QP kernels {bad}")
    for run, lc in others.items():
        if run.startswith("stripes"):
            continue
        bad = {k: lc[k] for k in ("halo_bands", "motion_select_halo",
                                  "motion_select_halo444") if lc.get(k)}
        check(not bad, f"the {run} path launched split-frame kernels {bad}")

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
    fstock = H264EncoderSession(dataclasses.replace(settings, fullcolor=True))
    recs444 = kernel444_checks(frames, fstock, fc["grown"])
    k4_444 = {k: recs444.pop(k) for k in ("pack_stream444_i",
                                          "pack_stream444_p")}
    recs.update(recs444)
    srecs = seat_kernel_checks(stock.device, h264_buffer_caps(g),
                               jpeg_buffer_caps(jg, False))
    for name, per_n in srecs.items():
        for n, (err, ms, pms, by, ops, _) in per_n.items():
            if name in ("pack_stream_seats", "jpeg_pack_seats"):
                point(f"{name} S={n}", ms, by, ops, pms)
            t_b = bound_ms(by, ops)
            print(f"  {name} at {n} seats: {ms:.4f} ms (plain {pms:.2f} "
                  f"ms, bound {t_b:.4f} ms)")
        recs[name] = per_n[SEATS]
    recs.update(stripe_kernel_checks(frames, stock.device))
    f2, f3 = (torch.as_tensor(f).cuda() for f in frames[2:4])
    times = frame_times(settings, {"I": (f3, f2, True),
                                   "P": (f3, f2, False)})
    base = seq[0][1]
    typed = base.clone()
    typed[typing_rows(g.height), 300:420] = 20
    dtimes = frame_times(dsettings, {"I": (base, base, True),
                                     "scroll_P": (base, seq[1][1], False),
                                     "typing_P": (base, typed, False)})
    step_times = step_device_times(dsettings, base, seq[1][1], typed)
    rsettings = dataclasses.replace(dsettings, h264_roi_qp=True,
                                    h264_roi_qp_bias=ROI_RUNS[0][0])
    rstep_times = step_device_times(rsettings, base, seq[1][1], typed)
    fdsettings = dataclasses.replace(dsettings, fullcolor=True)
    fstep_times = step_device_times(fdsettings, base, seq[1][1], typed)
    ftimes = frame_times(fdsettings, {"I": (base, base, True),
                                      "scroll_P": (base, seq[1][1], False),
                                      "typing_P": (base, typed, False)})
    jf0, jf1 = jframes[:2]
    jtimes = jpeg_frame_times(jsettings, {"full": (255 - jf0, jf0),
                                          "damaged": (jf0, jf1),
                                          "idle": (jf1, jf1)})
    jstep_times = jpeg_step_device_times(jsettings,
                                         {"full": (255 - jf0, jf0),
                                          "idle": (jf0, jf0)})
    syncs = sync_checks(settings, dsettings, base, typed,
                        dataclasses.replace(dsettings, h264_roi_qp=True))
    fsyncs = sync_checks(dataclasses.replace(settings, fullcolor=True),
                         fdsettings, base, typed)
    jsess = JpegEncoderSession(jsettings)
    jsess.finalize(jsess.encode(jf0))
    jsyncs = {}
    for kind, frame in (("damaged", jf1), ("idle", jf1)):
        out, jsyncs[kind] = count_syncs(lambda: jsess.encode(frame))
        jsess.finalize(out)
    check(all(not v for v in jsyncs.values()),
          f"syncs inside the JPEG encode(): {jsyncs}")
    print(f"host syncs inside encode(): {json.dumps(syncs)}; "
          f"fullcolor: {json.dumps(fsyncs)}; jpeg: {json.dumps(jsyncs)}")
    print(f"buffer caps: stock w_cap {stock._w_cap} out_cap "
          f"{stock._out_cap}; after the overflow episode w_cap "
          f"{kern._w_cap} out_cap {kern._out_cap}; jpeg stock w_cap "
          f"{jstock._w_cap} out_cap {jstock._out_cap}, after its episode "
          f"{jkern._w_cap} / {jkern._out_cap}")
    print(f"frame times, stock configuration (ms, host clock, "
          f"{g.width}x{g.height}, stock caps): " + json.dumps(times))
    print(f"frame times, default configuration (ms, host clock, "
          f"{g.width}x{g.height}, stock caps): " + json.dumps(dtimes))
    print(f"frame times, fullcolor default configuration (ms, host clock, "
          f"{g.width}x{g.height}, stock 4:4:4 caps, median of 7): "
          + json.dumps(ftimes))
    print("step device times, default configuration (ms between CUDA "
          f"events, {g.width}x{g.height}, stock caps, L2 flushed, median of "
          "7): " + json.dumps(step_times))
    print(f"step device times, roi configuration (bias {ROI_RUNS[0][0]}: "
          "the default one's band steps with K17, K2-P's per-MB-QP entry "
          "and K18, its stock I step the default one's; ms between CUDA "
          f"events, {g.width}x{g.height}, stock caps, L2 flushed, median "
          "of 7): " + json.dumps(rstep_times))
    print("step device times, fullcolor default configuration (ms between "
          f"CUDA events, {g.width}x{g.height}, stock 4:4:4 caps, L2 "
          "flushed, median of 7): " + json.dumps(fstep_times))
    print("step device times, jpeg configuration (K6-K9; ms between CUDA "
          f"events, {jg.width}x{jg.height}, stock caps, L2 flushed, median "
          "of 7): " + json.dumps(jstep_times))
    print(f"fullcolor path launches: {json.dumps(fc['launches'])}")
    for k, (err, ms, _, by, ops, _) in k4_444.items():
        point(k, ms, by, ops)
        print(f"  {k} (K4 at the 4:4:4 slot count): {ms:.4f} ms, bound "
              f"{bound_ms(by, ops):.4f} ms")
    print(f"frame times, jpeg (ms, host clock, {jg.width}x{jg.height}, "
          f"2x stock caps, median of 7): " + json.dumps(jtimes))
    print(f"stock path launches: {json.dumps(stock_launches)}")
    print(f"jpeg path launches: {json.dumps(jpeg_launches)}")
    err, ms, pms, by, ops, lib = k6_stripes
    print(f"  row_damage_probe at stripe granularity ({jg.n_stripes} "
          f"stripes): {ms:.4f} ms (plain {pms:.2f} ms, bound "
          f"{bound_ms(by, ops):.4f} ms, "
          f"library {lib:.4f} ms)")
    # library_ms: K6's one-expression torch counterpart, F.pad for K11
    # and index_select for K20; null elsewhere, since no single PyTorch
    # call does block matching (K5, K19), CSC +
    # subsampling + damage (K1), the H.264 transforms, CAVLC or bit
    # packing (K2-K5, K14-K16, K4's seat entry), CSC + DCT + quantisation
    # + zigzag (K7), Huffman events (K8), bit packing (K9 and its seat
    # entry), the synthetic pattern (K10 and its seat entry),
    # a blend rounded half to even, clipped and written back (K12) or
    # CSC rounded to three planes + damage (K13)
    rows = []
    s420, s444 = (stripes["launches"][k] for k in ("4:2:0", "4:4:4"))
    for name, (src, replaces) in KERNELS.items():
        err, ms, pms, by, ops, lib = recs[name]
        t_bytes = by / HBM_BYTES_PER_S * 1e3
        t_ops = ops / FP32_OPS_PER_S * 1e3
        if name == "pack_stream_seats444":
            # the C entry pack_stream_seats, launched at 4:4:4's slots
            n = s444["pack_stream_seats"]
        else:
            n = launches[name] if name in DEFAULT_PATH else 0
            n += jpeg_launches[name] if name in JPEG_PATH else 0
            n += capture_launches[name]
            n += fc_launches[name]
            n += seats["launches"][name]
            n += roi_launches[name]
            n += s420[name]
            n += s444[name] if name != "pack_stream_seats" else 0
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
    print("K3 / K4 / K16 / K5 / K19 / K2-P / K10 / K9 / K15 / K1 / K7 / K2-I "
          "/ K6 / K8 / K11 / K14 / K13 / K12 / K17 timing points (ms between "
          "CUDA events after an L2 flush, median of 20; bound and plain ms "
          "as in the kernels line): " + json.dumps(POINTS))
    print(f"roi path launches: {json.dumps(roi['launches'])}")
    print(f"stripes path launches: {json.dumps(stripes['launches'])}")
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s of its 1200 s "
          "limit, the kernels' build included")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
