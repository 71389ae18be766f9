"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the four CUDA kernels of selkies_tpu_torch from csrc/, drives a
1920x1080 H.264 4:2:0 session (stock slice: zero-MV P frames, no band
step) through them over a seeded frame sequence — IDR, damaged and idle P
frames, paint-over, a forced IDR and one overflow episode — and runs the
same sequence through the kernels' plain PyTorch versions on the same
card, requiring equal chunks and equal reference planes frame by frame.
Then each kernel is held against its plain version at the 1080p shapes of
the main path (tolerance 0: every output is an integer) and timed with
CUDA events beside the plain version and its memory bound. Exits non-zero
on any mismatch, launch error or kernel the main path did not launch;
the last line is the device record. Needs no network and one card.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from selkies_tpu_torch.engine.h264_encoder import (H264EncoderSession,
                                                   h264_buffer_caps)
from selkies_tpu_torch.engine.types import CaptureSettings
from selkies_tpu_torch.ops import _cuda
from selkies_tpu_torch.ops import h264_planes as HP

SEED = 20261017
HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3 (data sheet)
FP32_OPS_PER_S = 67e12           # H100 SXM non-tensor FP32 (data sheet)

#: C entry -> (source, the reference function(s) it replaces)
KERNELS = {
    "csc420_damage": ("selkies_tpu_torch/csrc/csc420_damage.cu",
                      "selkies_tpu/ops/h264_planes.py:494"),
    "mb_encode_i": ("selkies_tpu_torch/csrc/mb_encode.cu",
                    "selkies_tpu/ops/h264_planes.py:541"),
    "mb_encode_p0": ("selkies_tpu_torch/csrc/mb_encode.cu",
                     "selkies_tpu/ops/h264_planes.py:875"),
    "cavlc_events": ("selkies_tpu_torch/csrc/cavlc_events.cu",
                     "selkies_tpu/ops/h264_planes.py:178"),
    "pack_stream": ("selkies_tpu_torch/csrc/pack_stream.cu",
                    "selkies_tpu/ops/h264_planes.py:324"),
}


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
    """A session whose steps run the four kernels' plain PyTorch versions
    on the card: the path the kernel session is held against."""
    sess = H264EncoderSession(settings)
    sess._ops = HP.PLAIN_OPS
    sess._i_step = sess._build_step("i")
    sess._p_step = sess._build_step("p")
    return sess


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
        snap = {k: getattr(sess, k).clone() for k in (
            "_ref_y", "_ref_u", "_ref_v", "_age", "_sent", "_fnum", "_prev")}
        log.append((chunks, snap))
        return chunks

    idr_bytes = 0
    for i, (frame, force) in enumerate(script):
        chunks = step(frame, force)
        if i == 7:
            idr_bytes = sum(len(c.payload) for c in chunks)
    # overflow episode: shrink the byte buffer below the forced IDR
    sess._out_cap = idr_bytes * 2 // 3
    sess._i_step = sess._build_step("i")
    sess._p_step = sess._build_step("p")
    gen = sess._cap_gen
    check(step(f2, True) == [], "shrunk out_cap did not overflow")
    check(sess._cap_gen == gen + 1, "overflow did not grow the buffers")
    check(all(c.is_idr for c in step(f2, False)),
          "frame after overflow was not an IDR")
    step(f3, False)
    return log


def compare_runs(a, b) -> None:
    check(len(a) == len(b), "runs differ in length")
    for i, ((ca, sa), (cb, sb)) in enumerate(zip(a, b)):
        check([dataclasses.astuple(c) for c in ca]
              == [dataclasses.astuple(c) for c in cb],
              f"frame {i}: kernel chunks differ from the plain path's")
        for k in sa:
            check(torch.equal(sa[k], sb[k]),
                  f"frame {i}: {k} differs from the plain path's")


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
    f0, f1, f2 = (torch.as_tensor(f).to(dev) for f in frames[:3])

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
    out["csc420_damage"] = (err, ms, pms, by, ops)

    # K2: both entries; every other stripe sent, so the gate shows
    qp = torch.full((R,), sess.qp, dtype=torch.int32, device=dev)
    qp[::3] = sess.paint_qp
    send = (torch.arange(S, device=dev) % 2 == 0).to(torch.int32)
    zero_ref = [torch.zeros_like(p) for p in (y, u, v)]
    res = {}
    for name, plain, base in (("mb_encode_i", HP.mb_encode_i_plain, zero_ref),
                              ("mb_encode_p0", HP.mb_encode_p0_plain, None)):
        if base is None:         # P: frame f2 against the I recon of f1
            base = [t.clone() for t in res["mb_encode_i"][1]]
            planes = HP.csc420_damage(f2, f1.clone(), S)[:3]
        else:
            planes = (y, u, v)
        kref = [t.clone() for t in base]
        pref = [t.clone() for t in base]
        kern = getattr(HP, name)
        ko = kern(*planes, qp, send, rps, *kref)
        po = plain(*planes, qp, send, rps, *pref)
        err = max_abs_err(list(ko) + kref, list(po) + pref)
        check(err == 0, f"{name} differs from plain (max err {err})")
        res[name] = (ko, kref)
        work = [t.clone() for t in base]

        def restore(work=work, base=base):
            for w, b in zip(work, base):
                w.copy_(b)
        ms = time_fn(lambda: kern(*planes, qp, send, rps, *work), 20,
                     restore=restore, flush=flush, hide_launch=True)
        pms = time_fn(lambda: plain(*planes, qp, send, rps, *work), 3,
                      restore=restore)
        # planes and levels move once; the reference planes are written
        # for the sent stripes only (and read as well in P)
        sent_frac = float(send.float().mean())
        by = nbytes(*planes, qp, send, *ko) + int(
            nbytes(*kref) * sent_frac * (2 if name == "mb_encode_p0" else 1))
        ops = 1200 * 24 * R * M                   # ~1200 int ops per block
        out[name] = (err, ms, pms, by, ops)

    # K3 and K4 on the K2 outputs of both modes
    for intra, key in ((True, "mb_encode_i"), (False, "mb_encode_p0")):
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
                                   30 * 36 * 27 * R * M)
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
                                      10 * ko[1].numel())
    return out


def frame_times(settings, frames, reps: int = 7) -> dict:
    """Host-clock encode+finalize times (ms) of I and P frames at the
    stock buffer caps. Each rep is a fresh session: an untimed IDR of
    one frame, then the timed frame (a forced IDR, or a P frame where
    the text panels change), so no rep meets a paint-over or an
    overflow that an earlier rep caused."""
    f2, f3 = (torch.as_tensor(f).cuda() for f in frames[2:4])
    res = {}
    for kind in ("I", "P"):
        ts, enc = [], []
        for _ in range(reps):
            sess = H264EncoderSession(settings)
            sess.finalize(sess.encode(f3))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = sess.encode(f2, force=(kind == "I"))
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            chunks = sess.finalize(out)
            t2 = time.perf_counter()
            check(chunks and all(c.is_idr == (kind == "I") for c in chunks),
                  f"timed {kind} frame sent no {kind} chunks")
            check((sess._w_cap, sess._out_cap)
                  == h264_buffer_caps(sess.grid)[1:],
                  "frame timing overflowed the stock buffers")
            enc.append((t1 - t0) * 1e3)
            ts.append((t2 - t0) * 1e3)
        res[kind] = {"encode_ms": statistics.median(enc),
                     "encode_finalize_ms": statistics.median(ts)}
    return res


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

    settings = CaptureSettings(capture_width=1920, capture_height=1080,
                               output_mode="h264", h264_motion_vrange=0,
                               h264_partial_encode=False,
                               paint_over_delay_frames=4)
    kern = H264EncoderSession(settings)
    plain = plain_session(dataclasses.replace(settings))
    g = kern.grid
    frames = desktop_frames(g.height, g.width, settings.capture_height)
    dev_frames = [torch.as_tensor(f).to(kern.device) for f in frames]

    _cuda.reset_launches()
    t0 = time.perf_counter()
    klog = run_sequence(kern, dev_frames)
    torch.cuda.synchronize()
    seq_s = time.perf_counter() - t0
    launches = dict(_cuda.LAUNCHES)
    print(f"kernel sequence: {len(klog)} frames in {seq_s:.2f} s; "
          f"launches {launches}")
    for name in KERNELS:
        check(launches[name] > 0, f"main path never launched {name}")
    check_stream(klog, kern)

    t0 = time.perf_counter()
    plog = run_sequence(plain, dev_frames)
    torch.cuda.synchronize()
    print(f"plain sequence: {len(plog)} frames in "
          f"{time.perf_counter() - t0:.2f} s")
    compare_runs(klog, plog)
    print("kernel path == plain path: chunks and reference planes, "
          f"{len(klog)} frames")

    # the overflow episode grew kern's buffers: time at the stock caps
    stock = H264EncoderSession(settings)
    recs = kernel_checks(frames, stock, (kern._w_cap, kern._out_cap))
    times = frame_times(settings, frames)
    print(f"buffer caps: stock w_cap {stock._w_cap} out_cap "
          f"{stock._out_cap}; after the overflow episode w_cap "
          f"{kern._w_cap} out_cap {kern._out_cap}")
    print(f"frame times (ms, host clock, {g.width}x{g.height}, stock caps): "
          + json.dumps(times))
    rows = []
    for name, (src, replaces) in KERNELS.items():
        err, ms, pms, by, ops = recs[name]
        t_bytes = by / HBM_BYTES_PER_S * 1e3
        t_ops = ops / FP32_OPS_PER_S * 1e3
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": err, "ms": ms, "plain_ms": pms,
                     "bound_ms": max(t_bytes, t_ops),
                     "bound_by": "bytes" if t_bytes >= t_ops
                     else "operations",
                     "library_ms": None})
        print(f"  {name}: launches {launches[name]}, {ms:.4f} ms "
              f"(plain {pms:.2f} ms, bound {max(t_bytes, t_ops):.4f} ms)")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
