"""Multi-seat H.264 on one card.

The counterpart of selkies_tpu/parallel/h264_seats.py: the adaptive I/P
step of engine/h264_encoder.py over a leading seat axis. The reference
runs ``shard_map(vmap(step))`` over a seat mesh; here the seats of a
tick go through the kernels together. Each MB row is its own slice, K5's
search window is the stripe, and every wire stripe is its own stream, so
the seat batch (S, H, W, 3) IS a (S * H, W, 3) frame of S * n_stripes
stripes, and every per-stripe (per-row) array is the seats' arrays back
to back. One tick is one launch of each of K1 ``csc420_damage``, K5
``motion_select`` (P ticks), K2 ``mb_encode_i``/``mb_encode_p`` and K3
``cavlc_events`` on that stacked view, and one of K4's seat entry
``pack_stream_seats``, which bounds each seat's words, byte buffer and
overflow flags by its own (ops/h264_planes.py). K5's prediction and MV
scratch and the reference planes are S times a seat's.

Like the reference this is the STOCK 4:2:0 step with the scroll motion
candidates on P: no band path, no ROI QP, no 4:4:4 (``fullcolor``,
``h264_partial_encode`` and ``h264_roi_qp`` are not read). A batch runs
in ONE mode: the first frame, ``force``, or any seat's recovery from an
overflow runs the IDR step for every seat.

The reference hands its step (S,) arrays of qp, paint-over qp and force
(equal across seats by construction) and slice-header events tiled over
seats. The port keeps ONE qp, paint-over qp and force for all seats, and
tiles the header events to the stacked rows, which K4 reads per row.
"""

from __future__ import annotations

import functools
import logging
import threading
import time
from typing import Any, Optional, Sequence

import numpy as np
import torch

from ..codecs import h264 as hcodec
from ..engine import state as _state
from ..engine.h264_encoder import (_motion_candidates, build_h264_step_fn,
                                   h264_buffer_caps, h264_stripe_payload,
                                   plan_h264_grid)
from ..engine.readback import HostCopy, fetch_stream_bytes, upload
from ..engine.types import CaptureSettings, EncodedChunk
from ..ops.h264_planes import SEAT_KERNEL_OPS, StepOps
from ..trace import tracer as _tracer
from .seats import mesh_device

logger = logging.getLogger("selkies_tpu_torch.parallel.h264_seats")


def build_h264_seats_step_fn(n_seats: int, mode: str, width: int,
                             stripe_h: int, n_stripes: int, e_cap: int,
                             w_cap: int, out_cap: int, paint_delay: int,
                             damage_gating: bool, paint_over: bool,
                             candidates: tuple = ((0, 0),),
                             ops: StepOps = SEAT_KERNEL_OPS, scratch=None):
    """The stock step of engine/h264_encoder.py over ``n_seats`` seats,
    as one stacked frame of ``n_seats * n_stripes`` stripes. ``ops`` are
    a seat set (``SEAT_KERNEL_OPS`` or ``SEAT_PLAIN_OPS``), whose
    ``pack_stream`` takes ``n_seats``; ``scratch`` is K5's prediction and
    MV planes for the stacked frame.

    step(frames (S, H, W, 3), prev, age, sent, fnum (S, n_stripes),
         ref_y, ref_u, ref_v (S, ...), qp_motion, qp_paint, force,
         hdr_pay, hdr_nb (S * R, 2))
    -> (data u8 (S, out_cap), row_lens i32 (S, R), send and is_paint
        (S, n_stripes), overflow (S,)); the state is updated in place."""
    seat_ops = ops._replace(pack_stream=functools.partial(
        ops.pack_stream, n_seats=n_seats))
    step = build_h264_step_fn(mode, width, stripe_h, n_seats * n_stripes,
                              e_cap, w_cap, out_cap, paint_delay,
                              damage_gating, paint_over, candidates,
                              ops=seat_ops, scratch=scratch)

    def seats_step(frames, prev, age, sent, fnum, ref_y, ref_u, ref_v,
                   qp_motion: int, qp_paint: int, force: bool, hdr_pay,
                   hdr_nb):
        def flat(t):                     # (S, H, ...) -> (S * H, ...)
            return t.view(-1, *t.shape[2:])
        data, lens, send, is_paint, overflow = step(
            flat(frames), flat(prev), age.view(-1), sent.view(-1),
            fnum.view(-1), flat(ref_y), flat(ref_u), flat(ref_v), qp_motion,
            qp_paint, force, hdr_pay, hdr_nb)
        return (data, lens.view(n_seats, -1), send.view(n_seats, -1),
                is_paint.view(n_seats, -1), overflow)

    seats_step.__name__ = f"h264_seats{n_seats}_{mode}_step"
    return seats_step


class MultiSeatH264Encoder:
    """N per-seat adaptive-I/P H.264 sessions fused into one device step
    a tick; the API of :class:`~.seats.MultiSeatEncoder` (encode/finalize
    with a leading seat axis). ``devices`` None means the card (raises
    without one); tests pass ``["cpu"]``."""

    STATE_KEYS = _state.SEATS_H264_STATE

    def __init__(self, settings: CaptureSettings, n_seats: int,
                 devices: Optional[Sequence] = None, mesh=None):
        if n_seats < 1:
            raise ValueError("n_seats must be >= 1")
        self.settings = settings
        self.n_seats = n_seats
        self.grid = plan_h264_grid(settings)
        g = self.grid
        self._e_cap, self._w_cap, self._out_cap = h264_buffer_caps(g)
        self._cap_gen = 0       # buffer-growth generation (pipelined
        #                         stale-cap frames must not re-grow)
        self.mesh, self.device = mesh_device(n_seats, devices, mesh)
        self._candidates = _motion_candidates(settings)
        n, R, dev = n_seats, g.n_stripes * g.rows_per_stripe, self.device

        def zeros(*shape, dtype=torch.int32):
            return torch.zeros(shape, dtype=dtype, device=dev)
        self.frame_id = 0
        self._age = zeros(n, g.n_stripes)
        self._sent = zeros(n, g.n_stripes)
        self._fnum = zeros(n, g.n_stripes)
        self._prev = zeros(n, g.height, g.width, 3, dtype=torch.uint8)
        ch, cw = g.height // 2, g.width // 2
        self._ref_y = zeros(n, g.height, g.width, dtype=torch.uint8)
        self._ref_u = zeros(n, ch, cw, dtype=torch.uint8)
        self._ref_v = zeros(n, ch, cw, dtype=torch.uint8)
        # K5's prediction and MV field for the stacked frame (never the
        # reference planes, which the P coder rewrites in place)
        self._scratch = None
        if len(self._candidates) > 1:
            self._scratch = (zeros(n * g.height, g.width, dtype=torch.uint8),
                             zeros(n * ch, cw, dtype=torch.uint8),
                             zeros(n * ch, cw, dtype=torch.uint8),
                             zeros(n * R, g.mb_w, 2))
        self._force_after_drop = np.zeros((n,), bool)
        # encode() tests-and-clears the flags while finalize sets them
        self._drop_lock = threading.Lock()
        self._sps_pps = hcodec.write_sps(g.width, g.stripe_h) \
            + hcodec.write_pps()

        def events(fn):
            pay, nb = fn(g.mb_w, g.rows_per_stripe)
            reps = (n * g.n_stripes, 1)
            return (upload(np.tile(pay.astype(np.int32), reps), dev),
                    upload(np.tile(nb.astype(np.int32), reps), dev))
        self._hdr_pay, self._hdr_nb = events(hcodec.slice_header_events)
        self._p_hdr_pay, self._p_hdr_nb = events(
            hcodec.p_slice_header_events)
        self.qp = int(np.clip(settings.video_crf, 8, 48))
        self.paint_qp = int(np.clip(settings.video_min_qp, 8, self.qp))
        self._copy_stream = torch.cuda.Stream(dev) \
            if dev.type == "cuda" else None
        self._ops = SEAT_KERNEL_OPS
        self._rebuild_steps()

    def _build(self, mode: str):
        g, s = self.grid, self.settings
        return build_h264_seats_step_fn(
            self.n_seats, mode, g.width, g.stripe_h, g.n_stripes,
            self._e_cap, self._w_cap, self._out_cap,
            s.paint_over_delay_frames, s.use_damage_gating, s.use_paint_over,
            candidates=self._candidates if mode == "p" else ((0, 0),),
            ops=self._ops, scratch=self._scratch)

    def _rebuild_steps(self) -> None:
        self._i_step = self._build("i")
        self._p_step = self._build("p")

    @property
    def input_sharding(self) -> torch.device:
        """Where callers should put frame batches: the seats' device."""
        return self.device

    # -- device step --------------------------------------------------------
    def encode(self, frames, force: bool = False) -> dict[str, Any]:
        """One I/P step over all seats (does not wait for the device).
        ``force`` (or the first frame, or a post-overflow recovery on ANY
        seat) runs the IDR step batch-wide."""
        cap_gen = self._cap_gen
        with self._drop_lock:
            if self._force_after_drop.any():
                self._force_after_drop[:] = False
                force = True
        if self.frame_id == 0:
            force = True
        intra = bool(force)
        step = self._i_step if intra else self._p_step
        hdr_pay = self._hdr_pay if intra else self._p_hdr_pay
        hdr_nb = self._hdr_nb if intra else self._p_hdr_nb
        frames = upload(frames, self.device).contiguous()
        with _tracer.span("encode.dispatch"):
            data, row_lens, send, is_paint, overflow = step(
                frames, self._prev, self._age, self._sent, self._fnum,
                self._ref_y, self._ref_u, self._ref_v, self.qp,
                self.paint_qp, intra, hdr_pay, hdr_nb)
            fid = self.frame_id
            self.frame_id = (self.frame_id + 1) & 0xFFFF
            control = HostCopy([row_lens, send, is_paint, overflow])
        return {"data": data, "control": control, "frame_id": fid,
                "intra": intra, "cap_gen": cap_gen}

    # -- host tail ----------------------------------------------------------
    def finalize(self, out: dict[str, Any], force_all: bool = False
                 ) -> list[list[EncodedChunk]]:
        """Waits for the control arrays; returns ``chunks[seat]``.
        ``force_all`` is ignored: forcing is an encode()-time decision."""
        del force_all
        g = self.grid
        rps = g.rows_per_stripe
        tl = _tracer.lookup(self.settings.display_id, out["frame_id"])
        rb_t0 = out.get("submitted_ns") or time.perf_counter_ns()
        lens, send, _, overflow = out["control"].wait()
        # per seat only the rows through the last SENT stripe; all-idle
        # ticks fetch nothing
        total = 0
        for seat in range(self.n_seats):
            if overflow[seat] or not send[seat].any():
                continue
            last_row = (int(np.nonzero(send[seat])[0][-1]) + 1) * rps
            total = max(total, int(lens[seat, :last_row].sum()))
        data = fetch_stream_bytes(out["data"], total, self._copy_stream,
                                  out["control"].done) if total else None
        _tracer.record_span(tl, "encode.readback", rb_t0)
        intra = out["intra"]
        if overflow.any():
            if out["cap_gen"] == self._cap_gen:
                logger.warning("multi-seat h264 overflow on seats %s; "
                               "growing", np.nonzero(overflow)[0].tolist())
                self._w_cap *= 2
                self._out_cap *= 2
                self._rebuild_steps()
                self._cap_gen += 1
            with self._drop_lock:
                self._force_after_drop |= overflow
        results: list[list[EncodedChunk]] = []
        for seat in range(self.n_seats):
            if overflow[seat]:
                results.append([])
                continue
            with _tracer.span("packetize", tl, lane=f"seat{seat}"):
                starts = np.concatenate([[0], np.cumsum(lens[seat])])
                chunks: list[EncodedChunk] = []
                for i in range(g.n_stripes):
                    if not send[seat, i]:
                        continue
                    rows = [bytes(data[seat, starts[r]:starts[r]
                                       + lens[seat, r]])
                            for r in range(i * rps, (i + 1) * rps)]
                    chunks.append(EncodedChunk(
                        payload=h264_stripe_payload(intra, rows,
                                                    self._sps_pps),
                        frame_id=out["frame_id"], stripe_y=i * g.stripe_h,
                        width=g.width, height=g.stripe_h, is_idr=intra,
                        output_mode="h264", seat_index=seat,
                        display_id=f"seat{seat}"))
            results.append(chunks)
        return results
