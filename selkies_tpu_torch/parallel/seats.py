"""Multi-seat JPEG encoding on one card.

The counterpart of selkies_tpu/parallel/seats.py. One *seat* is one
remote desktop (framebuffer and encoder state). The reference shards N
seats over a ``Mesh('seat')`` and runs ``shard_map(vmap(step))``; on one
card a seat is a batch index of the same kernels. Every kernel before
packing reads only inside one stripe, and JPEG stripes are separate
JFIFs, so the seat batch (S, H, W, 3), contiguous, IS a (S * H, W, 3)
frame of S * n_stripes stripes, and the per-stripe state (S, n_stripes)
is (S * n_stripes,). One tick is one launch of each of K6
``row_damage_probe``, K7 ``jpeg_forward`` and K8 ``jpeg_events`` on that
stacked view, and one of K9's seat entry ``jpeg_pack_seats``, which
keeps a byte buffer, an ``out_cap`` bound and overflow flags per seat
(ops/jpeg_pipeline.py). Frames for tests and the capture facade come
from K10's seat entry (:func:`synthetic_seat_frames`).

The reference hands its step per-seat copies of the quantisation tables
(tiled over the seat axis; equal by construction). The port keeps ONE
copy: (4, 64) for every stripe of every seat.
"""

from __future__ import annotations

import dataclasses
import functools
import logging
import time
from typing import Any, Optional, Sequence

import numpy as np
import torch

from .._device import resolve_device
from ..codecs import jpeg as jtab
from ..engine import state as _state
from ..engine.encoder import build_step_fn, jpeg_buffer_caps, plan_grid
from ..engine.readback import HostCopy, fetch_stream_bytes, upload
from ..engine.types import CaptureSettings, EncodedChunk
from ..ops.frames import synthetic_frames
from ..ops.jpeg_entropy import scan_layout, scan_maps
from ..ops.jpeg_pipeline import SEAT_KERNEL_OPS, JpegOps
from ..trace import tracer as _tracer
from .stripes import one_device

logger = logging.getLogger("selkies_tpu_torch.parallel.seats")

@dataclasses.dataclass(frozen=True)
class SeatMesh:
    """The devices the seats are spread over (the reference's 1-D
    ``Mesh('seat')``); ``devices`` is a 1-D object array, so
    ``devices.size`` reads as the reference's does."""
    devices: np.ndarray
    axis_names: tuple = ("seat",)


def seat_mesh(n_seats: int, devices: Optional[Sequence] = None) -> SeatMesh:
    """As many of ``devices`` (None: the card) as divide ``n_seats``."""
    if devices is None:
        devices = [None]
    devs = [resolve_device(d) for d in devices]
    n_dev = min(len(devs), n_seats)
    while n_seats % n_dev:
        n_dev -= 1
    arr = np.empty((n_dev,), object)
    arr[:] = devs[:n_dev]
    return SeatMesh(arr)


def mesh_device(n_seats: int, devices, mesh) -> tuple[SeatMesh, torch.device]:
    """The seat mesh and its one device. A mesh whose entries are all one
    device holds every seat group there, as one stacked batch (the
    reference's ``shard_map(vmap(step))`` over that many devices, seat for
    seat); distinct devices raise (ROADMAP A11c)."""
    mesh = mesh if mesh is not None else seat_mesh(n_seats, devices)
    if n_seats % mesh.devices.size:
        raise ValueError(f"{mesh.devices.size} devices do not divide "
                         f"{n_seats} seats")
    return mesh, one_device(mesh.devices)


def build_seats_step_fn(n_seats: int, width: int, stripe_h: int,
                        n_stripes: int, subsampling: str, e_cap: int,
                        w_cap: int, out_cap: int, paint_delay: int,
                        damage_gating: bool, paint_over: bool,
                        scan: torch.Tensor, ops: JpegOps = SEAT_KERNEL_OPS):
    """The JPEG step of engine/encoder.py over ``n_seats`` seats, as one
    stacked frame of ``n_seats * n_stripes`` stripes. ``ops`` are a seat
    set (``SEAT_KERNEL_OPS`` or ``SEAT_PLAIN_OPS``), whose ``jpeg_pack``
    takes ``n_seats``.

    step(frames u8 (S, H, W, 3), prev u8 (S, H, W, 3), age i32
         (S, n_stripes), qtables f32 (4, 64))
    -> (data u8 (S, out_cap), byte_lens i32 (S, n_stripes), send and
        is_paint bool (S, n_stripes), overflow bool (S,)); ``prev`` and
        ``age`` are updated in place."""
    seat_ops = ops._replace(jpeg_pack=functools.partial(ops.jpeg_pack,
                                                        n_seats=n_seats))
    step = build_step_fn(width, stripe_h, n_seats * n_stripes, subsampling,
                         e_cap, w_cap, out_cap, paint_delay, damage_gating,
                         paint_over, scan, ops=seat_ops)

    def seats_step(frames, prev, age, qtables):
        def flat(t):                     # (S, H, ...) -> (S * H, ...)
            return t.view(-1, *t.shape[2:])
        data, lens, send, is_paint, overflow = step(
            flat(frames), flat(prev), age.view(-1), qtables)
        return (data, lens.view(n_seats, -1), send.view(n_seats, -1),
                is_paint.view(n_seats, -1), overflow)

    seats_step.__name__ = f"jpeg_seats{n_seats}_step"
    return seats_step


class MultiSeatEncoder:
    """N per-seat JPEG stripe encoders fused into one device step a tick.

    The reference's API with a leading seat axis: ``encode(frames)``
    takes (S, H, W, 3) uint8, ``finalize`` returns a list of per-seat
    chunk lists. ``devices`` None means the card (raises without one);
    tests pass ``["cpu"]``, which runs the plain versions."""

    STATE_KEYS = _state.SEATS_JPEG_STATE

    def __init__(self, settings: CaptureSettings, n_seats: int,
                 devices: Optional[Sequence] = None, mesh=None):
        if n_seats < 1:
            raise ValueError("n_seats must be >= 1")
        self.settings = settings
        self.n_seats = n_seats
        self.grid = plan_grid(settings)
        self.subsampling = "444" if settings.fullcolor else "420"
        g = self.grid
        self._e_cap, self._w_cap, self._out_cap = jpeg_buffer_caps(
            g, settings.fullcolor)
        self.mesh, self.device = mesh_device(n_seats, devices, mesh)
        self._ops = SEAT_KERNEL_OPS
        self._scan = scan_maps(scan_layout(g.stripe_h // 8, g.width // 8,
                                           self.subsampling), self.device)
        self._rebuild_steps()
        self.frame_id = 0
        self._age = torch.zeros((n_seats, g.n_stripes), dtype=torch.int32,
                                device=self.device)
        # the reference's first prev is make_prev_buffer()'s zeros
        self._prev = self.make_prev_buffer()
        self._force_after_drop = np.zeros((n_seats,), bool)
        self._cap_gen = 0   # growth generation: pipelined frames encoded
        #                     with stale caps must not re-grow
        self._copy_stream = torch.cuda.Stream(self.device) \
            if self.device.type == "cuda" else None
        self.update_quality(settings.jpeg_quality,
                            settings.paint_over_quality)

    def _rebuild_steps(self) -> None:
        """(Re)build the step for the current caps and ops."""
        g, s = self.grid, self.settings
        self._step = build_seats_step_fn(
            self.n_seats, g.width, g.stripe_h, g.n_stripes, self.subsampling,
            self._e_cap, self._w_cap, self._out_cap,
            s.paint_over_delay_frames, s.use_damage_gating, s.use_paint_over,
            self._scan, ops=self._ops)

    # -- tunables -----------------------------------------------------------
    def update_quality(self, motion_q: int, paint_q: int | None = None):
        self.settings.jpeg_quality = int(motion_q)
        if paint_q is not None:
            self.settings.paint_over_quality = int(paint_q)
        s = self.settings
        self._qt_np = tuple(
            jtab.scale_qtable(base, q)
            for base, q in ((jtab.STD_LUMA_QUANT, s.jpeg_quality),
                            (jtab.STD_CHROMA_QUANT, s.jpeg_quality),
                            (jtab.STD_LUMA_QUANT, s.paint_over_quality),
                            (jtab.STD_CHROMA_QUANT, s.paint_over_quality)))
        self._qtab = upload(np.stack(self._qt_np).astype(np.float32),
                            self.device)

    # -- state --------------------------------------------------------------
    @property
    def input_sharding(self) -> torch.device:
        """Where callers should put frame batches: the seats' device."""
        return self.device

    def make_prev_buffer(self) -> torch.Tensor:
        g = self.grid
        return torch.zeros((self.n_seats, g.height, g.width, 3),
                           dtype=torch.uint8, device=self.device)

    # -- device step --------------------------------------------------------
    def encode(self, frames, prev: Optional[torch.Tensor] = None
               ) -> dict[str, Any]:
        """Dispatch one multi-seat step (does not wait for the device).

        ``frames``: (n_seats, grid.height, grid.width, 3) uint8, numpy or
        a tensor. ``prev`` defaults to the tracked previous batch; an
        explicit ``prev`` takes its place (the reference donates it): it
        is compared against and then updated in place."""
        if prev is not None:
            self._prev = prev
        cap_gen = self._cap_gen
        frames = upload(frames, self.device).contiguous()
        with _tracer.span("encode.dispatch"):
            data, lens, send, is_paint, overflow = self._step(
                frames, self._prev, self._age, self._qtab)
            fid = self.frame_id
            self.frame_id = (self.frame_id + 1) & 0xFFFF
            control = HostCopy([lens, send, is_paint, overflow])
        return {"data": data, "control": control, "frame_id": fid,
                "cap_gen": cap_gen, "qtabs": self._qt_np}

    # -- host tail ----------------------------------------------------------
    def finalize(self, out: dict[str, Any], force_all: bool = False
                 ) -> list[list[EncodedChunk]]:
        """Waits for the control arrays; returns ``chunks[seat]``."""
        g = self.grid
        tl = _tracer.lookup(self.settings.display_id, out["frame_id"])
        rb_t0 = out.get("submitted_ns") or time.perf_counter_ns()
        lens, send, is_paint, overflow = out["control"].wait()
        # per seat only the bytes through the last DELIVERED stripe;
        # overflowed seats are skipped, all-idle ticks fetch nothing
        total = 0
        for seat in range(self.n_seats):
            if overflow[seat]:
                continue
            if force_all or self._force_after_drop[seat]:
                total = max(total, int(lens[seat].sum()))
            elif send[seat].any():
                last = int(np.nonzero(send[seat])[0][-1])
                total = max(total, int(lens[seat, :last + 1].sum()))
        data = fetch_stream_bytes(out["data"], total, self._copy_stream,
                                  out["control"].done) if total else None
        _tracer.record_span(tl, "encode.readback", rb_t0)
        qy_m, qc_m, qy_p, qc_p = out["qtabs"]
        if overflow.any():
            # the single-seat policy: the overflowed seats' frames are
            # dropped, the growable buffers double ONCE per episode, and
            # those seats' next delivered frame is sent in full
            if out.get("cap_gen", self._cap_gen) == self._cap_gen:
                logger.warning("multi-seat overflow on seats %s; growing "
                               "buffers", np.nonzero(overflow)[0].tolist())
                self._w_cap *= 2
                self._out_cap *= 2
                self._rebuild_steps()
                self._cap_gen += 1
            self._force_after_drop |= overflow
        results: list[list[EncodedChunk]] = []
        for seat in range(self.n_seats):
            if overflow[seat]:
                results.append([])
                continue
            force = force_all or self._force_after_drop[seat]
            self._force_after_drop[seat] = False
            with _tracer.span("packetize", tl, lane=f"seat{seat}"):
                starts = np.concatenate([[0], np.cumsum(lens[seat])])
                chunks: list[EncodedChunk] = []
                for i in range(g.n_stripes):
                    if not (force or send[seat, i]):
                        continue
                    raw = data[seat, starts[i]:starts[i] + lens[seat, i]]
                    paint = bool(is_paint[seat, i])
                    qy, qc = (qy_p, qc_p) if paint else (qy_m, qc_m)
                    payload = jtab.assemble_jfif(
                        g.stripe_h, g.width, jtab.stuff_ff_bytes(raw), qy,
                        qc, self.subsampling)
                    chunks.append(EncodedChunk(
                        payload=payload, frame_id=out["frame_id"],
                        stripe_y=i * g.stripe_h, width=g.width,
                        height=g.stripe_h, is_idr=True, output_mode="jpeg",
                        seat_index=seat, display_id=f"seat{seat}"))
            results.append(chunks)
        return results


def synthetic_seat_frames(enc, tick: int) -> torch.Tensor:
    """Per-seat animated test frames on the seats' device, one launch
    (K10's seat entry): seat k shows the synthetic pattern at phase
    ``k * 37 + tick``, so every seat's content differs."""
    g = enc.grid
    return synthetic_frames(g.height, g.width, enc.n_seats, tick,
                            enc.input_sharding)
