"""Host readback of the encoded-stream buffer and the control arrays.

The counterpart of selkies_tpu/engine/readback.py. The device keeps the
full-capacity byte buffer; the host fetches only the prefix (or one
stripe's range) that the per-row lengths say is filled. On a CUDA tensor
every fetch is a ``non_blocking`` copy into pinned host memory, completed
by a CUDA event; on a CPU tensor it is a view. No kernel is involved:
readback is a copy. :func:`upload` is the other direction, for frames and
per-frame host inputs.

Streams: a session dispatches its frames on the capture thread's current
stream and :class:`HostCopy` records the frame's ``done`` event there,
after the step's kernels. With frames in flight (engine/pipeline.py) the
finalizer thread fetches frame N while frame N+1's kernels are queued on
that stream, so a fetch goes on the session's own copy stream, which
waits for frame N's ``done`` event only; ``record_stream`` tells the
caching allocator that the copy stream reads the buffer.
"""

from __future__ import annotations

import numpy as np
import torch

from ..resilience import faults as _faults

#: smallest whole-frame fetch
MIN_BUCKET = 32768

#: smallest per-stripe fetch (stripe streaming is latency-bound)
MIN_STRIPE_BUCKET = 4096


def bucket_for(total: int, floor: int = MIN_BUCKET) -> int:
    b = floor
    while b < total:
        b *= 2
    return b


def upload(x, device: torch.device) -> torch.Tensor:
    """Host data (numpy or a tensor) on ``device``. A CUDA upload of host
    data is a ``non_blocking`` copy from pinned memory, so it never waits
    for the device (a pageable copy would synchronise the stream)."""
    t = torch.as_tensor(x)
    if device.type != "cuda" or t.device.type == "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def _to_host(t: torch.Tensor, stream, after) -> np.ndarray:
    """``t`` on the host. A CUDA copy runs on ``stream`` after the event
    ``after``, and is waited for."""
    if t.device.type == "cpu":
        return t.numpy()
    stream.wait_event(after)
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    with torch.cuda.stream(stream):
        host.copy_(t, non_blocking=True)
        t.record_stream(stream)
        done = torch.cuda.Event()
        done.record(stream)
    done.synchronize()
    return host.numpy()


class HostCopy:
    """Non-blocking copies of small device tensors, started now on the
    current stream and waited for by :meth:`wait` (the session's one sync
    point). ``done`` is the CUDA event recorded after them: every kernel
    the frame queued before is complete when it is (None on the CPU)."""

    def __init__(self, tensors):
        self._src = list(tensors)
        self.done = None
        if self._src and self._src[0].device.type == "cuda":
            self._host = []
            for t in self._src:
                h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                h.copy_(t, non_blocking=True)
                self._host.append(h)
            self.done = torch.cuda.Event()
            self.done.record()
        else:
            self._host = self._src

    def wait(self) -> list[np.ndarray]:
        if self.done is not None:
            self.done.synchronize()
        return [h.numpy() for h in self._host]


def fetch_stream_bytes(data_dev: torch.Tensor, total: int, stream,
                       after) -> np.ndarray:
    """The first ``total`` bytes of the stream buffer, fetched as the
    power-of-two bucket that covers them (at most the whole buffer), on
    ``stream`` after the event ``after`` (see the module docstring)."""
    _faults.registry.perturb("readback.fetch")
    if total <= 0:
        return np.zeros((0,), np.uint8)
    n = int(data_dev.shape[-1])
    if data_dev.device.type == "cpu":
        return data_dev[..., :min(total, n)].numpy()
    return _to_host(data_dev[..., :min(bucket_for(total), n)], stream,
                    after)


def fetch_stripe_bytes(data_dev: torch.Tensor, start: int, length: int,
                       stream, after) -> np.ndarray:
    """``length`` bytes at ``start`` — the stripe-streaming fetch;
    byte-identical to the same range of a whole-prefix fetch; on
    ``stream`` after ``after``, as :func:`fetch_stream_bytes`."""
    _faults.registry.perturb("readback.fetch")
    if length <= 0:
        return np.zeros((0,), np.uint8)
    n = int(data_dev.shape[-1])
    start = max(0, int(start))
    length = min(int(length), n - start)
    return _to_host(data_dev[..., start:start + length], stream, after)
