"""Per-frame span tracing with latency attribution.

A copy of selkies_tpu/trace (its :mod:`.core`; the exporter, summarizer
and CLI are not ported yet). The capture loop and both encoder sessions
record their stages on :data:`tracer`: a dependency-free, low-overhead
span tracer whose spans are correlated by frame id across the capture
and finalizer threads, kept in a fixed-size ring of frame timelines, and
near free when disabled.

Stage names used across the repo: ``capture``, ``convert``,
``encode.dispatch``, ``encode.readback``, ``packetize``, ``fanout``,
``ws.send`` — plus the ``ack`` instant.
"""

from .core import FrameTracer, FrameTimeline, tracer  # noqa: F401

#: the stage-name contract
STAGES = ("capture", "convert", "encode.dispatch", "encode.readback",
          "packetize", "fanout", "ws.send")
