"""Carry a session's state across implementations, as numpy arrays.

The system's counterpart of carrying weights across: a reference
(selkies_tpu) session's device state, read out as numpy arrays, loads
into a port session of the same codec, which then continues the same
streams byte for byte — and back. The keys are the reference session's
attribute names; each port session names its set in ``STATE_KEYS`` and
rebuilds its steps for the buffer caps it is handed
(``_rebuild_steps``). H.264: on the band path the host age mirror
``_host_age``, not the device ``_age``, is the authority between I
frames, so it is carried too. JPEG: ``prev``, ``age``, the caps and the
force-after-drop flag. The multi-seat encoders (parallel/) carry the
same arrays with a leading seat axis, and their force-after-drop flags
as a (seats,) host array.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

#: device arrays of the session (name -> dtype)
ARRAY_KEYS = {"_prev": torch.uint8, "_age": torch.int32,
              "_sent": torch.int32, "_fnum": torch.int32,
              "_ref_y": torch.uint8, "_ref_u": torch.uint8,
              "_ref_v": torch.uint8}
#: host arrays of the session (name -> dtype)
HOST_ARRAY_KEYS = {"_host_age": np.int64}
#: host scalars of the session
SCALAR_KEYS = ("qp", "paint_qp", "frame_id", "_w_cap", "_out_cap",
               "_cap_gen", "_force_after_drop")


class StateKeys(NamedTuple):
    arrays: dict        # device arrays (name -> dtype)
    host_arrays: dict   # host arrays (name -> dtype)
    scalars: tuple      # host scalars


H264_STATE = StateKeys(ARRAY_KEYS, HOST_ARRAY_KEYS, SCALAR_KEYS)
JPEG_STATE = StateKeys({"_prev": torch.uint8, "_age": torch.int32}, {},
                       ("frame_id", "_w_cap", "_out_cap", "_cap_gen",
                        "_force_after_drop"))
_SEAT_SCALARS = ("frame_id", "_w_cap", "_out_cap", "_cap_gen")
SEATS_JPEG_STATE = StateKeys({"_prev": torch.uint8, "_age": torch.int32},
                             {"_force_after_drop": np.bool_}, _SEAT_SCALARS)
SEATS_H264_STATE = StateKeys(ARRAY_KEYS, {"_force_after_drop": np.bool_},
                             ("qp", "paint_qp") + _SEAT_SCALARS)


def session_state_to_numpy(session) -> dict:
    """Every state array as numpy plus the host scalars."""
    keys = session.STATE_KEYS
    d = {k: getattr(session, k).cpu().numpy() for k in keys.arrays}
    d.update({k: getattr(session, k).copy() for k in keys.host_arrays})
    d.update({k: getattr(session, k) for k in keys.scalars})
    return d


def session_state_from_numpy(session, d: dict) -> None:
    """Load ``d`` (numpy arrays + scalars, e.g. a reference session's
    attributes) into ``session``'s preallocated device state, checking
    every shape; the buffer caps it carries rebuild the steps."""
    keys = session.STATE_KEYS
    for k, dtype in keys.arrays.items():
        dst = getattr(session, k)
        src = np.asarray(d[k])
        if tuple(src.shape) != tuple(dst.shape):
            raise ValueError(f"{k}: shape {src.shape}, session has "
                             f"{tuple(dst.shape)}")
        dst.copy_(torch.as_tensor(np.array(src)).to(dtype))
    for k, dtype in keys.host_arrays.items():
        # a state without the mirror kept its age on the device
        src = np.asarray(d.get(k, d["_age"]), dtype)
        if src.shape != getattr(session, k).shape:
            raise ValueError(f"{k}: shape {src.shape}, session has "
                             f"{getattr(session, k).shape}")
        setattr(session, k, src.copy())
    for k in keys.scalars:
        if k in d:
            v = d[k]
            setattr(session, k, bool(v) if k == "_force_after_drop"
                    else int(v))
    session._rebuild_steps()
