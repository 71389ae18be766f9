"""Byte framing of the port against selkies_tpu/ops/stripes.py.

words_to_bytes_device (the H.264 zero-padded form) and
concat_stripe_bytes, including empty rows, rows longer than their word
capacity, and a total past ``out_cap`` (the overflow flag). Tolerance: 0
for bytes, lengths and flags.
"""

import numpy as np
import pytest
import torch

import jax

from selkies_tpu.ops import stripes as JS
from selkies_tpu_torch.ops import h264_planes as TP
from selkies_tpu_torch.ops import stripes as TS

torch.set_num_threads(1)


def _words(seed, s, wc):
    w = np.random.default_rng(seed).integers(0, 1 << 32, (s, wc),
                                             dtype=np.uint64)
    return w.astype(np.uint32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_words_to_bytes(seed):
    s, wc = 5, 7
    words = _words(seed, s, wc)
    bits = np.random.default_rng(seed + 9).integers(0, wc * 32 + 1, s)
    bits = bits.astype(np.int32)
    jb, jl = jax.jit(lambda w, b: JS.words_to_bytes_device(
        w, b, pad_ones=False))(words, bits)
    tb, tl = TS.words_to_bytes_device(
        torch.from_numpy(words.view(np.int32)), torch.from_numpy(bits))
    assert np.array_equal(tb.numpy(), np.asarray(jb))
    assert np.array_equal(tl.numpy(), np.asarray(jl))


CASES = {
    "fits": ([5, 0, 17, 3], 64),
    "empty_rows": ([0, 0, 9, 0], 32),
    "all_empty": ([0, 0, 0, 0], 16),
    "exact_cap": ([8, 8, 8, 8], 32),
    "overflow": ([20, 20, 20, 20], 50),
    "row_past_capacity": ([3, 40, 2, 1], 64),   # clipped to B - 1
}


@pytest.mark.parametrize("case", list(CASES))
def test_concat_stripe_bytes(case):
    lens, out_cap = CASES[case]
    s, b = len(lens), 24
    sb = np.random.default_rng(len(case)).integers(0, 256, (s, b),
                                                   dtype=np.uint8)
    lens = np.asarray(lens, np.int32)
    ref = jax.jit(JS.concat_stripe_bytes, static_argnums=2)(sb, lens,
                                                            out_cap)
    got = TS.concat_stripe_bytes(torch.from_numpy(sb),
                                 torch.from_numpy(lens), out_cap)
    assert np.array_equal(got.data.numpy(), np.asarray(ref.data))
    assert np.array_equal(got.byte_lens.numpy(), np.asarray(ref.byte_lens))
    assert bool(got.overflow) == bool(ref.overflow)
    assert bool(got.overflow) == (case == "overflow")


@pytest.mark.parametrize("out_cap", [4096, 40])
def test_pack_stream_buffer_and_flags(out_cap):
    """K4's plain version ends in these two functions: its byte buffer,
    lengths and out_cap flag are theirs on its own words."""
    R, M = 2, 3
    rng = np.random.default_rng(out_cap)
    ev_nb = rng.integers(0, 12, (R, M, TP.SB_I)).astype(np.uint8)
    ev_nb[rng.random(ev_nb.shape) < 0.9] = 0
    ev_pay = (rng.integers(0, 1 << 11, ev_nb.shape)
              & ((1 << ev_nb.astype(np.int64)) - 1)).astype(np.int32)
    hdr_pay = np.zeros((R, M, TP.HDR_SLOTS), np.int32)
    hdr_nb = np.zeros((R, M, TP.HDR_SLOTS), np.int32)
    hdr_pay[..., :3], hdr_nb[..., :3] = 1, 1
    st = TP.pack_stream(*(torch.from_numpy(a) for a in (
        hdr_pay, hdr_nb, ev_pay, ev_nb, np.ones((R, 2), np.int32),
        np.ones((R, 2), np.int32), np.zeros(R, np.int32),
        np.full(R, 26, np.int32))), True, 10 ** 6, 64, out_cap)
    sb, lens = TS.words_to_bytes_device(st.words, st.total_bits)
    buf = TS.concat_stripe_bytes(sb, lens, out_cap)
    assert torch.equal(st.data, buf.data)
    assert torch.equal(st.byte_lens, lens)
    assert st.flags.tolist() == [0, int(bool(buf.overflow))]
    assert bool(buf.overflow) == (out_cap == 40)
