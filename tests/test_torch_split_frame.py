"""Split-frame H.264 of the port (``selkies_tpu_torch.parallel.stripes``)
on the CPU against the JAX package's ``selkies_tpu.parallel.stripes``,
which runs on the 8 virtual CPU devices that tests/conftest.py forces.
The port runs its shards on ``devices=["cpu"] * n``.

At the geometries and seeds of tests/test_stripes.py (64x48 frames):

- I frames at 2 and 4 shards, P frames with whole motion windows per
  shard (``stripe_rows=2``, 2 shards) and P frames whose window is the
  whole frame, so the scroll's best candidate reaches across the shard
  seam and resolves only through the halo rows (``stripe_rows=4``, 2 and
  4 shards; candidates ((0, 0), (3, 0), (-1, 0), (0, 1))). Row words,
  ``total_bits``, overflow and recon planes equal the reference's
  sharded functions, tolerance 0. Each JAX program is built once per
  module; the JAX I program at 2 shards stands for every shard count
  (the reference's own tests hold its counts equal).
- The halo pieces: ``halo_bands_plain`` against ``_halo_bands``, and
  ``motion_select_halo_plain`` (4:2:0 and 4:4:4) against
  ``_motion_select_halo`` called eagerly shard by shard.
- The mesh: the divide rule against the reference's, the degraded mesh
  (logged on ``selkies_tpu_torch.parallel.stripes`` and gauged), a mesh
  of distinct devices (raises, naming ROADMAP A11c), the card as the
  default device, and the ``ValueError`` surface.
"""

import logging
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from selkies_tpu.codecs import h264 as jcodec
from selkies_tpu.ops.h264_encode import P_SLOTS_MB, SLOTS_MB
from selkies_tpu.parallel import stripes as JST
from selkies_tpu_torch.parallel import stripes as ST
from selkies_tpu_torch.server import metrics

torch.set_num_threads(1)

H, W = 64, 48
R, M = H // 16, W // 16
E_CAP = 9 + M * max(SLOTS_MB, P_SLOTS_MB) + 2
W_CAP = 4096
HDR = jcodec.slice_header_events(M, R)
P_HDR = jcodec.p_slice_header_events(M, R)
CANDS = ((0, 0), (3, 0), (-1, 0), (0, 1))


@pytest.fixture(scope="module", autouse=True)
def no_threads_left_behind():
    start = threading.active_count()
    yield
    assert threading.active_count() == start


def _yuv420(rng, h, w):
    return (rng.integers(0, 256, (h, w)).astype(np.int32),
            rng.integers(0, 256, (h // 2, w // 2)).astype(np.int32),
            rng.integers(0, 256, (h // 2, w // 2)).astype(np.int32))


def _jmesh(n):
    return JST.stripe_mesh(R, devices=jax.devices()[:n])


def _mesh(n, rows=R):
    return ST.stripe_mesh(rows, devices=["cpu"] * n)


def _same_out(got, want):
    assert np.array_equal(got.words.numpy().view(np.uint32),
                          np.asarray(want.words))
    assert np.array_equal(got.total_bits.numpy(),
                          np.asarray(want.total_bits))
    assert bool(got.overflow) == bool(want.overflow)
    assert got.mb_rows == want.mb_rows


def _same_planes(got, want):
    for a, b in zip(got, want):
        assert np.array_equal(a.numpy(), np.asarray(b).astype(np.uint8))


@pytest.fixture(scope="module")
def i_ref():
    """The I fixture's frame (seed 11), I-encoded by the JAX package over
    2 shards."""
    y, u, v = _yuv420(np.random.default_rng(11), H, W)
    ref, rec = JST.h264_encode_sharded(
        jnp.asarray(y), jnp.asarray(u), jnp.asarray(v), 26, *HDR, E_CAP,
        W_CAP, _jmesh(2), want_recon=True)
    return (y, u, v), ref, rec


@pytest.mark.parametrize("ndev", [2, 4])
def test_i_frame_sharded_equals_reference(i_ref, ndev):
    planes, ref, rec = i_ref
    out, got_rec = ST.h264_encode_sharded(*planes, 26, *HDR, E_CAP, W_CAP,
                                          _mesh(ndev), want_recon=True)
    _same_out(out, ref)
    _same_planes(got_rec, rec)
    # without recon: the frame output alone
    _same_out(ST.h264_encode_sharded(*planes, 26, *HDR, E_CAP, W_CAP,
                                     _mesh(ndev)), ref)


@pytest.fixture(scope="module")
def p_case():
    """tests/test_stripes.py's P fixture: the I recon of a frame (seed 7;
    made by the port, which the I test holds to the reference) and the
    frame scrolled by 3 rows, which crosses the 2-shard seam of the 4-row
    frame."""
    y0, u0, v0 = _yuv420(np.random.default_rng(7), H, W)
    _, rec = ST.h264_encode_sharded(y0, u0, v0, 26, *HDR, E_CAP, W_CAP,
                                    _mesh(2), want_recon=True)
    return (np.roll(y0, 3, axis=0), np.roll(u0, 1, axis=0),
            np.roll(v0, 1, axis=0)), [p.numpy() for p in rec]


def _j_p(p_case, stripe_rows):
    cur, rec = p_case
    return JST.h264_encode_p_sharded(
        *(jnp.asarray(p) for p in cur), *rec, 26, *P_HDR, 1, E_CAP, W_CAP,
        _jmesh(2), candidates=CANDS, stripe_rows=stripe_rows)


def _p(p_case, ndev, stripe_rows, **kw):
    cur, rec = p_case
    return ST.h264_encode_p_sharded(*cur, *rec, 26, *P_HDR, 1, E_CAP, W_CAP,
                                    _mesh(ndev), candidates=CANDS,
                                    stripe_rows=stripe_rows, **kw)


def test_p_frame_sharded_aligned_equals_reference(p_case):
    """Whole motion windows per shard: K5 over the frame, no halo."""
    ref, ref_rec = _j_p(p_case, 2)
    out, rec = _p(p_case, 2, 2)
    _same_out(out, ref)
    _same_planes(rec, ref_rec)


@pytest.fixture(scope="module")
def halo_ref(p_case):
    return _j_p(p_case, 4)


@pytest.mark.parametrize("ndev", [2, 4])
def test_p_frame_sharded_halo_equals_reference(p_case, halo_ref, ndev):
    """The window is the whole frame, so every shard seam cuts it: the
    halo bands and the halo search give the reference's bytes."""
    ref, ref_rec = halo_ref
    out, rec = _p(p_case, ndev, 4)
    _same_out(out, ref)
    _same_planes(rec, ref_rec)
    # the scroll's vector was chosen across the seam: zero-MV costs more
    cur, prec = p_case
    no_mv, _ = ST.h264_encode_p_sharded(*cur, *prec, 26, *P_HDR, 1, E_CAP,
                                        W_CAP, _mesh(ndev))
    assert int(out.total_bits.sum()) < int(no_mv.total_bits.sum())


def test_reference_planes_are_not_updated(p_case):
    cur, rec = p_case
    before = [p.copy() for p in rec]
    _p(p_case, 2, 4)
    for a, b in zip(rec, before):
        assert np.array_equal(a, b)


# ---------------------------------------------------------------- halo units
@pytest.mark.parametrize("band,halo", [(16, 3), (32, 1), (16, 24), (8, 2)])
def test_halo_bands_plain_equals_reference(band, halo):
    plane = np.random.default_rng(band + halo).integers(
        0, 256, (64, 24)).astype(np.uint8)
    want = np.asarray(JST._halo_bands(jnp.asarray(plane).astype(jnp.int32),
                                      band, halo))
    got = ST.halo_bands_plain(torch.as_tensor(plane), band, halo)
    assert got.dtype == torch.uint8
    assert np.array_equal(got.numpy(), want)
    assert torch.equal(ST.halo_bands(torch.as_tensor(plane), band, halo),
                       got)


def _halo_search_case(full, seed):
    """A 64-row frame of 4 shards against a scrolled reference, with
    per-row QPs; candidates with odd and negative dy, and a whole-frame
    window next to 32-row windows."""
    rng = np.random.default_rng(seed)
    w = 32 if full else 48
    cw = w if full else w // 2
    ch = H if full else H // 2
    ref = [rng.integers(0, 256, s).astype(np.uint8)
           for s in ((H, w), (ch, cw), (ch, cw))]
    cur = np.roll(ref[0], -3, axis=0)
    cur[::7] = rng.integers(0, 256, (len(cur[::7]), w))
    qp = rng.integers(10, 45, R).astype(np.int32)
    return cur, ref, qp


@pytest.mark.parametrize("full", [False, True])
@pytest.mark.parametrize("win_rows", [4, 2])
def test_motion_select_halo_plain_equals_reference(full, win_rows):
    cands = ((0, 0), (3, 0), (-3, 0), (1, 0), (-2, 1), (0, -2), (2, 2))
    cur, ref, qp = _halo_search_case(full, 3 + win_rows)
    n, band, win = 4, 16, 16 * win_rows
    vmax = 3
    halo_y = vmax
    halo_c = vmax if full else vmax // 2 + 1
    cband = band if full else band // 2
    bands = [ST.halo_bands_plain(torch.as_tensor(ref[0]), band, halo_y)] + [
        ST.halo_bands_plain(torch.as_tensor(p), cband, halo_c)
        for p in ref[1:]]
    fn = ST.motion_select_halo444_plain if full \
        else ST.motion_select_halo_plain
    got = fn(torch.as_tensor(cur), *bands, torch.as_tensor(qp), cands, win)
    # the reference, eagerly, one shard at a time
    jb = [JST._halo_bands(jnp.asarray(ref[0]).astype(jnp.int32), band,
                          halo_y)] + [
        JST._halo_bands(jnp.asarray(p).astype(jnp.int32), cband, halo_c)
        for p in ref[1:]]
    want = [[], [], [], []]
    for s in range(n):
        outs = JST._motion_select_halo(
            jnp.asarray(cur[s * band:(s + 1) * band]).astype(jnp.int32),
            jb[0][s], jb[1][s], jb[2][s], jnp.asarray(qp[s:s + 1]), cands,
            win, s * band, halo_y, halo_c, full)
        for k, o in enumerate(outs):
            want[k].append(np.asarray(o))
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.concatenate(w).astype(
            g.numpy().dtype))
    # and the wrapper on CPU tensors is the plain version
    wrap = ST.motion_select_halo444 if full else ST.motion_select_halo
    for a, b in zip(wrap(torch.as_tensor(cur), *bands, torch.as_tensor(qp),
                         cands, win), got):
        assert torch.equal(a, b)


def test_motion_select_halo_rejects_a_short_halo():
    cur, ref, qp = _halo_search_case(False, 1)
    bands = [ST.halo_bands_plain(torch.as_tensor(ref[0]), 16, 2)] + [
        ST.halo_bands_plain(torch.as_tensor(p), 8, 2) for p in ref[1:]]
    with pytest.raises(ValueError, match="halo"):
        ST.motion_select_halo(torch.as_tensor(cur), *bands,
                              torch.as_tensor(qp), ((0, 0), (3, 0)), 64)


# ------------------------------------------------------------------ the mesh
@pytest.mark.parametrize("n_rows", [1, 4, 5, 6, 8, 68, 135])
@pytest.mark.parametrize("requested,n_avail", [(1, 8), (2, 8), (4, 8),
                                               (4, 2), (8, 8), (64, 3)])
def test_resolved_stripe_devices_keeps_the_divide_rule(n_rows, requested,
                                                       n_avail):
    assert ST.resolved_stripe_devices(n_rows, requested, n_avail) \
        == JST.resolved_stripe_devices(n_rows, requested, n_avail)


def test_stripe_mesh_degrades_loudly(caplog):
    with caplog.at_level(logging.WARNING,
                         logger="selkies_tpu_torch.parallel.stripes"):
        mesh = ST.stripe_mesh(5, devices=["cpu"] * 8, requested=4)
    assert mesh.devices.size == 1 \
        == JST.stripe_mesh(5, requested=4).devices.size
    assert any("degraded" in r.message for r in caplog.records)
    # the chosen count is a gauge, never only a log line
    assert metrics._gauges.get(("selkies_stripe_devices", ())) == 1.0
    assert ST.stripe_mesh(8, devices=["cpu"] * 8, requested=4) \
        .devices.size == 4
    assert metrics._gauges.get(("selkies_stripe_devices", ())) == 4.0


def test_distinct_devices_raise():
    mesh = ST.stripe_mesh(R, devices=["cpu", "meta"])
    assert mesh.devices.size == 2
    y, u, v = _yuv420(np.random.default_rng(0), H, W)
    with pytest.raises(NotImplementedError, match="A11c"):
        ST.h264_encode_sharded(y, u, v, 26, *HDR, E_CAP, W_CAP, mesh)


def test_the_card_is_the_default_device():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default resolves to it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ST.stripe_mesh(R)


def test_sharded_geometry_value_errors():
    rng = np.random.default_rng(0)
    mesh = _mesh(2)
    y = rng.integers(0, 256, (40, 48)).astype(np.int32)
    u = rng.integers(0, 256, (20, 24)).astype(np.int32)
    with pytest.raises(ValueError, match="macroblock"):
        ST.h264_encode_sharded(y, u, u, 26, np.zeros((2, 2)),
                               np.zeros((2, 2)), 64, 64, mesh)
    y4, u4, v4 = _yuv420(rng, 64, 48)
    bad_hdr = np.zeros((2, 2), np.uint32)      # 4 rows need 4 header rows
    with pytest.raises(ValueError, match="header"):
        ST.h264_encode_sharded(y4, u4, v4, 26, bad_hdr, bad_hdr, 64, 64,
                               mesh)
    y1, u1, v1 = _yuv420(rng, 16, 16)
    with pytest.raises(ValueError, match="more shards than rows"):
        ST.h264_encode_sharded(y1, u1, v1, 26, np.zeros((1, 2)),
                               np.zeros((1, 2)), 64, 64, mesh)
    with pytest.raises(ValueError, match="does not tile"):
        ST.h264_encode_p_sharded(y4, u4, v4, y4, u4, v4, 26, *P_HDR, 1,
                                 E_CAP, W_CAP, mesh, candidates=CANDS,
                                 stripe_rows=3)
    # 3 rows over 2 shards with a window spanning them: no pad geometry
    y3, u3, v3 = _yuv420(rng, 48, 48)
    p3 = jcodec.p_slice_header_events(M, 3)
    with pytest.raises(ValueError, match="no pad geometry"):
        ST.h264_encode_p_sharded(y3, u3, v3, y3, u3, v3, 26, *p3, 1, E_CAP,
                                 W_CAP, ST.stripe_mesh(4, ["cpu"] * 2),
                                 candidates=CANDS, stripe_rows=3)
    with pytest.raises(ValueError, match="mesh"):
        ST.h264_encode_sharded(y4, u4, v4, 26, *HDR, E_CAP, W_CAP, mesh,
                               device="meta")
