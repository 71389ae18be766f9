"""The port's CUDA kernels against their plain PyTorch versions.

Needs a CUDA card (marker ``cuda``; skipped elsewhere, decided inside the
fixture). Run on the card with ``python -m pytest tests/test_torch_cuda.py
-m cuda``. Each kernel gets the same inputs as its plain version at small
geometries (one and several stripes, per-row qp, half the stripes sent)
and must match it exactly, overflow flags included. Tolerance: 0.
"""

import numpy as np
import pytest
import torch

from selkies_tpu_torch.codecs import h264 as hcodec
from selkies_tpu_torch.ops import h264_planes as HP

pytestmark = pytest.mark.cuda

torch.set_num_threads(1)

GEOMS = [(64, 80, 32), (48, 96, 16), (32, 32, 32)]


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _same(ks, ps):
    for k, p in zip(ks, ps):
        assert k.shape == p.shape and k.dtype == p.dtype
        assert torch.equal(k.cpu(), p.cpu())


def _frames(dev, H, W):
    rng = np.random.default_rng(H * W)
    f0 = torch.as_tensor(rng.integers(0, 256, (H, W, 3), dtype=np.uint8),
                         device=dev)
    f1 = f0.clone()
    f1[:16, :32] = 255 - f1[:16, :32]
    return f0, f1


def _stage(dev, H, W, sh):
    """K1..K2 outputs of a geometry (through the plain versions)."""
    S, rps, R = H // sh, sh // 16, H // 16
    f0, f1 = _frames(dev, H, W)
    y, u, v, _ = HP.csc420_damage_plain(f1, f0.clone(), S)
    qp = torch.full((R,), 26, dtype=torch.int32, device=dev)
    qp[::2] = 44
    send = torch.ones((S,), dtype=torch.int32, device=dev)
    send[1::2] = 0
    ref = [torch.zeros_like(p) for p in (y, u, v)]
    i_out = HP.mb_encode_i_plain(y, u, v, qp, send, rps, *ref)
    return S, rps, (y, u, v), qp, send, ref, i_out


@pytest.mark.parametrize("geom", GEOMS)
def test_csc420_damage(dev, geom):
    H, W, sh = geom
    f0, f1 = _frames(dev, H, W)
    pk, pp = f0.clone(), f0.clone()
    _same(list(HP.csc420_damage(f1, pk, H // sh)) + [pk],
          list(HP.csc420_damage_plain(f1, pp, H // sh)) + [pp])


@pytest.mark.parametrize("geom", GEOMS)
@pytest.mark.parametrize("mode", ["i", "p0"])
def test_mb_encode(dev, geom, mode):
    S, rps, planes, qp, send, ref, _ = _stage(dev, *geom)
    if mode == "p0":
        base = [p.clone() for p in ref]
        planes = tuple(255 - p for p in planes)
    else:
        base = [torch.zeros_like(p) for p in planes]
    kref = [b.clone() for b in base]
    pref = [b.clone() for b in base]
    kern = getattr(HP, f"mb_encode_{mode}")
    plain = getattr(HP, f"mb_encode_{mode}_plain")
    _same(list(kern(*planes, qp, send, rps, *kref)) + kref,
          list(plain(*planes, qp, send, rps, *pref)) + pref)


@pytest.mark.parametrize("geom", GEOMS)
def test_cavlc_and_pack(dev, geom):
    H, W, sh = geom
    S, rps, planes, qp, send, ref, (lv, cbp, hp, hn) = _stage(dev, *geom)
    R, M = H // 16, W // 16
    ev = HP.cavlc_events(lv, cbp, True)
    _same(ev, HP.cavlc_events_plain(lv, cbp, True))
    pay, nb = hcodec.slice_header_events(M, rps)
    rhp = torch.as_tensor(np.tile(pay.astype(np.int32), (S, 1)), device=dev)
    rhn = torch.as_tensor(np.tile(nb, (S, 1)), device=dev)
    rid = torch.arange(R, dtype=torch.int32, device=dev)
    for w_cap, out_cap in ((2048, 1 << 16), (16, 1 << 16), (2048, 64)):
        args = (hp, hn, *ev, rhp, rhn, rid, qp, True, 10 ** 6, w_cap,
                out_cap)
        _same(HP.pack_stream(*args), HP.pack_stream_plain(*args))


@pytest.mark.parametrize("seed", range(4))
def test_chain_on_noise_at_random_qp(dev, seed):
    """Noise frames at per-row qp drawn from 0..51 (level escapes, large
    nC, long runs), I then P: every stage's kernel output equals the
    plain version's on the same inputs."""
    H, W, sh = 64, 96, 32
    S, rps, R, M = H // sh, sh // 16, H // 16, W // 16
    rng = np.random.default_rng(100 + seed)
    f0, f1 = (torch.as_tensor(rng.integers(0, 256, (H, W, 3),
                                           dtype=np.uint8), device=dev)
              for _ in range(2))
    qp = torch.as_tensor(rng.integers(0, 52, R).astype(np.int32), device=dev)
    send = torch.ones((S,), dtype=torch.int32, device=dev)
    ref = [torch.zeros((H, W), dtype=torch.uint8, device=dev)] + [
        torch.zeros((H // 2, W // 2), dtype=torch.uint8, device=dev)
        for _ in range(2)]
    for intra, frame in ((True, f0), (False, f1)):
        planes = HP.csc420_damage_plain(frame, f0.clone(), S)[:3]
        kref = [r.clone() for r in ref]
        kern = HP.mb_encode_i if intra else HP.mb_encode_p0
        plain = HP.mb_encode_i_plain if intra else HP.mb_encode_p0_plain
        ko = kern(*planes, qp, send, rps, *kref)
        _same(list(ko) + kref, list(plain(*planes, qp, send, rps, *ref))
              + ref)
        lv, cbp, hp, hn = ko
        ev = HP.cavlc_events(lv, cbp, intra)
        _same(ev, HP.cavlc_events_plain(lv, cbp, intra))
        fn = hcodec.slice_header_events if intra \
            else hcodec.p_slice_header_events
        pay, nb = fn(M, rps)
        args = (hp, hn, *ev,
                torch.as_tensor(np.tile(pay.astype(np.int32), (S, 1)),
                                device=dev),
                torch.as_tensor(np.tile(nb, (S, 1)), device=dev),
                torch.arange(R, dtype=torch.int32, device=dev), qp, intra,
                10 ** 6, 4096, 1 << 17)
        _same(HP.pack_stream(*args), HP.pack_stream_plain(*args))


def test_frame_entry_points_run_on_the_card(dev):
    """With numpy input and no device, h264_encode_yuv and
    h264_encode_p_yuv run on the card, equal to the plain CPU run."""
    H, W = 64, 80
    R, M = H // 16, W // 16
    rng = np.random.default_rng(11)
    y = rng.integers(0, 256, (H, W)).astype(np.int32)
    u, v = (rng.integers(0, 256, (H // 2, W // 2)).astype(np.int32)
            for _ in range(2))
    qp = np.array([8, 30, 51, 19], np.int32)
    e_cap, w_cap = 9 + M * 879 + 2, 2048
    hdr = hcodec.slice_header_events(M, R)
    p_hdr = hcodec.p_slice_header_events(M, R)
    outs = {}
    for d in (None, "cpu"):
        i_out, rec = HP.h264_encode_yuv(y, u, v, qp, *hdr, e_cap, w_cap,
                                        want_recon=True, device=d)
        p_out, _ = HP.h264_encode_p_yuv(255 - y, u, v, *rec, qp, *p_hdr,
                                        np.ones(R, np.int32), e_cap, w_cap,
                                        device=d)
        outs[d] = (i_out, p_out)
    assert outs[None][0].words.device.type == "cuda"
    for k, p in zip(outs[None], outs["cpu"]):
        _same([k.words, k.total_bits], [p.words, p.total_bits])
        assert bool(k.overflow) == bool(p.overflow)
