"""The port's CUDA kernels against their plain PyTorch versions.

Needs a CUDA card (marker ``cuda``; skipped elsewhere, decided inside the
fixture). Run on the card with ``python -m pytest tests/test_torch_cuda.py
-m cuda``. Each kernel gets the same inputs as its plain version at small
geometries (one and several stripes, per-row qp, half the stripes sent,
scrolled and panned content for the motion search, neighbouring
macroblocks with different vectors, an unaligned probe input; for the
JPEG kernels 4:2:0 and 4:4:4, per-stripe tables at qualities 10 to 100
and tables of 1/16 that expose one ulp of a coefficient, values past the
category caps, and word and byte buffers too small; for the H.264 4:4:4
kernels K13-K16 and K5's 4:4:4 entry the same cases, the CSC over all
2^24 byte triples and the fullcolor session; for the seat entries of K4,
K9 and K10 one to four seats, one of whose rows overflows and spills,
and both multi-seat encoders through a one-seat overflow; for ROI QP's
K17 and K18 and K2-P's per-MB-QP entry random frames and planes at
1080p with QPs 0..51, an unaligned K17 input and the ROI session; for
split-frame K4's seat entry at 4:4:4's slot counts, K20 at widths that
are not multiples of 16 with halos past both frame edges, K19 at 4:2:0
and 4:4:4 with windows across the shard seams and odd negative vertical
candidates (equal to K5 on the whole frame as well), the sharded frame
entries and the sharded session at 4 shards; for K3 and K4 the edge
frame (45 MBs a row, an all-skip P row, a row coded in its last MB only,
a row ending on a word boundary) and each of its rows as a 1-row band,
bands of 1, 2, 4 and 5 rows at 45 and 63 MBs a row (as views, their nb
rows off 16-byte boundaries), 28-bit escapes at QP 0 on noise past K4's
shared words, e_cap overflow alone, spills into the next row and off a
seat's end at 1, 3 and 8 seats, out_cap at the total and one byte less,
4:4:4 through both K4 entries with K16, and a 1080p frame; for K16
rows of 1, 45 and 63 MBs, so a block of 4 MBs spans a row start, 28-bit
escapes at QP 0, P rows with every 8x8 group gated off and each group
bit alone, bands of 1, 2, 4 and 5 rows as views and a misaligned level
array, which is refused; for K5 and K19, all four entries, rows of 45
and 63 MBs at 4 and 2 MBs a block, row groups of 4 and 5 MB rows, W =
16, 16- and 64-row windows, 1, 57
and 128 candidates with |dy| and |dx| up to 64, a flat frame where the
lambda and then the lowest index decide, an exact tie between (3, 0) and
(-3, 0), per-row qp at 0, 51 and out of range, and a misaligned plane,
which is refused; for K2-P 13 MBs a row (odd, so chroma rows start off
16-byte boundaries, and not a multiple of its 4 MBs a block), bands as
views from a stripe boundary, send gates that cut across the stripes,
the prediction aliasing the reference and separate prediction planes
with vectors, planes 4 and 1 bytes into their storage, and per-MB QPs
0 and 51 inside one block; for K10 widths whose rows are not multiples
of 16 bytes at H <= 96, rows that are, and 3 seats of an odd frame; for
K9 made-up slot events: dense stripes on the largest cluster, their
blocks' words past their shared buffers (one with nbits too large for
shared memory), 300 stripes on one block each,
64 stripes of 2880 scan blocks on clusters that stream their payloads
through two buffers, a stripe with no bits, totals that end on a byte
and off one, out_caps at the total, one byte under and not multiples of
16, a noise frame at quality 100 at 4:2:0 and 4:4:4, a payload off 16
bytes, which is refused, and its seat entry at 8 seats; for K15 13 MBs a row, bands as views from a stripe
boundary, send gates across the stripes, zero motion and vectors, and
QPs 0 and 51 at 6 and 13 MBs a row; for K1 even widths off its vector
path (W = 54, 90, 18, 2), 4- and 16-row band views at a stripe boundary,
idle frames, one differing byte at the first and the last byte of each
stripe and of a 16-byte piece, stripes of two rows and stripes over many
blocks (the whole 1080p frame as one), and 4 stacked seats; for K7 W =
40 at 4:4:4 and 1920-wide frames of a few MCU rows at both
subsamplings, widths whose last block of MCUs is partial, per-stripe
tables with the ulp tables of 1/16, 4 stacked seats, a frame 8 bytes
into its storage (taken) and one 4 bytes in (refused), and its hoisted
divide against __fdiv_rn over every mantissa of the dividend; for K2-I
qp 0 and 51 and a different qp on every row on all-0, all-255, noise and
black-and-white planes (DC levels at LEVEL_CLAMP, edges clipped), 1, 5,
6, 13, 120 and 125 MBs a row, 1 to 4 MB rows, send gates all on, all
off and mixed (the unsent rows of a noise reference checked untouched),
planes and references 1, 4 and 8 bytes into their storage, and 1 and 4
stacked 1080p frames; for K6 bands of 1, 68 MB rows, 17 stripes, 4
stacked seats' 68 stripes and 135 MB rows at 3840x2160, rows off 16
bytes, frames 1 and 3 bytes into their storage, idle and fully damaged
frames, one differing byte at each band's first and last byte and on
both sides of a 16-byte piece boundary, and launches alternating over
two streams; for K8 scan blocks a stripe that are not multiples of its
tile (6, 30, 132, 1176), the 1080p stripe's 2880 at 1 and 68 stripes,
5760 at 4:4:4, made-up maps whose predecessors point ahead, far back,
past M and outside any tile, with gathers out of range, and maps with
-1 in mid-stripe, all-zero blocks, blocks with every slot nonzero, runs
of exactly 16, 32 and 48 zeros with and without a later nonzero, values
past the category caps, and planes 2 and 8 bytes into their storage;
for K11 frame rows that are not multiples of 16 bytes (1366 into 1376),
no padding at all, h = 1, grids of a byte count off 16, 2160p, sources
0, 1, 4 and 8 bytes into their storage and grids 1 and 4 bytes into
theirs; for K14 K2-I's cases at 4:4:4 (qp 0, 51 and mixed by row on
all-0, all-255, noise and black-and-white planes, M = 1, 5, 8, 13, 120
and 125, R = 1 to 4, send gates all on, all off and mixed with unsent
noise reference rows untouched, planes 1, 4 and 8 bytes into their
storage, 1 and 4 stacked 1080p frames); for K13 idle, fully damaged and
one-stripe-in-three frames at 17 and 68 stripes of the 1080p grid and at
W = 90 and 7, frames 1 and 4 bytes into their storage, one differing
byte at each stripe's first and last byte and at a 16-byte piece's
edges, widths off 16 pixels, band views of 4 and 16 MB rows as 1 and 4
stripes, and launches alternating over two streams; for K12 the 1080p
and 1366x768 watermarks, odd widths whose rows start at every byte of a
word, frames 1-3 bytes into their storage, an RGBA 4 bytes into its,
and all 2^24 (region, R, A) byte triples; for K17 whole frames, 20-, 16-,
4- and 1-row bands (each segment size the host picks), rows ending in a
short segment, idle, fully dirty and one-byte-an-MB frames, and frame
and prev views off 16 bytes) and must match it exactly, overflow flags
included.
Tolerance: 0.
"""

import numpy as np
import pytest
import torch

from selkies_tpu_torch.codecs import h264 as hcodec
from selkies_tpu_torch.codecs import jpeg as jtab
from selkies_tpu_torch.ops import h264_encode as TE
from selkies_tpu_torch.ops import h264_planes as HP
from selkies_tpu_torch.ops import h264_planes444 as H4
from selkies_tpu_torch.ops import jpeg_entropy as JE
from selkies_tpu_torch.ops import jpeg_pipeline as JPP
from selkies_tpu_torch.ops import jpeg_planes as JPL

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


def _k1_same(frame, prev, S):
    """K1 against its plain version on copies of ``prev`` (tolerance 0,
    prev included) -> the kernel's flags."""
    pk, pp = prev.clone(), prev.clone()
    ko = HP.csc420_damage(frame, pk, S)
    _same(list(ko) + [pk], list(HP.csc420_damage_plain(frame, pp, S)) + [pp])
    assert torch.equal(pk, frame)
    return ko[3].cpu().tolist()


@pytest.mark.parametrize("W", [54, 90, 18, 2])
def test_csc420_damage_off_the_vector_path(dev, W):
    """Even widths whose rows are not whole 16-byte pieces (the byte
    instantiation), a unit cut at the row's end."""
    f0, f1 = _frames(dev, 32, W)
    f1[17, W - 1, 2] ^= 1
    assert _k1_same(f1, f0, 4) == [1, 1, 1, 0]


@pytest.mark.parametrize("rows", [4, 16])
def test_csc420_damage_on_band_views(dev, rows):
    """Views of rows at a stripe boundary, one stripe, as the band step
    hands them over; the rest of prev is untouched."""
    H, W, y0 = 512, 208, 64
    f0, f1 = _frames(dev, H, W)
    f1 = torch.roll(f1, 3, 0)
    bh = 16 * rows
    pk, pp = f0.clone(), f0.clone()
    band = f1.narrow(0, y0, bh)
    ko = HP.csc420_damage(band, pk.narrow(0, y0, bh), 1)
    po = HP.csc420_damage_plain(band, pp.narrow(0, y0, bh), 1)
    _same(list(ko) + [pk], list(po) + [pp])
    assert ko[3].tolist() == [1]
    assert torch.equal(pk[:y0], f0[:y0]) and torch.equal(pk[y0 + bh:],
                                                         f0[y0 + bh:])


@pytest.mark.parametrize("W", [208, 54])
def test_csc420_damage_on_an_idle_frame(dev, W):
    f0, _ = _frames(dev, 64, W)
    prev = f0.clone()
    ko = HP.csc420_damage(f0, prev, 4)
    assert ko[3].tolist() == [0, 0, 0, 0]
    assert torch.equal(prev, f0)
    _k1_same(f0, f0, 4)


@pytest.mark.parametrize("W", [1920, 208, 90])
def test_csc420_damage_one_byte_at_stripe_and_piece_edges(dev, W):
    """One differing byte at the first and the last byte of each stripe,
    and at the first and last byte of a 16-byte piece inside one: only
    that stripe is flagged."""
    H, sh = 64, 16
    S = H // sh
    f0, _ = _frames(dev, H, W)
    stripe = sh * W * 3
    spots = []
    for s in range(S):
        spots += [s * stripe, (s + 1) * stripe - 1]
    spots += [stripe + 16 * 37, stripe + 16 * 37 + 15, 2 * stripe + 16 * 5 - 1]
    for at in spots:
        f1 = f0.clone()
        f1.view(-1)[at] ^= 0x80
        want = [int(s == at // stripe) for s in range(S)]
        assert _k1_same(f1, f0, S) == want, at


@pytest.mark.parametrize("geom", [(64, 208, 2), (32, 1920, 2), (1088, 1920,
                                                                 1088),
                                  (256, 1920, 256), (128, 96, 128)])
def test_csc420_damage_short_and_tall_stripes(dev, geom):
    """Many short stripes (2 rows: one block each), and stripes over
    many blocks (up to the whole 1080p frame as one stripe, as the band
    step hands it over), each flag right."""
    H, W, sh = geom
    S = H // sh
    f0, _ = _frames(dev, H, W)
    f1 = f0.clone()
    dirty = list(range(0, S, 3))
    for s in dirty:
        f1[s * sh + sh - 1, W // 2, 1] ^= 0x40
    assert _k1_same(f1, f0, S) == [int(s in dirty) for s in range(S)]


def test_csc420_damage_on_stacked_seats(dev):
    """The seat step's frame: 4 seats stacked, 4 stripes each, seats
    damaged differently (one idle)."""
    n, H, W, sh = 4, 64, 208, 16
    f0, f1 = _frames(dev, n * H, W)
    f1[H:2 * H] = f0[H:2 * H]
    f1[3 * H + 40, 7] = 0
    f0[3 * H + 40, 7] = 1
    flags = _k1_same(f1, f0, n * H // sh)
    assert flags[4:8] == [0, 0, 0, 0] and flags[14] == 1


def test_csc420_damage_on_two_streams(dev):
    """Launches alternating between two streams (the stripes' tickets are
    shared module state, so the second waits for the first): every
    launch's flags and planes equal the plain version's."""
    H, W, sh = 128, 208, 16
    S = H // sh
    frames = [_frames(dev, H, W) for _ in range(2)]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    outs = []
    for k in range(8):
        f0, f1 = frames[k % 2]
        f1 = f1.clone()
        f1[sh * (k % S)] ^= 1
        prev = f0.clone()
        streams[k % 2].wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(streams[k % 2]):
            outs.append((f1, f0, prev, HP.csc420_damage(f1, prev, S)))
    torch.cuda.synchronize()
    for f1, f0, prev, ko in outs:
        pp = f0.clone()
        _same(list(ko) + [prev],
              list(HP.csc420_damage_plain(f1, pp, S)) + [pp])


def _p_call(p_fn, planes, qp, send, rps, ref, cands, send_rows=None,
            rows=None):
    """K2-P (kernel or plain) with the prediction of K5 (zero motion: the
    reference planes themselves, updated in place). ``send_rows``
    overrides the stripes' gate row by row; ``rows`` (a slice of MB rows)
    codes that band only, every plane, the prediction and the reference
    handed over as views, as the band step does."""
    if send_rows is None:
        send_rows = send.repeat_interleave(rps)
    if cands is None:
        pred, mv = ref, None
    else:
        *pred, mv = TE.motion_select_plain(planes[0], *ref, qp, cands,
                                           16 * rps)
    if rows is not None:
        def band(ts):
            return [t[16 * rows.start // c:16 * rows.stop // c]
                    for t, c in zip(ts, (1, 2, 2))]
        planes, pred, ref = band(planes), band(pred), band(ref)
        qp, send_rows = qp[rows], send_rows[rows]
        mv = None if mv is None else mv[rows]
    return p_fn(*planes, qp, send_rows, *pred, mv, *ref)


#: K2-P also at 13 MBs a row: odd (chroma rows off 16-byte boundaries)
#: and not a multiple of the 4 MBs a block takes; and at 8, a multiple,
#: which takes its kernel for whole blocks on 16-byte boundaries
P_GEOMS = GEOMS + [(64, 208, 32), (64, 128, 32)]


@pytest.mark.parametrize("geom", P_GEOMS)
@pytest.mark.parametrize("mode", ["i", "p0", "p", "p0_rows", "p_rows",
                                  "p0_band", "p_band"])
def test_mb_encode(dev, geom, mode):
    """K2 against plain: I, P with zero motion (the prediction is the
    reference, rewritten in place) and with K5's prediction; ``_rows``
    sends MB rows in a pattern that cuts across the stripes, ``_band``
    codes the MB rows of the second stripe on (views from a stripe
    boundary)."""
    S, rps, planes, qp, send, ref, _ = _stage(dev, *geom)
    if mode == "i":
        base = [torch.zeros_like(p) for p in planes]
    else:
        base = [p.clone() for p in ref]
        planes = tuple(255 - p for p in planes) if mode.startswith("p0") \
            else tuple(torch.roll(p, (-2, 1), (0, 1)) for p in planes)
    kref = [b.clone() for b in base]
    pref = [b.clone() for b in base]
    if mode == "i":
        ko = HP.mb_encode_i(*planes, qp, send, rps, *kref)
        po = HP.mb_encode_i_plain(*planes, qp, send, rps, *pref)
    else:
        cands = None if mode.startswith("p0") else TE.scroll_candidates(4, 2)
        R = geom[0] // 16
        kw = {}
        if mode.endswith("_rows"):
            kw["send_rows"] = torch.tensor([1, 0, 0, 1, 1, 0][:R] * 2,
                                           dtype=torch.int32,
                                           device=dev)[:R]
        if mode.endswith("_band"):
            kw["rows"] = slice(rps if S > 1 else 0, R)
        ko = _p_call(HP.mb_encode_p, planes, qp, send, rps, kref, cands,
                     **kw)
        po = _p_call(HP.mb_encode_p_plain, planes, qp, send, rps, pref,
                     cands, **kw)
    _same(list(ko) + kref, list(po) + pref)


@pytest.mark.parametrize("offset", [4, 1])
@pytest.mark.parametrize("motion", [False, True])
def test_mb_encode_p_on_unaligned_planes(dev, offset, motion):
    """K2-P on planes that start ``offset`` bytes into their storage (a
    4-byte and a byte-aligned view: the block's narrower staging pieces),
    at 13 MBs a row, equal to plain."""
    H, W, sh = 64, 208, 32
    S, rps, planes, qp, send, ref, _ = _stage(dev, H, W, sh)

    def shifted(t):
        buf = torch.zeros(t.numel() + 16, dtype=torch.uint8, device=dev)
        v = buf[offset:offset + t.numel()].view(t.shape)
        v.copy_(t)
        return v
    cur = [shifted(torch.roll(p, (-2, 1), (0, 1))) for p in planes]
    cands = TE.scroll_candidates(4, 2) if motion else None
    outs = []
    for fn in (HP.mb_encode_p, HP.mb_encode_p_plain):
        r = [shifted(p) for p in ref]
        outs.append(list(_p_call(fn, cur, qp, send, rps, r, cands)) + r)
    _same(outs[0], outs[1])


@pytest.mark.parametrize("geom", GEOMS)
@pytest.mark.parametrize("cands", ["small", "default"])
def test_motion_select(dev, geom, cands):
    """K5 against its plain version: a scrolled and a panned half, per-row
    qp, windows of one stripe (clamping at both window edges and the
    right picture edge)."""
    H, W, sh = geom
    cands = TE.scroll_candidates(4, 2) if cands == "small" \
        else TE.scroll_candidates()
    S, rps, planes, qp, send, ref, _ = _stage(dev, *geom)
    ref = [p.clone() for p in planes]
    cur = torch.roll(planes[0], -3, 0)
    cur[:, W // 2:] = torch.roll(planes[0], -2, 1)[:, W // 2:]
    _same(TE.motion_select(cur, *ref, qp, cands, sh),
          TE.motion_select_plain(cur, *ref, qp, cands, sh))


def test_motion_then_p_coder_with_neighbouring_vectors(dev):
    """Neighbouring macroblocks with different non-zero vectors: K5 then
    K2-P rewriting the reference in place equal the plain versions, in
    levels, headers and the reference planes after the frame."""
    H, W, sh = 64, 128, 32
    rng = np.random.default_rng(3)
    y = torch.as_tensor(rng.integers(0, 256, (H, W), dtype=np.uint8),
                        device=dev)
    u, v = (torch.as_tensor(rng.integers(0, 256, (H // 2, W // 2),
                                         dtype=np.uint8), device=dev)
            for _ in range(2))
    cur = torch.roll(y, -3, 0)
    cur[:, 32:64] = torch.roll(y, -2, 1)[:, 32:64]
    cur[:, 64:96] = torch.roll(y, 4, 0)[:, 64:96]
    qp = torch.full((H // 16,), 28, dtype=torch.int32, device=dev)
    send = torch.ones((H // 16,), dtype=torch.int32, device=dev)
    cands = TE.scroll_candidates(4, 2)
    outs = []
    for sel, p_fn in ((TE.motion_select, HP.mb_encode_p),
                      (TE.motion_select_plain, HP.mb_encode_p_plain)):
        ref = [y.clone(), u.clone(), v.clone()]
        *pred, mv = sel(cur, *ref, qp, cands, sh)
        outs.append(list(p_fn(cur, u, v, qp, send, *pred, mv, *ref))
                    + [mv] + ref)
    mv = outs[1][4]
    assert ((mv[:, 1:] != mv[:, :-1]).any(-1)
            & (mv[:, 1:] != 0).any(-1) & (mv[:, :-1] != 0).any(-1)).any()
    _same(outs[0], outs[1])


@pytest.mark.parametrize("geom", GEOMS)
def test_row_damage_probe(dev, geom):
    H, W, sh = geom
    f0, f1 = _frames(dev, H, W)
    for frame in (f0, f1, 255 - f0):
        _same([HP.row_damage_probe(frame, f0)],
              [HP.row_damage_probe_plain(frame, f0)])
    # a view 3 bytes into the frame takes the kernel's unaligned path
    a = f0.reshape(-1)[3:3 + H * W * 3 - 48 * W].reshape(H - 16, W, 3)
    b = f1.reshape(-1)[3:3 + H * W * 3 - 48 * W].reshape(H - 16, W, 3)
    _same([HP.row_damage_probe(a, b)], [HP.row_damage_probe_plain(a, b)])


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
@pytest.mark.parametrize("W", [96, 208])
def test_chain_on_noise_at_random_qp(dev, seed, W):
    """Noise frames at per-row qp drawn from 0..51 (level escapes, large
    nC, long runs), I then P: every stage's kernel output equals the
    plain version's on the same inputs; also at 13 MBs a row (odd, not a
    multiple of K2-P's 4 MBs a block)."""
    H, sh = 64, 32
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
        if intra:
            ko = HP.mb_encode_i(*planes, qp, send, rps, *kref)
            po = HP.mb_encode_i_plain(*planes, qp, send, rps, *ref)
        else:
            ko = _p_call(HP.mb_encode_p, planes, qp, send, rps, kref, None)
            po = _p_call(HP.mb_encode_p_plain, planes, qp, send, rps, ref,
                         None)
        _same(list(ko) + kref, list(po) + ref)
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


# ---------------------------------------------------------------- JPEG
JPEG_GEOMS = [(64, 96, 16, "420"), (128, 64, 64, "420"), (48, 40, 8, "444"),
              (64, 64, 32, "444")]


def _jpeg_frame(dev, H, W, seed):
    """Noise over the top half, flat and gradient panels below."""
    rng = np.random.default_rng(seed)
    f = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
    f[H // 2:, : W // 2] = (200, 30, 90)
    f[H // 2:, W // 2:] = np.linspace(0, 255, W - W // 2,
                                      dtype=np.uint8)[None, :, None]
    return torch.as_tensor(f, device=dev)


def _qtables(dev, qm, qp):
    t = [jtab.scale_qtable(b, q) for q in (qm, qp)
         for b in (jtab.STD_LUMA_QUANT, jtab.STD_CHROMA_QUANT)]
    return torch.as_tensor(np.stack(t).astype(np.float32), device=dev)


def _jpeg_stage(dev, H, W, sh, sub, seed=0, q=(60, 90)):
    S = H // sh
    frame = _jpeg_frame(dev, H, W, seed)
    tab = torch.as_tensor(np.arange(S) % 2, dtype=torch.int32, device=dev)
    qt = _qtables(dev, *q)
    planes = JPL.jpeg_forward_plain(frame, torch.zeros_like(frame), tab, qt,
                                    sub)
    scan = JE.scan_maps(JE.scan_layout(sh // 8, W // 8, sub), dev)
    return S, frame, tab, qt, planes, scan


@pytest.mark.parametrize("geom", JPEG_GEOMS)
@pytest.mark.parametrize("q", [(10, 100), (60, 90), "ulp"])
def test_jpeg_forward(dev, geom, q):
    H, W, sh, sub = geom
    S = H // sh
    frame = _jpeg_frame(dev, H, W, 1)
    tab = torch.as_tensor(np.arange(S) % 2, dtype=torch.int32, device=dev)
    qt = torch.full((4, 64), 1 / 16, device=dev) if q == "ulp" \
        else _qtables(dev, *q)
    pk, pp = torch.zeros_like(frame), torch.zeros_like(frame)
    _same(list(JPL.jpeg_forward(frame, pk, tab, qt, sub)) + [pk],
          list(JPL.jpeg_forward_plain(frame, pp, tab, qt, sub)) + [pp])


def _k7_same(frame, prev, tab, qt, sub):
    pk, pp = prev.clone(), prev.clone()
    _same(list(JPL.jpeg_forward(frame, pk, tab, qt, sub)) + [pk],
          list(JPL.jpeg_forward_plain(frame, pp, tab, qt, sub)) + [pp])


@pytest.mark.parametrize("geom", [(48, 40, 8, "444"), (24, 40, 24, "444"),
                                  (32, 1920, 16, "420"),
                                  (48, 1920, 16, "444"),
                                  (32, 1376, 32, "420"),
                                  (16, 1352, 8, "444")])
@pytest.mark.parametrize("q", [(60, 90), "ulp"])
def test_jpeg_forward_wide_and_unaligned(dev, geom, q):
    """W = 40 at 4:4:4 (120-byte rows: the 8-byte instantiation), 1920
    wide at both subsamplings (whole blocks of MCUs), widths whose last
    block of MCUs is partial; the ulp tables of 1/16."""
    H, W, sh, sub = geom
    S = H // sh
    frame = _jpeg_frame(dev, H, W, 7)
    tab = torch.as_tensor(np.arange(S) % 2, dtype=torch.int32, device=dev)
    qt = torch.full((4, 64), 1 / 16, device=dev) if q == "ulp" \
        else _qtables(dev, *q)
    _k7_same(frame, torch.zeros_like(frame), tab, qt, sub)


@pytest.mark.parametrize("sub", ["420", "444"])
def test_jpeg_forward_per_stripe_ulp_tables(dev, sub):
    """Stripes on different tables where one of them is 1/16 (one ulp of
    a coefficient shows) and the other a real table."""
    H, W, sh = 64, 1920, 16
    S = H // sh
    frame = _jpeg_frame(dev, H, W, 3)
    qt = _qtables(dev, 60, 90)
    qt[0] = 1 / 16
    qt[1] = 1 / 16
    tab = torch.as_tensor([0, 1, 1, 0], dtype=torch.int32, device=dev)
    _k7_same(frame, torch.zeros_like(frame), tab, qt, sub)


@pytest.mark.parametrize("sub", ["420", "444"])
def test_jpeg_forward_on_stacked_seats(dev, sub):
    n, H, W, sh = 4, 64, 208 if sub == "420" else 200, 32
    frame = torch.cat([_jpeg_frame(dev, H, W, k) for k in range(n)])
    tab = torch.as_tensor(np.arange(n * H // sh) % 2, dtype=torch.int32,
                          device=dev)
    _k7_same(frame, frame.roll(1, 0), tab, _qtables(dev, 40, 95), sub)


@pytest.mark.parametrize("sub", ["420", "444"])
def test_jpeg_forward_off_16_bytes(dev, sub):
    """A frame and prev 8 bytes into their storage take the 8-byte
    instantiation; 4 bytes in is refused."""
    H, W, sh = 32, 64, 16
    S = H // sh
    src = _jpeg_frame(dev, H, W, 5)
    tab = torch.as_tensor([1, 0], dtype=torch.int32, device=dev)
    qt = _qtables(dev, 60, 90)
    n = H * W * 3
    for off, ok in ((8, True), (4, False)):
        fb = torch.zeros(n + off, dtype=torch.uint8, device=dev)
        pb = torch.zeros(n + off, dtype=torch.uint8, device=dev)
        frame = fb[off:].view(H, W, 3)
        frame.copy_(src)
        prev = pb[off:].view(H, W, 3)
        if ok:
            pp = prev.clone()
            _same(list(JPL.jpeg_forward(frame, prev, tab, qt, sub)) + [prev],
                  list(JPL.jpeg_forward_plain(frame, pp, tab, qt, sub))
                  + [pp])
        else:
            with pytest.raises(RuntimeError, match="jpeg_forward"):
                JPL.jpeg_forward(frame, prev, tab, qt, sub)


QUANT_DIV_PROBE = r"""
#include "quant_div.cuh"
#include <stdint.h>

__global__ void probe(const float* bs, int nb, const int* exps, int ne,
                      unsigned long long* bad) {
  const unsigned m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= (1u << 24)) return;
  for (int e = 0; e < ne; e++) {
    const float a = __uint_as_float(((m >> 23) << 31)
                                    | ((unsigned)(exps[e] + 127) << 23)
                                    | (m & 0x7fffffu));
    for (int k = 0; k < nb; k++) {
      const float b = bs[k];
      if (!div_moderate(b)) continue;
      if (__float_as_uint(div_by(a, b, div_recip(b)))
          != __float_as_uint(__fdiv_rn(a, b)))
        atomicAdd(bad, 1ull);
    }
  }
}

extern "C" int probe_run(const float* bs, int nb, const int* exps, int ne,
                         unsigned long long* bad, void* stream) {
  probe<<<(1 << 24) / 256, 256, 0, (cudaStream_t)stream>>>(bs, nb, exps, ne,
                                                          bad);
  return (int)cudaGetLastError();
}
"""


def test_quant_div_equals_fdiv_rn(dev, tmp_path):
    """K7's hoisted divide (csrc/quant_div.cuh) against __fdiv_rn, bit
    for bit, over every sign and mantissa of the dividend at exponents
    from 2^-72 to 2^13 (the range of the DCT outputs), for every divisor
    a JPEG table holds at any quality (1..255), 1/16 and 64 random
    ones."""
    import ctypes
    import subprocess

    from selkies_tpu_torch.ops import _cuda
    src = tmp_path / "probe.cu"
    src.write_text(QUANT_DIV_PROBE)
    so = tmp_path / "probe.so"
    r = subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-shared", "-I",
                        str(_cuda.CSRC), "-o", str(so), str(src)],
                       capture_output=True, text=True)
    assert r.returncode == 0, r.stdout + r.stderr
    lib = ctypes.CDLL(str(so))
    lib.probe_run.argtypes = [ctypes.c_void_p, ctypes.c_int,
                              ctypes.c_void_p, ctypes.c_int,
                              ctypes.c_void_p, ctypes.c_void_p]
    rng = np.random.default_rng(16)
    divisors = np.concatenate([np.arange(1, 256), [1 / 16],
                               rng.uniform(0.01, 300.0, 64)])
    bs = torch.as_tensor(divisors.astype(np.float32), device=dev)
    exps = torch.as_tensor([-72, -45, -20, -7, -1, 0, 3, 7, 10, 13],
                           dtype=torch.int32, device=dev)
    bad = torch.zeros(1, dtype=torch.int64, device=dev)
    rc = lib.probe_run(bs.data_ptr(), bs.numel(), exps.data_ptr(),
                       exps.numel(), bad.data_ptr(),
                       torch.cuda.current_stream().cuda_stream)
    assert rc == 0
    assert int(bad.item()) == 0


@pytest.mark.parametrize("geom", JPEG_GEOMS)
def test_jpeg_events(dev, geom):
    H, W, sh, sub = geom
    S, _, _, _, planes, scan = _jpeg_stage(dev, H, W, sh, sub, q=(100, 100))
    # past the category caps: AC magnitudes >= 1024, DC steps >= 2048
    y = planes[0].clone()
    y[0, 5], y[1, 9] = 1500, -1100
    y[:8, 0] = torch.tensor([1024, -1024] * 4, dtype=torch.int16)
    _same(JE.jpeg_events(y, *planes[1:], scan, S),
          JE.jpeg_events_plain(y, *planes[1:], scan, S))


def _k8_blocks(rng, n):
    """``n`` zigzag blocks (n, 64) int16 that cover K8's slot cases: noise
    blocks, all-zero blocks (EOB only), blocks with every slot nonzero (no
    EOB), runs of exactly 16, 32 and 48 zeros with a later nonzero (ZRL)
    and at the block's end (no ZRL), runs across the 8-slot pieces of a
    lane, values past the category caps (AC >= 1024, DC steps >= 2048)."""
    c = rng.integers(-40, 41, (n, 64)) * (rng.random((n, 64)) < 0.3)
    c[:, 0] = rng.integers(-1024, 1024, n)
    kinds = rng.integers(0, 10, n)
    for i in range(n):
        k = int(kinds[i])
        if k == 1:
            c[i] = 0                                     # EOB only
        elif k == 2:
            c[i] = rng.choice([-3, -1, 1, 2, 700], 64)   # no EOB
        elif k in (3, 4, 5):
            run = 16 * (k - 2)                           # 16, 32, 48 zeros
            start = int(rng.integers(1, 64 - run))
            c[i, 1:] = rng.choice([-2, 1, 5], 63)
            c[i, start:start + run] = 0
            if rng.random() < 0.5:
                c[i, start + run:] = 0                   # no later nonzero
        elif k == 6:
            c[i, 1:] = 0                                 # zeros after DC
            c[i, int(rng.integers(1, 64))] = int(rng.choice([-1500, 1100]))
        elif k == 7:
            c[i, 0] = 2047 if i % 2 else -2048           # DC steps >= 2048
    return torch.as_tensor(c.astype(np.int16))


#: K8 on made-up coefficients: (stripes, luma blocks high and wide a
#: stripe, subsampling, map) with the scan map of the geometry ("real"),
#: a made-up one whose prev_same points anywhere in the stripe (ahead,
#: far back, past M, outside any block's tile) with out-of-range gathers
#: ("far"), or one with -1 in mid-stripe ("breaks"). M = 6, 30, 132 and
#: 1176 are not multiples of K8's 32 scan blocks a tile; 2880 (the
#: 1080p stripe) at 1 and 68 stripes (4 stacked seats), 5760 at 4:4:4.
K8_CASES = [(1, 2, 2, "420", "real"), (3, 2, 10, "420", "real"),
            (5, 2, 22, "444", "real"), (2, 4, 98, "444", "far"),
            (1, 8, 240, "420", "real"), (68, 8, 240, "420", "real"),
            (17, 8, 240, "444", "real"), (4, 8, 240, "420", "far"),
            (3, 2, 10, "420", "breaks"), (2, 8, 240, "444", "breaks")]


@pytest.mark.parametrize("case", K8_CASES)
def test_jpeg_events_k8_shapes_and_maps(dev, case):
    S, bh, bw, sub, kind = case
    rng = np.random.default_rng(S * bw + bh)
    lay = JE.scan_layout(bh, bw, sub)
    ny = bh * bw
    nc = ny // 4 if sub == "420" else ny
    maps = np.stack([lay.comp, lay.gather, lay.prev_same]).astype(np.int64)
    M = maps.shape[1]
    if kind == "far":
        maps[0] = rng.integers(0, 3, M)
        maps[1] = rng.integers(-3, max(ny, nc) + 3, M)
        maps[2] = rng.integers(-1, M + 40, M)
        maps[2, M // 2] = M - 1
        maps[2, :8] = np.arange(M - 8, M)
    elif kind == "breaks":
        maps[2, rng.random(M) < 0.2] = -1
    scan = torch.as_tensor(maps.astype(np.int32), device=dev)
    planes = [_k8_blocks(rng, S * n).to(dev) for n in (ny, nc, nc)]
    _same(JE.jpeg_events(*planes, scan, S),
          JE.jpeg_events_plain(*planes, scan, S))


@pytest.mark.parametrize("offset", [2, 8])
def test_jpeg_events_on_planes_off_16_bytes(dev, offset):
    """Coefficient planes 2 and 8 bytes into their storage (K8's
    element-wise instantiation at M = 2880, a multiple of its tile)."""
    S, bh, bw = 3, 8, 240
    rng = np.random.default_rng(offset)
    scan = JE.scan_maps(JE.scan_layout(bh, bw, "420"), dev)
    planes = []
    for n in (bh * bw, bh * bw // 4, bh * bw // 4):
        src = _k8_blocks(rng, S * n).to(dev)
        k = offset // 2
        buf = torch.empty(src.numel() + k, dtype=torch.int16, device=dev)
        planes.append(buf[k:].view(src.shape).copy_(src))
    _same(JE.jpeg_events(*planes, scan, S),
          JE.jpeg_events_plain(*[p.clone() for p in planes], scan, S))


#: K9 also on made-up slot events: ("events", stripes, scan blocks a
#: stripe, kind). A dense stripe has a codeword of 18..27 bits in every
#: slot: one of 960 scan blocks takes the largest cluster (16 blocks),
#: each block's words past its 2048-word shared buffer (asserted below
#: for the block of the fewest scan blocks it can get); one of 30000
#: does the same with nbits too large for a block's shared memory, read
#: from device memory; 300 stripes of 8 take one block a stripe; 64
#: stripes of 2880 (the 1080p stripe, several waves as with seats) take
#: 6 blocks a stripe, each streaming its payloads through two buffers;
#: "empty" has a stripe with no bits; "ends" a stripe whose bits end on a
#: byte boundary and one whose bits do not; ("noise", subsampling): K7
#: and K8 on a 640x64 noise frame at quality 100, inside w_cap
PACK_CASES = JPEG_GEOMS + [("events", 1, 960, "dense"),
                           ("events", 1, 30000, "dense"),
                           ("events", 300, 8, "sparse"),
                           ("events", 64, 2880, "sparse"),
                           ("events", 3, 40, "empty"),
                           ("events", 2, 37, "ends"),
                           ("noise", "420"), ("noise", "444")]


def _pack_events(dev, S, m, kind, seed=5):
    """(payload, nbits) of S stripes of m scan blocks: codewords of 0..27
    bits, 18..27 in every slot where ``kind`` is "dense" (a payload never
    wider than its bits, as K8 makes them)."""
    rng = np.random.default_rng(seed)
    nb = rng.integers(18 if kind == "dense" else 0, 28, (S, m, 64))
    if kind != "dense":
        nb[rng.random((S, m, 64)) < 0.8] = 0
    if kind == "empty":
        nb[1] = 0
    if kind == "ends":
        for s, want in ((0, 0), (1, 3)):
            free = np.flatnonzero(nb[s].reshape(-1) == 0)
            add = (want - int(nb[s].sum())) % 8
            if add:
                nb[s].reshape(-1)[free[0]] = add
            assert int(nb[s].sum()) % 8 == want
    pay = rng.integers(0, 1 << 31, (S, m, 64)) & ((1 << nb) - 1)
    return (torch.as_tensor(pay.astype(np.int32), device=dev),
            torch.as_tensor(nb.astype(np.uint8), device=dev))


@pytest.mark.parametrize("geom", PACK_CASES)
def test_jpeg_pack(dev, geom):
    """K9 against plain at roomy caps, at a w_cap the stripes' bits
    overrun (their bytes past their 4 * w_cap), at an e_cap and out_cap
    under the events and bytes, and (made-up events) at out_caps that are
    not multiples of 16; the noise cases at roomy caps."""
    if geom[0] == "noise":
        H, W, sh, sub = 64, 640, 64, geom[1]
        frame = torch.as_tensor(np.random.default_rng(9).integers(
            0, 256, (H, W, 3), dtype=np.uint8), device=dev)
        tab = torch.zeros((1,), dtype=torch.int32, device=dev)
        planes = JPL.jpeg_forward_plain(frame, torch.zeros_like(frame), tab,
                                        _qtables(dev, 100, 100), sub)
        scan = JE.scan_maps(JE.scan_layout(sh // 8, W // 8, sub), dev)
        ev = JE.jpeg_events_plain(*planes, scan, 1)
        m = scan.shape[1]
        w_cap = 64 * m * 27 // 32 + 1
        assert int(ev[1].to(torch.int64).sum()) > 8 * 65536
        caps = ((m * 64, w_cap, 4 * w_cap),)
    elif geom[0] == "events":
        _, S, m, kind = geom
        ev = _pack_events(dev, S, m, kind)
        if kind == "dense":
            # a cluster has at most 16 blocks, so a block holds at least
            # m // 16 scan blocks: more bits than its shared words hold
            assert int(ev[1][0, :m // 16].to(torch.int64).sum()) \
                > 32 * (2048 - 1)
        w_big = 64 * m * 27 // 32 + 1
        total = int((ev[1].to(torch.int64).sum(dim=(1, 2)) + 7).div(
            8, rounding_mode="floor").sum())
        caps = ((m * 64, w_big, 4 * S * w_big + 13),
                (m * 64, w_big, total),
                (m * 64, w_big, total - 1),
                (m * 64, 16, total + 5),
                (m * 8, w_big // 2, 1000))
    else:
        H, W, sh, sub = geom
        S, _, _, _, planes, scan = _jpeg_stage(dev, H, W, sh, sub)
        ev = JE.jpeg_events_plain(*planes, scan, S)
        m = scan.shape[1]
        caps = ((m * 64, sh * W // 2, 1 << 16), (m * 64, 16, 1 << 16),
                (100, sh * W // 2, 64))
    for e_cap, w_cap, out_cap in caps:
        args = (*ev, e_cap, w_cap, out_cap)
        _same(JPP.jpeg_pack(*args), JPP.jpeg_pack_plain(*args))


@pytest.mark.parametrize("geom", JPEG_GEOMS)
def test_row_damage_probe_at_stripes(dev, geom):
    """K6 at the JPEG step's granularity: one flag per stripe."""
    H, W, sh, _ = geom
    f0 = _jpeg_frame(dev, H, W, 2)
    f1 = f0.clone()
    f1[-1, -1, 2] ^= 1
    for frame in (f0, f1, 255 - f0):
        _same([HP.row_damage_probe(frame, f0, H // sh)],
              [HP.row_damage_probe_plain(frame, f0, H // sh)])


def test_jpeg_session_on_the_card(dev):
    """The session's step on the kernels equals it on the plain versions
    over a damaged, an idle and a paint-over frame."""
    from selkies_tpu_torch.engine.encoder import JpegEncoderSession
    from selkies_tpu_torch.engine.types import CaptureSettings
    s = CaptureSettings(capture_width=96, capture_height=60,
                        stripe_height=16, paint_over_delay_frames=1)
    kern, plain = JpegEncoderSession(s), JpegEncoderSession(s)
    plain._ops = JPP.PLAIN_OPS
    plain._rebuild_steps()
    f0 = _jpeg_frame(dev, 64, 96, 3)
    f1 = f0.clone()
    f1[:8, :16] = 255 - f1[:8, :16]
    for frame in (f0, f1, f1, f1):
        a = kern.finalize(kern.encode(frame))
        b = plain.finalize(plain.encode(frame))
        assert a == b
        _same([kern._prev, kern._age], [plain._prev, plain._age])


# ------------------------------------------------- the engine loop: K10-K12

#: (height, width): the 1080p capture and the grid, odd sizes whose byte
#: counts are not multiples of 4 (the kernels' ragged tails), widths
#: whose rows (3W bytes) are not multiples of 16 with H <= 96 (the block's
#: bounce period at its floor of 1), so K10's rows start off 16-byte
#: boundaries in every channel phase, and rows that are multiples of 16
#: bytes (K10's aligned path) with a height that is not a multiple of its
#: 8 rows a block, narrower than the block's columns or ending inside them
FRAME_GEOMS = [(1080, 1920), (1088, 1920), (37, 53), (5, 7), (96, 1366),
               (90, 250), (100, 208), (45, 16)]


@pytest.mark.parametrize("geom", FRAME_GEOMS)
@pytest.mark.parametrize("tick", [0, 95, 306783379, 429496730, 2**31 - 1])
def test_synthetic_frame(dev, geom, tick):
    from selkies_tpu_torch.ops import frames as FR
    H, W = geom
    _same([FR.synthetic_frame(H, W, tick, dev)],
          [FR.synthetic_frame_plain(H, W, tick, dev)])


@pytest.mark.parametrize("src,dst", [((1080, 1920), (1088, 1920)),
                                     ((37, 53), (48, 64)), ((5, 7), (5, 9)),
                                     ((64, 64), (64, 64))])
def test_pad_frame(dev, src, dst):
    from selkies_tpu_torch.ops import frames as FR
    f = _jpeg_frame(dev, *src, 4)
    _same([FR.pad_frame(f, *dst)], [FR.pad_frame_plain(f, *dst)])
    # an unaligned view of a contiguous source
    g = torch.empty(f.numel() + 1, dtype=torch.uint8, device=dev)[1:]
    g = g.view(f.shape).copy_(f)
    _same([FR.pad_frame(g, *dst)], [FR.pad_frame_plain(f, *dst)])


#: K11 at more shapes, (frame h, w) -> (grid H, W): frame rows of 3w
#: bytes not multiples of 16 (1366 into its 1376-wide grid, 53, 7, 5),
#: h == H, w == W and both (no padding), h = 1, grids of 3HW bytes not
#: multiples of 16 (rows of 15 and 27 bytes) and the 2160p capture
K11_CASES = [((96, 1366), (96, 1376)), ((768, 1366), (768, 1376)),
             ((40, 53), (40, 64)), ((37, 64), (48, 64)),
             ((64, 64), (64, 64)), ((1, 1920), (16, 1920)),
             ((1, 7), (3, 9)), ((3, 5), (7, 5)), ((5, 9), (5, 9)),
             ((2160, 3840), (2176, 3840))]


@pytest.mark.parametrize("src,dst", K11_CASES)
@pytest.mark.parametrize("offset", [0, 1, 4, 8])
def test_pad_frame_shapes(dev, src, dst, offset):
    """Sources at 0, 1, 4 and 8 bytes into their storage (K11's flat
    instantiation, its row one with 16-byte, 4-byte and funnel-shifted
    loads)."""
    from selkies_tpu_torch.ops import frames as FR
    f = _jpeg_frame(dev, *src, 6)
    buf = torch.empty(f.numel() + offset, dtype=torch.uint8, device=dev)
    g = buf[offset:].view(f.shape).copy_(f)
    _same([FR.pad_frame(g, *dst)], [FR.pad_frame_plain(f, *dst)])


@pytest.mark.parametrize("src,dst", [((37, 53), (48, 64)),
                                     ((1080, 1920), (1088, 1920)),
                                     ((5, 7), (5, 9))])
@pytest.mark.parametrize("offset", [1, 4])
def test_pad_frame_into_an_unaligned_grid(dev, src, dst, offset):
    """K11's C entry writing a grid 1 and 4 bytes into its storage (the
    wrapper allocates an aligned one), the bytes around it untouched."""
    from selkies_tpu_torch.ops import _cuda
    from selkies_tpu_torch.ops import frames as FR
    f = _jpeg_frame(dev, *src, 7)
    H, W = dst
    buf = torch.full((3 * H * W + offset + 5,), 77, dtype=torch.uint8,
                     device=dev)
    out = buf[offset:offset + 3 * H * W].view(H, W, 3)
    _cuda.launch("pad_frame", f, out, src[0], src[1], H, W)
    _same([out], [FR.pad_frame_plain(f, H, W)])
    assert int((buf[:offset] != 77).sum()) == 0
    assert int((buf[offset + 3 * H * W:] != 77).sum()) == 0


def _wm_inputs(dev, wh, ww, seed):
    from selkies_tpu_torch.ops import frames as FR
    rng = np.random.default_rng(seed)
    rgba = torch.as_tensor(rng.integers(0, 256, (wh, ww, 4), dtype=np.uint8),
                           device=dev)
    return rgba, FR.blend_table().to(dev)


@pytest.mark.parametrize("case", [
    (1088, 1920, 270, 480, 794, 1424),       # the largest, location 6
    (1088, 1920, 270, 480, 2000, -5),        # clamped anchors
    (37, 53, 9, 13, 3, 40), (37, 53, 37, 1, -1, 0),
    # 1366x768 into its 1376 grid, location 6: bytes start off a word
    (768, 1376, 192, 341, 560, 1009), (768, 1376, 270, 480, 482, 870),
    # odd widths (rows off a word, every phase) and anchors
    (61, 77, 17, 23, 5, 1), (61, 77, 17, 22, 6, 2), (61, 77, 61, 77, 0, 0),
    (40, 41, 8, 5, -9, 3), (64, 64, 3, 4, 0, 61), (9, 8, 1, 2, 8, 6)])
def test_watermark_blend(dev, case):
    from selkies_tpu_torch.ops import frames as FR
    H, W, wh, ww, y0, x0 = case
    f = _jpeg_frame(dev, H, W, 5)
    rgba, table = _wm_inputs(dev, wh, ww, H + wh)
    k, p = f.clone(), f.cpu()
    FR.watermark_blend(k, rgba, table, y0, x0)
    FR.watermark_blend_plain(p, rgba.cpu(), table.cpu(), y0, x0)
    _same([k], [p])


@pytest.mark.parametrize("offset", [1, 2, 3])
def test_watermark_blend_on_frame_views_off_a_word(dev, offset):
    """Frames 1-3 bytes into their storage (each row's bytes off a word
    by a different amount), an RGBA view 4 bytes in (the byte-wise
    watermark loads) and a 16-byte aligned one; the bytes around the
    frame untouched."""
    from selkies_tpu_torch.ops import frames as FR
    H, W, wh, ww = 50, 67, 21, 32
    src = _jpeg_frame(dev, H, W, 9 + offset)
    buf = torch.full((src.numel() + offset + 8,), 77, dtype=torch.uint8,
                     device=dev)
    k = buf[offset:offset + src.numel()].view(H, W, 3)
    k.copy_(src)
    rgba, table = _wm_inputs(dev, wh, ww, offset)
    rbuf = torch.empty(rgba.numel() + 4, dtype=torch.uint8, device=dev)
    for r in (rgba, rbuf[4:].view(wh, ww, 4).copy_(rgba)):
        k.copy_(src)
        FR.watermark_blend(k, r, table, 13, 30 + offset)
        p = src.cpu().clone()
        FR.watermark_blend_plain(p, rgba.cpu(), table.cpu(), 13, 30 + offset)
        _same([k], [p])
    assert int((buf[:offset] != 77).sum()) == 0
    assert int((buf[offset + src.numel():] != 77).sum()) == 0


def test_watermark_blend_on_every_byte_triple(dev):
    """All 2^24 (region, R, A) bytes: the kernel's float order and its
    alpha table against the plain version's."""
    from selkies_tpu_torch.ops import frames as FR
    q = -(-65536 // 3)
    pairs = np.arange(3 * q) % 65536
    region = torch.as_tensor((pairs >> 8).astype(np.uint8).reshape(q, 3),
                             device=dev).expand(256, q, 3).contiguous()
    rgba = np.empty((256, q, 4), np.uint8)
    rgba[..., :3] = (pairs & 255).astype(np.uint8).reshape(q, 3)
    rgba[..., 3] = np.arange(256, dtype=np.uint8)[:, None]
    rgba = torch.as_tensor(rgba, device=dev)
    table = FR.blend_table().to(dev)
    k, p = region.clone(), region.clone()
    FR.watermark_blend(k, rgba, table, 0, 0)
    FR.watermark_blend_plain(p, rgba, table, 0, 0)
    _same([k], [p])


@pytest.mark.parametrize("mode", ["jpeg", "h264"])
def test_capture_depth_two_equals_depth_one_on_the_card(dev, mode,
                                                         monkeypatch):
    """ScreenCapture on the card: the pipelined loop's chunks per frame
    equal the serial loop's, with a watermark and the padder running."""
    import time

    from selkies_tpu_torch.engine import CaptureSettings, ScreenCapture
    from selkies_tpu_torch.engine import encoder as T_enc
    from selkies_tpu_torch.engine import h264_encoder as T_h264
    from selkies_tpu_torch.engine.watermark import Watermark

    rgba = np.random.default_rng(8).integers(0, 256, (24, 40, 4),
                                             dtype=np.uint8)

    def from_array(settings, w, h, device):
        # the array watermark, as chip_smoke builds it (no PIL there)
        return Watermark.from_rgba(rgba, settings.watermark_location, w, h,
                                   device)
    for mod in (T_enc, T_h264):
        monkeypatch.setattr(mod, "maybe_load", from_array)
    runs = []
    for depth in (1, 2):
        got = []
        s = CaptureSettings(capture_width=256, capture_height=120,
                            stripe_height=64, target_fps=240.0,
                            output_mode=mode, use_cbr=False,
                            keyframe_interval_s=0,
                            h264_content_adaptive=False, pipeline_depth=depth,
                            watermark_path="seeded", watermark_location=6)
        cap = ScreenCapture("synthetic")
        cap.start_capture(got.append, s)
        deadline = time.monotonic() + 60
        while (not any(c.frame_id >= 12 for c in got)
               and time.monotonic() < deadline):
            time.sleep(0.01)
        cap.stop_capture()
        runs.append({fid: [c for c in got if c.frame_id == fid]
                     for fid in range(12)})
    assert runs[0] == runs[1] and all(runs[0].values())


# ------------------------------------------------------------ H.264 4:4:4
def _stage444(dev, H, W, sh, seed=0):
    """K13..K14 outputs of a geometry at 4:4:4 (through the plain
    versions): per-row qp, every other stripe sent."""
    S, rps, R = H // sh, sh // 16, H // 16
    f0, f1 = _frames(dev, H, W)
    planes = H4.csc444_damage_plain(f1, f0.clone(), S)[:3]
    qp = torch.full((R,), 26, dtype=torch.int32, device=dev)
    qp[::2] = 44
    send = torch.ones((S,), dtype=torch.int32, device=dev)
    send[1::2] = 0
    ref = [torch.zeros_like(p) for p in planes]
    i_out = H4.mb_encode_i444_plain(*planes, qp, send, rps, *ref)
    return S, rps, planes, qp, send, ref, i_out


@pytest.mark.parametrize("geom", GEOMS)
def test_csc444_damage(dev, geom):
    H, W, sh = geom
    f0, f1 = _frames(dev, H, W)
    pk, pp = f0.clone(), f0.clone()
    _same(list(H4.csc444_damage(f1, pk, H // sh)) + [pk],
          list(H4.csc444_damage_plain(f1, pp, H // sh)) + [pp])


def test_csc444_on_every_byte_triple(dev):
    """All 2^24 RGB triples as one 4096x4096 frame: K13's float order
    equals the plain version's (the reference's) on every one."""
    v = torch.arange(1 << 24, dtype=torch.int64, device=dev)
    rgb = torch.stack([(v >> 16) & 255, (v >> 8) & 255, v & 255], -1).to(
        torch.uint8).reshape(4096, 4096, 3)
    pk, pp = torch.zeros_like(rgb), torch.zeros_like(rgb)
    _same(list(H4.csc444_damage(rgb, pk, 16)) + [pk],
          list(H4.csc444_damage_plain(rgb, pp, 16)) + [pp])


def _p444_call(p_fn, sel, planes, qp, send_rows, ref, cands, win,
               rows=None):
    """K15 (kernel or plain) with the prediction of K5's 4:4:4 entry
    (zero motion: the reference planes themselves, updated in place);
    ``rows`` (a slice of MB rows) codes that band only, every plane, the
    prediction and the reference handed over as views, as the band step
    does."""
    if cands is None:
        pred, mv = ref, None
    else:
        *pred, mv = sel(planes[0], *ref, qp, cands, win)
    if rows is not None:
        def band(ts):
            return [t[16 * rows.start:16 * rows.stop] for t in ts]
        planes, pred, ref = band(planes), band(pred), band(ref)
        qp, send_rows = qp[rows], send_rows[rows]
        mv = None if mv is None else mv[rows]
    return p_fn(*planes, qp, send_rows, *pred, mv, *ref)


#: K15 also at 13 MBs a row (not a multiple of the 4 MBs a block takes:
#: its kernel for any shape) and at 8 (whole blocks on 16-byte
#: boundaries)
P444_GEOMS = GEOMS + [(64, 208, 32), (64, 128, 32)]


@pytest.mark.parametrize("geom", P444_GEOMS)
@pytest.mark.parametrize("mode", ["i", "p0", "p", "p0_rows", "p_rows",
                                  "p0_band", "p_band"])
def test_mb_encode444(dev, geom, mode):
    """K14 / K15 against plain: I, P with zero motion (the prediction is
    the reference, rewritten in place) and with K5's prediction; ``_rows``
    sends MB rows in a pattern that cuts across the stripes, ``_band``
    codes the MB rows of the second stripe on (views from a stripe
    boundary)."""
    S, rps, planes, qp, send, ref, _ = _stage444(dev, *geom)
    if mode == "i":
        base = [torch.zeros_like(p) for p in planes]
    else:
        base = [p.clone() for p in ref]
        planes = tuple(255 - p for p in planes) if mode.startswith("p0") \
            else tuple(torch.roll(p, (-2, 1), (0, 1)) for p in planes)
    kref = [b.clone() for b in base]
    pref = [b.clone() for b in base]
    if mode == "i":
        ko = H4.mb_encode_i444(*planes, qp, send, rps, *kref)
        po = H4.mb_encode_i444_plain(*planes, qp, send, rps, *pref)
    else:
        cands = None if mode.startswith("p0") else TE.scroll_candidates(4, 2)
        R = geom[0] // 16
        send_rows = send.repeat_interleave(rps)
        if mode.endswith("_rows"):
            send_rows = torch.tensor([1, 0, 0, 1, 1, 0][:R] * 2,
                                     dtype=torch.int32, device=dev)[:R]
        rows = slice(rps if S > 1 else 0, R) if mode.endswith("_band") \
            else None
        ko = _p444_call(H4.mb_encode_p444, TE.motion_select444, planes, qp,
                        send_rows, kref, cands, 16 * rps, rows)
        po = _p444_call(H4.mb_encode_p444_plain, TE.motion_select444_plain,
                        planes, qp, send_rows, pref, cands, 16 * rps, rows)
    _same(list(ko) + kref, list(po) + pref)


@pytest.mark.parametrize("geom", GEOMS)
@pytest.mark.parametrize("cands", ["small", "default"])
def test_motion_select444(dev, geom, cands):
    H, W, sh = geom
    cands = TE.scroll_candidates(4, 2) if cands == "small" \
        else TE.scroll_candidates()
    S, rps, planes, qp, send, ref, _ = _stage444(dev, *geom)
    ref = [p.clone() for p in planes]
    cur = torch.roll(planes[0], -3, 0)
    cur[:, W // 2:] = torch.roll(planes[0], -2, 1)[:, W // 2:]
    _same(TE.motion_select444(cur, *ref, qp, cands, sh),
          TE.motion_select444_plain(cur, *ref, qp, cands, sh))


@pytest.mark.parametrize("geom", GEOMS)
def test_cavlc444_and_pack(dev, geom):
    H, W, sh = geom
    S, rps, planes, qp, send, ref, i_out = _stage444(dev, *geom)
    R, M = H // 16, W // 16
    p_planes = tuple(torch.roll(p, (-2, 1), (0, 1)) for p in planes)
    p_out = H4.mb_encode_p444_plain(*p_planes, qp, torch.ones(
        (R,), dtype=torch.int32, device=dev), *ref, None, *ref)
    for intra, (lv, cbp, hp, hn) in ((True, i_out), (False, p_out)):
        ev = H4.cavlc_events444(lv, cbp, intra)
        _same(ev, H4.cavlc_events444_plain(lv, cbp, intra))
        fn = hcodec.slice_header_events if intra \
            else hcodec.p_slice_header_events
        pay, nb = fn(M, rps)
        rhp = torch.as_tensor(np.tile(pay.astype(np.int32), (S, 1)),
                              device=dev)
        rhn = torch.as_tensor(np.tile(nb, (S, 1)), device=dev)
        rid = torch.arange(R, dtype=torch.int32, device=dev)
        for w_cap, out_cap in ((3072, 1 << 17), (16, 1 << 17), (3072, 64)):
            args = (hp, hn, *ev, rhp, rhn, rid, qp, intra, 10 ** 6, w_cap,
                    out_cap)
            _same(HP.pack_stream(*args), HP.pack_stream_plain(*args))


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("W", [96, 208])
def test_chain444_on_noise_at_random_qp(dev, seed, W):
    """Noise frames at per-row qp drawn from 0..51 (the first two rows at
    0 and 51), I then P with motion, 6 and 13 MBs a row: every 4:4:4
    stage's kernel output equals the plain version's."""
    H, sh = 64, 32
    S, rps, R, M = H // sh, sh // 16, H // 16, W // 16
    rng = np.random.default_rng(200 + seed)
    f0, f1 = (torch.as_tensor(rng.integers(0, 256, (H, W, 3),
                                           dtype=np.uint8), device=dev)
              for _ in range(2))
    qps = rng.integers(0, 52, R).astype(np.int32)
    qps[:2] = (0, 51)
    qp = torch.as_tensor(qps, device=dev)
    send = torch.ones((S,), dtype=torch.int32, device=dev)
    ref = [torch.zeros((H, W), dtype=torch.uint8, device=dev)
           for _ in range(3)]
    cands = TE.scroll_candidates(4, 2)
    for intra, frame in ((True, f0), (False, f1)):
        planes = H4.csc444_damage_plain(frame, f0.clone(), S)[:3]
        kref = [r.clone() for r in ref]
        if intra:
            ko = H4.mb_encode_i444(*planes, qp, send, rps, *kref)
            po = H4.mb_encode_i444_plain(*planes, qp, send, rps, *ref)
        else:
            send_rows = send.repeat_interleave(rps)
            ko = _p444_call(H4.mb_encode_p444, TE.motion_select444, planes,
                            qp, send_rows, kref, cands, sh)
            po = _p444_call(H4.mb_encode_p444_plain,
                            TE.motion_select444_plain, planes, qp, send_rows,
                            ref, cands, sh)
        _same(list(ko) + kref, list(po) + ref)
        ev = H4.cavlc_events444(ko[0], ko[1], intra)
        _same(ev, H4.cavlc_events444_plain(ko[0], ko[1], intra))


def test_444_frame_entry_points_run_on_the_card(dev):
    H, W = 64, 80
    R, M = H // 16, W // 16
    rng = np.random.default_rng(12)
    y, u, v = (rng.integers(0, 256, (H, W)).astype(np.int32)
               for _ in range(3))
    qp = np.array([8, 30, 51, 19], np.int32)
    e_cap, w_cap = 9 + M * H4.SLOTS_MB_444 + 2, 3072
    hdr = hcodec.slice_header_events(M, R)
    p_hdr = hcodec.p_slice_header_events(M, R)
    outs = {}
    for d in (None, "cpu"):
        i_out, rec = H4.h264_encode_yuv444(y, u, v, qp, *hdr, e_cap, w_cap,
                                           want_recon=True, device=d)
        p_out, _ = H4.h264_encode_p_yuv444(
            np.roll(y, 3, 0), u, v, *rec, qp, *p_hdr, np.ones(R, np.int32),
            e_cap, w_cap, candidates=TE.scroll_candidates(4, 2), device=d)
        outs[d] = (i_out, p_out)
    assert outs[None][0].words.device.type == "cuda"
    for k, p in zip(outs[None], outs["cpu"]):
        _same([k.words, k.total_bits], [p.words, p.total_bits])
        assert bool(k.overflow) == bool(p.overflow)


@pytest.mark.parametrize("partial", [False, True])
def test_444_session_on_the_card(dev, partial):
    """The fullcolor session on the card against the same session on
    its plain versions (on the card), through a scroll and a typed band:
    equal chunks and state."""
    from selkies_tpu_torch.engine.h264_encoder import H264EncoderSession
    from selkies_tpu_torch.engine.types import CaptureSettings
    kw = dict(capture_width=128, capture_height=64, stripe_height=32,
              output_mode="h264", fullcolor=True, h264_motion_vrange=4,
              h264_motion_hrange=2, h264_partial_encode=partial,
              paint_over_delay_frames=2)
    kern = H264EncoderSession(CaptureSettings(**kw))
    plain = H264EncoderSession(CaptureSettings(**kw))
    plain._ops = H4.PLAIN_OPS_444
    plain._rebuild_steps()
    f0, _ = _frames(dev, 64, 128)
    typed = torch.roll(f0, 5, 0)
    typed[40:48, 8:40] = 20
    for frame in (f0, torch.roll(f0, 5, 0), typed, typed, typed, f0):
        a = kern.finalize(kern.encode(frame))
        b = plain.finalize(plain.encode(frame))
        assert [(c.stripe_y, c.is_idr, c.payload) for c in a] \
            == [(c.stripe_y, c.is_idr, c.payload) for c in b]
        for k in ("_ref_y", "_ref_u", "_ref_v", "_prev", "_sent", "_fnum"):
            assert torch.equal(getattr(kern, k), getattr(plain, k)), k


# ------------------------------------------------ multi-seat entries (K4,
# K9, K10 with a seat axis) and the multi-seat encoders
def _seat_pack_inputs(dev, rng, n_seats, rows, mb_w, intra, tables=HP):
    """K4 inputs for ``n_seats`` seats of ``rows`` MB rows: random slot
    events, with every slot of seat 0's last row carrying 16 bits, so
    that row overflows a small w_cap and spills into the words after it
    (never into seat 1's). P rows leave header slot 0 empty: K4 puts the
    skip run there (K2-P writes no bits into it). ``tables`` gives the
    block slots per MB: ``HP`` 4:2:0's, ``H4`` 4:4:4's."""
    R, sb = n_seats * rows, tables.SB_I if intra else tables.SB_P
    hdr_nb = rng.integers(0, 8, (R, mb_w, HP.HDR_SLOTS)).astype(np.int32)
    if not intra:
        hdr_nb[..., 0] = 0
    ev_nb = rng.integers(0, 3, (R, mb_w, sb)).astype(np.uint8)
    ev_nb[rows - 1] = 16
    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    hdr_pay = t(rng.integers(0, 256, hdr_nb.shape).astype(np.int32)) \
        & ((1 << t(hdr_nb)) - 1)
    pay = t(rng.integers(0, 1 << 16, ev_nb.shape).astype(np.int32)) \
        & ((1 << t(ev_nb).to(torch.int32)) - 1)
    return (hdr_pay, t(hdr_nb), pay, t(ev_nb),
            t(rng.integers(0, 64, (R, 2)).astype(np.int32)),
            t(np.full((R, 2), 6, np.int32)),
            t(rng.integers(0, 16, (R,)).astype(np.int32)),
            t(rng.integers(10, 40, (R,)).astype(np.int32)))


@pytest.mark.parametrize("n_seats", [1, 2, 3])
@pytest.mark.parametrize("intra", [True, False])
def test_pack_stream_seats(dev, n_seats, intra):
    rows, mb_w = 3, 4
    args = _seat_pack_inputs(dev, np.random.default_rng(n_seats), n_seats,
                             rows, mb_w, intra)
    for e_cap, w_cap, out_cap in ((10**6, 4096, 1 << 16),
                                  (10**6, 256, 1 << 16),
                                  (500, 4096, 64)):
        a = (*args, intra, e_cap, w_cap, out_cap)
        k = HP.pack_stream_seats(*a, n_seats=n_seats)
        p = HP.pack_stream_seats_plain(*a, n_seats=n_seats)
        _same(k, p)
        assert k.data.shape == (n_seats, out_cap)
    # the single-frame entry is the one-seat case
    a = (*(x[:rows] for x in args), intra, 10**6, 256, 1 << 16)
    k1, p1 = HP.pack_stream(*a), HP.pack_stream_seats_plain(*a, n_seats=1)
    _same([k1.words, k1.total_bits, k1.data, k1.byte_lens, k1.flags],
          [p1.words, p1.total_bits, p1.data[0], p1.byte_lens, p1.flags[0]])


@pytest.mark.parametrize("n_seats", [1, 2, 4])
@pytest.mark.parametrize("intra", [True, False])
def test_pack_stream_seats_at_444_slot_counts(dev, n_seats, intra):
    """K4's seat entry at 4:4:4's 1740 (I) / 1728 (P) block slots per MB,
    the layout of the split frame's 4:4:4 shards."""
    rows, mb_w = 2, 3
    args = _seat_pack_inputs(dev, np.random.default_rng(40 + n_seats),
                             n_seats, rows, mb_w, intra, H4)
    for e_cap, w_cap, out_cap in ((10**6, 8192, 1 << 17),
                                  (10**6, 512, 1 << 17),
                                  (900, 8192, 128)):
        a = (*args, intra, e_cap, w_cap, out_cap)
        k = HP.pack_stream_seats(*a, n_seats=n_seats)
        _same(k, HP.pack_stream_seats_plain(*a, n_seats=n_seats))
        assert k.data.shape == (n_seats, out_cap)


@pytest.mark.parametrize("geom", JPEG_GEOMS)
@pytest.mark.parametrize("n_seats", [1, 3, 8])
def test_jpeg_pack_seats(dev, geom, n_seats):
    H, W, sh, sub = geom
    evs = []
    for k in range(n_seats):
        S, _, _, _, planes, scan = _jpeg_stage(dev, H, W, sh, sub,
                                               q=(10 + 40 * k, 90))
        evs.append(JE.jpeg_events_plain(*planes, scan, S))
    ev = [torch.cat([e[i] for e in evs]) for i in range(2)]
    m = scan.shape[1]
    for e_cap, w_cap, out_cap in ((m * 64, sh * W // 2, 1 << 16),
                                  (m * 64, 16, 1 << 16),
                                  (100, sh * W // 2, 64)):
        args = (*ev, e_cap, w_cap, out_cap)
        k = JPP.jpeg_pack_seats(*args, n_seats=n_seats)
        _same(k, JPP.jpeg_pack_seats_plain(*args, n_seats=n_seats))
        assert k.flags.shape == (n_seats, 2)


@pytest.mark.parametrize("geom", FRAME_GEOMS)
@pytest.mark.parametrize("n_seats", [1, 3, 4])
@pytest.mark.parametrize("tick", [0, 95, 2**31 - 100])
def test_synthetic_frames(dev, geom, n_seats, tick):
    """K10's seat entry: seat k at phase k * 37 + tick, wrapping int32; at
    an odd frame size the later seats start off 16-byte boundaries."""
    from selkies_tpu_torch.ops import frames as FR
    H, W = geom
    _same([FR.synthetic_frames(H, W, n_seats, tick, dev)],
          [FR.synthetic_frames_plain(H, W, n_seats, tick, dev)])


def _seat_script(dev, n, H, W, noisy_seat):
    from selkies_tpu_torch.ops import frames as FR
    base = FR.synthetic_frames(H, W, n, 0, dev)
    rng = np.random.default_rng(11)
    noise = torch.as_tensor(rng.integers(0, 256, (H, W, 3), dtype=np.uint8),
                            device=dev)
    t1 = base.clone()
    t1[1, 20:28, 8:40] = 20
    t1[2] = FR.synthetic_frame(H, W, 77, dev)
    t1[3] = torch.roll(base[3], 4, 0)
    t2 = t1.clone()
    t2[noisy_seat] = noise
    t3 = t2.clone()
    t3[noisy_seat] = base[noisy_seat]
    return [(base, True), (t1, False), (t1, False), (t2, False),
            (t3, False), (t3, True)]


@pytest.mark.parametrize("mode", ["jpeg", "h264"])
def test_multiseat_encoder_on_the_card(dev, mode):
    """Each multi-seat encoder on the kernels equals it on the plain
    versions (on the card) through damaged, idle, paint-over and forced
    ticks and an overflow of one seat's buffer: equal chunks and state."""
    from selkies_tpu_torch.engine.types import CaptureSettings
    from selkies_tpu_torch.parallel import (MultiSeatEncoder,
                                            MultiSeatH264Encoder)
    n, H, W = 4, 64, 128
    kw = dict(capture_width=W, capture_height=H, stripe_height=32,
              paint_over_delay_frames=2)
    if mode == "h264":
        kw.update(output_mode="h264", h264_motion_vrange=4,
                  h264_motion_hrange=2)
    cls = MultiSeatH264Encoder if mode == "h264" else MultiSeatEncoder
    plain_ops = HP.SEAT_PLAIN_OPS if mode == "h264" else JPP.SEAT_PLAIN_OPS
    encs = [cls(CaptureSettings(**kw), n) for _ in range(2)]
    encs[1]._ops = plain_ops
    for e in encs:
        e._out_cap = 3000
        e._rebuild_steps()
    for frames, force in _seat_script(dev, n, H, W, noisy_seat=2):
        outs = []
        for e in encs:
            out = e.encode(frames, force=force) if mode == "h264" \
                else e.encode(frames)
            outs.append([[(c.stripe_y, c.is_idr, c.payload) for c in s]
                         for s in e.finalize(out, force_all=force)])
        assert outs[0] == outs[1]
        for key in encs[0].STATE_KEYS.arrays:
            assert torch.equal(getattr(encs[0], key),
                               getattr(encs[1], key)), key
        assert (encs[0]._force_after_drop == encs[1]._force_after_drop).all()
    assert encs[0]._cap_gen == 1, "the noise seat did not overflow"


# ------------------------------------------- ROI QP: K17, K18, K2-P's plane
def _roi_frames(dev, H, W, seed):
    """A random frame and a copy with random MBs, single bytes and the
    last MB changed."""
    rng = np.random.default_rng(seed)
    prev = torch.as_tensor(rng.integers(0, 256, (H, W, 3), dtype=np.uint8),
                           device=dev)
    f = prev.clone()
    R, M = H // 16, W // 16
    for r, m in zip(*np.nonzero(rng.random((R, M)) < 0.3)):
        f[16 * r + 3, 16 * m + 7, 1] ^= 4
    f[-1, -1, 2] ^= 1
    f[0, 0, 0] ^= 1
    return f, prev


@pytest.mark.parametrize("bias", [0, 4, 12])
def test_roi_qp_plane_at_1080p(dev, bias):
    H, W = 1088, 1920
    f, prev = _roi_frames(dev, H, W, bias)
    rng = np.random.default_rng(bias + 1)
    qp = torch.as_tensor(rng.integers(0, 52, H // 16).astype(np.int32),
                         device=dev)
    _same([HP.roi_qp_plane(f, prev, qp, bias)],
          [HP.roi_qp_plane_plain(f, prev, qp, bias)])
    # a band 16 rows into the frame, and a view 3 bytes in (byte loop)
    _same([HP.roi_qp_plane(f[16:80], prev[16:80], qp[:4], bias)],
          [HP.roi_qp_plane_plain(f[16:80], prev[16:80], qp[:4], bias)])
    a = f.reshape(-1)[3:3 + 64 * W * 3].reshape(64, W, 3)
    b = prev.reshape(-1)[3:3 + 64 * W * 3].reshape(64, W, 3)
    _same([HP.roi_qp_plane(a, b, qp[:4], bias)],
          [HP.roi_qp_plane_plain(a, b, qp[:4], bias)])


def _one_byte_per_mb(rng, prev, frac):
    """``prev`` with one byte changed in about ``frac`` of its MBs, each
    at a random place of the MB's 16 x 48 bytes (its first and last byte
    among the places drawn)."""
    H, W = prev.shape[0], prev.shape[1]
    R, M = H // 16, W // 16
    f = prev.copy()
    hit = rng.random((R, M)) < frac
    hit[0, 0] = hit[-1, -1] = True
    py = rng.integers(0, 16, (R, M))
    bx = rng.integers(0, 48, (R, M))
    py[0, 0], bx[0, 0], py[-1, -1], bx[-1, -1] = 0, 0, 15, 47
    r, m = np.nonzero(hit)
    y, x = 16 * r + py[r, m], 16 * m + bx[r, m] // 3
    f[y, x, bx[r, m] % 3] ^= 1 << rng.integers(0, 8, len(r)).astype(np.uint8)
    return f


@pytest.mark.parametrize("rows,W", [(68, 1920), (20, 1920), (16, 1920),
                                    (4, 1920), (1, 1920), (5, 720), (3, 16),
                                    (9, 1008), (2, 560), (40, 3840)])
def test_roi_qp_plane_segments(dev, rows, W):
    """K17 at each segment size the host picks (32, 16 and 8 MBs a
    block: a whole 1080p frame, a 20-row band, 16-, 4- and 1-row bands,
    a 4K band) and at widths that end a row in a short segment, as band
    views 16 rows into a taller frame: idle (prev equal), fully dirty,
    one byte changed in some MBs (an MB's first and last byte among
    them), at bias 0, 4 and 12 with row QPs over 0..51."""
    rng = np.random.default_rng(rows * W)
    H = 16 * rows
    p_np = rng.integers(0, 256, (H + 32, W, 3), dtype=np.uint8)
    prev = torch.as_tensor(p_np, device=dev)
    cases = {"idle": p_np, "full": 255 - p_np,
             "bytes": _one_byte_per_mb(rng, p_np, 0.4)}
    for tag, f_np in cases.items():
        f = torch.as_tensor(f_np, device=dev)
        a, b = f[16:16 + H], prev[16:16 + H]
        for bias in (0, 4, 12):
            qp = torch.as_tensor(rng.integers(0, 52, rows).astype(np.int32),
                                 device=dev)
            got = HP.roi_qp_plane(a, b, qp, bias)
            want = HP.roi_qp_plane_plain(a.cpu(), b.cpu(), qp.cpu(), bias)
            _same([got], [want])
            q = torch.clamp(qp, 8, 48)[:, None].expand(rows, W // 16)
            if tag == "idle":
                assert torch.equal(got, q), tag
            if tag == "full":
                assert torch.equal(got, torch.clamp(
                    qp - bias, 8, 48)[:, None].expand(rows, W // 16)), tag


@pytest.mark.parametrize("fo,po", [(1, 1), (3, 0), (0, 8), (5, 13)])
def test_roi_qp_plane_on_unaligned_views(dev, fo, po):
    """The byte loop: the frame and prev views ``fo`` and ``po`` bytes
    into their storage (either off 16 bytes), at a whole 1080p frame and
    a 4-row band, idle, fully dirty and with one byte changed in some
    MBs."""
    rng = np.random.default_rng(100 * fo + po)
    W = 1920
    p_np = rng.integers(0, 256, (1088, W, 3), dtype=np.uint8)
    for tag, f_np in (("idle", p_np), ("full", 255 - p_np),
                      ("bytes", _one_byte_per_mb(rng, p_np, 0.3))):
        fb = torch.empty(f_np.size + fo, dtype=torch.uint8, device=dev)
        pb = torch.empty(p_np.size + po, dtype=torch.uint8, device=dev)
        f = fb[fo:].view(f_np.shape).copy_(torch.as_tensor(f_np))
        prev = pb[po:].view(p_np.shape).copy_(torch.as_tensor(p_np))
        for r0, n in ((0, 68), (32, 4)):
            a, b = f[16 * r0:16 * (r0 + n)], prev[16 * r0:16 * (r0 + n)]
            qp = torch.as_tensor(rng.integers(0, 52, n).astype(np.int32),
                                 device=dev)
            _same([HP.roi_qp_plane(a, b, qp, 4)],
                  [HP.roi_qp_plane_plain(a.cpu(), b.cpu(), qp.cpu(), 4)])


def _qp_planes(dev, rng, R, M):
    qp = torch.as_tensor(rng.integers(0, 52, R).astype(np.int32), device=dev)
    qp_mb = torch.as_tensor(rng.integers(0, 52, (R, M)).astype(np.int32),
                            device=dev)
    return qp, qp_mb


@pytest.mark.parametrize("motion", [False, True])
@pytest.mark.parametrize("W", [1920, 208])
def test_mb_encode_p_with_qp_mb_at_1080p(dev, motion, W):
    """K2-P's per-MB-QP entry on noise against a moved reference, QPs
    0..51 per MB (the first block of each row holds 0, 51, 0, 51), half
    the rows sent; then K18 on its headers. Also 1088 rows of 13 MBs."""
    H = 1088
    R, M = H // 16, W // 16
    rng = np.random.default_rng(7 + motion)
    f0, f1 = (torch.as_tensor(rng.integers(0, 256, (H, W, 3),
                                           dtype=np.uint8), device=dev)
              for _ in range(2))
    f1[:, : W // 2] = torch.roll(f0, 3, 0)[:, : W // 2]
    ref = list(HP.csc420_damage_plain(f0, f0.clone(), 17)[:3])
    planes = HP.csc420_damage_plain(f1, f0.clone(), 17)[:3]
    qp, qp_mb = _qp_planes(dev, rng, R, M)
    qp_mb[:, :4] = torch.tensor([0, 51, 0, 51], dtype=torch.int32,
                                device=dev)
    send = (torch.arange(R, device=dev) % 2).to(torch.int32)
    if motion:
        *pred, mv = TE.motion_select_plain(planes[0], *ref, qp,
                                           TE.scroll_candidates(24, 8), 64)
    else:
        pred, mv = ref, None
    outs = []
    for fn in (HP.mb_encode_p, HP.mb_encode_p_plain):
        r = [p.clone() for p in ref]
        pr = [p.clone() for p in pred] if motion else r
        outs.append(list(fn(*planes, qp, send, *pr, mv, *r, qp_mb=qp_mb))
                    + r)
    _same(outs[0], outs[1])
    hp, hn = outs[0][2], outs[0][3]
    kd = HP.mb_qp_delta(hp.clone(), hn.clone(), qp_mb, qp)
    pd = HP.mb_qp_delta_plain(hp.clone(), hn.clone(), qp_mb, qp)
    _same(kd, pd)


@pytest.mark.parametrize("M", [1, 31, 32, 33, 120])
def test_mb_qp_delta(dev, M):
    """Random gates (motion-only MBs included) and QPs 0..51 on rows of
    1..120 MBs: chunks of 32 and the carry between them."""
    R = 68
    rng = np.random.default_rng(M)
    hp = torch.as_tensor(rng.integers(0, 99, (R, M, 6)).astype(np.int32),
                         device=dev)
    hn = torch.as_tensor(rng.integers(0, 9, (R, M, 6)).astype(np.int32),
                         device=dev)
    hn[..., 5] = torch.as_tensor((rng.random((R, M)) < 0.4).astype(np.int32),
                                 device=dev)
    hp[..., 5] = hn[..., 5]
    qp, qp_mb = _qp_planes(dev, rng, R, M)
    _same(HP.mb_qp_delta(hp.clone(), hn.clone(), qp_mb, qp),
          HP.mb_qp_delta_plain(hp.clone(), hn.clone(), qp_mb, qp))


@pytest.mark.parametrize("bias", [4, 12])
def test_roi_session_on_the_card(dev, bias):
    """The ROI QP band session on the card against the same session on
    its plain versions (on the card): scrolls, typing, idle and
    paint-over bands at qp 12 (so bias 12 meets the lower clip)."""
    from selkies_tpu_torch.engine.h264_encoder import H264EncoderSession
    from selkies_tpu_torch.engine.types import CaptureSettings
    from selkies_tpu_torch.ops import _cuda
    kw = dict(capture_width=128, capture_height=64, stripe_height=32,
              output_mode="h264", h264_motion_vrange=4, h264_motion_hrange=2,
              h264_partial_encode=True, h264_roi_qp=True,
              h264_roi_qp_bias=bias, paint_over_delay_frames=2)
    kern = H264EncoderSession(CaptureSettings(**kw))
    plain = H264EncoderSession(CaptureSettings(**kw))
    plain._ops = HP.PLAIN_OPS
    plain._rebuild_steps()
    for sess in (kern, plain):
        sess.set_qp(12)
    f0, _ = _frames(dev, 64, 128)
    typed = torch.roll(f0, 5, 0)
    typed[40:48, 8:40] = 20
    before = dict(_cuda.LAUNCHES)
    n_band = 0
    for frame in (f0, torch.roll(f0, 5, 0), typed, typed, typed, typed, f0):
        out = kern.encode(frame)
        n_band += out.get("band") is not None
        a = kern.finalize(out)
        b = plain.finalize(plain.encode(frame))
        assert [(c.stripe_y, c.is_idr, c.payload) for c in a] \
            == [(c.stripe_y, c.is_idr, c.payload) for c in b]
        for k in ("_ref_y", "_ref_u", "_ref_v", "_prev", "_sent", "_fnum"):
            assert torch.equal(getattr(kern, k), getattr(plain, k)), k
    n = {k: _cuda.LAUNCHES[k] - before[k] for k in
         ("roi_qp_plane", "mb_qp_delta", "mb_encode_p_qp", "mb_encode_p")}
    assert n_band > 0 and n == {"roi_qp_plane": n_band,
                                "mb_qp_delta": n_band,
                                "mb_encode_p_qp": n_band, "mb_encode_p": 0}


# ------------------------------------------ split frame (K19, K20 and the
# sharded frame entries and session)
@pytest.mark.parametrize("shape", [(64, 24), (64, 40), (48, 8), (32, 7),
                                   (1088, 960), (1088, 1920)])
@pytest.mark.parametrize("band,halo", [(16, 3), (16, 24), (8, 13), (32, 0)])
def test_halo_bands(dev, shape, band, halo):
    """K20 at widths that are and are not multiples of 16, 8 and 4, with
    halos that reach past both frame edges (24 rows around a 16-row
    band)."""
    H, W = shape
    if H % band:
        pytest.skip("band does not tile the plane")
    plane = torch.as_tensor(np.random.default_rng(W + band).integers(
        0, 256, (H, W), dtype=np.uint8), device=dev)
    from selkies_tpu_torch.parallel import stripes as ST
    _same([ST.halo_bands(plane, band, halo)],
          [ST.halo_bands_plain(plane, band, halo)])


def _halo_case(dev, H, W, full, n, seed):
    rng = np.random.default_rng(seed)
    cdiv = 1 if full else 2
    ref = [torch.as_tensor(rng.integers(0, 256, s, dtype=np.uint8),
                           device=dev)
           for s in ((H, W), (H // cdiv, W // cdiv), (H // cdiv, W // cdiv))]
    cur = torch.roll(ref[0], -3, 0)
    cur[:, W // 2:] = torch.roll(ref[0], 5, 0)[:, W // 2:]
    qp = torch.as_tensor(rng.integers(8, 48, H // 16).astype(np.int32),
                         device=dev)
    return cur, ref, qp


@pytest.mark.parametrize("full", [False, True])
@pytest.mark.parametrize("geom", [(64, 48, 4, 64), (64, 48, 4, 32),
                                  (128, 64, 2, 128), (128, 64, 4, 64),
                                  (96, 32, 3, 96)])
@pytest.mark.parametrize("cands", ["odd", "default"])
def test_motion_select_halo(dev, full, geom, cands):
    """K19 (4:2:0 and 4:4:4) against its plain version and against K5 on
    the whole frame, (H, W, shards, window rows): whole-frame windows over
    2, 3 and 4 shards and windows of two shards each; odd and negative
    vertical candidates, scrolls both ways across the seams."""
    from selkies_tpu_torch.parallel import stripes as ST
    H, W, n, win = geom
    cands = ((0, 0), (3, 0), (-3, 0), (-5, 1), (1, -1), (-1, 2)) \
        if cands == "odd" else TE.scroll_candidates()
    cur, ref, qp = _halo_case(dev, H, W, full, n, H + W + n)
    band = H // n
    vmax = max(abs(dy) for dy, _ in cands)
    halo_c = vmax if full else vmax // 2 + 1
    cband = band if full else band // 2
    bands = [ST.halo_bands(ref[0], band, vmax)] + [
        ST.halo_bands(p, cband, halo_c) for p in ref[1:]]
    if full:
        kern, plain = ST.motion_select_halo444, ST.motion_select_halo444_plain
        k5 = TE.motion_select444
    else:
        kern, plain = ST.motion_select_halo, ST.motion_select_halo_plain
        k5 = TE.motion_select
    got = kern(cur, *bands, qp, cands, win)
    _same(got, plain(cur, *bands, qp, cands, win))
    _same(got, k5(cur, *ref, qp, cands, win))


@pytest.mark.parametrize("full", [False, True])
def test_sharded_frames_on_the_card(dev, full, monkeypatch):
    """The sharded frame entries on the card (kernels) against their
    plain run on the card and the unsharded frame entries: I at 2 and 4
    shards, P with whole windows a shard, P across the halo, and 3 rows
    padded over 2 shards."""
    from selkies_tpu_torch.parallel import stripes as ST
    enc_i = H4.h264_encode_yuv444 if full else HP.h264_encode_yuv
    enc_p = H4.h264_encode_p_yuv444 if full else HP.h264_encode_p_yuv
    H, W = 128, 64
    cdiv = 1 if full else 2
    rng = np.random.default_rng(17)
    planes = [torch.as_tensor(rng.integers(0, 256, s, dtype=np.uint8),
                              device=dev)
              for s in ((H, W), (H // cdiv, W // cdiv),
                        (H // cdiv, W // cdiv))]
    R, M = H // 16, W // 16
    hdr = hcodec.slice_header_events(M, R)
    p_hdr = hcodec.p_slice_header_events(M, R)
    e_cap, w_cap = 10**6, 8192
    ref, rec = enc_i(*planes, 26, *hdr, e_cap, w_cap, want_recon=True)
    cur = [torch.roll(p, 3 if k == 0 or full else 1, 0)
           for k, p in enumerate(planes)]
    cands = TE.scroll_candidates(4, 2)
    for n in (2, 4):
        mesh = ST.stripe_mesh(R, devices=[dev] * n)
        out, rec_k = ST.h264_encode_sharded(*planes, 26, *hdr, e_cap, w_cap,
                                            mesh, fullcolor=full,
                                            want_recon=True)
        _same([out.words, out.total_bits, *rec_k],
              [ref.words, ref.total_bits, *rec])
        for sr in (2, R):
            want, want_rec = enc_p(*cur, *rec, 30, *p_hdr, 1, e_cap, w_cap,
                                   candidates=cands, stripe_rows=sr)
            got, got_rec = ST.h264_encode_p_sharded(
                *cur, *rec, 30, *p_hdr, 1, e_cap, w_cap, mesh,
                candidates=cands, stripe_rows=sr, fullcolor=full)
            with monkeypatch.context() as m:
                m.setattr(ST, "SHARD_OPS", ST.SHARD_PLAIN_OPS)
                pl, pl_rec = ST.h264_encode_p_sharded(
                    *cur, *rec, 30, *p_hdr, 1, e_cap, w_cap, mesh,
                    candidates=cands, stripe_rows=sr, fullcolor=full)
            _same([got.words, got.total_bits, *got_rec],
                  [want.words, want.total_bits, *want_rec])
            _same([got.words, got.total_bits, *got_rec],
                  [pl.words, pl.total_bits, *pl_rec])
    p3 = [p[:48 // cdiv if k else 48] for k, p in enumerate(planes)]
    hdr3 = hcodec.slice_header_events(M, 3)
    want = enc_i(*p3, 26, *hdr3, e_cap, w_cap)
    got = ST.h264_encode_sharded(*p3, 26, *hdr3, e_cap, w_cap,
                                 ST.stripe_mesh(4, [dev] * 2), fullcolor=full)
    _same([got.words, got.total_bits], [want.words, want.total_bits])


@pytest.mark.parametrize("full", [False, True])
def test_sharded_session_on_the_card(dev, full):
    """StripeShardedH264Session at 4 shards on the card against the same
    session on its plain versions and against H264EncoderSession, over
    an IDR, scrolls and typing, with one overflow episode."""
    from selkies_tpu_torch.engine.h264_encoder import (
        H264EncoderSession, StripeShardedH264Session)
    from selkies_tpu_torch.engine.types import CaptureSettings
    from selkies_tpu_torch.ops import _cuda
    kw = dict(capture_width=128, capture_height=128, stripe_height=32,
              output_mode="h264", h264_motion_vrange=4,
              h264_motion_hrange=2, fullcolor=full,
              paint_over_delay_frames=2)
    sh = StripeShardedH264Session(CaptureSettings(**kw, stripe_devices=4),
                                  devices=[dev] * 4)
    pl = StripeShardedH264Session(CaptureSettings(**kw, stripe_devices=4),
                                  devices=[dev] * 4)
    pl._ops = HP.SEAT_PLAIN_OPS if not full else H4.SEAT_PLAIN_OPS_444
    pl._rebuild_steps()
    one = H264EncoderSession(CaptureSettings(**kw), dev)
    assert sh.stripe_devices == 4 and not sh._partial
    f0, _ = _frames(dev, 128, 128)
    typed = torch.roll(f0, 5, 0)
    typed[40:48, 8:40] = 20
    # frame 4 repeats frame 0 as a forced IDR with each shard's buffer cut
    # to 2/3 of frame 0's largest stripe: it overflows, and the doubled
    # buffers hold frame 5's IDR
    frames = [f0, torch.roll(f0, 5, 0), typed, typed, f0, typed]
    before = dict(_cuda.LAUNCHES)
    for i, frame in enumerate(frames):
        if i == 4:
            for s in (sh, pl):
                s._out_cap = 4 * (largest * 2 // 3)
                s._rebuild_steps()
        got = [s.finalize(s.encode(frame, force=i == 4)) for s in (sh, pl)]
        tup = [[(c.stripe_y, c.is_idr, c.payload) for c in g] for g in got]
        if i < 4:
            want = list(one.finalize_stream(one.encode(frame)))
            tup.append([(c.stripe_y, c.is_idr, c.payload) for c in want])
            assert tup[0] == tup[2], i
        if i == 0:
            largest = max(len(c[2]) for c in tup[0])
        assert tup[0] == tup[1], i
        assert (tup[0] == []) == (i == 4) or i == 3, i
        for k in ("_ref_y", "_ref_u", "_ref_v", "_prev", "_sent", "_fnum"):
            assert torch.equal(getattr(sh, k), getattr(pl, k)), k
    assert sh._cap_gen == 1 and all(c.is_idr for c in got[0])
    assert _cuda.LAUNCHES["pack_stream_seats"] - before[
        "pack_stream_seats"] == len(frames)


# ----------------------------------------- K3 and K4 on their edge shapes
#: the K3 / K4 edge frame, shared with the CPU test that pins it to the
#: reference (tests/test_torch_h264_frames.py): 3 MB rows of 45 MBs (720
#: px, not a multiple of K4's 16 warps a block). As a P frame at QP 28
#: against ``ref``: row 0 is unchanged (every MB skipped: the tail skip
#: run only), row 1 changes in its last MB only, and row 2 changes
#: throughout, its bits ending on a word boundary (EDGE_SEED is a seed
#: for which they do)
EDGE_R, EDGE_M, EDGE_QP, EDGE_SEED = 3, 45, 28, 81


def _edge_planes(seed=EDGE_SEED):
    """-> (cur, ref): Y, U, V uint8 planes of the edge frame (numpy)."""
    rng = np.random.default_rng(seed)
    H, W = 16 * EDGE_R, 16 * EDGE_M
    yy, xx = np.mgrid[0:H, 0:W]
    ref = [(40 + 2 * yy + xx // 3) % 256, 100 + xx[::2, ::2] // 4,
           160 - yy[::2, ::2]]
    cur = [p.copy() for p in ref]
    cur[0][16:32, W - 16:] = rng.integers(0, 256, (16, 16))
    cur[0][32:48] = np.where(rng.random((16, W)) < 0.3, 20, cur[0][32:48])
    cur[1][16:24] = np.clip(cur[1][16:24]
                            + rng.integers(-20, 21, (8, W // 2)), 0, 255)
    return ([a.astype(np.uint8) for a in cur],
            [a.astype(np.uint8) for a in ref])


def _k2_plain(dev, planes, ref, qp, intra, tables=HP):
    """K2's plain outputs (lv, cbp, hdr_pay, hdr_nb) on the card: I as one
    stripe, P at zero motion against ``ref`` (``tables``: HP for 4:2:0,
    H4 for 4:4:4)."""
    t = [torch.as_tensor(p, device=dev) for p in planes]
    rf = [torch.as_tensor(p, device=dev) for p in ref]
    R = t[0].shape[0] // 16
    qp = torch.full((R,), qp, dtype=torch.int32, device=dev)
    if intra:
        fn = tables.mb_encode_i_plain if tables is HP \
            else tables.mb_encode_i444_plain
        return fn(*t, qp, torch.ones((1,), dtype=torch.int32, device=dev),
                  R, *rf)
    fn = tables.mb_encode_p_plain if tables is HP \
        else tables.mb_encode_p444_plain
    return fn(*t, qp, torch.ones((R,), dtype=torch.int32, device=dev), *rf,
              None, *[r.clone() for r in rf])


def _row_events(dev, M, R, intra, qp=EDGE_QP):
    """Slice-header rows, row ids and QPs of R rows of M MBs."""
    fn = hcodec.slice_header_events if intra \
        else hcodec.p_slice_header_events
    pay, nb = fn(M, R)
    return (torch.as_tensor(pay.astype(np.int32), device=dev),
            torch.as_tensor(nb.astype(np.int32), device=dev),
            torch.arange(R, dtype=torch.int32, device=dev) % 16,
            torch.full((R,), qp, dtype=torch.int32, device=dev))


def _k3_k4(dev, out, intra, rows=None, e_cap=10 ** 6, w_cap=4096,
           out_cap=1 << 16, qp=EDGE_QP):
    """K3 and K4 against their plain versions on K2's ``out`` (the rows
    ``rows`` of it and of the frame's slice-header rows, as views, as the
    band step hands them over); -> K4's output."""
    R, M = out[0].shape[:2]
    rows = slice(None) if rows is None else rows
    lv, cbp, hp, hn = (t[rows] for t in out)
    ev = HP.cavlc_events(lv, cbp, intra)
    _same(ev, HP.cavlc_events_plain(lv, cbp, intra))
    args = (hp, hn, *ev, *(t[rows] for t in _row_events(dev, M, R, intra,
                                                         qp)),
            intra, e_cap, w_cap, out_cap)
    k = HP.pack_stream(*args)
    _same(k, HP.pack_stream_plain(*args))
    return k


@pytest.mark.parametrize("intra", [True, False])
def test_k3_k4_edge_frame(dev, intra):
    """The edge frame: an all-skip P row, a P row whose last MB is the
    only one coded, a row ending on a word boundary, 45 MBs a row; then
    each row alone as a 1-row band, equal to its row of the frame."""
    cur, ref = _edge_planes()
    out = _k2_plain(dev, cur, ref, EDGE_QP, intra)
    k = _k3_k4(dev, out, intra)
    if not intra:
        coded = (out[3][..., 1] > 0).cpu().numpy()
        assert not coded[0].any()
        assert coded[1].tolist() == [False] * (EDGE_M - 1) + [True]
        assert int(k.total_bits[2]) % 32 == 0
    for r in range(EDGE_R):
        k1 = _k3_k4(dev, out, intra, slice(r, r + 1))
        _same([k1.words[0], k1.total_bits[0]], [k.words[r], k.total_bits[r]])


def _band_frame(dev, W, rows, intra, seed):
    """K2's plain outputs of a desktop-like frame of ``rows`` MB rows and
    width ``W`` with noise patches (I; P against it shifted)."""
    rng = np.random.default_rng(seed)
    H = 16 * rows
    yy, xx = np.mgrid[0:H, 0:W]
    y = (30 + yy + xx // 2) % 256
    y[:, W // 3:W // 2] = rng.integers(0, 256, (H, W // 2 - W // 3))
    planes = [y, 90 + xx[::2, ::2] // 8, 170 - yy[::2, ::2] // 2]
    ref = [np.roll(p, 3, 1) for p in planes]
    return _k2_plain(dev, [p.astype(np.uint8) for p in planes],
                     [p.astype(np.uint8) for p in ref], 24, intra)


@pytest.mark.parametrize("intra", [True, False])
@pytest.mark.parametrize("W", [720, 1008])
@pytest.mark.parametrize("rows", [1, 2, 4, 5])
def test_k3_k4_bands(dev, rows, W, intra):
    """Bands of 1, 2, 4 and 5 MB rows (rows 1.. of a 6-row frame, as
    views) at 45 and 63 MBs a row; K4 also on views of the whole frame's
    K3 output, whose nb rows start off 16-byte boundaries."""
    out = _band_frame(dev, W, 6, intra, rows)
    band = slice(1, 1 + rows)
    _k3_k4(dev, out, intra, band, qp=24)
    lv, cbp, hp, hn = out
    ev = HP.cavlc_events(lv, cbp, intra)
    M = W // 16
    args = (hp[band], hn[band], ev[0][band], ev[1][band],
            *(t[band] for t in _row_events(dev, M, 6, intra, 24)), intra,
            10 ** 6, 4096, 1 << 16)
    _same(HP.pack_stream(*args), HP.pack_stream_plain(*args))


@pytest.mark.parametrize("intra", [True, False])
def test_k3_k4_escapes_at_qp0_on_noise(dev, intra):
    """Noise at QP 0, 120 MBs a row: 28-bit level escapes, rows of over
    8192 words, at the stock 1080p w_cap (which some rows overflow) and
    at one they fit. (The blocks' shares of a row past K4's shared words
    are test_k4_block_shares_past_its_shared_words'.)"""
    rng = np.random.default_rng(7)
    H, W = 32, 1920
    planes = [rng.integers(0, 256, s, dtype=np.uint8)
              for s in ((H, W), (H // 2, W // 2), (H // 2, W // 2))]
    ref = [rng.integers(0, 256, p.shape, dtype=np.uint8) for p in planes]
    out = _k2_plain(dev, planes, ref, 0, intra)
    ev = HP.cavlc_events(out[0], out[1], intra)
    assert int(ev[1].max()) == 28
    for w_cap in (23040, 1 << 16):
        k = _k3_k4(dev, out, intra, w_cap=w_cap, out_cap=1 << 20, qp=0)
        assert int(k.total_bits.max()) > 8192 * 32
    assert int(k.flags[0]) == 0


#: pack_stream.cu: the words a block keeps in shared memory (kWords),
#: the blocks a row at most (kMaxRank), the MBs a block at most (kMaxMBs)
K4_WORDS, K4_MAX_RANK, K4_MAX_MBS = 2048, 8, 132


def _ue_bits(v):
    return 2 * (int(v) + 1).bit_length() - 1


def _rank_starts(hn, en, total, intra, P):
    """The bit where each of P blocks' MBs start in a row (and the row's
    end), from the row's header and slot bit counts (numpy, (M, 6) and
    (M, SB)) and its total bits: the row prefix, then each MB with the
    skip run before it (P), then the tail skip run and the stop bit."""
    M = hn.shape[0]
    bits = hn.sum(1).astype(np.int64) + en.sum(1).astype(np.int64)
    tail = 0
    if not intra:
        prev = -1
        for m in np.flatnonzero(hn[:, 1] > 0):
            bits[m] += _ue_bits(m - prev - 1)
            prev = m
        tail = _ue_bits(M - 1 - prev) if M - 1 - prev > 0 else 0
    prefix = total - int(bits.sum()) - tail - 1
    Mb = -(-M // P)
    cum = np.concatenate([[0], np.cumsum(bits)])
    return [0] + [prefix + int(cum[min(k * Mb, M)]) for k in range(1, P)] \
        + [total]


@pytest.mark.parametrize("intra", [True, False])
def test_k4_block_shares_past_its_shared_words(dev, intra):
    """One 3840 px row of noise at QP 0 (a one-row band: 8 blocks of 30
    MBs, whatever the card's SM count): every block but the last packs
    over 2048 words, so its words past its shared buffer take global
    atomics, and a block whose first bit lies inside a word hands that
    word to a block whose shared buffer it lies past."""
    rng = np.random.default_rng(5)
    H, W = 16, 3840
    planes = [rng.integers(0, 256, s, dtype=np.uint8)
              for s in ((H, W), (H // 2, W // 2), (H // 2, W // 2))]
    ref = [rng.integers(0, 256, p.shape, dtype=np.uint8) for p in planes]
    out = _k2_plain(dev, planes, ref, 0, intra)
    k = _k3_k4(dev, out, intra, w_cap=1 << 16, out_cap=1 << 19, qp=0)
    ev = HP.cavlc_events(out[0], out[1], intra)
    starts = _rank_starts(out[3][0].cpu().numpy(), ev[1][0].cpu().numpy(),
                          int(k.total_bits[0]), intra, K4_MAX_RANK)
    shares = np.diff(starts)
    assert shares[:-1].min() > 32 * (K4_WORDS + 1)
    assert any(b % 32 for b in starts[1:-1])
    assert int(k.total_bits[0]) < 32 * (1 << 16)


def _k4_both_entries(args, intra, n_seats, w_cap=1 << 16, out_cap=1 << 18):
    """K4's frame and seat entries on ``args``, each equal to its plain
    version (tolerance 0)."""
    a = (*args, intra, 10 ** 6, w_cap, out_cap)
    _same(HP.pack_stream(*a), HP.pack_stream_plain(*a))
    _same(HP.pack_stream_seats(*a, n_seats=n_seats),
          HP.pack_stream_seats_plain(*a, n_seats=n_seats))


@pytest.mark.parametrize("intra", [True, False])
def test_k3_k4_at_3840(dev, intra):
    """4:2:0 at 3840 px (240 MBs a row), 4 rows: K3, then K4 through both
    entries (the frame, and its rows as two seats)."""
    out = _band_frame(dev, 3840, 4, intra, 9)
    lv, cbp, hp, hn = out
    ev = HP.cavlc_events(lv, cbp, intra)
    _same(ev, HP.cavlc_events_plain(lv, cbp, intra))
    _k4_both_entries((hp, hn, *ev, *_row_events(dev, 240, 4, intra, 24)),
                     intra, 2)


@pytest.mark.parametrize("intra", [True, False])
def test_k16_k4_444_at_3840(dev, intra):
    """4:4:4 at 3840 px (240 MBs a row, 1740 / 1728 slots an MB: the row's
    nb is over 8 blocks' preferred share of shared memory), 4 rows: K16,
    then K4 through both entries."""
    rng = np.random.default_rng(12)
    H, W = 64, 3840
    planes = [rng.integers(0, 256, (H, W), dtype=np.uint8)
              for _ in range(3)]
    for p in planes:
        p[:, :2000] = 128 + (np.arange(2000) // 64) % 8
    ref = [np.roll(p, 2, 1) for p in planes]
    lv, cbp, hp, hn = _k2_plain(dev, planes, ref, 22, intra, H4)
    ev = H4.cavlc_events444(lv, cbp, intra)
    _same(ev, H4.cavlc_events444_plain(lv, cbp, intra))
    _k4_both_entries((hp, hn, *ev, *_row_events(dev, 240, 4, intra, 22)),
                     intra, 2)


@pytest.mark.parametrize("intra", [True, False])
@pytest.mark.parametrize("tables", [HP, H4], ids=["420", "444"])
@pytest.mark.parametrize("mb_w", [240, 480, 1056])
def test_pack_stream_wide_rows(dev, mb_w, tables, intra):
    """Rows of 240, 480 and 1056 MBs (3840, 7680 and 16896 px, the last
    past the widest row H.264 allows) at 4:2:0's and 4:4:4's slot counts,
    random slot events, through both K4 entries: each block's nb
    resident two blocks an SM, one block an SM, and (4:4:4 at 1056 MBs)
    read from device memory. Seat 0's last row spills off the seat."""
    args = _seat_pack_inputs(dev, np.random.default_rng(mb_w), 2, 2, mb_w,
                             intra, tables)
    _k4_both_entries(args, intra, 2)


def test_pack_stream_refuses_rows_past_its_widest(dev):
    """A row of 8 * 132 + 1 MBs is refused: the wrapper raises."""
    args = _seat_pack_inputs(dev, np.random.default_rng(1), 1, 1,
                             K4_MAX_RANK * K4_MAX_MBS + 1, True)
    with pytest.raises(RuntimeError, match="pack_stream"):
        HP.pack_stream(*args, True, 10 ** 6, 1 << 16, 1 << 16)


def test_pack_stream_e_cap_overflow_alone(dev):
    """More events than e_cap in rows that fit their words: flag 0 set,
    everything else as the plain version's."""
    cur, ref = _edge_planes()
    out = _k2_plain(dev, cur, ref, EDGE_QP, True)
    k = _k3_k4(dev, out, True, e_cap=200)
    assert k.flags.tolist() == [1, 0]
    assert int(k.total_bits.max()) <= 4096 * 32


@pytest.mark.parametrize("intra", [True, False])
def test_pack_stream_out_cap_at_the_total(dev, intra):
    """out_cap exactly the stream's bytes (flag 1 clear) and one byte
    less (set); neither a multiple of 16."""
    cur, ref = _edge_planes()
    out = _k2_plain(dev, cur, ref, EDGE_QP, intra)
    total = int(_k3_k4(dev, out, intra).byte_lens.sum())
    for cap, flag in ((total, 0), (total - 1, 1)):
        k = _k3_k4(dev, out, intra, out_cap=cap)
        assert int(k.flags[1]) == flag


def _spill_inputs(dev, rng, n_seats, rows, mb_w, intra):
    """K4 seat inputs whose first and last rows of every seat carry
    ~20 bits a slot: with a small w_cap the first row spills into the
    second and the last one off the seat's end."""
    args = list(_seat_pack_inputs(dev, rng, n_seats, rows, mb_w, intra))
    nb = args[3].clone()
    big = nb.view(n_seats, rows, mb_w, -1)
    big[:, 0] = 20
    big[:, -1] = 20
    pay = torch.as_tensor(rng.integers(0, 1 << 20, nb.shape).astype(
        np.int32), device=dev) & ((1 << nb.to(torch.int32)) - 1)
    args[2], args[3] = pay, nb
    return args


@pytest.mark.parametrize("n_seats", [1, 3, 8])
@pytest.mark.parametrize("intra", [True, False])
def test_pack_stream_spills_into_the_next_row_and_off_the_seat(
        dev, n_seats, intra):
    rows, mb_w = 3, 5
    args = _spill_inputs(dev, np.random.default_rng(60 + n_seats), n_seats,
                         rows, mb_w, intra)
    w_cap = 2048
    a = (*args, intra, 10 ** 6, w_cap, 1 << 16)
    k = HP.pack_stream_seats(*a, n_seats=n_seats)
    _same(k, HP.pack_stream_seats_plain(*a, n_seats=n_seats))
    tb = k.total_bits.view(n_seats, rows)
    assert bool((tb[:, 0] > w_cap * 32).all())
    assert bool((tb[:, -1] > w_cap * 32).all())
    assert bool((tb[:, 1] <= w_cap * 32).all())
    assert k.flags[:, 0].tolist() == [1] * n_seats
    if n_seats == 1:
        one = (*(x[:rows] for x in args), intra, 10 ** 6, w_cap, 1 << 16)
        _same(HP.pack_stream(*one), HP.pack_stream_plain(*one))


@pytest.mark.parametrize("intra", [True, False])
def test_k16_and_k4_at_444_slot_counts_odd_width(dev, intra):
    """4:4:4 at 45 MBs a row: K16 equal to its plain version, and K4
    through both entries (the frame, and its rows as two seats) at the
    1740 / 1728 slot counts."""
    rng = np.random.default_rng(11)
    H, W = 32, 720
    planes = [rng.integers(0, 256, (H, W), dtype=np.uint8)
              for _ in range(3)]
    planes[0][:, :300] = 128
    ref = [np.roll(p, 2, 1) for p in planes]
    lv, cbp, hp, hn = _k2_plain(dev, planes, ref, 22, intra, H4)
    ev = H4.cavlc_events444(lv, cbp, intra)
    _same(ev, H4.cavlc_events444_plain(lv, cbp, intra))
    args = (hp, hn, *ev, *_row_events(dev, 45, 2, intra, 22), intra,
            10 ** 6, 4096, 1 << 16)
    _same(HP.pack_stream(*args), HP.pack_stream_plain(*args))
    _same(HP.pack_stream_seats(*args, n_seats=2),
          HP.pack_stream_seats_plain(*args, n_seats=2))


@pytest.mark.parametrize("intra", [True, False])
def test_k3_k4_at_1080p(dev, intra):
    """A 1080p frame (68 rows of 120 MBs) through K3 and K4 at the stock
    caps, kernel == plain."""
    out = _band_frame(dev, 1920, 68, intra, 3)
    _k3_k4(dev, out, intra, w_cap=23040, out_cap=345600, qp=24)


# ------------------------------------------------ K16 and K5 (redesigned)
def _k16_case(dev, rng, R, M, intra, cbp=None, level_max=3):
    """Synthetic K16 inputs: sparse random levels and cbp (I: the AC flag
    and chroma bits, P: random 8x8 group bits unless ``cbp`` is given)."""
    nb = 51 if intra else 48
    lv = rng.integers(-level_max, level_max + 1, (R, M, nb, 16))
    lv *= rng.random((R, M, nb, 16)) < 0.3
    if cbp is None:
        cbp = rng.integers(0, 48, (R, M))
    return (torch.as_tensor(lv.astype(np.int16), device=dev),
            torch.as_tensor(np.asarray(cbp, np.int32), device=dev))


def _k16_same(lv, cbp, intra):
    ev = H4.cavlc_events444(lv, cbp, intra)
    _same(ev, H4.cavlc_events444_plain(lv, cbp, intra))
    return ev


@pytest.mark.parametrize("intra", [True, False])
@pytest.mark.parametrize("M", [1, 45, 63])
def test_k16_blocks_across_row_starts(dev, M, intra):
    """Rows of 1, 45 and 63 MBs (not multiples of K16's 4 MBs a block):
    a block spans a row start and must not take the MB before it as its
    left neighbour."""
    rng = np.random.default_rng(100 + M)
    lv, cbp = _k16_case(dev, rng, 5, M, intra)
    _k16_same(lv, cbp, intra)


@pytest.mark.parametrize("intra", [True, False])
def test_k16_escapes_at_qp0_on_noise(dev, intra):
    """4:4:4 noise at QP 0 through K14 / K15: 28-bit level escapes."""
    rng = np.random.default_rng(21)
    H, W = 32, 720
    planes = [rng.integers(0, 256, (H, W), dtype=np.uint8)
              for _ in range(3)]
    ref = [rng.integers(0, 256, (H, W), dtype=np.uint8) for _ in range(3)]
    lv, cbp, _, _ = _k2_plain(dev, planes, ref, 0, intra, H4)
    ev = _k16_same(lv, cbp, intra)
    assert int(ev[1].max()) == 28


def test_k16_p_gates_each_group_bit_alone(dev):
    """P rows whose MBs have every 8x8 group gated off, then each group
    bit alone, then all four (levels everywhere, so a gated-off block
    that leaked would show)."""
    rng = np.random.default_rng(31)
    M = 45
    cbp = np.zeros((6, M), np.int32)
    for g in range(4):
        cbp[1 + g] = 1 << g
    cbp[5] = 15 | 32
    lv, cbp = _k16_case(dev, rng, 6, M, False, cbp)
    ev = _k16_same(lv, cbp, False)
    assert int(ev[1][0].sum()) == 0


@pytest.mark.parametrize("intra", [True, False])
@pytest.mark.parametrize("W", [720, 1008])
@pytest.mark.parametrize("rows", [1, 2, 4, 5])
def test_k16_bands_as_views(dev, rows, W, intra):
    """Bands of 1, 2, 4 and 5 MB rows (rows 1.. of a 6-row 4:4:4 frame,
    as views, as the band step hands them over) at 45 and 63 MBs a row,
    each equal to its rows of the whole frame's events."""
    rng = np.random.default_rng(rows * W)
    lv, cbp = _k16_case(dev, rng, 6, W // 16, intra)
    whole = _k16_same(lv, cbp, intra)
    band = slice(1, 1 + rows)
    ev = _k16_same(lv[band], cbp[band], intra)
    _same(ev, [t[band] for t in whole])


def test_k9_refuses_misaligned_payload(dev):
    """16-byte payload pieces: a payload off a 16-byte boundary raises."""
    pay, nb = _pack_events(dev, 2, 8, "sparse")
    flat = torch.zeros(pay.numel() + 4, dtype=torch.int32, device=dev)
    off = flat[1:1 + pay.numel()].view(pay.shape)
    off.copy_(pay)
    with pytest.raises(RuntimeError, match="jpeg_pack"):
        JPP.jpeg_pack(off, nb, 512, 64, 4096)


def test_k16_refuses_misaligned_levels(dev):
    """16-byte staging: a level array off a 16-byte boundary raises."""
    rng = np.random.default_rng(3)
    lv, cbp = _k16_case(dev, rng, 2, 3, True)
    flat = torch.zeros(lv.numel() + 8, dtype=torch.int16, device=dev)
    off = flat[4:4 + lv.numel()].view(lv.shape)
    off.copy_(lv)
    with pytest.raises(RuntimeError, match="cavlc_events444"):
        H4.cavlc_events444(off, cbp, True)


def _k5_entries(dev, cur, ref, qp, cands, win, full):
    """K5 (or its 4:4:4 entry) against its plain version, then K19 on two
    shards' halo bands of the same reference (one for an odd number of
    MB rows) against its plain version and against K5 (tolerance 0).
    -> K5's outputs."""
    from selkies_tpu_torch.parallel import stripes as ST
    k5, p5 = (TE.motion_select444, TE.motion_select444_plain) if full \
        else (TE.motion_select, TE.motion_select_plain)
    got = k5(cur, *ref, qp, cands, win)
    _same(got, p5(cur, *ref, qp, cands, win))
    H = cur.shape[0]
    band = H // (2 - (H // 16) % 2)
    vmax = max(abs(dy) for dy, _ in cands)
    halo_c = vmax if full else vmax // 2 + 1
    bands = [ST.halo_bands(ref[0], band, vmax)] + [
        ST.halo_bands(p, band if full else band // 2, halo_c)
        for p in ref[1:]]
    kern, plain = (ST.motion_select_halo444, ST.motion_select_halo444_plain) \
        if full else (ST.motion_select_halo, ST.motion_select_halo_plain)
    hg = kern(cur, *bands, qp, cands, win)
    _same(hg, plain(cur, *bands, qp, cands, win))
    _same(hg, got)
    return got


def _k5_frame(dev, H, W, full, seed, qp=None):
    """Random reference planes; the current luma scrolled by 3 rows on
    the left half, by -5 rows and 2 columns on the right, noise in its
    second MB column (when it has one)."""
    rng = np.random.default_rng(seed)
    c = 1 if full else 2
    ref = [torch.as_tensor(rng.integers(0, 256, s, dtype=np.uint8),
                           device=dev)
           for s in ((H, W), (H // c, W // c), (H // c, W // c))]
    cur = torch.roll(ref[0], -3, 0)
    cur[:, W // 2:] = torch.roll(ref[0], (5, -2), (0, 1))[:, W // 2:]
    if W > 16:
        cur[:, 16:32] = torch.as_tensor(
            rng.integers(0, 256, (H, 16), dtype=np.uint8), device=dev)
    if qp is None:
        qp = rng.integers(0, 52, H // 16)
    return cur.contiguous(), ref, torch.as_tensor(
        np.asarray(qp, np.int32), device=dev)


def _wide_candidates(n, seed=13):
    """(0, 0), the four extremes at 64 and distinct random (dy, dx) with
    |dy|, |dx| <= 64: ``n`` candidates."""
    rng = np.random.default_rng(seed)
    c = [(0, 0), (64, 0), (-64, 0), (0, 64), (0, -64), (-64, 64)][:n]
    while len(c) < n:
        d = tuple(int(v) for v in rng.integers(-64, 65, 2))
        if d not in c:
            c.append(d)
    return tuple(c)


@pytest.mark.parametrize("full", [False, True])
@pytest.mark.parametrize("shape,ncand,win", [((288, 1008), 57, 32),
                                             ((1088, 1008), 57, 64),
                                             ((1408, 720), 57, 64),
                                             ((1088, 1056), 128, 1088)])
def test_k5_rows_not_a_multiple_of_the_blocks_mbs(dev, shape, ncand, win,
                                                  full):
    """Rows of 63 and 45 MBs at 2 and 4 MB columns a block (the launch
    policy's choice for these shapes on a 132-SM H100), so each row's
    last block is short; a whole-frame window of 68 MB rows (K5) and two
    shards of 34 (K19) cut into row groups of 4 and 5 rows, with 128
    candidates; all four entries."""
    H, W = shape
    cands = TE.scroll_candidates() if ncand == 57 \
        else _wide_candidates(ncand)
    cur, ref, qp = _k5_frame(dev, H, W, full, H + W + ncand)
    got = _k5_entries(dev, cur, ref, qp, cands, win, full)
    assert bool((got[3] != 0).any())


@pytest.mark.parametrize("full", [False, True])
@pytest.mark.parametrize("win", [16, 64])
@pytest.mark.parametrize("ncand", [1, 57, 128])
def test_k5_width_16_and_16_row_windows(dev, ncand, win, full):
    """W = 16 (one MB a row: both width clamps at once), 16- and 64-row
    windows, 1, 57 and 128 candidates (|dy| and |dx| up to 64)."""
    cands = {1: ((-5, 3),), 57: TE.scroll_candidates()}.get(
        ncand) or _wide_candidates(ncand)
    cur, ref, qp = _k5_frame(dev, 64, 16, full, ncand + win)
    _k5_entries(dev, cur, ref, qp, cands, win, full)


@pytest.mark.parametrize("full", [False, True])
def test_k5_flat_frame_ties(dev, full):
    """Every SAD equal: the lambda decides, then the lowest index (three
    candidates of 8 bits; at QP 0 the lambda is 0 and index 0 wins)."""
    H, W = 64, 96
    c = 1 if full else 2
    ref = [torch.full(s, 128, dtype=torch.uint8, device=dev)
           for s in ((H, W), (H // c, W // c), (H // c, W // c))]
    cur = torch.full((H, W), 131, dtype=torch.uint8, device=dev)
    cands = ((4, 0), (0, 1), (0, -1), (1, 0))
    qp = torch.as_tensor(np.array([0, 28, 51, 12], np.int32), device=dev)
    got = _k5_entries(dev, cur, ref, qp, cands, 32, full)
    mv = got[3].cpu().numpy()
    assert (mv[0] == [0, 16]).all()                  # (4, 0), index 0
    assert (mv[1:] == [4, 0]).all()                  # (0, 1), index 1


@pytest.mark.parametrize("full", [False, True])
@pytest.mark.parametrize("order", [1, -1])
def test_k5_exact_tie_of_two_vectors(dev, full, order):
    """A reference of period 6 rows and the frame scrolled by 3: (3, 0)
    and (-3, 0) both match exactly at equal bits, so the lower index of
    the two wins (either order)."""
    H, W = 128, 64
    rng = np.random.default_rng(8)
    c = 1 if full else 2
    per = rng.integers(0, 256, (6, W), dtype=np.uint8)
    ry = np.tile(per, (H // 6 + 1, 1))[:H]
    ref = [torch.as_tensor(ry, device=dev)] + [
        torch.as_tensor(rng.integers(0, 256, (H // c, W // c),
                                     dtype=np.uint8), device=dev)
        for _ in range(2)]
    cur = torch.as_tensor(np.roll(ry, -3, 0).copy(), device=dev)
    cands = ((0, 0), (3 * order, 0), (-3 * order, 0))
    qp = torch.full((H // 16,), 30, dtype=torch.int32, device=dev)
    got = _k5_entries(dev, cur, ref, qp, cands, H, full)
    mvy = got[3][2:-2, :, 1].cpu().numpy()
    assert (mvy == 12 * order).all()


@pytest.mark.parametrize("full", [False, True])
def test_k5_qp_at_and_out_of_its_range(dev, full):
    """Per-row qp at 0 and 51 and out of range (clipped to 0 .. 51)."""
    qp = [0, 51, -7, 60, 1000, -1000, 25, 51]
    cur, ref, qp = _k5_frame(dev, 128, 96, full, 4, qp)
    _k5_entries(dev, cur, ref, qp, TE.scroll_candidates(), 32, full)


def test_k5_refuses_misaligned_planes(dev):
    """16-byte loads and stores: a luma plane off a 16-byte boundary
    raises."""
    cur, ref, qp = _k5_frame(dev, 64, 64, False, 2)
    flat = torch.zeros(cur.numel() + 8, dtype=torch.uint8, device=dev)
    off = flat[4:4 + cur.numel()].view(cur.shape)
    off.copy_(cur)
    with pytest.raises(RuntimeError, match="motion_select"):
        TE.motion_select(off, *ref, qp, TE.scroll_candidates(), 32)


# ---------------------------------------------------------------- K2-I
def _k2i_planes(dev, H, W, kind, seed, offset=0, cdiv=2):
    """Y, U, V of ``kind`` (noise, zero, max, binary), each ``offset``
    bytes into its storage (0: fresh tensors); chroma H/cdiv x W/cdiv."""
    rng = np.random.default_rng(seed)
    out = []
    for h, w in ((H, W), (H // cdiv, W // cdiv), (H // cdiv, W // cdiv)):
        if kind == "noise":
            a = rng.integers(0, 256, (h, w), dtype=np.uint8)
        elif kind == "binary":
            a = (rng.integers(0, 2, (h, w)) * 255).astype(np.uint8)
        else:
            a = np.full((h, w), 0 if kind == "zero" else 255, np.uint8)
        t = torch.as_tensor(a, device=dev)
        if offset:
            flat = torch.zeros(h * w + offset, dtype=torch.uint8, device=dev)
            view = flat[offset:].view(h, w)
            view.copy_(t)
            t = view
        out.append(t)
    return out


def _k2i_same(dev, planes, qp, send, rps, offset=0, seed=1, cdiv=2):
    """K2-I (K14 with ``cdiv`` 1) against plain on reference planes that
    start as noise (rows of unsent stripes must keep it), levels, cbp,
    headers and the whole reference planes at tolerance 0."""
    base = _k2i_planes(dev, planes[0].shape[0], planes[0].shape[1],
                       "noise", seed, offset, cdiv)
    kref = [b.clone() if not offset else b for b in base]
    pref = [b.clone() for b in base]
    before = [b.clone() for b in pref]
    kern, plain = ((HP.mb_encode_i, HP.mb_encode_i_plain) if cdiv == 2
                   else (H4.mb_encode_i444, H4.mb_encode_i444_plain))
    ko = kern(*planes, qp, send, rps, *kref)
    po = plain(*planes, qp, send, rps, *pref)
    _same(list(ko) + kref, list(po) + pref)
    rows = send.repeat_interleave(rps) == 0
    for k, b, c in zip(kref, before, (1, cdiv, cdiv)):
        unsent = rows.repeat_interleave(16 // c)
        assert torch.equal(k[unsent].cpu(), b[unsent].cpu())
    return ko


def _qp_rows(dev, R, mode, seed=3):
    if mode == "rows":
        rng = np.random.default_rng(seed)
        q = rng.permutation(52)[np.arange(R) % 52].astype(np.int32)
        return torch.as_tensor(q, device=dev)
    return torch.full((R,), int(mode), dtype=torch.int32, device=dev)


@pytest.mark.parametrize("kind", ["noise", "zero", "max", "binary"])
@pytest.mark.parametrize("qp", ["0", "51", "rows"])
def test_mb_encode_i_levels_clamp_and_edges_clip(dev, kind, qp):
    """K2-I at qp 0 and 51 and a different qp on every row, on all-0,
    all-255, noise and black-and-white frames (DC levels at LEVEL_CLAMP,
    edges clipped at 0 and 255), every other stripe sent."""
    H, W, rps = 128, 128, 2
    planes = _k2i_planes(dev, H, W, kind, 5)
    q = _qp_rows(dev, H // 16, qp)
    send = (torch.arange(H // 16 // rps, device=dev) % 2 == 0).to(
        torch.int32)
    lv = _k2i_same(dev, planes, q, send, rps)[0]
    if kind in ("zero", "max") and qp == "0":
        assert int(lv[:, :, 0].abs().max()) == 2000


@pytest.mark.parametrize("geom", [(16, 16), (16, 80), (48, 208), (32, 96),
                                  (64, 1920), (16, 2000)])
@pytest.mark.parametrize("gate", ["on", "off", "mixed"])
def test_mb_encode_i_row_widths_and_send_gates(dev, geom, gate):
    """K2-I at M = 1, 5 (odd), 13, 6 (not multiples of the 4 MBs a tile),
    120 and 125, R = 1 to 4, with the send gates all on, all off and
    mixed (unsent reference rows untouched)."""
    H, W = geom
    R = H // 16
    rps = 1 if R < 4 else 2
    planes = _k2i_planes(dev, H, W, "noise", W)
    S = R // rps
    send = {"on": torch.ones(S, dtype=torch.int32, device=dev),
            "off": torch.zeros(S, dtype=torch.int32, device=dev),
            "mixed": (torch.arange(S, device=dev) % 2).to(torch.int32)}[gate]
    _k2i_same(dev, planes, _qp_rows(dev, R, "rows", W), send, rps)


@pytest.mark.parametrize("offset", [1, 4, 8])
@pytest.mark.parametrize("geom", [(64, 128), (32, 80)])
def test_mb_encode_i_on_unaligned_planes(dev, offset, geom):
    """K2-I on planes and references that start ``offset`` bytes into
    their storage (the instantiation for planes off 16 bytes)."""
    H, W = geom
    planes = _k2i_planes(dev, H, W, "noise", 9, offset)
    send = torch.tensor([1, 0], dtype=torch.int32, device=dev)
    _k2i_same(dev, planes, _qp_rows(dev, H // 16, "rows"), send,
              H // 16 // 2, offset=offset)


@pytest.mark.parametrize("seats", [1, 4])
def test_mb_encode_i_at_1080p_and_on_stacked_seats(dev, seats):
    """K2-I on 1, and 4 stacked, 1920x1088 frames (68 and 272 MB rows:
    fewer blocks a row where the rows would not fit one wave), qp mixed
    by row, every other stripe sent."""
    H, W, rps = 1088 * seats, 1920, 4
    planes = _k2i_planes(dev, H, W, "noise", 17)
    qp = torch.full((H // 16,), 25, dtype=torch.int32, device=dev)
    qp[::3] = 10
    send = (torch.arange(H // 16 // rps, device=dev) % 2 == 0).to(
        torch.int32)
    _k2i_same(dev, planes, qp, send, rps)


# ---------------------------------------------------------------- K6
def _k6_same(frame, prev, R):
    got = HP.row_damage_probe(frame, prev, R)
    _same([got], [HP.row_damage_probe_plain(frame, prev, R)])
    return got


def _k6_frame(dev, H, W, seed, offset=0):
    rng = np.random.default_rng(seed)
    a = torch.as_tensor(rng.integers(0, 256, (H, W, 3), dtype=np.uint8),
                        device=dev)
    if offset:
        flat = torch.zeros(H * W * 3 + offset, dtype=torch.uint8, device=dev)
        view = flat[offset:].view(H, W, 3)
        view.copy_(a)
        a = view
    return a


@pytest.mark.parametrize("geom", [(16, 40, 1), (1088, 1920, 68),
                                  (1088, 1920, 17), (4 * 1088, 1920, 68),
                                  (2160, 3840, 135), (64, 54, 4),
                                  (5, 7, 5), (48, 18, 3)])
@pytest.mark.parametrize("offset", [0, 1, 3])
def test_row_damage_probe_bands_and_bases(dev, geom, offset):
    """K6 at R = 1, 68 MB rows, 17 JPEG stripes, 4 stacked seats' 68
    stripes, 135 MB rows at 3840x2160, widths whose rows are not 16-byte
    multiples (W = 54, 7, 18), on frames 0, 1 and 3 bytes into their
    storage: an idle frame (all 0), a fully damaged one (all 1) and one
    damaged band in three."""
    H, W, R = geom
    prev = _k6_frame(dev, H, W, 1, offset)
    frame = _k6_frame(dev, H, W, 1, offset)
    assert int(_k6_same(frame, prev, R).sum()) == 0
    full = _k6_frame(dev, H, W, 2, offset)
    full.copy_(255 - prev)
    assert int(_k6_same(full, prev, R).sum()) == R
    band = H // R
    for r in range(0, R, 3):
        frame[r * band + band // 2, W // 2, 1] ^= 0x40
    got = _k6_same(frame, prev, R)
    assert got.cpu().tolist() == [int(r % 3 == 0) for r in range(R)]


@pytest.mark.parametrize("geom", [(1088, 1920, 68), (1088, 1920, 17),
                                  (64, 54, 4), (48, 18, 3)])
def test_row_damage_probe_one_byte_at_band_and_piece_edges(dev, geom):
    """One differing byte at the first and the last byte of each band,
    and on both sides of a 16-byte piece boundary inside it: exactly that
    band flagged."""
    H, W, R = geom
    prev = _k6_frame(dev, H, W, 4)
    band = 3 * W * (H // R)
    for r in range(R):
        for k in (0, band - 1, 15, 16, band // 2 - 1, band // 2):
            frame = prev.clone()
            frame.view(-1)[r * band + k] ^= 1
            got = _k6_same(frame, prev, R)
            assert got.cpu().tolist() == [int(i == r) for i in range(R)]
            if R > 8 and r not in (0, R // 2, R - 1):
                break


def test_row_damage_probe_on_two_streams(dev):
    """K6 launches alternating between two streams (its bands' tickets are
    shared module state, so the second waits for the first), on frames
    large enough for many blocks a band: every launch's flags equal the
    plain version's."""
    H, W, R = 1088, 1920, 68
    prev = _k6_frame(dev, H, W, 6)
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    outs = []
    for k in range(8):
        frame = prev.clone()
        frame.view(-1)[(k * 977) % (H // R * W * 3) + (k % R) * (H // R)
                       * W * 3] ^= 1
        streams[k % 2].wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(streams[k % 2]):
            outs.append((frame, HP.row_damage_probe(frame, prev, R)))
    torch.cuda.synchronize()
    for frame, got in outs:
        _same([got], [HP.row_damage_probe_plain(frame, prev, R)])
        assert int(got.sum()) == 1


# ---------------------------------------------------------------- K14
@pytest.mark.parametrize("kind", ["noise", "zero", "max", "binary"])
@pytest.mark.parametrize("qp", ["0", "51", "rows"])
def test_mb_encode_i444_levels_clamp_and_edges_clip(dev, kind, qp):
    """K14 at qp 0 and 51 and a different qp on every row (Cb and Cr at
    K_QPC of it), on all-0, all-255, noise and black-and-white planes (DC
    levels at LEVEL_CLAMP, edges clipped at 0 and 255), every other
    stripe sent."""
    H, W, rps = 128, 128, 2
    planes = _k2i_planes(dev, H, W, kind, 5, cdiv=1)
    q = _qp_rows(dev, H // 16, qp)
    send = (torch.arange(H // 16 // rps, device=dev) % 2 == 0).to(
        torch.int32)
    lv = _k2i_same(dev, planes, q, send, rps, cdiv=1)[0]
    if kind in ("zero", "max") and qp == "0":
        assert int(lv[:, :, 0].abs().max()) == 2000


@pytest.mark.parametrize("geom", [(16, 16), (16, 80), (48, 128), (32, 208),
                                  (64, 1920), (16, 2000)])
@pytest.mark.parametrize("gate", ["on", "off", "mixed"])
def test_mb_encode_i444_row_widths_and_send_gates(dev, geom, gate):
    """K14 at M = 1, 5 (odd), 8, 13 (not a multiple of the 4 MBs a tile,
    nor of the records grid's 16), 120 and 125, R = 1 to 4, with the send
    gates all on, all off and mixed (unsent reference rows untouched)."""
    H, W = geom
    R = H // 16
    rps = 1 if R < 4 else 2
    planes = _k2i_planes(dev, H, W, "noise", W, cdiv=1)
    S = R // rps
    send = {"on": torch.ones(S, dtype=torch.int32, device=dev),
            "off": torch.zeros(S, dtype=torch.int32, device=dev),
            "mixed": (torch.arange(S, device=dev) % 2).to(torch.int32)}[gate]
    _k2i_same(dev, planes, _qp_rows(dev, R, "rows", W), send, rps, cdiv=1)


@pytest.mark.parametrize("offset", [1, 4, 8])
@pytest.mark.parametrize("geom", [(64, 128), (32, 80)])
def test_mb_encode_i444_on_unaligned_planes(dev, offset, geom):
    """K14 on planes and references that start ``offset`` bytes into
    their storage (the instantiations for planes off 16 bytes)."""
    H, W = geom
    planes = _k2i_planes(dev, H, W, "noise", 9, offset, cdiv=1)
    send = torch.tensor([1, 0], dtype=torch.int32, device=dev)
    _k2i_same(dev, planes, _qp_rows(dev, H // 16, "rows"), send,
              H // 16 // 2, offset=offset, cdiv=1)


@pytest.mark.parametrize("seats", [1, 4])
def test_mb_encode_i444_at_1080p_and_on_stacked_frames(dev, seats):
    """K14 on 1, and 4 stacked, 1920x1088 frames (68 and 272 MB rows), qp
    mixed by row, every other stripe sent."""
    H, W, rps = 1088 * seats, 1920, 4
    planes = _k2i_planes(dev, H, W, "noise", 17, cdiv=1)
    qp = torch.full((H // 16,), 25, dtype=torch.int32, device=dev)
    qp[::3] = 10
    send = (torch.arange(H // 16 // rps, device=dev) % 2 == 0).to(
        torch.int32)
    _k2i_same(dev, planes, qp, send, rps, cdiv=1)


# ---------------------------------------------------------------- K13
def _k13_same(frame, prev, S):
    """K13 against its plain version on copies of ``prev`` (tolerance 0,
    prev included) -> the kernel's flags."""
    pk, pp = prev.clone(), prev.clone()
    ko = H4.csc444_damage(frame, pk, S)
    _same(list(ko) + [pk], list(H4.csc444_damage_plain(frame, pp, S)) + [pp])
    assert torch.equal(pk, frame)
    return ko[3].cpu().tolist()


@pytest.mark.parametrize("geom", [(1088, 1920, 17), (1088, 1920, 68),
                                  (64, 208, 4), (48, 90, 3), (32, 7, 2)])
@pytest.mark.parametrize("offset", [0, 1, 4])
def test_csc444_damage_idle_full_and_one_stripe_in_three(dev, geom, offset):
    """K13 on an idle frame (no flag, prev untouched), a fully damaged one
    (every flag) and one with one damaged stripe in three, at 17 and 68
    stripes of the 1080p grid and widths off 16 pixels (W = 90, 7), on
    frames 0, 1 and 4 bytes into their storage (the byte instantiation)."""
    H, W, S = geom
    prev = _k6_frame(dev, H, W, 1, offset)
    frame = _k6_frame(dev, H, W, 1, offset)
    pk = prev.clone()
    ko = H4.csc444_damage(frame, pk, S)
    assert int(ko[3].sum()) == 0 and torch.equal(pk, prev)
    assert _k13_same(frame, prev, S) == [0] * S
    full = _k6_frame(dev, H, W, 2, offset)
    full.copy_(255 - prev)
    assert _k13_same(full, prev, S) == [1] * S
    sh = H // S
    for s in range(0, S, 3):
        frame[s * sh + sh // 2, W // 2, 1] ^= 0x40
    assert _k13_same(frame, prev, S) == [int(s % 3 == 0) for s in range(S)]


@pytest.mark.parametrize("W", [1920, 208, 90])
def test_csc444_damage_one_byte_at_stripe_and_piece_edges(dev, W):
    """One differing byte at the first and the last byte of each stripe,
    and at the first and last byte of a 16-byte piece inside one: only
    that stripe is flagged."""
    H, sh = 64, 16
    S = H // sh
    f0, _ = _frames(dev, H, W)
    stripe = sh * W * 3
    spots = []
    for s in range(S):
        spots += [s * stripe, (s + 1) * stripe - 1]
    spots += [stripe + 16 * 37, stripe + 16 * 37 + 15, 2 * stripe + 16 * 5 - 1]
    for at in spots:
        f1 = f0.clone()
        f1.view(-1)[at] ^= 0x80
        assert _k13_same(f1, f0, S) == [int(s == at // stripe)
                                        for s in range(S)], at


@pytest.mark.parametrize("W", [54, 90, 18, 2, 7])
def test_csc444_damage_off_the_vector_path(dev, W):
    """Widths whose rows are not whole 16-byte pieces (the byte
    instantiation), a run cut at the row's end."""
    f0, f1 = _frames(dev, 32, W)
    f1[17, W - 1, 2] ^= 1
    assert _k13_same(f1, f0, 4) == [1, 1, 1, 0]


@pytest.mark.parametrize("rows", [4, 16])
@pytest.mark.parametrize("stripes", [1, 4])
def test_csc444_damage_on_band_views(dev, rows, stripes):
    """Views of 4 and 16 MB rows at a stripe boundary, as one stripe (as
    the band step hands them over) and as 4; the rest of prev is
    untouched."""
    H, W, y0 = 512, 208, 64
    f0, f1 = _frames(dev, H, W)
    f1 = torch.roll(f1, 3, 0)
    bh = 16 * rows
    pk, pp = f0.clone(), f0.clone()
    band = f1.narrow(0, y0, bh)
    ko = H4.csc444_damage(band, pk.narrow(0, y0, bh), stripes)
    po = H4.csc444_damage_plain(band, pp.narrow(0, y0, bh), stripes)
    _same(list(ko) + [pk], list(po) + [pp])
    assert torch.equal(pk[:y0], f0[:y0]) and torch.equal(pk[y0 + bh:],
                                                         f0[y0 + bh:])


def test_csc444_damage_on_two_streams(dev):
    """Launches alternating between two streams (the stripes' tickets are
    shared module state, so the second waits for the first): every
    launch's flags, planes and prev equal the plain version's."""
    H, W, sh = 1088, 1920, 64
    S = H // sh
    frames = [_frames(dev, H, W) for _ in range(2)]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    outs = []
    for k in range(8):
        f0, f1 = frames[k % 2]
        f1 = f1.clone()
        f1[sh * (k % S)] ^= 1
        prev = f0.clone()
        streams[k % 2].wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(streams[k % 2]):
            outs.append((f1, f0, prev, H4.csc444_damage(f1, prev, S)))
    torch.cuda.synchronize()
    for f1, f0, prev, ko in outs:
        pp = f0.clone()
        _same(list(ko) + [prev],
              list(H4.csc444_damage_plain(f1, pp, S)) + [pp])
