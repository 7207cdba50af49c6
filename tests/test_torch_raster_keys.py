"""Kernel 1's design, transcribed in plain torch and held to the plain
rasterizer bit for bit on the CPU.

``csrc/raster.cu`` bins by bitset, ranks by prefix popcount, covers
face-parallel with a 64-bit ``atomicMax`` of ``bits(zd) << 32 | (0xFFFFFFFF
- f)`` keys over the pixels where each face can hit, and resolves per
pixel.  :func:`rasterize_by_keys` repeats those four steps with int64 keys
and ``scatter_reduce("amax")`` (the bits of a positive float fit in 31, so
the keys stay positive) and must give ``rasterize_plain``'s depth, tri_id,
bary, overflow and attributes exactly: at full and overflowing capacity,
with exact z-ties, degenerate and back-facing faces, corners a few ulps off
integer pixels and slivers.  The walk bound (``cover_reach``) is held on its
own: where it lets a face walk only its bbox widened by one pixel, the
plain version's whole-tile inside test finds no hit outside it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gif_tpu.render import raster as jr
from gif_tpu_torch.render import raster as tr

U32 = 0xFFFFFFFF


def _random_faces(rng, b, n_faces, h, w, spread=12.0):
    centers = rng.uniform(5, min(h, w) - 5, size=(b, n_faces, 1, 2))
    offsets = rng.uniform(-spread, spread, size=(b, n_faces, 3, 2))
    z = rng.uniform(1.0, 20.0, size=(b, n_faces, 3, 1))
    return np.concatenate([centers + offsets, z], axis=-1).astype(np.float32)


def _popcount(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each int64 holding a 32-bit word."""
    n = torch.zeros_like(x)
    for i in range(32):
        n += (x >> i) & 1
    return n


def face_boxes(fv, h, w):
    """Step (a)'s per-face part: clamped integer bbox (ints) and alive."""
    xs, ys = fv[..., 0], fv[..., 1]
    x0 = torch.clamp(torch.ceil(xs.amin(-1)), min=0)
    x1 = torch.clamp(torch.floor(xs.amax(-1)), max=w - 1)
    y0 = torch.clamp(torch.ceil(ys.amin(-1)), min=0)
    y1 = torch.clamp(torch.floor(ys.amax(-1)), max=h - 1)
    alive = tr._front_facing(fv) & (x0 <= x1) & (y0 <= y1)
    box = [torch.where(alive, v, 0).long() for v in (x0, x1, y0, y1)]
    return box, alive


def bin_and_rank(fv, h, w, tile, cap):
    """Steps (a)-(b): the (B, T, ceil(F / 32)) membership bitset, the
    exclusive prefix popcount over each row's words, counts and overflow;
    returns (rank (B, T, F) of every face in every tile, overflow, K)."""
    b, f = fv.shape[:2]
    n_ty, n_tx = h // tile, w // tile
    (x0, x1, y0, y1), alive = face_boxes(fv, h, w)
    ty = torch.arange(n_ty)[:, None].expand(n_ty, n_tx).reshape(-1)
    tx = torch.arange(n_tx)[None, :].expand(n_ty, n_tx).reshape(-1)
    member = (
        alive[:, None, :]
        & (x0[:, None, :] // tile <= tx[None, :, None]) & (x1[:, None, :] // tile >= tx[None, :, None])
        & (y0[:, None, :] // tile <= ty[None, :, None]) & (y1[:, None, :] // tile >= ty[None, :, None])
    )  # (B, T, F)
    n_words = (f + 31) // 32
    padded = torch.zeros((b, n_ty * n_tx, n_words * 32), dtype=torch.int64)
    padded[..., :f] = member.long()
    bits = (padded.reshape(b, -1, n_words, 32) << torch.arange(32)).sum(-1)  # the words
    pops = _popcount(bits)
    prefix = torch.cumsum(pops, -1) - pops
    counts = pops.sum(-1)
    k = min(cap, f)
    fid = torch.arange(f)
    below = (1 << (fid % 32)) - 1
    rank = prefix[..., fid // 32] + _popcount(bits[..., fid // 32] & below)
    rank = torch.where(member, rank, k)  # not a candidate: never below K
    return rank, counts > k, k


def cover_margin(tab, box, tile):
    """csrc/raster.cu's walk margin per face: m pixels around the bbox
    (``tile`` where the rounding bound does not hold: whole tiles)."""
    x0, x1, y0, y1 = box
    p0x, p0y, d00, d01, d11, inv = (tab[..., i] for i in (0, 1, 6, 7, 8, 9))
    ai = inv.abs()
    n0, n1 = d00.sqrt(), d11.sqrt()
    tx0, tx1, ty0, ty1 = ((v // tile * tile).float() for v in (x0, x1, y0, y1))
    r = torch.maximum((tx0 - p0x).abs(), (tx1 + tile - 1 - p0x).abs()) + torch.maximum(
        (ty0 - p0y).abs(), (ty1 + tile - 1 - p0y).abs())
    e = 2.0**-19 * r * (n0 * d11 + n1 * d00) * ai + 2.0**-20
    shape = 2.0**-20 * (1 + d00 * d11 * ai + (d00 + d11) * ai.sqrt())
    reach = (2 * e + shape * (1 + 2 * e)) * (n0 + n1)
    bounded = (d00 * d11 - d01 * d01 > 0) & (shape < 0.0625) & (2 * reach < tile)
    return torch.where(bounded, torch.clamp(torch.ceil(2 * reach), min=1), tile).long()


def _test(tab, px, py):
    """The inside test in _tile_winners' order: (inside, zd, w0, v, u)."""
    c = [tab[..., i] for i in range(14)]
    p0x, p0y, v0x, v0y, v1x, v1y, d00, d01, d11, inv, degen, rz0, rz1, rz2 = c
    v2x, v2y = px - p0x, py - p0y
    dot02 = v0x * v2x + v0y * v2y
    dot12 = v1x * v2x + v1y * v2y
    u = (d11 * dot02 - d01 * dot12) * inv
    v = (d00 * dot12 - d01 * dot02) * inv
    w0 = torch.where(degen != 0, -1.0, (1.0 - u) - v)
    zd = w0 * rz0 + v * rz1 + u * rz2
    return (w0 > 0) & (v >= 0) & (u >= 0), zd, w0, v, u


def walk_pairs(fv, h, w, tile, cap):
    """Steps (a)-(c)'s walk: every (batch, face, pixel) the coverage step
    tests — the face's candidate tiles (rank below K), within its bbox
    widened by ``cover_margin`` pixels.  Returns (b, f, px, py) long
    tensors, overflow, the table and the per-face margins."""
    b, f = fv.shape[:2]
    n_tx = w // tile
    rank, overflow, k = bin_and_rank(fv, h, w, tile, cap)
    tab = tr.face_table(fv)
    box, _ = face_boxes(fv, h, w)
    margin = cover_margin(tab, box, tile)
    bi, ti, fi = torch.nonzero(rank < k, as_tuple=True)
    lin = torch.arange(tile * tile)
    px = ((ti % n_tx) * tile)[:, None] + lin % tile
    py = ((ti // n_tx) * tile)[:, None] + lin // tile
    x0, x1, y0, y1 = (v[bi, fi][:, None] for v in box)
    m = margin[bi, fi][:, None]
    keep = (px >= x0 - m) & (px <= x1 + m) & (py >= y0 - m) & (py <= y1 + m)
    keep &= (tab[bi, fi, 10] == 0)[:, None]  # degenerate faces are never walked
    rows = torch.nonzero(keep, as_tuple=True)
    return (bi[rows[0]], fi[rows[0]], px[rows], py[rows]), overflow, tab, margin


def rasterize_by_keys(fv, attrs, h, w, tile, cap):
    """Steps (a)-(d) in plain torch: same outputs as ``rasterize_plain``."""
    fv = fv.float()
    b, f = fv.shape[:2]
    (bi, fi, px, py), overflow, tab = walk_pairs(fv, h, w, tile, cap)[:3]
    inside, zd, *_ = _test(tab[bi, fi], px.float(), py.float())
    key = (zd.view(torch.int32).long() << 32) | (U32 - fi)
    keys = torch.zeros(b * h * w, dtype=torch.int64)
    pix = (bi * h + py) * w + px
    keys.scatter_reduce_(0, pix[inside], key[inside], reduce="amax")
    # (d) resolve.
    hit = keys != 0
    f_win = torch.where(hit, U32 - (keys & U32), 0)
    zd_win = (keys >> 32).int().view(torch.float32)
    lin = torch.arange(b * h * w)
    b_of, py_of, px_of = lin // (h * w), (lin // w) % h, lin % w
    _, _, w0, v, u = _test(tab[b_of, f_win], px_of.float(), py_of.float())
    depth = torch.where(hit, 1.0 / torch.where(hit, zd_win, 1.0), tr.BIG_DEPTH)
    tri = torch.where(hit, f_win, -1).int()
    bary = torch.where(hit[:, None], torch.stack([w0, v, u], -1), 0.0)
    a = attrs.float()[b_of, f_win]  # (N, 3, D)
    img = bary[:, 0:1] * a[:, 0] + bary[:, 1:2] * a[:, 1] + bary[:, 2:3] * a[:, 2]
    img = torch.where(hit[:, None], img, 0.0)
    return (depth.reshape(b, h, w), tri.reshape(b, h, w), bary.reshape(b, h, w, 3), overflow,
            img.reshape(b, h, w, -1))


def _assert_bit_equal(fv, attrs, h, w, tile, cap):
    fv_t, at_t = torch.from_numpy(fv), torch.from_numpy(attrs)
    want, want_img = tr.rasterize_plain(fv_t, at_t, h=h, w=w, tile=tile, max_tris_per_tile=cap)
    depth, tri, bary, overflow, img = rasterize_by_keys(fv_t, at_t, h, w, tile, cap)
    for got, ref, name in ((depth, want.depth, "depth"), (tri, want.tri_id, "tri_id"),
                           (bary, want.bary, "bary"), (overflow, want.tile_overflow, "overflow"),
                           (img, want_img, "attributes")):
        assert got.dtype == ref.dtype and torch.equal(got, ref), name
    return want


@pytest.mark.parametrize("cap", [600, 16])  # cap = F, and 16: tiles overflow
def test_keys_match_plain(cap):
    rng = np.random.default_rng(0)
    fv = _random_faces(rng, 2, 600, 128, 128)
    attrs = rng.standard_normal((2, 600, 3, 5)).astype(np.float32)
    want = _assert_bit_equal(fv, attrs, 128, 128, 32, cap)
    assert (want.tri_id >= 0).float().mean() > 0.3
    assert bool(want.tile_overflow.any()) == (cap == 16)


def test_keys_exact_z_ties():
    """Duplicated faces under other ids tie exactly on zd: the lowest id
    wins, as in the plain version's argmax."""
    rng = np.random.default_rng(1)
    base = _random_faces(rng, 1, 80, 64, 64)
    fv = np.concatenate([base, base[:, ::-1], base], axis=1)  # ids i, 159 - i, 160 + i
    attrs = rng.standard_normal((1, 240, 3, 2)).astype(np.float32)
    want = _assert_bit_equal(fv, attrs, 64, 64, 16, 240)
    hit = want.tri_id[want.tri_id >= 0]
    assert hit.numel() > 0 and int(hit.max()) < 160  # the third copy never wins
    _assert_bit_equal(fv, attrs, 64, 64, 16, 24)  # and under overflow


def test_keys_degenerate_and_backfacing():
    rng = np.random.default_rng(2)
    fv = _random_faces(rng, 2, 120, 64, 64)
    fv[:, :30] = fv[:, :30, [0, 2, 1]]  # back-facing copies of a quarter
    line = np.linspace(0, 1, 3, dtype=np.float32)[:, None]
    fv[:, 30:40, :, :2] = fv[:, 30:40, :1, :2] + line * (fv[:, 30:40, 1:2, :2] - fv[:, 30:40, :1, :2])
    fv[:, 40:44, :, :2] = fv[:, 40:44, :1, :2]  # a point
    attrs = rng.standard_normal((2, 120, 3, 3)).astype(np.float32)
    want = _assert_bit_equal(fv, attrs, 64, 64, 16, 120)
    _assert_bit_equal(fv, attrs, 64, 64, 16, 20)
    tab = tr.face_table(torch.from_numpy(fv))
    assert (tab[:, 40:44, 10] == 1).all()  # det == 0: counted, never hit
    assert not bool(((want.tri_id >= 40) & (want.tri_id < 44)).any())


def test_keys_corners_near_integer_pixels():
    """Corners a few ulps either side of integer pixel coordinates, where
    a pixel just outside a corner's x- or y-range can round inside."""
    rng = np.random.default_rng(3)
    fv = _random_faces(rng, 2, 400, 64, 64, spread=5.0)
    ints = np.round(fv[..., :2]).astype(np.float32)
    ulps = rng.integers(-4, 5, size=ints.shape)
    fv[..., :2] = ints
    for i in range(4):  # step each coordinate |ulps| float spacings off
        toward = np.where(np.abs(ulps) > i, np.where(ulps > 0, np.inf, -np.inf), fv[..., :2]).astype(np.float32)
        fv[..., :2] = np.nextafter(fv[..., :2], toward)
    attrs = rng.standard_normal((2, 400, 3, 5)).astype(np.float32)
    want = _assert_bit_equal(fv, attrs, 64, 64, 16, 400)
    assert (want.tri_id >= 0).float().mean() > 0.3


def _slivers(rng, b, n, h, w):
    """Nearly collinear triangles at random scales (det's rounding error
    comparable to det itself) mixed with tiny and ordinary faces."""
    p0 = rng.uniform(8, min(h, w) - 8, size=(b, n, 2))
    d = rng.normal(size=(b, n, 2)) * rng.choice([0.3, 3.0, 20.0], size=(b, n, 1))
    t = rng.uniform(0.2, 1.0, size=(b, n, 1))
    off = rng.normal(size=(b, n, 2)) * 10.0 ** rng.uniform(-7, 0, size=(b, n, 1))
    xy = np.stack([p0, p0 + d, p0 + t * d + off], axis=2)
    z = rng.uniform(1.0, 4.0, size=(b, n, 3, 1))
    return np.concatenate([xy, z], axis=-1).astype(np.float32)


def test_keys_slivers():
    rng = np.random.default_rng(4)
    fv = np.concatenate([_slivers(rng, 2, 500, 64, 64), _random_faces(rng, 2, 100, 64, 64)], axis=1)
    attrs = rng.standard_normal((2, 600, 3, 2)).astype(np.float32)
    _assert_bit_equal(fv, attrs, 64, 64, 32, 600)
    _assert_bit_equal(fv, attrs, 64, 64, 16, 32)


@pytest.mark.parametrize("case", ["random", "slivers", "near_integer"])
def test_cover_margin_bounds_the_inside_test(case):
    """Every inside hit of the plain version's whole-tile test lies within
    the face's bbox widened by its ``cover_margin``; slivers do hit beyond
    one pixel, so the margin is needed; and few ordinary faces need more
    than one pixel."""
    rng = np.random.default_rng(5)
    h = w = 64
    tile = 32
    if case == "random":
        fv = _random_faces(rng, 2, 500, h, w, spread=20.0)
    elif case == "slivers":
        fv = _slivers(rng, 2, 2000, h, w)
    else:
        fv = np.round(_random_faces(rng, 2, 500, h, w, spread=3.0))
        fv[..., :2] = np.nextafter(fv[..., :2], np.float32(np.inf) * rng.choice([-1, 1], fv[..., :2].shape))
    fv_t = torch.from_numpy(fv.astype(np.float32))
    tab = tr.face_table(fv_t)
    box, alive = face_boxes(fv_t, h, w)
    margin = cover_margin(tab, box, tile)
    rank, _, k = bin_and_rank(fv_t, h, w, tile, 10**9)
    bi, ti, fi = torch.nonzero(rank < k, as_tuple=True)
    lin = torch.arange(tile * tile)
    px = (((ti % (w // tile)) * tile)[:, None] + lin % tile)
    py = (((ti // (w // tile)) * tile)[:, None] + lin // tile)
    inside = _test(tab[bi, fi][:, None, :].expand(-1, tile * tile, -1), px.float(), py.float())[0]
    x0, x1, y0, y1 = (v[bi, fi][:, None] for v in box)

    def beyond(m):
        return (inside & ((px < x0 - m) | (px > x1 + m) | (py < y0 - m) | (py > y1 + m))).any(-1)

    assert not bool(beyond(margin[bi, fi][:, None]).any())
    wide = (margin[alive] > 1).float().mean().item()
    if case == "slivers":
        assert bool(beyond(1).any())  # rounding does draw slivers far off
    else:
        assert wide < 0.05, wide


def test_keys_match_jax_rasterize():
    """One small case against the JAX package's XLA rasterizer (the bars
    of tests/test_torch_raster.py: tri_id and overflow equal)."""
    rng = np.random.default_rng(6)
    fv = _random_faces(rng, 2, 200, 64, 64, spread=8.0)
    attrs = np.zeros((2, 200, 3, 1), np.float32)
    want = jr.rasterize(jnp.asarray(fv), h=64, w=64, tile=16, max_tris_per_tile=96)
    depth, tri, bary, overflow, _ = rasterize_by_keys(torch.from_numpy(fv), torch.from_numpy(attrs), 64, 64,
                                                      16, 96)
    np.testing.assert_array_equal(tri.numpy(), np.asarray(want.tri_id))
    np.testing.assert_array_equal(overflow.numpy(), np.asarray(want.tile_overflow))
    hit = np.asarray(want.tri_id) >= 0
    assert hit.mean() > 0.3
    np.testing.assert_allclose(depth.numpy()[hit], np.asarray(want.depth)[hit], rtol=1e-3)
    np.testing.assert_allclose(bary.numpy()[hit], np.asarray(want.bary)[hit], rtol=5e-3, atol=2e-3)
