"""What the port's kernels 2, 4 and 6 are launched with, checked on the CPU.

The CUDA kernels run only on a card; the geometry and argument helpers
around them are pure Python, so the launch of kernel 4 (which thread walks
which strip of which plane), kernel 2's stride arguments (read in place,
never copied) and kernel 6's image windows (one CTA each, every pixel in
exactly one) are held here at the main path's shapes.
"""

import numpy as np
import pytest
import torch

from gif_tpu_torch.ops import blur_cuda
from gif_tpu_torch.render import sampling_ops, shading
from gif_tpu_torch.render.sampler_cuda import sampler_strides
from gif_tpu_torch.render.scatter_cuda import WINDOW_BYTES, scatter_launch_geometry

# Planes of the main path: batch x channels of the run_id-8 step (16),
# the fused run_id-0 G forward (31) and a served batch (8), at 512 and 128
# channels.
PLANES = [16 * 512, 31 * 512, 16 * 128, 31 * 128, 8 * 512]
# Blur output maps of the main path (G's up-blurs, D's down-blurs and
# their VJPs) and odd sizes.
MAPS = [8, 9, 16, 17, 32, 33, 64, 65, 128, 129, 255, 256, 257, 1, 3, 35]


def _check_geometry(planes, ho, wo):
    g = blur_cuda.blur4_launch_geometry(planes, ho, wo)
    if g["mode"] == "planes":
        _check_plane_geometry(g, planes, ho, wo)
    else:
        _check_strip_geometry(g, planes, ho, wo)
    return g


def _check_plane_geometry(g, planes, ho, wo):
    # CTA b stages planes [b * per_cta, min((b + 1) * per_cta, planes)) and
    # writes every output of each: each plane in exactly one CTA, no CTA
    # empty, the staged inputs inside the shared-memory budget.
    assert max(ho, wo) <= blur_cuda.PLANE_MAP
    k = g["per_cta"]
    assert k >= 1 and (g["blocks"] - 1) * k < planes <= g["blocks"] * k
    assert k * (ho + 3) * (wo + 3) * 4 <= blur_cuda.PLANE_SMEM
    first = np.arange(g["blocks"]) * k
    count = np.minimum(k, planes - first)
    assert (count >= 1).all() and count.sum() == planes
    assert k == 1 or k * ho * wo <= blur_cuda.PLANE_OUTPUTS


def _check_strip_geometry(g, planes, ho, wo):
    rows, cols = g["rows"], blur_cuda.BLUR_COLS
    assert max(ho, wo) > blur_cuda.PLANE_MAP
    assert rows in blur_cuda.BLUR_ROWS
    assert g["threads"] == planes * g["col_groups"] * g["row_strips"] < 2**31
    # Every CTA of the grid has a live thread; no live thread past the grid.
    assert (g["blocks"] - 1) * blur_cuda.BLUR_THREADS < g["threads"] <= g["blocks"] * blur_cuda.BLUR_THREADS
    # Strips and column groups tile the map: each starts inside it and
    # together they cover each row / column once.
    assert (g["row_strips"] - 1) * rows < ho <= g["row_strips"] * rows
    assert (g["col_groups"] - 1) * cols < wo <= g["col_groups"] * cols
    # The kernel's thread -> tile map over the whole grid: live threads are
    # exactly the first ``threads``, and they hit each (plane, strip, group)
    # tile once.
    t = np.arange(g["blocks"] * blur_cuda.BLUR_THREADS, dtype=np.int32)
    plane, oy0, ox0 = blur_cuda.blur4_thread_tiles(g, t)
    live = plane < planes
    np.testing.assert_array_equal(live, t < g["threads"])
    assert oy0[live].max() < ho and ox0[live].max() < wo
    key = (plane[live].astype(np.int64) * g["row_strips"] + oy0[live] // rows) * g["col_groups"] + ox0[live] // cols
    counts = np.bincount(key, minlength=g["threads"])
    assert counts.shape == (g["threads"],) and (counts == 1).all()
    # Pixel by pixel, for the first and the last plane: each output once.
    for p in (0, planes - 1):
        cover = np.zeros((ho, wo), np.int32)
        for y, x in zip(oy0[plane == p], ox0[plane == p]):
            cover[y : y + rows, x : x + cols] += 1
        assert (cover == 1).all(), (p, np.unique(cover))


@pytest.mark.parametrize("size", MAPS)
@pytest.mark.parametrize("planes", PLANES)
def test_blur4_launch_geometry_covers_every_output_once(planes, size):
    _check_geometry(planes, size, size)


@pytest.mark.parametrize("ho,wo", [(257, 9), (8, 256), (1, 129), (35, 3), (33, 34), (1, 1)])
def test_blur4_launch_geometry_non_square(ho, wo):
    _check_geometry(4096, ho, wo)


def test_blur4_launch_geometry_picks_the_path_by_map():
    geo = {m: blur_cuda.blur4_launch_geometry(16 * 512, m, m) for m in (8, 9, 16, 17, 24, 25, 32, 35, 64, 257)}
    # Up to 24 px: whole planes, several a CTA (32 planes of 8x8 outputs).
    assert all(geo[m]["mode"] == "planes" for m in (8, 9, 16, 17, 24))
    assert (geo[8]["per_cta"], geo[8]["blocks"]) == (32, 256) and geo[24]["per_cta"] == 3
    # Larger: strips of the rows that load the fewest input rows per
    # column — 8 for 35 (5 strips of 11 rows against 3 of 19), 16 else.
    assert {m: geo[m]["rows"] for m in (25, 32, 35, 64, 257)} == {25: 16, 32: 16, 35: 8, 64: 16, 257: 16}


# Kernel 4 on channels-last maps: the discriminator's blur outputs at batch
# 16 (pads (2, 2) and (1, 1) on 256 px down to 8 px, 128-512 channels) and
# their VJPs, and ragged shapes; (n, c, ho, wo, channels a thread).
NHWC_OUTPUTS = [(16, 128, 257, 257, 8), (16, 128, 256, 256, 8), (16, 256, 129, 129, 8), (16, 512, 65, 65, 8),
                (16, 512, 33, 33, 8), (16, 512, 17, 17, 8), (16, 512, 9, 9, 8), (16, 512, 8, 8, 8),
                (16, 512, 65, 65, 4), (3, 9, 7, 5, 1), (2, 130, 17, 13, 1), (3, 12, 33, 31, 4), (1, 1, 1, 1, 1)]


@pytest.mark.parametrize("n,c,ho,wo,vec", NHWC_OUTPUTS)
def test_blur4_nhwc_geometry_covers_every_output_once(n, c, ho, wo, vec):
    g = blur_cuda.blur4_nhwc_geometry(n, c, ho, wo, vec)
    assert g["blocks"] * blur_cuda.BLUR_THREADS >= g["threads"] > g["threads"] - blur_cuda.BLUR_THREADS
    assert g["cb"] <= 32 and g["cb"] * g["cblocks"] * vec == c and g["col_strips"] * g["cols"] >= wo
    # Enough threads to fill the card, or strips of one column already.
    assert g["threads"] >= blur_cuda.NHWC_THREADS or g["cols"] == 1
    img, oy, c0, ox0 = blur_cuda.blur4_nhwc_thread_tiles(g, np.arange(g["threads"], dtype=np.int64))
    assert img.max() == n - 1 and oy.max() == ho - 1 and c0.max() == c - vec and 0 <= ox0.min()
    # Every output of the first image written by exactly one thread (the
    # images follow one another in the thread order).
    first = img == 0
    assert first.sum() * n == g["threads"]
    ox = ox0[first, None, None] + np.arange(g["cols"])[:, None]
    ch = c0[first, None, None] + np.arange(vec)
    flat = (oy[first, None, None] * wo + ox) * c + ch
    cover = np.bincount(flat[np.broadcast_to(ox < wo, flat.shape)], minlength=ho * wo * c)
    assert (cover == 1).all()
    # A CTA's lanes walk the channels of one pixel, then the next output row.
    if g["cb"] >= 8 and g["threads"] >= 64:
        assert (c0[:g["cb"]] == np.arange(g["cb"]) * vec).all() and (oy[:g["cb"]] == 0).all()
        assert oy[g["cb"]] == min(1, ho - 1)


def test_blur4_nhwc_geometry_shortens_strips_on_small_maps():
    strips = {s: blur_cuda.blur4_nhwc_geometry(16, 128 if s == 257 else 512, s, s, 8)["cols"]
              for s in (257, 65, 33, 17, 9)}
    assert strips == {257: 16, 65: 16, 33: 4, 17: 1, 9: 1}


def _nchw_backed(b=4, c=3, h=8, w=6):
    """An NHWC view of NCHW memory, as the generator returns its images."""
    x = torch.arange(b * c * h * w, dtype=torch.float32).reshape(b, c, h, w)
    return x.permute(0, 2, 3, 1)


def test_sampler_strides_nhwc_contiguous():
    img = torch.zeros((2, 8, 6, 3))
    grid = torch.zeros((2, 4, 5, 2))
    assert sampler_strides(img, grid) == ((8 * 6 * 3, 6 * 3, 3, 1), (4 * 5 * 2, 2))


def test_sampler_strides_nhwc_view_of_nchw_and_batch_slice():
    img = _nchw_backed()
    pts = torch.zeros((4, 7, 2))
    want = ((3 * 8 * 6, 6, 1, 8 * 6), (7 * 2, 2))
    assert sampler_strides(img, pts[:, :, None, :]) == want
    # The texture steal's input: a batch slice of G's output, read in place.
    sl = img[1:]
    assert sl.data_ptr() == img.data_ptr() + 3 * 8 * 6 * 4 and not sl.is_contiguous()
    assert sampler_strides(sl, pts[1:, :, None, :]) == want
    # A batch of one: its batch stride is never stepped.
    assert sampler_strides(img[2:3], pts[2:3, :, None, :]) == ((0, 6, 1, 8 * 6), (0, 2))


@pytest.mark.parametrize("case", [
    "float64", "five_channels", "rank3", "batch_mismatch", "grid_last_dim", "zero_stride",
    "grid_channel_stride", "grid_not_walkable", "grid_odd_stride", "grid_misaligned",
])
def test_sampler_strides_rejects(case):
    img, grid = torch.zeros((2, 8, 6, 3)), torch.zeros((2, 4, 5, 2))
    if case == "float64":
        img, grid = img.double(), grid.double()
    elif case == "five_channels":
        img = torch.zeros((2, 8, 6, 5))
    elif case == "rank3":
        img = torch.zeros((2, 48, 3))
    elif case == "batch_mismatch":
        grid = torch.zeros((3, 4, 5, 2))
    elif case == "grid_last_dim":
        grid = torch.zeros((2, 4, 5, 3))
    elif case == "zero_stride":
        img = torch.zeros((1, 8, 6, 3)).expand(2, 8, 6, 3)
    elif case == "grid_channel_stride":
        grid = torch.zeros((2, 2, 4, 5)).permute(0, 2, 3, 1)
    elif case == "grid_not_walkable":
        grid = torch.zeros((2, 4, 8, 2))[:, :, :5]
    elif case == "grid_odd_stride":
        grid = torch.zeros((2, 4, 5, 3))[..., :2]
    elif case == "grid_misaligned":
        grid = torch.zeros(2 * 4 * 5 * 2 + 1)[1:].reshape(2, 4, 5, 2)
    with pytest.raises(ValueError):
        sampler_strides(img, grid)


def test_sampler_strides_never_copies():
    img = _nchw_backed()[1:]
    grid = torch.zeros((3, 4, 5, 2))
    ptrs = img.data_ptr(), grid.data_ptr()
    sampler_strides(img, grid)
    assert (img.data_ptr(), grid.data_ptr()) == ptrs and not img.is_contiguous()


def test_sample_at_points_on_nchw_view_equals_contiguous():
    rng = np.random.default_rng(4)
    img = _nchw_backed(5, 3, 16, 12) / 100.0
    pts = torch.from_numpy(rng.uniform(-1.1, 1.1, (4, 301, 2)).astype(np.float32))
    view = img[1:].detach().requires_grad_(True)
    dense = view.detach().contiguous().requires_grad_(True)
    assert not view.is_contiguous()
    got, want = sampling_ops.sample_at_points(view, pts), sampling_ops.sample_at_points(dense, pts)
    assert torch.equal(got, want)
    cot = torch.from_numpy(rng.standard_normal((4, 301, 3)).astype(np.float32))
    (g_view,), (g_dense,) = torch.autograd.grad(got, view, cot), torch.autograd.grad(want, dense, cot)
    assert torch.equal(g_view, g_dense)
    # The plain grid_sample agrees on the view too.
    grid = pts[:, :, None, :]
    assert torch.equal(shading.grid_sample_bilinear(view.detach(), grid),
                       shading.grid_sample_bilinear(dense.detach(), grid))


# Kernel 6's images: the run_id-0 steal's gradient (15 rows of 256 x 256 x
# 3), the card tests' shapes, and rows too wide for one window.
SCATTER_IMAGES = [(15, 256, 256, 3), (3, 64, 48, 3), (2, 256, 256, 3), (1, 7, 9, 2), (1, 5, 10000, 3),
                  (4, 3, 40000, 1), (200, 16, 16, 3)]


@pytest.mark.parametrize("b,h,w,c", SCATTER_IMAGES)
@pytest.mark.parametrize("n_sm", [132, 1])
def test_scatter_launch_geometry_covers_every_pixel_once(b, h, w, c, n_sm):
    g = scatter_launch_geometry(b, h, w, c, n_sm)
    rows, cols = g["win_rows"], g["win_cols"]
    assert g["smem_bytes"] == 4 * rows * cols * c <= WINDOW_BYTES
    cover = np.zeros((h, w), np.int32)
    for i in range(g["n_row_windows"] * g["n_col_windows"]):  # the kernel's blockIdx.x -> window
        y_lo, x_lo = i // g["n_col_windows"] * rows, i % g["n_col_windows"] * cols
        assert y_lo < h and x_lo < w  # no empty window
        cover[y_lo : y_lo + rows, x_lo : x_lo + cols] += 1
    assert (cover == 1).all()
    n_cta = b * g["n_row_windows"] * g["n_col_windows"]
    # About one CTA per SM: at least half of them busy where the image has
    # the rows for it, and no more windows than that takes unless the
    # window is full.
    assert n_cta >= min(n_sm, b * h * g["n_col_windows"]) / 2
    assert n_cta < n_sm + b * g["n_col_windows"] or rows == 1 or g["smem_bytes"] + 4 * cols * c > WINDOW_BYTES


def _scatter_by_windows(g, pts, h, w, geo):
    """csrc/scatter.cu's two steps in torch: list each point under the
    windows its valid taps land in, then let each window add the taps of its
    listed points that lie inside it."""
    b, p, c = g.shape
    rows, cols, n_col = geo["win_rows"], geo["win_cols"], geo["n_col_windows"]
    gx = (pts[..., 0] + 1.0) * (w * 0.5) - 0.5
    gy = (pts[..., 1] + 1.0) * (h * 0.5) - 0.5
    x0, y0 = torch.floor(gx), torch.floor(gy)
    dx, dy = gx - x0, gy - y0
    taps = []
    for k in range(4):
        ty, tx = y0 + (k >> 1), x0 + (k & 1)
        ok = (ty >= 0) & (ty <= h - 1) & (tx >= 0) & (tx <= w - 1)
        wt = (dy if k >> 1 else 1 - dy) * (dx if k & 1 else 1 - dx)
        win = torch.where(ok, (ty // rows) * n_col + tx // cols, -1).long()
        taps.append((ty, tx, ok, wt, win))
    out = torch.full((b, h, w, c), float("nan"))
    for i in range(geo["n_row_windows"] * n_col):
        y_lo, x_lo = i // n_col * rows, i % n_col * cols
        r, q = min(rows, h - y_lo), min(cols, w - x_lo)
        listed = torch.stack([t[4] == i for t in taps]).any(0)  # step 1: this window's list
        acc = torch.zeros((b, r * q, c))
        for ty, tx, ok, wt, _ in taps:
            inside = listed & ok & (ty >= y_lo) & (ty < y_lo + r) & (tx >= x_lo) & (tx < x_lo + q)
            idx = torch.where(inside, (ty - y_lo) * q + (tx - x_lo), 0).long()
            acc.scatter_add_(1, idx[..., None].expand(-1, -1, c), torch.where(inside[..., None], wt[..., None] * g, 0.0))
        out[:, y_lo : y_lo + r, x_lo : x_lo + q] = acc.reshape(b, r, q, c)
    return out


@pytest.mark.parametrize("b,p,h,w,c,n_sm", [(3, 2001, 64, 48, 3, 132), (2, 777, 33, 40, 3, 7), (1, 50, 7, 9, 2, 132),
                                           (2, 500, 6, 9000, 3, 4)])
def test_scatter_windows_sum_to_the_plain_scatter(b, p, h, w, c, n_sm):
    """Every valid tap lands in exactly one window, and the windows'
    sums make the plain scatter; points outside the image add nothing."""
    rng = np.random.default_rng(7)
    pts = rng.uniform(-1.2, 1.2, (b, p, 2)).astype(np.float32)
    pts[:, -4:] = np.array([[-1, -1], [1, 1], [-1, 1], [1 - 1e-7, -1]], np.float32)
    pts, g = torch.from_numpy(pts), torch.from_numpy(rng.standard_normal((b, p, c)).astype(np.float32))
    geo = scatter_launch_geometry(b, h, w, c, n_sm)
    got = _scatter_by_windows(g, pts, h, w, geo)
    want = sampling_ops.scatter_bilinear_plain(g, pts, h, w)
    assert not bool(got.isnan().any())
    err = (got - want).abs().max().item()
    assert err <= 1e-5 * want.abs().max().item() + 1e-7, err


def _c_entry_points():
    """name -> (pointers without the stream, ints, floats) of every
    ``extern "C"`` entry point in gif_tpu_torch/csrc."""
    import re

    from gif_tpu_torch import kernels

    out = {}
    for src in kernels.SOURCES:
        text = (kernels.CSRC / src).read_text()
        for name, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', text):
            kinds = [p.strip().rsplit(" ", 1)[0] for p in params.split(",")]
            assert kinds[-1] == "void*", (name, "the stream comes last")
            kinds = kinds[:-1]
            out[name] = (sum("void*" in k for k in kinds), kinds.count("int"), kinds.count("float"))
            assert sum(out[name]) == len(kinds), (name, kinds)
    return out


def test_ctypes_declarations_match_the_c_entry_points():
    """Every ``kernels.function(name, n_ptrs, n_ints[, n_floats])`` in the
    package declares the C function's own argument list (a mismatch only
    shows on the card, as a TypeError or a garbled launch)."""
    import re
    from pathlib import Path

    from gif_tpu_torch import kernels

    entries = _c_entry_points()
    declared = {}
    for path in Path(kernels.__file__).parent.rglob("*.py"):
        for name, args in re.findall(r'kernels\.function\(\s*"(\w+)",\s*([\d,\s]+)\)', path.read_text()):
            n = [int(a) for a in args.replace(" ", "").split(",") if a]
            declared[name] = tuple(n + [0] * (3 - len(n)))
    assert declared and set(declared) == set(entries)
    for name, sig in declared.items():
        assert sig == entries[name], (name, sig, entries[name])


def _scatter_fixed_order(g, pts, h, w, geo):
    """csrc/scatter.cu's fixed-order accumulate step in numpy: per window,
    its listed points go to the cell of their top-left tap ((rows + 1) x
    (cols + 1) cells from one up-left of the window), each cell sorted by
    point id; each pixel merges the four cells it receives taps from and
    adds the products in point-id order, in float32."""
    b, p, c = g.shape
    rows, cols, n_col = geo["win_rows"], geo["win_cols"], geo["n_col_windows"]
    gx = (pts[..., 0] + 1.0) * (w * 0.5) - 0.5
    gy = (pts[..., 1] + 1.0) * (h * 0.5) - 0.5
    x0, y0 = torch.floor(gx), torch.floor(gy)
    dx, dy = (gx - x0).numpy(), (gy - y0).numpy()
    x0, y0 = x0.long().numpy(), y0.long().numpy()
    wts = [(1 - dy) * (1 - dx), (1 - dy) * dx, dy * (1 - dx), dy * dx]  # float32, the kernel's products
    gn = g.numpy()
    out = np.full((b, h, w, c), np.nan, np.float32)
    for bi in range(b):
        for i in range(geo["n_row_windows"] * n_col):
            y_lo, x_lo = i // n_col * rows, i % n_col * cols
            r, q = min(rows, h - y_lo), min(cols, w - x_lo)
            listed = [pi for pi in range(p)
                      if any(y_lo <= y0[bi, pi] + (k >> 1) < y_lo + r and x_lo <= x0[bi, pi] + (k & 1) < x_lo + q
                             and 0 <= y0[bi, pi] + (k >> 1) < h and 0 <= x0[bi, pi] + (k & 1) < w
                             for k in range(4))]
            cells = {}
            for pi in listed:
                cells.setdefault((y0[bi, pi] - y_lo + 1, x0[bi, pi] - x_lo + 1), []).append(pi)
            for ry in range(r):
                for rx in range(q):
                    taps = sorted((pi, k) for k in range(4)
                                  for pi in cells.get((ry - (k >> 1) + 1, rx - (k & 1) + 1), []))
                    acc = np.zeros(c, np.float32)
                    for pi, k in taps:
                        acc = acc + wts[k][bi, pi] * gn[bi, pi]
                    out[bi, y_lo + ry, x_lo + rx] = acc
    return torch.from_numpy(out)


@pytest.mark.parametrize("b,p,h,w,c,n_sm,clustered", [(2, 300, 12, 10, 3, 132, False), (1, 400, 9, 7, 2, 3, True),
                                                      (2, 200, 5, 40, 1, 4, False)])
def test_scatter_fixed_order_equals_the_plain_scatter_bit_for_bit(b, p, h, w, c, n_sm, clustered):
    """The fixed-order step (deterministic mode) adds each pixel's taps in
    the plain version's index_add_ order, so it is the plain scatter bit for
    bit; points outside the image add nothing."""
    rng = np.random.default_rng(8)
    pts = rng.uniform(-1.2, 1.2, (b, p, 2)).astype(np.float32)
    if clustered:  # many points a cell
        pts[:, : p // 2] = rng.uniform(-0.1, 0.1, (b, p // 2, 2)).astype(np.float32)
    pts[:, -4:] = np.array([[-1, -1], [1, 1], [-1, 1], [1 - 1e-7, -1]], np.float32)
    pts, g = torch.from_numpy(pts), torch.from_numpy(rng.standard_normal((b, p, c)).astype(np.float32))
    geo = scatter_launch_geometry(b, h, w, c, n_sm)
    got = _scatter_fixed_order(g, pts, h, w, geo)
    want = sampling_ops.scatter_bilinear_plain(g, pts, h, w)
    assert torch.equal(got, want)
