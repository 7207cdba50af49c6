"""Port parity of the input pipeline on the CPU (``gif_tpu_torch.data``
against ``gif_tpu.data``): the same seeded arrays go through both.

Batches, the FID accumulator, packed datasets and the LMDB route must be
equal bit for bit (the pipeline is numpy on both sides and the native
loaders run the same C++ arithmetic).  The synthetic render dataset is
rendered by each package's own rasterizer; its uint8 frames may differ by
one grey level where a pixel sits on a rounding boundary (tolerance 1/255).
"""

import os
import sys
import time

import numpy as np
import pytest

from gif_tpu.data import lmdb_import as j_lmdb_import
from gif_tpu.data import lmdb_reader as j_lmdb_reader
from gif_tpu.data import native as j_native
from gif_tpu.data import pipeline as jp
from gif_tpu.flame.resources import synthetic_flame_resources as j_synth
from gif_tpu_torch.data import lmdb_import, lmdb_reader, native
from gif_tpu_torch.data import pipeline as tp
from gif_tpu_torch.data.augment import FLIPPED_LABEL_SENTINEL
from gif_tpu_torch.flame.resources import synthetic_flame_resources

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
AUGMENTS = {
    "plain": {},
    "crop": {"random_crop": True, "crop_max_in_px": 4},
    "flip": {"horizontal_flip": True},
    "crop_flip": {"random_crop": True, "horizontal_flip": True, "crop_max_in_px": 4},
}


def jax_loader_loaded():
    """Load the JAX package's native loader, as its pipeline uses it.  A
    first build racing another test process can make one load fail (the
    package then falls back to numpy, whose rounding differs), so retry."""
    for _ in range(20):
        if j_native._load() is not None:
            return
        j_native._tried = False
        time.sleep(0.5)
    raise RuntimeError("the JAX package's native loader did not load")


def _arrays(n=40, size=16, seed=0):
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (n, size, size, 3), dtype=np.uint8)
    flame = jp.sample_flame_params(rng, n)
    bad = np.array([3, n - 5])
    return images, flame, bad


def _assert_batches_equal(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("aug", sorted(AUGMENTS))
def test_data_iterator_batches_equal_jax(aug):
    jax_loader_loaded()
    images, flame, bad = _arrays()
    jds = jp.FlameDataset(images, flame, bad_images=bad, **AUGMENTS[aug])
    tds = tp.FlameDataset(images, flame, bad_images=bad, **AUGMENTS[aug])
    np.testing.assert_array_equal(tds.good_indices, jds.good_indices)
    jit = jp.data_iterator(jds, 8, seed=(3, 0), start_step=5)
    tit = tp.data_iterator(tds, 8, seed=(3, 0), start_step=5)
    for _ in range(3):
        want, got = next(jit), next(tit)
        _assert_batches_equal(got, want)
        if "flip" in aug:
            assert (got["flame"] == FLIPPED_LABEL_SENTINEL).all()
        if aug == "crop":
            assert (got["flame"] == 0).all() and "flip" not in got
    tit.close()
    jit.close()


def test_synthetic_flame_dataset_equals_jax():
    jds = jp.SyntheticFlameDataset(n=64, size=8, seed=4)
    tds = tp.SyntheticFlameDataset(n=64, size=8, seed=4)
    np.testing.assert_array_equal(tds.images, jds.images)
    np.testing.assert_array_equal(tds.flame_params, jds.flame_params)
    np.testing.assert_array_equal(tds.good_indices, jds.good_indices)
    assert len(tds) == 63


@pytest.mark.parametrize("flip", [False, True])
def test_native_loader_equals_plain(flip):
    rng = np.random.default_rng(1)
    imgs = rng.integers(0, 256, (20, 16, 12, 3), dtype=np.uint8)
    idx = np.array([3, 7, 0, 19, 7])
    f = np.array([0, 1, 0, 1, 1], np.uint8) if flip else None
    got = native.assemble_batch(imgs, idx, f)
    np.testing.assert_array_equal(got, native.assemble_batch_plain(imgs, idx, f))
    assert np.abs(got).max() <= 1.0
    jax_loader_loaded()
    np.testing.assert_array_equal(got, j_native.assemble_batch(imgs, idx, f))


def test_native_loader_rejects_bad_input():
    imgs = np.zeros((5, 8, 8, 3), np.uint8)
    with pytest.raises(IndexError):
        native.assemble_batch(imgs, np.array([99]))
    with pytest.raises(ValueError):
        native.assemble_batch(imgs.astype(np.float32), np.array([0]))


def test_native_build_failure_raises(monkeypatch, tmp_path):
    """No silent fallback: a source that does not compile raises."""
    bad = tmp_path / "broken.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.build()


def test_accumulator_skips_sentinels_and_rolls_like_jax():
    rng = np.random.default_rng(2)
    jds = jp.FlameDataset(*_arrays(n=30, size=4)[:2])
    tds = tp.FlameDataset(*_arrays(n=30, size=4)[:2])
    for chunk in range(7):
        rows = jp.sample_flame_params(rng, 3000)
        rows[::7] = FLIPPED_LABEL_SENTINEL  # flipped labels
        rows[1::11] = 0.0  # crop-zeroed labels
        jds.accumulate_batches_of_flm(rows)
        tds.accumulate_batches_of_flm(rows)
        want, got = jds.get_10k_flame_params(), tds.get_10k_flame_params()
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        assert (got[0][:, 0] > -9000).all() and (np.abs(got[0]).sum(1) > 0).all()
    assert len(got[0]) == 10_000 and tds._flm_count < 10_000 + 3000
    tds.accumulate_batches_of_flm(np.full((4, 236), FLIPPED_LABEL_SENTINEL, np.float32))
    assert len(tds._flm_buffer) == len(jds._flm_buffer)
    with pytest.raises(RuntimeError):
        tp.FlameDataset(*_arrays(n=4, size=4)[:2]).get_10k_flame_params()


def test_load_packed_dataset_images_path(tmp_path):
    """The importer's layout (``images_path`` to a mem-mapped npy), also
    after the directory moved, and an inline ``images`` array."""
    images, flame, bad = _arrays(n=12, size=8)
    d = tmp_path / "data"
    d.mkdir()
    np.save(d / "images.npy", images)
    np.savez(d / "dataset.npz", flame_params=flame, bad_images=bad, images_path=str(d / "images.npy"))
    np.savez(d / "inline.npz", flame_params=flame, images=images)
    for path in (d / "dataset.npz", d / "inline.npz"):
        ds = tp.load_packed_dataset(str(path), horizontal_flip=True)
        jds = jp.load_packed_dataset(str(path))
        np.testing.assert_array_equal(np.asarray(ds.images), images)
        np.testing.assert_array_equal(ds.good_indices, jds.good_indices)
        assert ds.horizontal_flip
    assert isinstance(tp.load_packed_dataset(str(d / "dataset.npz")).images, np.memmap)
    moved = tmp_path / "moved"
    os.rename(d, moved)
    ds = tp.load_packed_dataset(str(moved / "dataset.npz"))
    np.testing.assert_array_equal(np.asarray(ds.images), images)
    assert len(ds) == 10
    np.savez(moved / "empty.npz", flame_params=flame)
    with pytest.raises(KeyError):
        tp.load_packed_dataset(str(moved / "empty.npz"))


def test_data_iterator_surfaces_persistent_failure():
    class Broken(tp.FlameDataset):
        def sample_batch(self, rng, batch_size):
            raise OSError("disk gone")

    it = tp.data_iterator(Broken(*_arrays(n=8, size=4)[:2]), 2)
    with pytest.raises(OSError, match="disk gone"):
        next(it)


def _fixture_module():
    sys.path.insert(0, FIXTURES)
    try:
        import make_lmdb_fixture
    finally:
        sys.path.pop(0)
    return make_lmdb_fixture


def test_lmdb_import_committed_fixture_equals_jax(tmp_path):
    """The committed LMDB (the reference prep's layout) through the port's
    pure-Python reader and importer into ``load_packed_dataset``: the same
    frames and FLAME rows as the JAX package's importer."""
    fixture = os.path.join(FIXTURES, "tiny_lmdb")
    rng = np.random.default_rng(7)
    params = np.array(
        [{"shape": rng.standard_normal(100), "exp": rng.standard_normal(50), "pose": rng.standard_normal(6),
          "cam": rng.standard_normal(3), "tex": rng.standard_normal(50), "lit": rng.standard_normal((9, 3))}
         for _ in range(4)],
        dtype=object,
    )
    np.save(tmp_path / "flame.npy", params, allow_pickle=True)
    np.savez(tmp_path / "bad.npz", bad_images=np.array([1]))
    outs = [
        mod.import_ffhq_lmdb(fixture, str(tmp_path / "flame.npy"), str(tmp_path / name), resolution=32,
                             bad_images_file=str(tmp_path / "bad.npz"))
        for mod, name in ((lmdb_import, "port"), (j_lmdb_import, "jax"))
    ]
    ds = tp.load_packed_dataset(outs[0])
    jds = jp.load_packed_dataset(outs[1])
    np.testing.assert_array_equal(np.asarray(ds.images), np.asarray(jds.images))
    np.testing.assert_array_equal(ds.flame_params, jds.flame_params)
    assert len(ds) == 3
    _, truth = _fixture_module().reference_style_items()
    for i in range(4):
        np.testing.assert_array_equal(np.asarray(ds.images[i]), truth[(32, i)])

    db, jdb = lmdb_reader.open(fixture), j_lmdb_reader.open(fixture)
    assert dict(db.items()) == dict(jdb.items()) and len(db) == len(jdb)
    assert db.get(b"length") == b"4"


def test_lmdb_reader_branch_tree_and_overflow(tmp_path):
    items = {f"k{i:06d}".encode(): (b"v" * (i % 97) if i % 50 else b"B" * 5000) for i in range(500)}
    _fixture_module().write_lmdb(str(tmp_path / "db"), items)
    db = lmdb_reader.open(str(tmp_path / "db"))
    assert db.depth == 2 and len(db) == 500
    assert all(db.get(k) == v for k, v in items.items())
    assert db.get(b"a-missing") is None and db.get(b"zzzz", b"dflt") == b"dflt"
    assert dict(db.items()) == items
    with db.begin(write=False) as txn:
        assert txn.get(b"k000001") == items[b"k000001"]
    with pytest.raises(lmdb_reader.LmdbFormatError):
        db.begin(write=True)


def test_import_image_dir_equals_jax(tmp_path):
    from PIL import Image

    rng = np.random.default_rng(3)
    img_dir = tmp_path / "imgs"
    img_dir.mkdir()
    for i in range(3):
        Image.fromarray(rng.integers(0, 255, (32, 32, 3), dtype=np.uint8)).save(img_dir / f"{i:05d}.png")
    params = np.array(
        [{"shape": rng.standard_normal(100), "exp": rng.standard_normal(50), "pose": rng.standard_normal(6),
          "cam": rng.standard_normal(3), "tex": rng.standard_normal(50), "lit": rng.standard_normal((9, 3))}
         for _ in range(3)],
        dtype=object,
    )
    np.save(tmp_path / "flame.npy", params, allow_pickle=True)
    lmdb_import.import_image_dir(str(img_dir), str(tmp_path / "flame.npy"), str(tmp_path / "port"), resolution=(16, 32))
    j_lmdb_import.import_image_dir(str(img_dir), str(tmp_path / "flame.npy"), str(tmp_path / "jax"), resolution=(16, 32))
    for s in (16, 32):
        got = tp.load_packed_dataset(str(tmp_path / "port" / f"dataset_{s}.npz"))
        want = jp.load_packed_dataset(str(tmp_path / "jax" / f"dataset_{s}.npz"))
        assert got.images.shape == (3, s, s, 3)
        np.testing.assert_array_equal(np.asarray(got.images), np.asarray(want.images))
        np.testing.assert_array_equal(got.flame_params, want.flame_params)


def test_synthetic_render_dataset_matches_jax(tmp_path):
    """32 px renders of the same FLAME rows over the same backgrounds,
    each package's rasterizer and albedo sampler: within one grey level.
    The cache round trip gives the same frames."""
    kw = dict(n=6, size=32, seed=3, render_batch=4)
    jds = jp.SyntheticRenderDataset(j_synth(seed=1, n_vertices=503), cache_dir="", **kw)
    res = synthetic_flame_resources(seed=1, n_vertices=503)
    tds = tp.SyntheticRenderDataset(res, cache_dir=str(tmp_path), device="cpu", **kw)
    np.testing.assert_array_equal(tds.flame_params, jds.flame_params)
    diff = np.abs(tds.images.astype(np.int32) - jds.images.astype(np.int32))
    assert diff.max() <= 1, diff.max()
    assert tds.conditionally_exact and tds.render_overflows == 0
    # The face is in frame: not just the smooth background gradient.
    assert (np.abs(np.diff(tds.images.astype(np.int32), axis=2)).max(axis=(1, 2, 3)) > 20).all()
    cached = tp.SyntheticRenderDataset(res, cache_dir=str(tmp_path), device="cpu", **kw)
    np.testing.assert_array_equal(cached.images, tds.images)
    assert len(os.listdir(tmp_path)) == 1
    noisy = tp.SyntheticRenderDataset(res, cache_dir="", device="cpu", noise_std=0.05, **kw)
    assert not noisy.conditionally_exact
    assert 0 < np.abs(noisy.images.astype(np.int32) - tds.images.astype(np.int32)).mean() < 20
