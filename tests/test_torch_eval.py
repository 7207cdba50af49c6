"""Port parity of the FID evaluation on the CPU (``gif_tpu_torch.eval``
against ``gif_tpu.eval``): the same seeded images and the same (converted)
InceptionV3 weights go through both.

Tolerances: ``random_fid_params`` and the weight converters are exact; the
pool3 features of the two InceptionV3s agree within rtol / atol 1e-4 (float
convolutions summed in another order over ~90 layers, as
tests/test_inception_parity.py holds the flax net to a torch one); the
resize within 2e-6; the Fréchet distance of the same statistics within
1e-9 relative (the same scipy ``sqrtm``, at 48-d: the 2048-d one takes
~11 s here, and the CLI test computes it); the statistics two FID
computers hand it within 1e-3 of their largest magnitude.  Inside the port, a batch's
features may differ by the batch's size (CPU convolution blocking) within
1e-5 of their largest magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gif_tpu.eval import fid as jfid
from gif_tpu.eval import inception as jinc
from gif_tpu.tools import convert_inception as j_convert_inception
from gif_tpu_torch.eval import fid as tfid
from gif_tpu_torch.eval.inception import InceptionV3FID, preprocess_for_fid, random_fid_params
from gif_tpu_torch.tools.convert_params import convert_inception_params, load_inception_npz
from torch_port_common import cpu_threads


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    with cpu_threads():
        yield


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def port_params():
    return random_fid_params(0)


def test_random_fid_params_equal_jax_exactly(port_params):
    want = convert_inception_params(_numpy_tree(jinc.random_fid_params(0)))
    assert sorted(port_params) == sorted(want)
    for k, v in want.items():
        assert port_params[k].dtype == v.dtype == torch.float32, k
        assert torch.equal(port_params[k], v), k
    n = sum(v.numel() for k, v in port_params.items() if k.endswith("conv.weight"))
    assert n == 21_751_136  # the conv weights of InceptionV3 without its classifier
    other = random_fid_params(1)
    assert not torch.equal(other["Mixed_7c.branch_pool.conv.weight"], port_params["Mixed_7c.branch_pool.conv.weight"])


def _small_random_tree(seed: int) -> dict:
    """A flax InceptionV3 tree with small random weights and non-trivial
    BatchNorm statistics (every leaf drawn, so BN folding and layouts are
    all exercised)."""
    with torch.device("meta"):
        shapes = {k: tuple(v.shape) for k, v in InceptionV3FID().state_dict().items()}
    rng = np.random.default_rng(seed)
    tree: dict = {}
    for k, shape in shapes.items():
        if not k.endswith(".conv.weight"):
            continue
        node = tree
        for part in k[: -len(".conv.weight")].split("."):
            node = node.setdefault(part, {})
        o, i, kh, kw = shape
        node["conv"] = {"kernel": (rng.standard_normal((kh, kw, i, o)) * 0.05).astype(np.float32)}
        node["bn_gamma"] = (rng.uniform(0.5, 1.5, o)).astype(np.float32)
        node["bn_beta"] = (rng.standard_normal(o) * 0.1).astype(np.float32)
        node["bn_mean"] = (rng.standard_normal(o) * 0.1).astype(np.float32)
        node["bn_var"] = (rng.uniform(0.5, 1.5, o)).astype(np.float32)
    return tree


def test_pool3_matches_jax():
    tree = _small_random_tree(5)
    net = InceptionV3FID().eval()
    net.load_state_dict(convert_inception_params(tree))
    rng = np.random.default_rng(0)
    x = (rng.uniform(0.0, 1.0, (2, 299, 299, 3)) * 2.0 - 1.0).astype(np.float32)
    with torch.no_grad():
        got = net(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    jnet = jinc.InceptionV3FID(fid_variant=True)
    want = np.asarray(jax.jit(lambda p, v: jnet.apply({"params": p}, v))(tree, jnp.asarray(x)))
    assert got.shape == want.shape == (2, 2048)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    assert np.abs(want).max() > 1e-2  # the features are live


def test_preprocess_matches_jax():
    rng = np.random.default_rng(1)
    for size in (32, 256):
        x = rng.uniform(0.0, 1.0, (2, size, size, 3)).astype(np.float32)
        got = preprocess_for_fid(torch.from_numpy(x)).numpy()
        want = np.asarray(jinc.preprocess_for_fid(jnp.asarray(x)))
        assert got.shape == want.shape == (2, 299, 299, 3)
        np.testing.assert_allclose(got, want, atol=2e-6)


def test_inception_npz_from_the_jax_converter_loads(tmp_path):
    """A pt_inception-style state_dict -> the JAX package's converter (npz,
    keys joined by '/') -> the port's loader gives the state_dict back, and
    it loads into the port's module by name as it is."""
    sd = convert_inception_params(_small_random_tree(6))
    net = InceptionV3FID()
    net.load_state_dict(sd)  # pytorch_fid's names: no key mapping
    torch.save(net.state_dict(), tmp_path / "pt_inception.pth")
    j_convert_inception.convert(str(tmp_path / "pt_inception.pth"), str(tmp_path / "fid.npz"))
    back = load_inception_npz(str(tmp_path / "fid.npz"))
    assert sorted(back) == sorted(sd)
    assert all(torch.equal(back[k], sd[k]) for k in sd)


def _psd(rng, d, n):
    a = rng.standard_normal((n, d))
    return a.mean(0), np.cov(a, rowvar=False)


def test_frechet_distance_matches_jax():
    rng = np.random.default_rng(2)
    mu1, s1 = _psd(rng, 48, 200)
    mu2, s2 = _psd(rng, 48, 300)
    got = tfid.frechet_distance(mu1, s1, mu2 + 0.1, s2)
    want = jfid.frechet_distance(mu1, s1, mu2 + 0.1, s2)
    assert got > 0
    np.testing.assert_allclose(got, want, rtol=1e-9)
    assert abs(tfid.frechet_distance(mu1, s1, mu1, s1)) < 1e-6
    with pytest.raises(ValueError, match="Imaginary"):
        tfid.frechet_distance(np.zeros(2), np.diag([1.0, -1.0]), np.zeros(2), np.eye(2))
    a = rng.standard_normal((64, 8)).astype(np.float32)
    for g, w in zip(tfid.activation_statistics(a), jfid.activation_statistics(a)):
        np.testing.assert_array_equal(g, w)


@pytest.fixture(scope="module")
def fid_cpu(port_params):
    return tfid.FidComputer(port_params, batch_size=4, device="cpu")


def test_uint8_equals_float_and_padding(fid_cpu):
    rng = np.random.default_rng(3)
    u8 = rng.integers(0, 256, (5, 32, 32, 3), dtype=np.uint8)
    a_u8 = fid_cpu.activations(u8)
    a_f = fid_cpu.activations(u8.astype(np.float32) / 255.0)
    assert a_u8.shape == (5, 2048)
    np.testing.assert_array_equal(a_u8, a_f)
    # The padded last chunk of 1 gives the features of that frame alone.
    alone = fid_cpu.activations(u8[4:])
    np.testing.assert_allclose(a_u8[4:], alone, rtol=0, atol=1e-5 * np.abs(alone).max())


def _statistics_instead_of_distance(monkeypatch):
    """``get_fid*`` return the generated set's (mu, sigma) instead of the
    distance: the streams are compared on their statistics, with no 2048-d
    matrix square root (~11 s on an 8-core CPU)."""
    monkeypatch.setattr(tfid, "frechet_distance", lambda mu_r, sig_r, mu_g, sig_g: (mu_g, sig_g))


def test_streaming_equals_materialized(fid_cpu, monkeypatch):
    _statistics_instead_of_distance(monkeypatch)
    rng = np.random.default_rng(4)
    gen = rng.uniform(-1, 1, (6, 32, 32, 3)).astype(np.float32)
    real = rng.integers(0, 256, (2, 32, 32, 3), dtype=np.uint8)
    mu, sigma = fid_cpu.get_fid(gen, real_images01=real)
    padded = torch.from_numpy(np.concatenate([gen[4:], gen[:2]]))
    mu_s, sigma_s = fid_cpu.get_fid_streaming(
        [torch.from_numpy(gen[:1]), (gen[1:4], 3), (padded, 2)], real_images01=real
    )
    assert mu.shape == (2048,) and sigma.shape == (2048, 2048)
    np.testing.assert_allclose(mu_s, mu, rtol=0, atol=1e-5 * np.abs(mu).max())
    np.testing.assert_allclose(sigma_s, sigma, rtol=0, atol=1e-5 * np.abs(sigma).max())
    with pytest.raises(ValueError):
        fid_cpu.get_fid_streaming([], real_images01=real)


def test_real_stats_cache(port_params, tmp_path, monkeypatch):
    rng = np.random.default_rng(5)
    real = rng.integers(0, 256, (3, 16, 16, 3), dtype=np.uint8)
    fc = tfid.FidComputer(port_params, stats_dir=str(tmp_path), batch_size=4, device="cpu")
    mu, sigma = fc.real_statistics(real, 16)
    assert (tmp_path / "ffhq_16X16_fid_stats.npz").exists()
    fc2 = tfid.FidComputer(port_params, stats_dir=str(tmp_path), batch_size=4, device="cpu")
    mu2, sigma2 = fc2.real_statistics(None, 16)
    np.testing.assert_array_equal(mu2, mu)
    np.testing.assert_array_equal(sigma2, sigma)
    with pytest.raises(ValueError):
        fc2.real_statistics(None, 32)
    # A FID without real images reads the cache of its resolution.
    seen = []
    monkeypatch.setattr(tfid, "frechet_distance", lambda mu_r, sig_r, mu_g, sig_g: seen.append(mu_r) or 0.0)
    fc2.get_fid(rng.uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32))
    np.testing.assert_array_equal(seen[0], mu)


def test_fid_statistics_match_jax_fid_computer(port_params, monkeypatch):
    """The same images through both packages' FID computers with the same
    random weights: the statistics both hand the Fréchet distance (held
    to JAX's above) agree within 1e-3 of their largest magnitude."""
    seen = {"jax": [], "port": []}
    for mod, key in ((jfid, "jax"), (tfid, "port")):
        monkeypatch.setattr(mod, "frechet_distance", lambda *a, k=key: seen[k].append(a) or 0.0)
    rng = np.random.default_rng(6)
    gen = rng.uniform(-1, 1, (4, 32, 32, 3)).astype(np.float32)
    real = rng.integers(0, 256, (3, 32, 32, 3), dtype=np.uint8)
    tfid.FidComputer(port_params, batch_size=4, device="cpu").get_fid(gen, real_images01=real)
    jfid.FidComputer(jinc.random_fid_params(0), batch_size=4).get_fid(gen, real_images01=real)
    for got, want in zip(seen["port"][0], seen["jax"][0]):
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-3 * np.abs(want).max())


def test_sample_batches_device_pads_and_matches_host_batches():
    """The device stream yields full padded batches and ``n_valid``; its
    valid rows are the host stream's images.  A generator module is used
    as it is (the loop's EMA), a state_dict loaded into a fresh one."""
    from gif_tpu_torch.eval.sampling import FlameSampler, random_flame_params
    from gif_tpu_torch.flame.resources import synthetic_flame_resources
    from gif_tpu_torch.models.generator import StyledGenerator
    from gif_tpu_torch.train.config import get_config
    from torch_port_common import tiny_overrides

    cfg = get_config(8, **tiny_overrides())
    res = synthetic_flame_resources(seed=1, n_vertices=503)
    gen = StyledGenerator.from_config(cfg, seed=2)
    flame = random_flame_params(np.random.default_rng(7), 7)
    idx = np.arange(7) % cfg.embedding_vocab_size
    by_module = FlameSampler(cfg, res, gen, batch_size=4, eye_center=False, device="cpu")
    by_state = FlameSampler(cfg, res, gen.state_dict(), batch_size=4, eye_center=False, device="cpu")
    assert by_module.generator is gen and by_state.generator is not gen
    stream = list(by_module.sample_batches_device(flame, idx))
    assert [(tuple(b.shape), n) for b, n in stream] == [((4, 32, 32, 3), 4), ((4, 32, 32, 3), 3)]
    host = np.concatenate([img for img, _ in by_state.sample_batches(flame, idx)])
    dev = torch.cat([b[:n] for b, n in stream]).numpy()
    np.testing.assert_allclose(dev, host, rtol=0, atol=1e-6)
