"""The port's full-width parity cases and their goldens.

Each case feeds numpy-seeded inputs and weights drawn by
:mod:`gif_tpu_torch.tools.seeded_params` to one piece of the port at the
size users run — 256 px, 512 channels, channel multiplier 2, an 8-layer
mapping net, 69158 identities, the FLAME-sized synthetic mesh (5023
vertices, 10042 faces, 20000 texels), raster capacity equal to the face
count — and returns its outputs as numpy arrays (a parameter-shaped
output as a dict of arrays by parameter name).  The JAX package computes
the same cases from the same inputs (``tests/full_width_jax.py``):
``tests/test_torch_full_width*.py`` hold the two together live on the
CPU, ``tests/golden/regen_torch_full_width.py`` summarises JAX's outputs
into ``tests/golden/torch_full_width.npz``, and ``chip_smoke.py`` (phase
23) holds the port on the card to that file, with no JAX there.

Cases, in the order the modules should be checked:

- ``flame``: FLAME decode and the orthographic projection of 2 codes;
- ``render``: ``render_condition_maps`` (8-bit levels), the foreground
  mask and the overflow flags;
- ``g8``, ``g0``: G forward in f32 (run_id 8 from identity indices,
  run_id 0 — the same architecture — from a latent ``z``), on the
  ``render`` case's reference condition maps;
- ``g8_bf16``: ``g8`` under the default bf16 compute policy;
- ``d``: D's scores of a real and a fake batch in f32, the non-saturating
  D loss and its first-order parameter gradient;
- ``sampler``: ``FlameSampler.sample`` (eye-centring, render, G);
- ``steal``: ``flame_texture_space`` (texture, visibility, the image
  gradient of a weighted sum of the texture) and ``sample_at_points`` at
  the 20000 texels' count (values and image gradient);
- ``step8``, ``step0``: one train step with R1 (``r1_interval`` 1) on 4
  rows from a rule-made f32 state: run_id 8, and run_id 0 with the fused
  interpolation loss.  Outputs: the
  metrics, G's and D's gradients (Adam's first moments: beta1 is 0), the
  updates of G and D and the EMA's.

A golden summarises each array output by its shape and dtype, the float64
sum and sum of squares, per-channel mean and std (last axis, where it has
at most 16 entries), a 64-bucket count sketch (each element added with a
seeded sign into a seeded bucket: the summed squares of two sketches'
difference estimate the squared L2 distance of the arrays without bias)
and 4096 values at seeded positions; parameter-shaped outputs keep, per
tensor, the sums, the sketch and 64 values.  8-bit condition maps are
stored whole.
"""

from __future__ import annotations

import dataclasses
import functools
import io
import zipfile
import zlib

import numpy as np

CASES = ("flame", "render", "g8", "g0", "g8_bf16", "d", "sampler", "steal")
STEP_CASES = ("step8", "step0")
BATCH = 2
# The train steps take minibatch stddev's groups of 4, as training does: in
# groups of 2 a feature's std is |a - b| / 2, whose curvature where the two
# samples nearly coincide makes R1's double backward ill-conditioned
# (tests/test_torch_full_width_steps.py measures it).
STEP_BATCH = 4
INPUT_SEED = 14
WEIGHT_SEEDS = {"g8": 8, "g0": 0, "d": 1}
SKETCH = 64
SAMPLES = 4096
TENSOR_SAMPLES = 64
SUMMARY_SEED = 2014
STEP_METRICS = ("d_loss", "g_loss", "r1", "g_total", "interp")


@dataclasses.dataclass(frozen=True)
class Bar:
    """How an output is held to its reference.

    ``kind``: ``allclose`` (every value within ``atol + rtol |want|``, and
    the relative L2 error at most ``rel_l2``), ``rel_l2`` (the relative L2
    error at most ``rel_l2``; for a parameter-shaped output, per tensor),
    ``tree_l2`` (a parameter-shaped output's relative L2 error over all its
    tensors together at most ``rel_l2``),
    ``levels`` (8-bit maps: at most one level apart, more than half a level
    on under ``flips`` of the values) or ``flips`` (0 / 1 maps: under
    ``flips`` of the values differ)."""

    kind: str
    rtol: float = 0.0
    atol: float = 0.0
    rel_l2: float = 0.0
    flips: float = 0.0

    def text(self) -> str:
        if self.kind == "allclose":
            return f"rtol {self.rtol:g} / atol {self.atol:g}, rel L2 <= {self.rel_l2:g}"
        if self.kind == "rel_l2":
            return f"rel L2 <= {self.rel_l2:g}"
        if self.kind == "tree_l2":
            return f"rel L2 over all tensors <= {self.rel_l2:g}"
        if self.kind == "levels":
            return f"<= 1 level, flips < {self.flips:g}"
        return f"flips <= {self.flips:g}"


# FLAME decode: tests/test_torch_flame.py's bar.
_FLAME = Bar("allclose", rtol=1e-5, atol=1e-6, rel_l2=1e-5)
# G in f32: tests/test_torch_generator.py's bar; the relative L2 cap is the
# loosest any full-depth f32 comparison may take.
_G = Bar("allclose", rtol=1e-4, atol=1e-5, rel_l2=1e-3)
_LEVELS = Bar("levels", flips=0.005)
# First-order parameter gradients, per tensor.
_GRAD = Bar("rel_l2", rel_l2=1e-3)

BARS = {
    ("flame", "verts"): _FLAME,
    ("flame", "proj"): _FLAME,
    ("render", "cond"): _LEVELS,
    ("render", "mask"): Bar("flips", flips=0.005),
    ("render", "overflow"): Bar("flips", flips=0.0),
    ("g8", "image"): _G,
    ("g0", "image"): _G,
    ("g8_bf16", "image"): Bar("rel_l2", rel_l2=2e-2),
    ("d", "scores_real"): Bar("allclose", rtol=1e-4, atol=1e-5, rel_l2=1e-4),
    ("d", "scores_fake"): Bar("allclose", rtol=1e-4, atol=1e-5, rel_l2=1e-4),
    ("d", "loss"): Bar("allclose", rtol=1e-4, atol=1e-6, rel_l2=1e-4),
    ("d", "grad"): _GRAD,
    ("sampler", "cond"): _LEVELS,
    # G fed conditions that differ on under 0.5% of values by one level.
    ("sampler", "image"): Bar("rel_l2", rel_l2=1e-3),
    # A texel whose blended normal's z lies within rounding of 0 may flip
    # where the vertex normals are summed in another order (the card's).
    ("steal", "vis"): Bar("flips", flips=1e-4),
    # FLAME decode's ~1e-7 relative differences move a projected texel by
    # up to ~2.4e-5 px at 256 px; next to the zero padding (a cliff of up
    # to one unit a pixel) that moves its sample as far.
    # tests/test_torch_texture_space.py's 1e-5 holds at 64 px, where the
    # same drift is four times fewer pixels.
    ("steal", "texture"): Bar("allclose", rtol=1e-5, atol=4e-5, rel_l2=1e-5),
    # The same drift moves each point's bilinear weights, times its
    # standard-normal cotangent.
    ("steal", "image_grad"): Bar("rel_l2", rel_l2=1e-4),
    # The same points in both packages: tests/test_torch_texture_space.py's
    # bars.
    ("steal", "samples"): Bar("allclose", rtol=1e-6, atol=1e-7, rel_l2=1e-6),
    ("steal", "samples_image_grad"): Bar("allclose", rtol=1e-5, atol=1e-6, rel_l2=1e-5),
}
# The train steps' gradients pass through D's input gradient, whose
# elements are sums over thousands of products of either sign: two float32
# evaluations of it at full width differ by ~4e-4 in relative L2 (the
# port's own oneDNN and native convolutions as much as the port and
# gif_tpu; tests/test_torch_full_width_steps.py measures it).  G's
# gradient and loss are moreover taken at the updated D, which differs
# between the packages where Adam's first step flipped the sign of a
# near-zero gradient (~0.03% of D's parameters, each 2 lr apart): up to
# ~7e-3 per tensor on the CPU, in small bias vectors.
_STEP_GRAD = Bar("rel_l2", rel_l2=2e-2)
# Adam's first step moves a parameter by about -lr sign(g): where float
# noise flips a near-zero gradient's sign the two packages move it 2 lr
# apart, and one flip in a 128-entry bias vector is already 0.18 of its
# relative L2.  Held over the whole tree by the tiny tests' rule (mean
# |error| <= 1e-2 mean |update|, 0.5% flips): 2 sqrt(0.005) = 0.14 in
# relative L2.
_UPDATE = Bar("tree_l2", rel_l2=0.14)
for _step in STEP_CASES:
    BARS.update({
        # R1 (~5e-5) comes from D's input gradient, G's loss from the
        # updated D (both above): they agree to ~1e-4.
        (_step, "metrics"): Bar("allclose", rtol=1e-3, atol=1e-9, rel_l2=1e-3),
        (_step, "g_grad"): _STEP_GRAD,
        (_step, "d_grad"): _STEP_GRAD,
        (_step, "g_delta"): _UPDATE,
        (_step, "d_delta"): _UPDATE,
        # The EMA's step, (1 - decay) * update (~3.5e-6), on the synthesis
        # tensors (the mapping weights, ~100, move by less than their float
        # spacing); every EMA tensor is also held to the EMA of the port's
        # own updated G (rtol 1e-6).
        (_step, "ema_delta"): _UPDATE,
    })


def full_config(run_id: int, compute_dtype: str = "float32", **overrides):
    """``get_config(run_id)`` at full width with ``compute_dtype``."""
    from gif_tpu_torch.train.config import get_config

    return get_config(run_id, compute_dtype=compute_dtype, **overrides)


def step_config(name: str):
    """The config of step case ``name``: R1 on every step, f32."""
    return full_config(8 if name == "step8" else 0, batch_size=STEP_BATCH, r1_interval=1)


def _rng(name: str) -> np.random.Generator:
    return np.random.default_rng([INPUT_SEED, zlib.crc32(name.encode())])


def flame_codes(rng: np.random.Generator, n: int) -> np.ndarray:
    """(n, 236) codes: shape, expression, small poses, a camera scale in
    [7, 9] with small shifts, texture codes and SH light around an ambient
    term of 3."""
    flame = np.zeros((n, 236), np.float32)
    flame[:, :100] = rng.standard_normal((n, 100))
    flame[:, 100:150] = rng.standard_normal((n, 50)) * 0.7
    flame[:, 150:156] = rng.standard_normal((n, 6)) * 0.05
    flame[:, 156] = rng.uniform(7.0, 9.0, n)
    flame[:, 157:159] = rng.standard_normal((n, 2)) * 0.02
    flame[:, 159:209] = rng.standard_normal((n, 50))
    flame[:, 209:236] = rng.standard_normal((n, 27)) * 0.3
    flame[:, 209:212] += 3.0
    return flame


def smooth_image(b: int, s: int) -> np.ndarray:
    """Slowly varying (b, s, s, 3) images: a stolen texel's value then moves
    little with its projected point, which carries FLAME decode's ~1e-6
    relative differences between the packages."""
    y, x = np.meshgrid(np.linspace(0, 1, s), np.linspace(0, 1, s), indexing="ij")
    img = np.stack([np.sin(2 * x + 1 + k) * np.cos(1.5 * y + k) for k in range(3)], -1)
    return np.stack([img * (0.5 + 0.25 * i) for i in range(b)]).astype(np.float32)


def inputs(name: str, n_texels: int = 20000) -> dict:
    """The case's numpy inputs (conditions come from the ``render`` case's
    reference output and are passed apart)."""
    rng = _rng(name)
    cfg = full_config(8)
    s, vocab = cfg.max_size, cfg.embedding_vocab_size
    if name in ("flame", "render"):
        return {"flame": flame_codes(rng, BATCH)}
    if name in ("g8", "g8_bf16"):
        return {"indices": np.array([3, vocab - 1], np.int64)}
    if name == "g0":
        return {"z": rng.standard_normal((BATCH, 512)).astype(np.float32)}
    if name == "d":
        return {"real": rng.uniform(-1, 1, (BATCH, s, s, 3)).astype(np.float32),
                "fake": rng.uniform(-1, 1, (BATCH, s, s, 3)).astype(np.float32)}
    if name == "sampler":
        return {"flame": flame_codes(rng, BATCH), "indices": rng.integers(0, vocab, BATCH)}
    if name == "steal":
        return {"flame": flame_codes(rng, BATCH), "image": smooth_image(BATCH, s),
                "texture_cot": rng.standard_normal((BATCH, 256, 256, 3)).astype(np.float32),
                "points": rng.uniform(-1.2, 1.2, (BATCH, n_texels, 2)).astype(np.float32),
                "points_cot": rng.standard_normal((BATCH, n_texels, 3)).astype(np.float32)}
    if name in STEP_CASES:
        b = STEP_BATCH
        return {"real_image": rng.uniform(-1, 1, (b, s, s, 3)).astype(np.float32),
                "flame": flame_codes(rng, b), "indices": rng.integers(0, vocab, b)}
    raise KeyError(name)


def levels(cond) -> np.ndarray:
    """[-1, 1] condition maps on the 8-bit grid -> their uint8 levels."""
    return np.rint((np.asarray(cond, np.float64) + 1.0) * 127.5).astype(np.uint8)


def from_levels(lv: np.ndarray) -> np.ndarray:
    """uint8 levels -> the [-1, 1] float32 maps the packages compute."""
    return (lv.astype(np.float32) / np.float32(255.0)) * np.float32(2.0) - np.float32(1.0)


# --- the port's side --------------------------------------------------------


@functools.lru_cache(maxsize=2)
def _generator_sd(run_id: int) -> dict:
    from gif_tpu_torch.tools.seeded_params import seeded_generator_state

    return seeded_generator_state(full_config(run_id), WEIGHT_SEEDS[f"g{run_id}"])


@functools.lru_cache(maxsize=1)
def _discriminator_sd() -> dict:
    from gif_tpu_torch.tools.seeded_params import seeded_discriminator_state

    return seeded_discriminator_state(full_config(8), WEIGHT_SEEDS["d"])


def rule_generator(cfg):
    """The ``StyledGenerator`` of ``cfg`` on the CPU holding the rule's
    weights for its run_id (a copy: the caller may train it)."""
    import torch

    from gif_tpu_torch.models.generator import StyledGenerator

    with torch.device("meta"):
        gen = StyledGenerator.from_config(cfg)
    gen.load_state_dict({k: v.clone() for k, v in _generator_sd(cfg.run_id).items()}, assign=True)
    return gen


def rule_discriminator(cfg):
    """The ``Discriminator`` of ``cfg`` on the CPU holding the rule's
    weights (a copy)."""
    import torch

    from gif_tpu_torch.models.discriminator import Discriminator

    with torch.device("meta"):
        disc = Discriminator.from_config(cfg)
    disc.load_state_dict({k: v.clone() for k, v in _discriminator_sd().items()}, assign=True)
    return disc


def _np(t) -> np.ndarray:
    """A numpy copy of ``t`` (never a view of a CPU tensor the step then
    updates in place)."""
    return np.array(t.detach().float().cpu().numpy())


def port_outputs(name: str, res, device, inp: dict, cond: np.ndarray | None = None) -> dict:
    """The port's outputs of case ``name`` on ``device`` (``cond``: the
    reference's condition maps, for the G and D cases)."""
    import torch

    from gif_tpu_torch.flame.camera import batch_orth_proj
    from gif_tpu_torch.flame.decoder import flame_decode
    from gif_tpu_torch.train import losses
    from gif_tpu_torch.train.step import quantize_condition, render_flame_maps

    def t(x, dtype=torch.float32):
        return torch.as_tensor(x, dtype=dtype, device=device)

    if name == "flame":
        fl = t(inp["flame"])
        verts = flame_decode(res, fl[:, :100], fl[:, 100:150], fl[:, 150:156])
        return {"verts": _np(verts), "proj": _np(batch_orth_proj(verts, fl[:, 156:159]))}
    if name == "render":
        cfg = full_config(8)
        maps = render_flame_maps(res, t(inp["flame"]), cfg.render_image_size, res.n_faces)
        c = quantize_condition(maps.textured, maps.normal, cfg)
        return {"cond": levels(_np(c)), "mask": maps.mask.cpu().numpy().astype(np.uint8),
                "overflow": maps.overflow.cpu().numpy().astype(np.uint8)}
    if name in ("g8", "g0", "g8_bf16"):
        cfg = full_config(0 if name == "g0" else 8, "bfloat16" if name == "g8_bf16" else "float32")
        gen = rule_generator(cfg).to(device).eval()
        kw = ({"z": t(inp["z"])} if "z" in inp else {"input_indices": t(inp["indices"], torch.long)})
        with torch.inference_mode():
            img = gen(t(from_levels(cond)), step=cfg.max_step, **kw)
        return {"image": _np(img)}
    if name == "d":
        disc = rule_discriminator(full_config(8)).to(device)
        c = t(from_levels(cond))
        real, fake = disc(t(inp["real"]), c), disc(t(inp["fake"]), c)
        loss = losses.d_ns_loss(real, fake)
        names, params = zip(*disc.named_parameters())
        grads = torch.autograd.grad(loss, params)
        return {"scores_real": _np(real), "scores_fake": _np(fake), "loss": _np(loss),
                "grad": {n: _np(g) for n, g in zip(names, grads)}}
    if name == "sampler":
        from gif_tpu_torch.eval.sampling import FlameSampler

        cfg = full_config(8)
        gen = rule_generator(cfg).to(device).eval()
        sampler = FlameSampler(cfg, res, gen, batch_size=BATCH, max_tris_per_tile=res.n_faces, device=device)
        img, c = sampler.sample(inp["flame"], inp["indices"])
        assert sampler.render_overflows == 0
        return {"image": img, "cond": levels(c)}
    if name == "steal":
        from gif_tpu_torch.models.texture_space import flame_texture_space
        from gif_tpu_torch.render.sampling_ops import sample_at_points

        img = t(inp["image"]).requires_grad_(True)
        tex, vis = flame_texture_space(res, img, t(inp["flame"]))
        (tex_grad,) = torch.autograd.grad((tex * t(inp["texture_cot"])).sum(), img)
        img2 = t(inp["image"]).requires_grad_(True)
        vals = sample_at_points(img2, t(inp["points"]))
        (pts_grad,) = torch.autograd.grad((vals * t(inp["points_cot"])).sum(), img2)
        return {"texture": _np(tex), "vis": vis.cpu().numpy().astype(np.uint8), "image_grad": _np(tex_grad),
                "samples": _np(vals), "samples_image_grad": _np(pts_grad)}
    raise KeyError(name)


def rule_train_state(cfg, device):
    """A fresh port train state on ``device`` whose G, EMA and D hold the
    rule's weights (G: run_id's seed; D: ``WEIGHT_SEEDS["d"]``)."""
    from gif_tpu_torch.train.state import create_train_state

    state = create_train_state(cfg, device=device)
    state.generator.load_state_dict(_generator_sd(cfg.run_id))
    state.g_ema.load_state_dict(_generator_sd(cfg.run_id))
    state.discriminator.load_state_dict(_discriminator_sd())
    return state


def port_step_outputs(name: str, res, device, inp: dict, draws: dict) -> dict:
    """One port train step of case ``name`` from the rule-made state, with
    the reference's draws: metrics, gradients and updates by parameter."""
    import torch

    from gif_tpu_torch.train.step import make_train_step

    cfg = step_config(name)
    state = rule_train_state(cfg, device)
    before = {what: {n: _np(p) for n, p in getattr(state, what).named_parameters()}
              for what in ("generator", "discriminator", "g_ema")}
    step = make_train_step(cfg, res, device=device, max_tris_per_tile=res.n_faces, fuse_interp=True)
    batch = {"real_image": torch.as_tensor(inp["real_image"], device=device),
             "flame": torch.as_tensor(inp["flame"], device=device),
             "indices": torch.as_tensor(inp["indices"], dtype=torch.long, device=device)}
    state, m = step(state, batch, draws)
    assert state.step == 1 and m["render_overflow"].item() == 0.0

    def moments(opt, module):
        return {n: _np(opt.state[p]["exp_avg"]) for n, p in module.named_parameters()}

    def deltas(what):
        return {n: _np(p) - before[what][n] for n, p in getattr(state, what).named_parameters()}

    out = {"metrics": np.array([m[k].item() if k in m else 0.0 for k in STEP_METRICS], np.float32),
           "g_grad": moments(state.g_opt, state.generator), "d_grad": moments(state.d_opt, state.discriminator),
           "g_delta": deltas("generator"), "d_delta": deltas("discriminator"), "ema_delta": deltas("g_ema")}
    # The EMA of the port's own updated G (rtol 1e-6), every tensor.
    decay = np.float32(cfg.ema_decay)
    for n, p in state.g_ema.named_parameters():
        want = before["g_ema"][n] * decay + _np(state.generator.get_parameter(n)) * (np.float32(1) - decay)
        np.testing.assert_allclose(_np(p), want, rtol=1e-6, atol=1e-7, err_msg=n)
    return out


# --- comparisons --------------------------------------------------------------


def rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    den = np.linalg.norm(want)
    return float(np.linalg.norm(got - want) / den) if den else float(np.linalg.norm(got))


def check(got, want, bar: Bar) -> tuple[float, float, bool]:
    """(max abs error, relative L2 error or flip share, within ``bar``) of
    ``got`` against the whole reference ``want``."""
    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape:
        return float("inf"), float("inf"), False
    if bar.kind in ("levels", "flips"):
        diff = np.abs(got.astype(np.int64) - want.astype(np.int64))
        flips = float((diff > 0).mean())
        worst = float(diff.max()) if diff.size else 0.0
        ok = (worst <= 1 and flips < bar.flips) if bar.kind == "levels" else flips <= bar.flips
        return worst, flips, ok
    err = np.abs(got.astype(np.float64) - want.astype(np.float64))
    r = rel_l2(got, want)
    ok = r <= bar.rel_l2
    if bar.kind == "allclose":
        ok = ok and bool(np.all(err <= bar.atol + bar.rtol * np.abs(want.astype(np.float64))))
    return float(err.max()) if err.size else 0.0, r, ok


def check_tree(got: dict, want: dict, bar: Bar, held=None) -> tuple[float, float, bool, str]:
    """A parameter-shaped output: (max abs error, the worst tensor's
    relative L2 error — or, for a ``tree_l2`` bar, all tensors' together —,
    within ``bar``, the worst tensor's name), over the tensors ``held``
    (a name predicate) keeps."""
    if set(got) != set(want):
        return float("inf"), float("inf"), False, "names differ"
    worst, worst_name, max_abs, num, den = 0.0, "", 0.0, 0.0, 0.0
    for n in sorted(want):
        if held is not None and not held(n):
            continue
        g, w = np.asarray(got[n], np.float64), np.asarray(want[n], np.float64)
        max_abs = max(max_abs, float(np.abs(g - w).max()))
        d2, w2 = float(((g - w) ** 2).sum()), float((w * w).sum())
        num, den = num + d2, den + w2
        r = np.sqrt(d2 / w2) if w2 else np.sqrt(d2)
        if r > worst:
            worst, worst_name = r, n
    return max_abs, *_tree_verdict(bar, worst, num, den), worst_name


def _tree_verdict(bar: Bar, worst: float, num: float, den: float) -> tuple[float, bool]:
    if bar.kind == "tree_l2":
        r = float(np.sqrt(num / den)) if den else float(np.sqrt(num))
        return r, r <= bar.rel_l2
    return worst, worst <= bar.rel_l2


def held_tensors(out_name: str):
    """The predicate of the tensors of a parameter-shaped output that are
    held, or None for all: the EMA's step is held on all but the mapping
    net's weights (~100), which move by less than their float spacing."""
    if out_name == "ema_delta":
        return lambda name: not name.startswith("mapping.")
    return None


# --- goldens ----------------------------------------------------------------


def _layout(key: str, n: int, k: int):
    rng = np.random.default_rng([SUMMARY_SEED, zlib.crc32(key.encode())])
    buckets = rng.integers(0, SKETCH, n)
    signs = rng.integers(0, 2, n).astype(np.float64) * 2.0 - 1.0
    positions = np.sort(rng.choice(n, min(k, n), replace=False)) if n else np.zeros(0, np.int64)
    return buckets, signs, positions


def sketch(flat: np.ndarray, key: str) -> np.ndarray:
    """The 64-bucket count sketch of a flat array (float64)."""
    buckets, signs, _ = _layout(key, flat.size, 0)
    return np.bincount(buckets, weights=signs * flat.astype(np.float64), minlength=SKETCH)


def summarize(arr: np.ndarray, key: str, n_samples: int = SAMPLES) -> dict:
    """The golden summary of one array (see the module docstring)."""
    arr = np.asarray(arr)
    flat = arr.reshape(-1).astype(np.float64)
    _, _, positions = _layout(key, flat.size, n_samples)
    out = {"shape": np.asarray(arr.shape, np.int64), "dtype": np.asarray(str(arr.dtype)),
           "sum": np.asarray(flat.sum()), "sumsq": np.asarray((flat * flat).sum()),
           "sketch": sketch(flat, key), "positions_n": np.asarray(len(positions)),
           "samples": flat[positions].astype(np.float32)}
    if arr.ndim >= 2 and 1 < arr.shape[-1] <= 16:
        ch = arr.reshape(-1, arr.shape[-1]).astype(np.float64)
        out["ch_mean"], out["ch_std"] = ch.mean(0), ch.std(0)
    return out


def golden_entries(case: str, outputs: dict) -> dict:
    """Flat npz entries ``case/output/...`` for one case's reference
    outputs.  A parameter-shaped output's tensors are packed: ``names``
    (sorted), ``sizes``, ``sum``, ``sumsq``, ``sketch`` (one row each) and
    ``samples`` (each tensor's values at its positions, concatenated)."""
    entries = {}
    for out_name, value in outputs.items():
        key = f"{case}/{out_name}"
        if isinstance(value, dict):
            names = sorted(value)
            rows = [summarize(value[n], f"{key}/{n}", TENSOR_SAMPLES) for n in names]
            entries[f"{key}/names"] = np.asarray(names)
            entries[f"{key}/sizes"] = np.asarray([value[n].size for n in names], np.int64)
            for stat in ("sum", "sumsq"):
                entries[f"{key}/{stat}"] = np.asarray([r[stat] for r in rows], np.float64)
            entries[f"{key}/sketch"] = np.stack([r["sketch"] for r in rows]).astype(np.float32)
            entries[f"{key}/samples"] = np.concatenate([r["samples"] for r in rows])
        elif value.dtype == np.uint8:
            entries[f"{key}/whole"] = value
        else:
            for stat, v in summarize(value, key).items():
                entries[f"{key}/{stat}"] = v
    return entries


def write_npz(path: str, entries: dict) -> None:
    """``entries`` as an ``np.load``-able npz whose bytes depend on the
    entries alone (fixed member timestamps, sorted names)."""
    with zipfile.ZipFile(path, "w", compression=zipfile.ZIP_DEFLATED) as zf:
        for name in sorted(entries):
            buf = io.BytesIO()
            np.lib.format.write_array(buf, np.asarray(entries[name]), allow_pickle=False)
            info = zipfile.ZipInfo(name + ".npy", date_time=(1980, 1, 1, 0, 0, 0))
            info.compress_type = zipfile.ZIP_DEFLATED
            info.external_attr = 0o644 << 16
            zf.writestr(info, buf.getvalue())


class Golden:
    """A golden file: reference summaries by ``case/output``."""

    def __init__(self, path: str):
        with np.load(path, allow_pickle=False) as z:
            self.entries = {k: z[k] for k in z.files}

    def whole(self, case: str, out_name: str) -> np.ndarray:
        return self.entries[f"{case}/{out_name}/whole"]

    def outputs(self, case: str) -> list:
        names = {k.split("/")[1] for k in self.entries if k.startswith(case + "/")}
        return sorted(names - {"draws"})

    def draws(self, case: str) -> dict:
        pre = f"{case}/draws/"
        return {k[len(pre):]: self.entries[k] for k in self.entries if k.startswith(pre)}

    def check(self, case: str, out_name: str, got) -> tuple[float, float, bool, str]:
        """(max abs error at the stored positions, relative L2 error
        estimated from the sketches — or, for 8-bit and 0 / 1 maps, their
        exact values —, within the bar, the worst tensor's name for a
        parameter-shaped output) of the port's output ``got``."""
        bar = BARS[(case, out_name)]
        key = f"{case}/{out_name}"
        if isinstance(got, dict):
            return self._check_tree(key, got, bar, held_tensors(out_name))
        if f"{key}/whole" in self.entries:
            a, r, ok = check(got, self.entries[f"{key}/whole"], bar)
            return a, r, ok, ""
        got = np.asarray(got)
        shape, dtype = tuple(self.entries[f"{key}/shape"]), str(self.entries[f"{key}/dtype"])
        if got.shape != shape or str(got.dtype) != dtype:
            return float("inf"), float("inf"), False, f"{got.shape} {got.dtype} != {shape} {dtype}"
        flat = got.reshape(-1)
        a, d2 = _estimate(key, flat, SAMPLES, self.entries[f"{key}/samples"], self.entries[f"{key}/sketch"])
        w2 = float(self.entries[f"{key}/sumsq"])
        r = float(np.sqrt(d2 / w2)) if w2 else float(np.sqrt(d2))
        ok = r <= bar.rel_l2
        if bar.kind == "allclose":
            _, _, pos = _layout(key, got.size, SAMPLES)
            want = self.entries[f"{key}/samples"].astype(np.float64)
            err = np.abs(got.reshape(-1)[pos].astype(np.float64) - want)
            ok = ok and bool(np.all(err <= bar.atol + bar.rtol * np.abs(want)))
        return a, r, ok, ""

    def _check_tree(self, key: str, got: dict, bar: Bar, held) -> tuple[float, float, bool, str]:
        names = [str(n) for n in self.entries[f"{key}/names"]]
        if sorted(got) != names:
            return float("inf"), float("inf"), False, "names differ"
        sizes = self.entries[f"{key}/sizes"]
        ends = np.cumsum(np.minimum(sizes, TENSOR_SAMPLES))
        worst, worst_name, max_abs, num, den = 0.0, "", 0.0, 0.0, 0.0
        for i, n in enumerate(names):
            flat = np.asarray(got[n]).reshape(-1)
            if flat.size != sizes[i]:
                return float("inf"), float("inf"), False, f"{n}: size {flat.size} != {sizes[i]}"
            if held is not None and not held(n):
                continue
            want = self.entries[f"{key}/samples"][ends[i] - min(sizes[i], TENSOR_SAMPLES):ends[i]]
            a, d2 = _estimate(f"{key}/{n}", flat, TENSOR_SAMPLES, want, self.entries[f"{key}/sketch"][i])
            w2 = float(self.entries[f"{key}/sumsq"][i])
            max_abs, num, den = max(max_abs, a), num + d2, den + w2
            r = np.sqrt(d2 / w2) if w2 else np.sqrt(d2)
            if r > worst:
                worst, worst_name = r, n
        return max_abs, *_tree_verdict(bar, worst, num, den), worst_name


def _estimate(key: str, flat: np.ndarray, n_samples: int, samples, sketched) -> tuple[float, float]:
    """(max abs error of ``flat`` at the stored positions, its squared L2
    error from the reference estimated from the sketches)."""
    _, _, pos = _layout(key, flat.size, n_samples)
    want = np.asarray(samples, np.float64)
    a = float(np.abs(flat[pos].astype(np.float64) - want).max()) if len(pos) else 0.0
    d = sketch(flat, key) - np.asarray(sketched, np.float64)
    return a, float((d * d).sum())
