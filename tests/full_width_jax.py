"""The JAX package's side of the full-width parity cases
(:mod:`gif_tpu_torch.tools.full_width_goldens`): the same inputs and
rule-made weights through ``gif_tpu`` on the CPU, outputs in the port's
names and layouts (parameter gradients and updates through
``convert_params``)."""

from __future__ import annotations

import contextlib
import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np

from gif_tpu_torch.tools import full_width_goldens as fw
from gif_tpu_torch.tools.convert_params import convert_params
from gif_tpu_torch.tools.seeded_params import seeded_leaf, seeded_tree


def jax_config(run_id: int, compute_dtype: str = "float32", **overrides):
    from gif_tpu.train import get_config

    return get_config(run_id, compute_dtype=compute_dtype, **overrides)


@functools.lru_cache(maxsize=None)
def templates(run_id: int, vocab: int) -> tuple[dict, dict, dict]:
    """(G params, G buffers, D params) of the full-width models with
    ``vocab`` identities as ``jax.ShapeDtypeStruct`` trees, from ``init``
    traced without running."""
    from gif_tpu.train.state import build_models

    cfg = jax_config(run_id, embedding_vocab_size=vocab)
    gen, disc = build_models(cfg)
    s = cfg.max_size
    cond = jnp.zeros((1, s, s, cfg.cond_channels))
    g = jax.eval_shape(lambda k: gen.init(k, cond, input_indices=jnp.zeros((1,), jnp.int32), step=cfg.max_step),
                       jax.random.PRNGKey(0))
    d = jax.eval_shape(lambda k: disc.init(k, jnp.zeros((1, s, s, 3)), cond), jax.random.PRNGKey(1))
    return g["params"], g["buffers"], d["params"]


@functools.lru_cache(maxsize=3)
def generator_trees(run_id: int, vocab: int) -> tuple[dict, dict]:
    """(G params, buffers) drawn by the rule with the case's seed."""
    params, buffers, _ = templates(run_id, vocab)
    seed = fw.WEIGHT_SEEDS[f"g{run_id}"]
    return seeded_tree(params, seed), {"embedding": seeded_leaf("embedding", buffers["embedding"].shape, seed)}


@functools.lru_cache(maxsize=1)
def discriminator_tree() -> dict:
    return seeded_tree(templates(8, jax_config(8).embedding_vocab_size)[2], fw.WEIGHT_SEEDS["d"])


def _np(x) -> np.ndarray:
    return np.asarray(jax.device_get(x))


def jax_outputs(name: str, res, inp: dict, cond: np.ndarray | None = None) -> dict:
    """``gif_tpu``'s outputs of case ``name`` (``cond``: the ``render``
    case's levels, for the G and D cases)."""
    from gif_tpu.flame import flame_decode
    from gif_tpu.flame.camera import batch_orth_proj
    from gif_tpu.train import losses as jl
    from gif_tpu.train.state import build_models
    from gif_tpu.train.step import quantize_condition, render_flame_maps

    if name == "flame":
        fl = jnp.asarray(inp["flame"])
        verts = flame_decode(res, fl[:, :100], fl[:, 100:150], fl[:, 150:156])
        return {"verts": _np(verts), "proj": _np(batch_orth_proj(verts, fl[:, 156:159]))}
    if name == "render":
        cfg = jax_config(8)
        maps = render_flame_maps(res, jnp.asarray(inp["flame"]), cfg.render_image_size, res.n_faces)
        c = quantize_condition(maps.textured, maps.normal, cfg)
        return {"cond": fw.levels(_np(c)), "mask": _np(maps.mask).astype(np.uint8),
                "overflow": _np(maps.overflow).astype(np.uint8)}
    if name in ("g8", "g0", "g8_bf16"):
        run_id = 0 if name == "g0" else 8
        cfg = jax_config(run_id, "bfloat16" if name == "g8_bf16" else "float32")
        gen, _ = build_models(cfg)
        params, buffers = generator_trees(run_id, cfg.embedding_vocab_size)
        kw = ({"z": jnp.asarray(inp["z"])} if "z" in inp
              else {"input_indices": jnp.asarray(inp["indices"], jnp.int32)})
        fn = jax.jit(lambda p, b, c, kw: gen.apply({"params": p, "buffers": b}, c, step=cfg.max_step, **kw))
        return {"image": _np(fn(params, buffers, jnp.asarray(fw.from_levels(cond)), kw))}
    if name == "d":
        cfg = jax_config(8)
        _, disc = build_models(cfg)
        c = jnp.asarray(fw.from_levels(cond))

        def loss_fn(p):
            real = disc.apply({"params": p}, jnp.asarray(inp["real"]), c)
            fake = disc.apply({"params": p}, jnp.asarray(inp["fake"]), c)
            return jl.d_ns_loss(real, fake), (real, fake)

        (loss, (real, fake)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(discriminator_tree())
        return {"scores_real": _np(real), "scores_fake": _np(fake), "loss": _np(loss),
                "grad": {k: v.numpy() for k, v in convert_params(_np_tree(grads)).items()}}
    if name == "sampler":
        from gif_tpu.eval.sampling import FlameSampler

        cfg = jax_config(8)
        params, buffers = generator_trees(8, cfg.embedding_vocab_size)
        sampler = FlameSampler(cfg, res, params, buffers, batch_size=fw.BATCH,
                               max_tris_per_tile=res.n_faces)
        img, c = sampler.sample(inp["flame"], np.asarray(inp["indices"], np.int32))
        return {"image": img, "cond": fw.levels(c)}
    if name == "steal":
        return _steal_outputs(res, inp)
    raise KeyError(name)


def _steal_outputs(res, inp: dict) -> dict:
    """The steal case.  Gradients go through XLA's autodiff of the plain
    gather (a scatter-add), as tests/test_torch_texture_space.py holds the
    port over thousands of points: ``sample_at_points``' CPU backward (the
    sort / cumsum form) loses ~1e-5 absolutely in a difference of two
    running sums.  ``steal_texture`` imports the sampler at call time, so
    the plain gather stands in for it while the steal is traced; the
    forward values are the same either way."""
    from gif_tpu.models.texture_space import flame_texture_space
    from gif_tpu.render import sampling_ops

    plain = sampling_ops._sample_fwd_impl
    fl, img = jnp.asarray(inp["flame"]), jnp.asarray(inp["image"])
    custom = sampling_ops.sample_at_points
    sampling_ops.sample_at_points = plain
    try:
        (tex, vis), vjp = jax.vjp(lambda im: flame_texture_space(res, im, fl), img)
    finally:
        sampling_ops.sample_at_points = custom
    (tex_grad,) = vjp((jnp.asarray(inp["texture_cot"]), np.zeros(vis.shape, jax.dtypes.float0)))
    vals, vjp2 = jax.vjp(lambda im: plain(im, jnp.asarray(inp["points"])), img)
    (pts_grad,) = vjp2(jnp.asarray(inp["points_cot"]))
    np.testing.assert_array_equal(_np(vals), _np(custom(img, jnp.asarray(inp["points"]))))
    return {"texture": _np(tex), "vis": _np(vis).astype(np.uint8), "image_grad": _np(tex_grad),
            "samples": _np(vals), "samples_image_grad": _np(pts_grad)}


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), jax.device_get(tree))


def rule_train_state(jcfg):
    """A fresh JAX train state whose G, EMA and D hold the rule's weights."""
    from gif_tpu.train.state import TrainState, make_optimizers

    g_params, buffers = generator_trees(jcfg.run_id, jcfg.embedding_vocab_size)
    d_params = discriminator_tree()
    as_j = functools.partial(jax.tree_util.tree_map, jnp.asarray)
    g_params, d_params, buffers = as_j(g_params), as_j(d_params), as_j(buffers)
    g_tx, d_tx = make_optimizers(jcfg)
    return TrainState(
        step=jnp.int32(0), g_params=g_params, d_params=d_params,
        g_ema_params=jax.tree_util.tree_map(jnp.copy, g_params), buffers=buffers,
        g_opt_state=g_tx.init(g_params), d_opt_state=d_tx.init(d_params),
        pl_mean=jnp.float32(0.0), used_samples=jnp.int32(0))


@contextlib.contextmanager
def rule_normals(name: str):
    """``jax.random.normal`` answering the calls of ``gif_tpu``'s step and
    losses, while the step of case ``name`` is traced, with the case's numpy
    draws (:func:`full_width_goldens.rule_draws`) in the order the step
    draws them, so the card can rebuild them; every such draw must be one
    of them, and every one of them taken."""
    draws = fw.rule_draws(name)
    queue = [(k, v[0] if k in fw.PER_G_ITERATION else v) for k, v in draws.items()]
    real = jax.random.normal
    step_files = tuple(os.path.join("gif_tpu", "train", f) for f in ("step.py", "losses.py"))

    def normal(key, shape=(), dtype=jnp.float32):
        if not sys._getframe(1).f_code.co_filename.endswith(step_files):
            return real(key, shape, dtype)  # flax's shape checks of initializers
        k, v = queue.pop(0)
        assert tuple(shape) == v.shape, (k, shape, v.shape)
        return jnp.asarray(v, dtype)

    jax.random.normal = normal
    try:
        yield
    finally:
        jax.random.normal = real
    assert not queue, f"{name}: draws never taken: {[k for k, _ in queue]}"


def jax_step_outputs(name: str, res, inp: dict, compute_dtype: str | None = None) -> tuple[dict, dict]:
    """(outputs, draws) of one jitted JAX step of case ``name`` (under
    ``compute_dtype`` when given: a bf16 case's f32 twin) from the
    rule-made state with ``jax.random.PRNGKey(1)``, its standard-normal
    draws the case's rule draws (:func:`rule_normals`); ``draws`` are that
    key's other draws in the port's form (``jax_branch_draws``)."""
    from gif_tpu.train.step import make_train_step
    from torch_port_common import jax_branch_draws

    run_id, over = fw.step_overrides(name)
    if compute_dtype is not None:
        over["compute_dtype"] = compute_dtype
    jcfg = jax_config(run_id, **over)
    state = rule_train_state(jcfg)
    step = make_train_step(jcfg, res, max_tris_per_tile=fw.step_capacity(name, res), fuse_interp=True)
    batch = {k: jnp.asarray(v, jnp.int32 if k in ("indices", "crop") else None) for k, v in inp.items()}
    with rule_normals(name):
        new, m = step(state, batch, jax.random.PRNGKey(1))
        jax.block_until_ready(new)
    assert int(new.step) == 1 and float(m["render_overflow"]) == 0.0
    old, new_np = _np_tree(state), _np_tree(new)
    m = {**m, "pl_mean": new.pl_mean}

    def delta(a, b):
        return {k: v.numpy() - a[k].numpy() for k, v in convert_params(b).items()}

    old_g, old_d, old_e = (convert_params(t) for t in (old.g_params, old.d_params, old.g_ema_params))
    out = {
        "metrics": np.array([float(m[k]) if k in m else 0.0 for k in fw.step_metrics(name)], np.float32),
        "g_grad": {k: v.numpy() for k, v in convert_params(new_np.g_opt_state[0].mu).items()},
        "d_grad": {k: v.numpy() for k, v in convert_params(new_np.d_opt_state[0].mu).items()},
        "g_delta": delta(old_g, new_np.g_params),
        "d_delta": delta(old_d, new_np.d_params),
        "ema_delta": delta(old_e, new_np.g_ema_params),
    }
    draws = jax_branch_draws(jax.random.PRNGKey(1), jcfg, fused=True, b=jcfg.batch_size)
    keep = {k: np.asarray(draws[k]) for k in ("interp_t", "interp_identity", "interp_pairs") if k in draws}
    if jcfg.shfld_cond_as_neg_smpl:
        keep["shuffle_shift"] = np.asarray(draws["shuffle_shift"])
    return out, keep
