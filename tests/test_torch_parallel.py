"""The port's data-parallel training on the CPU: two processes joined by
``torch.distributed`` (gloo), tiny config (f32, max_channels 16, 32 px).

- One step of the 2-rank port step against the JAX package's ``shard_map``
  step on a 2-device mesh, from one converted state (step 1, so R1 fires;
  ``pl_mean`` 0.5), each rank fed its shard's rows and the JAX draws of its
  shard (the key folded with the axis index): run_id 8 with R1 (batch 4,
  2 rows a rank), the fused run_id-0 step (batch 6, 3 rows a rank: the
  interpolation pairs stay within a rank) and the path-length penalty,
  whose mean length is averaged across ranks inside the graph (its
  gradient through the mean's transpose).  Bars, those of the
  single-process parity tests (tests/torch_port_common.py): metrics rtol
  1e-4, ``pl_mean`` rtol 1e-4, the updated G, D and EMA by the delta rule
  of tests/test_torch_train.py (1e-2); both ranks end bit-equal.
- ``train()`` on 2 ranks: only rank 0 logs rows and draws grids, the
  replicas end equal, a resume replays the uninterrupted run exactly.
- ``allgather_rows``'s round-robin order with unequal counts and a cut;
  ``choose_data_mesh_size`` against JAX's, case by case.
"""

import csv
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from gif_tpu.flame.resources import synthetic_flame_resources as j_synth
from gif_tpu.parallel.mesh import choose_data_mesh_size as j_choose
from gif_tpu.train import get_config as j_get_config
from gif_tpu.train.state import create_train_state as j_create_train_state
from gif_tpu.train.step import make_train_step as j_make_train_step
from gif_tpu_torch.parallel import choose_data_mesh_size
from gif_tpu_torch.tools.convert_params import convert_train_state
from gif_tpu_torch.train.config import get_config
from gif_tpu_torch.train.state import TrainState, create_train_state
from torch_parallel_ranks import RES_SEED, RES_VERTICES, allgather, run_ranks, step_cases, train_runs
from torch_port_common import (
    BRANCH_PL_MEAN,
    branch_overrides,
    check_step_update,
    jax_branch_draws,
    numpy_state,
    train_batch,
)

WORLD = 2

# name: (run id, overrides, global batch, fuse_interp)
CASES = {
    "run_id8_r1": (8, {}, 4, True),
    "run_id0_fused": (0, {}, 6, True),
    "path_len_reg": (8, dict(gen_reg_type="path_len_reg"), 4, True),
}


def _overrides(run_id, extra, gb):
    return branch_overrides(run_id, {**extra, "batch_size": gb})


@pytest.fixture(scope="module")
def step_results(tmp_path_factory):
    """Per case: (the JAX state before and after, JAX's metrics, each
    rank's (state_dict, metrics))."""
    tmp = tmp_path_factory.mktemp("parallel_steps")
    res = j_synth(seed=RES_SEED, n_vertices=RES_VERTICES)
    mesh = Mesh(np.array(jax.devices()[:WORLD]), ("data",))
    rows = NamedSharding(mesh, P("data"))
    payload, jax_out = {}, {}
    for case, (run_id, extra, gb, fuse) in CASES.items():
        jcfg = j_get_config(run_id, **_overrides(run_id, extra, gb))
        state = j_create_train_state(jcfg, jax.random.PRNGKey(0)).replace(
            step=jnp.int32(1), pl_mean=jnp.float32(BRANCH_PL_MEAN))
        batch = train_batch(jcfg, gb)
        step = j_make_train_step(jcfg, res, mesh=mesh, max_tris_per_tile=res.n_faces, fuse_interp=fuse)
        new, m = step(state, {k: jax.device_put(jnp.asarray(v), rows) for k, v in batch.items()},
                      jax.random.PRNGKey(1))
        jax_out[case] = (state, new, m)
        b = gb // WORLD
        payload[case] = dict(
            run_id=run_id, overrides=_overrides(run_id, extra, gb), fuse=fuse,
            state=convert_train_state(numpy_state(state)),
            batches=[{k: v[r * b:(r + 1) * b] for k, v in batch.items()} for r in range(WORLD)],
            draws=[jax_branch_draws(jax.random.PRNGKey(1), jcfg, fuse, b=b, shard=r) for r in range(WORLD)],
        )
    torch.save(payload, tmp / "payload.pt")
    run_ranks(step_cases, WORLD, str(tmp / "payload.pt"), str(tmp / "rank{}.pt"))
    ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]
    return {case: (*jax_out[case], [r[case] for r in ranks]) for case in CASES}


def _port_state(cfg, sd) -> TrainState:
    state = create_train_state(cfg, device="cpu")
    state.load_state_dict(sd)
    return state


@pytest.mark.parametrize("case", list(CASES))
def test_two_rank_step_matches_shard_map(step_results, case):
    run_id, extra, gb, _ = CASES[case]
    cfg = get_config(run_id, **_overrides(run_id, extra, gb))
    jprev, jnew, jm, ranks = step_results[case]
    (sd0, m0), (sd1, m1) = ranks
    # The replicas are one: every tensor of the two ranks' states equal.
    for key in ("generator", "g_ema", "discriminator"):
        for name, t in sd0[key].items():
            assert torch.equal(t, sd1[key][name]), (key, name)
    assert torch.equal(sd0["pl_mean"], sd1["pl_mean"]) and m0 == m1
    old = convert_train_state(numpy_state(jprev))
    want = convert_train_state(numpy_state(jnew))
    state = _port_state(cfg, sd0)
    assert state.step == want["step"] == 2 and state.used_samples == want["used_samples"] == gb
    assert set(m0) == set(jm) and m0["r1"] > 0 and m0["render_overflow"] == float(jm["render_overflow"]) == 0.0
    for k in set(m0) - {"render_overflow"}:
        np.testing.assert_allclose(m0[k], float(jm[k]), rtol=1e-4, err_msg=k)
    np.testing.assert_allclose(state.pl_mean.item(), float(want["pl_mean"]), rtol=1e-4)
    if cfg.gen_reg_type == "path_len_reg":
        assert state.pl_mean.item() != BRANCH_PL_MEAN
    check_step_update(state, old, want, cfg, 1e-2, case)


STEPS = 4


@pytest.fixture(scope="module")
def train_results(tmp_path_factory):
    out = tmp_path_factory.mktemp("parallel_train")
    overrides = branch_overrides(8, dict(batch_size=4, fid_every=2, checkpoint_every=2, d_input_noise_std=0.1,
                                         render_in_step=True))
    run_ranks(train_runs, WORLD, str(out), overrides, STEPS)
    return out, [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]


def _rows(path):
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def test_two_rank_train_writes_on_rank0_only(train_results):
    out, (r0, r1) = train_results
    # Rank 0: a row every step of runs a and b (4 + 2 + 2), a grid at each
    # sweep (the baseline, steps 2 and 4); rank 1: none.
    assert (r0["logged"], r0["grids"]) == (2 * STEPS, 3) and (r1["logged"], r1["grids"]) == (0, 0)
    rows = _rows(out / "a" / "8" / "metrics.csv")
    assert [r["step"] for r in rows] == ["1", "2", "3", "4"]
    assert all(np.isfinite(float(r[k])) for r in rows for k in ("d_loss", "g_loss", "fid"))
    assert sorted(g[:6] for g in os.listdir(out / "a" / "8" / "sample" / "8")) == ["000000", "000002", "000004"]
    assert sorted(os.listdir(out / "a" / "8" / "checkpoint")) == ["000000002.pt", "000000004.pt"]


def test_two_rank_train_replicas_equal_and_resume_exact(train_results):
    out, (r0, r1) = train_results
    assert r0["used"] == r1["used"] == (4 * STEPS, 4 * STEPS)
    for key in ("generator", "g_ema", "discriminator"):
        for name, t in r0["a"][key].items():
            assert torch.equal(t, r1["a"][key][name]), (key, name)
            assert torch.equal(t, r0["b"][key][name]), (key, name)
    for key in ("g_opt", "d_opt"):
        for i, st in r0["a"][key]["state"].items():
            for k, v in st.items():
                assert torch.equal(v, r0["b"][key]["state"][i][k]), (key, i, k)
    ra = _rows(out / "a" / "8" / "metrics.csv")
    rb = _rows(out / "b" / "8" / "metrics.csv")
    assert [r["step"] for r in rb] == ["1", "2", "3", "4"]
    for x, y in zip(ra, rb):
        assert {k: x[k] for k in ("d_loss", "g_loss", "r1", "g_total")} == \
            {k: y[k] for k in ("d_loss", "g_loss", "r1", "g_total")}


def test_allgather_rows_round_robin(tmp_path):
    counts, max_rows = (3, 5), 7
    run_ranks(allgather, WORLD, counts, max_rows, str(tmp_path / "rank{}.pt"))
    # The order the JAX package's docstring defines: row 0 of every rank,
    # then row 1, ...; ranks out of rows drop out; the cut keeps the head.
    want = [100, 200, 101, 201, 102, 202, 203, 204][:max_rows]
    for r in range(WORLD):
        rows, idx = torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
        np.testing.assert_array_equal(idx, np.asarray(want, np.int32))
        np.testing.assert_array_equal(rows, np.asarray(want, np.float32)[:, None].repeat(3, 1))


@pytest.mark.parametrize("args", [
    (16, 1, 1, 1), (16, 8, 1, 1), (12, 8, 1, 1), (16, 8, 1, 3), (7, 4, 1, 1), (2, 8, 1, 3),
    (16, 8, 2, 1), (16, 16, 4, 1), (24, 8, 2, 3),
])
def test_choose_data_mesh_size_matches_jax(args):
    assert choose_data_mesh_size(*args) == j_choose(*args)


@pytest.mark.parametrize("args", [(12, 8, 2, 1), (16, 8, 2, 3)])
def test_choose_data_mesh_size_raises_as_jax(args):
    with pytest.raises(ValueError) as want:
        j_choose(*args)
    with pytest.raises(ValueError) as got:
        choose_data_mesh_size(*args)
    assert str(got.value) == str(want.value)


def test_initialize_distributed_never_falls_back(monkeypatch):
    """NCCL without a card raises (no switch to gloo or the CPU); so does a
    call with neither a coordinator nor torchrun's environment."""
    from gif_tpu_torch.parallel import initialize_distributed

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="nccl"):
        initialize_distributed("localhost:1", 1, 0, backend="nccl")
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="torchrun"):
        initialize_distributed(backend="gloo")
    assert not torch.distributed.is_initialized()


def test_single_process_helpers():
    """Outside a process group: one rank, rank 0, the main one; the batch
    slice is the whole batch; host trees are numpy."""
    from gif_tpu_torch.parallel import host_local_tree, is_main_process, process_count, process_index, shard_batch

    assert (process_count(), process_index(), is_main_process()) == (1, 0, True)
    got = shard_batch({"a": np.arange(6).reshape(3, 2), "b": np.ones(3, np.float32)}, "cpu")
    assert torch.equal(got["a"], torch.arange(6).reshape(3, 2)) and got["b"].dtype == torch.float32
    tree = host_local_tree({"x": torch.ones(2), "y": [torch.zeros(1), 3]})
    assert isinstance(tree["x"], np.ndarray) and isinstance(tree["y"][0], np.ndarray) and tree["y"][1] == 3
