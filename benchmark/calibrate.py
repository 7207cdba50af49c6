"""The readings that the limits of a training cell are set from, on the
chip, in one process:

    python3 -m benchmark.calibrate --workload <name> --seeds 11,12,13 [--flops]

For each seed: the program's first three steps against the reference
(a sound run, with a one-cycle window: the lower reading); the control --
the reference computed with its bfloat16 convolutions on float8 operands
(``reference.ops.lower_precision``), put in the program's place; and the
faults of :func:`faults`, each the reference put in the program's place.
A state left unchanged reads 1 on ``change_gap`` and ``change_ratio`` by
their measure and needs no run.  ``--flops`` also counts the program's
step with PyTorch's FLOP counter, once, beside the analytic count.  One
JSON line per seed, then a summary line.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402

from benchmark.harness import compare, env, registry, traffic  # noqa: E402


def flop_cross_check(cell, seed: int) -> dict:
    """PyTorch's FLOP counter over one R1 step and one plain step of the
    program, against the analytic count."""
    import torch

    from gif_tpu_torch.train.step import make_train_step
    from gif_tpu_torch.utils.flops import compiled_flops

    from benchmark.harness import flops, train
    from benchmark.reference.train import build_models
    from benchmark.harness.weights import module_shapes, seeded_weights

    tcfg = train.train_config(cell.config)
    _, prog_res = train.resources(cell.config)
    g, d = seeded_weights(*(module_shapes(m) for m in build_models(tcfg)), seed, "cuda")
    pcfg, state = train.program_state(tcfg, g, d, "cuda")
    interp = tcfg["apply_texture_space_interpolation_loss"]
    ring = traffic.train_ring(cell.traffic, seed, "cuda", tcfg["max_size"], tcfg["embedding_vocab_size"], interp)
    step = make_train_step(pcfg, prog_res, device="cuda", generator=torch.Generator().manual_seed(seed))
    state.step = tcfg["r1_interval"] - 1
    counted = {}
    for name, entry in (("r1", ring[0]), ("plain", ring[1])):
        counted[name] = compiled_flops(step, state, entry["batch"], entry["draws"])
    analytic = flops.train_step(tcfg, cell.traffic["batch"])
    return {"counter_plain": counted["plain"], "counter_r1_extra": counted["r1"] - counted["plain"],
            "analytic_plain": analytic["plain"], "analytic_r1_extra": analytic["r1"],
            "ratio_plain": analytic["plain"] / counted["plain"],
            "ratio_r1_extra": analytic["r1"] / (counted["r1"] - counted["plain"])}


def faults(cell, tcfg: dict, out: dict, seed: int) -> dict:
    """Each fault's reference run, put in the program's place: half of the
    batch left out, the mean taken over the rest (the reference on the
    first half of each batch); the learning rate 1.25x; the EMA decay
    0.999 for the configuration's."""
    from benchmark.harness import train

    b = cell.traffic["batch"]
    half_ring = traffic.train_ring(cell.traffic, seed, "cuda", tcfg["max_size"], tcfg["embedding_vocab_size"],
                                   tcfg["apply_texture_space_interpolation_loss"], rows=slice(0, b // 2))
    return {
        "half_batch": train.reference_steps(tcfg, out["ref_res"], half_ring[: train.FIRST_STEPS], seed, "cuda"),
        "lr_x1.25": train.reference_steps(dict(tcfg, lr=1.25 * tcfg["lr"]), out["ref_res"], out["first"], seed,
                                          "cuda"),
        "ema_decay_0.999": train.reference_steps(dict(tcfg, ema_decay=0.999), out["ref_res"], out["first"], seed,
                                                 "cuda"),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--flops", action="store_true")
    a = ap.parse_args(argv)
    env.pin_caches()
    env.require_cards(1)
    import torch

    from benchmark.harness import train

    cell = registry.cell(a.workload)
    seeds = [int(s) for s in a.seeds.split(",")]
    rows = []
    for seed in seeds:
        t0 = time.perf_counter()
        out = train.run(cell, seed, 0.0, False, time.perf_counter(), keep=True)
        ref, tcfg = out["reference"], out["train_config"]
        runs = {"control": train.reference_steps(tcfg, out["ref_res"], out["first"], seed, "cuda", lower=True)}
        runs.update(faults(cell, tcfg, out, seed))
        row = {"seed": seed, "sound": {k: v["value"] for k, v in out["checks"].items()},
               "sound_where": {k: v["where"] for k, v in out["checks"].items()}}
        for name, run in runs.items():
            n = compare.train_numbers(run, ref)
            row[name] = {k: v[0] for k, v in n.items()}
            row[f"{name}_where"] = {k: v[1] for k, v in n.items()}
        row["loss_gap_3_steps"] = {"sound": compare.loss_gap(out["program"]["losses"], ref["losses"], 3)[0],
                                   **{k: compare.loss_gap(r["losses"], ref["losses"], 3)[0] for k, r in runs.items()}}
        row.update(losses=out["first_losses"], reference_losses=ref["losses"],
                   control_losses=runs["control"]["losses"], reference_s=out["reference_s"],
                   seconds=time.perf_counter() - t0)
        rows.append(row)
        print(json.dumps(row), flush=True)
        del out, ref, runs
        torch.cuda.empty_cache()
    summary = {"workload": a.workload, "card": env.card_power_limit()}
    for key in rows[0]["sound"]:
        summary[key] = {"lower": max(r["sound"][key] for r in rows)}
        summary[key].update({name: min(r[name][key] for r in rows)
                             for name in ("control", "half_batch", "lr_x1.25", "ema_decay_0.999")})
    if a.flops:
        summary["flops"] = flop_cross_check(cell, seeds[0])
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
