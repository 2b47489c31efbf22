#!/usr/bin/env python3
"""Three readings of the port's megastep on one GPU, beside
``chip_smoke.py`` (whose engine, prompts and helpers they use):

    python3 megastep_ab.py [--seed 0] [--rounds 4] [--steps 6]
                           [--readings write,agreement,graphs]

* ``write``: gemma-2b at full width and depth (bf16, random weights from
  ``--seed``), its megastep timed with the port's page write
  (``attention._write_pages``: every write to a slot carries the value of
  the last one) and with a plain ``index_put_`` (the winner of a duplicate
  write undefined), in the order plain, port, port, plain, ``--rounds``
  times. Each turn of a variant times ``--steps`` steps on the host clock
  (a step ends when its ids reach the host) in a prefill window (C = 32)
  and a decode window (C = 1) of a fresh engine with a full batch.
* ``agreement``: llama4-scout-17b-a16e through ``chip_smoke.py``'s main
  path (AgentRM -> PagedEngineBackend -> the megastep): the share of the
  AgentRM run's tokens equal to a fixed-schedule replay's at the same
  position, for each (dtype, layers, capacity factor) of AGREEMENT. A
  factor of 16 (the expert count, top-1) gives every expert a whole
  group's capacity: no token is dropped, whatever its batchmates.
* ``graphs``: the eager megastep (``cuda_graphs=False``) against the one
  replayed from CUDA graphs (the default), in the order eager, graphs,
  graphs, eager, ``--rounds`` times: gemma-2b's prefill (C = 32) and
  decode (C = 1) windows as ``write`` times them, then starcoder2-7b at
  full width and depth at tp 1, 2 and 4 (every shard on the card), each
  at ``--rounds`` // 2 (at least 1) rounds. Beside the bare host-clock
  steps, one ``chip_smoke.profile_steps`` per variant gives the device's
  busy ms per step and its idle share.

Prints one JSON line per reading, then the card's name and power limit.
Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import dataclasses
import statistics
import sys
from pathlib import Path

import chip_smoke as cs

ROOT = Path(__file__).resolve().parent
# (compute dtype, layers of 48, capacity factor): the config's factor, a
# larger one, and dropless; dropless also at f32, at a depth whose f32
# weights fit one card, beside bf16 at that depth
AGREEMENT = [("bfloat16", 8, 1.0), ("bfloat16", 8, 8.0),
             ("bfloat16", 8, 16.0), ("bfloat16", 4, 16.0),
             ("float32", 4, 16.0)]


def plain_write(k_pool, v_pool, bids, offs, k, v):
    """k_pool[bids, offs] = k, v_pool[bids, offs] = v by ``index_put_``
    alone."""
    k_pool.index_put_((bids.long(), offs.long()), k.to(k_pool.dtype))
    v_pool.index_put_((bids.long(), offs.long()), v.to(v_pool.dtype))


def write_ab(torch, seed: int, rounds: int, steps: int) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.models import attention
    from repro_torch.models.transformer import init_params

    cfg = get_config("gemma-2b")
    params = init_params(cfg, generator=torch.Generator(
        device="cuda").manual_seed(seed), device="cuda")
    variants = {"plain": plain_write, "port": attention._write_pages}
    times = {v: {"prefill": [], "decode": []} for v in variants}
    try:
        for _ in range(rounds):
            for name in ("plain", "port", "port", "plain"):
                attention._write_pages = variants[name]
                for phase, eng in cs.step_windows(cfg, params,
                                                  cs.MEGASTEP_ENGINE, seed):
                    times[name][phase].append(cs._timed_steps(eng, steps))
    finally:
        attention._write_pages = variants["port"]
    out = {}
    for name, phases in times.items():
        for phase, turns in phases.items():
            meds = [statistics.median(t) for t in turns]
            out[f"{name}_{phase}"] = {
                "median_ms": statistics.median(x for t in turns for x in t),
                "turn_medians_ms": meds,
                "spread_ms": [min(meds), max(meds)]}
    del params
    cs._free()
    return {"reading": "write", "arch": cfg.name, "rounds": rounds,
            "steps": steps, **out}


def _graph_rounds(torch, cfg, params, ekw, seed: int, rounds: int,
                  steps: int) -> dict:
    """Bare step ms of both variants, interleaved eager, graphs, graphs,
    eager, then one profiled window set each."""
    variants = {"eager": False, "graphs": True}
    times = {v: {"prefill": [], "decode": []} for v in variants}
    for _ in range(rounds):
        for name in ("eager", "graphs", "graphs", "eager"):
            for phase, eng in cs.step_windows(
                    cfg, params, {**ekw, "cuda_graphs": variants[name]},
                    seed):
                times[name][phase].append(cs._timed_steps(eng, steps))
            cs._free()
    out = {}
    for name, on in variants.items():
        prof = cs.profile_steps(torch, cfg, params,
                                {**ekw, "cuda_graphs": on}, seed)
        cs._free()
        for phase, turns in times[name].items():
            meds = [statistics.median(t) for t in turns]
            w = prof[phase]
            out[f"{name}_{phase}"] = {
                "bare_median_ms": statistics.median(
                    x for t in turns for x in t),
                "turn_medians_ms": meds, "spread_ms": [min(meds), max(meds)],
                "device_busy_ms_per_step": w["device_busy_ms_per_step"],
                "device_idle_share": w["device_idle_share"],
                "host_op_ms_per_step": w["host_op_ms_per_step"],
                "wall_ms_per_step_profiled": w["wall_ms_per_step_profiled"]}
    return out


def graphs_ab(torch, seed: int, rounds: int, steps: int) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_params

    out = {"reading": "graphs", "rounds": rounds, "steps": steps}
    cfg = get_config("gemma-2b")
    params = init_params(cfg, generator=torch.Generator(
        device="cuda").manual_seed(seed), device="cuda")
    out[cfg.name] = _graph_rounds(torch, cfg, params, cs.MEGASTEP_ENGINE,
                                  seed, rounds, steps)
    del params
    cs._free()
    cfg = get_config("starcoder2-7b")
    params = init_params(cfg, generator=torch.Generator(
        device="cuda").manual_seed(seed), device="cuda")
    for tp in cs.TP_WIDTHS:
        ekw = {**cs.MEGASTEP_ENGINE, "mesh": cs._tp_mesh(tp)}
        out[f"{cfg.name}_tp{tp}"] = _graph_rounds(
            torch, cfg, params, ekw, seed, max(rounds // 2, 1), steps)
    del params
    cs._free()
    return out


def agreement(torch, seed: int) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.models import build

    base = get_config("llama4-scout-17b-a16e")
    prompts = cs.make_prompts(seed)
    out = {"reading": "agreement", "arch": base.name,
           "reduced": "n_layers 48 -> 8 or 4 (memory)"}
    for dtype, n_layers, factor in AGREEMENT:
        cfg = base.replace(
            compute_dtype=dtype, n_layers=n_layers,
            moe=dataclasses.replace(base.moe, capacity_factor=factor))
        params = build(cfg).init_params(generator=torch.Generator(
            device="cuda").manual_seed(seed), device="cuda")
        _, main = cs.main_phase(torch, cfg, params, prompts, seed)
        out[f"{dtype}_layers{n_layers}_cf{factor:g}"] = {
            "agentrm_vs_replay_token_agreement":
                main["agentrm_vs_replay_token_agreement"],
            "tokens_out": main["tokens_out"], "steps": main["steps"],
            "launches": main["launches"]}
        del params
        cs._free()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--readings", default="write,agreement,graphs")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("megastep_ab: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build
    from repro_torch.kernels.paged_attention import ops as pa
    build.build_all([pa.SOURCE])
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = cs.nvidia_smi()
    readings = args.readings.split(",")
    if "write" in readings:
        cs.emit(write_ab(torch, args.seed, args.rounds, args.steps))
    if "agreement" in readings:
        cs.emit(agreement(torch, args.seed))
    if "graphs" in readings:
        cs.emit(graphs_ab(torch, args.seed, args.rounds, args.steps))
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
