"""Dry-run of the port: size every (architecture x input shape) cell on the
production mesh(es), on ``meta``, and record memory, work and the training
rules' placement for the roofline report (the port of
``repro.launch.dryrun``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma-2b \\
        --shape train_4k --mesh both --out /tmp/dryrun_torch

No card is needed: ``meta`` holds shapes and dtypes and allocates nothing,
as the reference's 512 forced host devices are placeholders, not the TPU.
Where the reference lowers and compiles each cell's step, this runs the
step once on ``meta`` (``hlo_analysis.analyze_step``): the train step
(loss, gradients, AdamW) on the master params, the serving steps on the
prepared ones. A decode cell's step takes ``cache_len = seq_len - 1``, a
Python int: one new token against a seq_len-deep session state. The step
does not depend on the mesh, so ``--mesh both`` runs it once per cell.

Each cell's JSON keeps the reference's keys:

  * ``n_params``, ``n_active_params``, ``tokens`` and ``model_flops`` are
    the reference's formulas on the same trees;
  * ``memory.argument_size_in_bytes``: the per-device bytes of the step's
    arguments under the rules (params in ``cfg.param_dtype``, the
    optimizer state, the batch, the decode state), each leaf's bytes over
    the product of the axes its spec names; ``output_size_in_bytes`` the
    same of its outputs (trees by their rules, any other output with a
    batch dim by ``batch_axes``);
  * ``hlo_flops_per_device`` / ``hlo_bytes_per_device``: the step's
    counts (``dot_flops`` / ``bytes_materialized``) split as the rules
    split the tensors the work reads (``per_device_split``). The aten work
    and the bytes go over the batch shards (``batch_axes``), and over
    ``model`` for the share of the weights' parameters whose spec names
    it: total / batch_shards x (share / model + 1 - share). The kernels'
    work in a decode step goes as the decode state its kernels read is
    split (``decode_state_shardings``); elsewhere as the aten work. These
    are estimates from the rules, not counts of a partitioned program:
    each cell says so in ``estimates``;
  * fields with no counterpart are null, each with its reason in
    ``null_reasons``.

Importing this module changes nothing in the environment.
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import math
import os
import re
import time
import traceback
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.configs import (SHAPES_BY_NAME, get_config, input_specs,
                                 iter_cells)
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.distributed.sharding import (MP, _map_with_path,
                                              batch_axes, batch_shardings,
                                              decode_state_shardings,
                                              opt_state_shardings,
                                              param_pspec, param_shardings,
                                              spec_slices)
from repro_torch.launch.hlo_analysis import analyze_step
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import abstract_decode_state, abstract_params, build
from repro_torch.training import optimizer as opt
from repro_torch.training.train_step import make_serve_steps, \
    make_train_step
from repro_torch.tree import leaves

NULL_REASONS = {
    "lower_s": "the port lowers nothing; trace_s is the meta step's "
               "seconds",
    "compile_s": "the port compiles nothing; trace_s is the meta step's "
                 "seconds",
    "xla_cost_flops_unscaled": "no XLA cost analysis: the port compiles "
                               "nothing",
    "xla_cost_bytes_unscaled": "no XLA cost analysis: the port compiles "
                               "nothing",
    "collectives": "one controller holds whole tensors and runs no "
                   "collective; the reference's come from XLA's SPMD "
                   "partitioner, which the port has no counterpart of",
    "temp_size_in_bytes": "meta has no allocator, so no step's "
                          "temporaries are held anywhere",
    "generated_code_size_in_bytes": "eager PyTorch generates no program",
}

ESTIMATES = {
    "hlo_flops_per_device": "an estimate from the rules: the step's counted "
                            "work (aten + kernels, on meta) times the "
                            "per_device fractions; no partitioned program "
                            "exists to count",
    "hlo_bytes_per_device": "an estimate from the rules: the step's bytes "
                            "materialized (on meta, the kernels' "
                            "workspaces included) times per_device's "
                            "fraction",
}


def count_params(params_tree) -> int:
    return sum(math.prod(t.shape) for t in leaves(params_tree))


def active_params(cfg: ModelConfig, params_tree) -> int:
    """Params a token uses: the routed experts' weights count top_k of
    n_experts."""
    total = count_params(params_tree)
    if cfg.moe is None:
        return total
    routed = 0

    def visit(name, leaf):
        nonlocal routed
        if "moe" in name and re.search(r"w_(gate|up|down)$", name) \
                and "shared" not in name:
            routed += math.prod(leaf.shape)

    _map_with_path(visit, params_tree)
    frac_active = cfg.moe.top_k / cfg.moe.n_experts
    return int(total - routed * (1.0 - frac_active))


def cell_counts(cfg: ModelConfig, shape: ShapeConfig,
                params_abs=None) -> Dict[str, Any]:
    """n_params, n_active_params, tokens and model_flops of one cell."""
    params_abs = abstract_params(cfg) if params_abs is None else params_abs
    n_active = active_params(cfg, params_abs)
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    return {"n_params": count_params(params_abs),
            "n_active_params": n_active, "tokens": tokens,
            "model_flops": float((6 if shape.kind == "train" else 2)
                                 * n_active * tokens)}


def spec_bytes(mesh, t, spec) -> int:
    """Bytes of ``t``'s slice on one device under ``spec``."""
    parts = 1
    for entry in spec:
        for a in ((entry,) if isinstance(entry, str) else entry or ()):
            parts *= mesh.shape[a]
    return math.prod(t.shape) * t.element_size() // parts


def _pairs(tree, shardings):
    """(leaf, (mesh, spec)) of a tree and its sharding tree, in step."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in tree:
            yield from _pairs(tree[k], shardings[k])
    elif isinstance(tree, (list, tuple)):
        for t, sh in zip(tree, shardings):
            yield from _pairs(t, sh)
    else:
        yield tree, shardings


def leaf_bytes(tree, shardings) -> List[int]:
    """Per-device bytes of each leaf of a tree under its tree of ``(mesh,
    spec)``."""
    return [spec_bytes(m, t, spec) for t, (m, spec)
            in _pairs(tree, shardings)]


def tree_bytes(tree, shardings) -> int:
    return sum(leaf_bytes(tree, shardings))


def _batched_bytes(mesh, t) -> int:
    """Per-device bytes of an output with no rule: its leading dim over
    ``batch_axes``, replicated when it is 0-d."""
    if len(t.shape) == 0:
        return t.element_size()
    ba = batch_axes(mesh, t.shape[0])
    return spec_bytes(mesh, t, (ba,) if ba else ())


def placed_pieces(cfg: ModelConfig, params, mesh) -> List[Tuple[str, int]]:
    """(device, bytes) of every tensor ``sharding.reshard_params`` places
    on a mesh of several positions: each distinct (device, leaf, slice)
    once."""
    seen, out = set(), []

    def visit(name, leaf):
        spec = param_pspec(cfg, mesh, name, leaf)
        for coords, dev in mesh.positions():
            sl = spec_slices(mesh, coords, leaf.shape, spec)
            if (str(dev), name, sl) not in seen:
                seen.add((str(dev), name, sl))
                out.append((str(dev), math.prod(hi - lo for lo, hi in sl)
                            * leaf.element_size()))

    _map_with_path(visit, params)
    return out


def per_device_split(cfg: ModelConfig, mesh, params_abs,
                     shape: ShapeConfig, decode_state=None) -> Dict[str, Any]:
    """How the rules split a step's work over the devices. ``fraction``
    (the aten work, the bytes): the batch over ``batch_axes``, and over
    ``model`` the share of the weights' parameters (leaves of 2 or more
    dims) whose spec names it. ``kernel_fraction``: with a decode state,
    its per-device share under ``decode_state_shardings`` (the caches the
    decode kernels read), else ``fraction``."""
    ba = batch_axes(mesh, shape.global_batch) or ()
    batch = math.prod(mesh.shape[a] for a in ba)
    split = total = 0

    def visit(name, leaf):
        nonlocal split, total
        if len(leaf.shape) < 2:
            return
        n = math.prod(leaf.shape)
        total += n
        if MP in param_pspec(cfg, mesh, name, leaf):
            split += n

    _map_with_path(visit, params_abs)
    share = split / total if total else 0.0
    model = mesh.shape[MP]
    fraction = (share / model + 1.0 - share) / batch
    kernel, read = fraction, "weights and batch"
    if decode_state is not None:
        held = sum(math.prod(t.shape) * t.element_size()
                   for t in leaves(decode_state))
        kernel = tree_bytes(decode_state, decode_state_shardings(
            cfg, mesh, decode_state)) / held
        read = "decode state"
    return {"batch_axes": list(ba), "batch_shards": batch,
            "model_shards": model, "model_split_share": share,
            "fraction": fraction, "kernel_fraction": kernel,
            "kernel_split_by": read}


def _configure(arch: str, overrides: Optional[Dict[str, Any]]):
    cfg = get_config(arch)
    if overrides:
        moe_over = {k[4:]: v for k, v in overrides.items()
                    if k.startswith("moe.")}
        plain = {k: v for k, v in overrides.items() if "." not in k}
        cfg = cfg.replace(**plain)
        if moe_over and cfg.moe is not None:
            cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, **moe_over))
    return cfg


def run_step(cfg: ModelConfig, shape: ShapeConfig):
    """The cell's step on ``meta`` under ``analyze_step``: returns
    (arguments {name: tree}, outputs {name: tree}, the counts, seconds).
    Arguments and outputs keep the step's trees for the sizing."""
    t0 = time.perf_counter()
    specs = input_specs(cfg, shape)
    model = build(cfg)
    if shape.kind == "train":
        params = abstract_params(cfg)
        state = opt.init(params, opt.AdamWConfig())
        args = {"params": params, "opt_state": state, "batch": specs}
        (params, state, metrics), stats = analyze_step(
            make_train_step(cfg), params, state, specs)
        outs = {"params": params, "opt_state": state, "other": metrics}
    elif shape.kind == "prefill":
        prefill_step, _ = make_serve_steps(cfg)
        args = {"batch": specs}
        logits, stats = analyze_step(
            prefill_step, model.init_params(device="meta"), specs)
        outs = {"other": {"logits": logits}}
    else:
        _, decode_step = make_serve_steps(cfg)
        state = abstract_decode_state(cfg, shape.global_batch,
                                      shape.seq_len)
        args = {"decode_state": state, "batch": {"token": specs["token"]},
                "cache_len": specs["cache_len"]}
        logits, stats = analyze_step(
            decode_step, model.init_params(device="meta"), state,
            specs["token"], shape.seq_len - 1)
        outs = {"decode_state": state, "other": {"logits": logits}}
    return args, outs, stats, time.perf_counter() - t0


@functools.lru_cache(maxsize=4)
def _meta_step(arch: str, shape_name: str, overrides_key: str):
    cfg = _configure(arch, json.loads(overrides_key))
    return run_step(cfg, SHAPES_BY_NAME[shape_name])


def sizing(cfg: ModelConfig, mesh, args: Dict, outs: Dict,
           params_abs) -> Dict[str, int]:
    """Per-device bytes of the step's arguments and outputs under the
    rules: ``argument_size_in_bytes``, ``output_size_in_bytes`` and the
    argument groups they sum."""
    def group(name, tree):
        if name == "params":
            return tree_bytes(tree, param_shardings(cfg, mesh, tree))
        if name == "opt_state":
            return tree_bytes(tree, opt_state_shardings(cfg, mesh, tree,
                                                        params_abs))
        if name == "decode_state":
            return tree_bytes(tree, decode_state_shardings(cfg, mesh, tree))
        if name == "batch":
            return tree_bytes(tree, batch_shardings(cfg, mesh, tree))
        return sum(_batched_bytes(mesh, t) for t in leaves(tree))

    groups = {"params": group("params", params_abs)}
    groups.update({k: group(k, v) for k, v in args.items()
                   if k != "params"})
    out_bytes = sum(group(k, v) for k, v in outs.items())
    return {"argument_size_in_bytes": sum(groups.values()),
            "output_size_in_bytes": out_bytes,
            "argument_groups": groups}


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             overrides: Dict[str, Any] = None) -> Dict[str, Any]:
    """One cell on the 16x16 (or 2x16x16) mesh on ``meta``: the
    reference's keys, see the module docstring."""
    cfg = _configure(arch, overrides)
    shape = SHAPES_BY_NAME[shape_name]
    mesh = make_production_mesh(multi_pod=multi_pod)
    params_abs = abstract_params(cfg)
    args, outs, stats, t_step = _meta_step(
        arch, shape_name, json.dumps(overrides or {}, sort_keys=True))
    split = per_device_split(cfg, mesh, params_abs, shape,
                             args.get("decode_state"))
    memory = sizing(cfg, mesh, args, outs, params_abs)
    kernel_flops = sum(stats["kernel_flops"].values())
    return {
        "arch": arch,
        "shape": shape_name,
        "overrides": overrides or {},
        "kind": shape.kind,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "n_devices": mesh.size,
        "device": "meta",
        "ok": True,
        "lower_s": None,
        "trace_s": t_step,
        "compile_s": None,
        **cell_counts(cfg, shape, params_abs),
        "hlo_flops_per_device": (stats["aten_flops"] * split["fraction"]
                                 + kernel_flops * split["kernel_fraction"]),
        "hlo_bytes_per_device": (stats["bytes_materialized"]
                                 * split["fraction"]),
        "flops_total": stats["dot_flops"],
        "bytes_materialized_total": stats["bytes_materialized"],
        "aten_flops": stats["aten_flops"],
        "kernel_flops": stats["kernel_flops"],
        "kernel_calls": stats["kernel_calls"],
        "per_device": split,
        "xla_cost_flops_unscaled": None,
        "xla_cost_bytes_unscaled": None,
        "collectives": None,
        "memory": {"temp_size_in_bytes": None,
                   "argument_size_in_bytes": memory["argument_size_in_bytes"],
                   "output_size_in_bytes": memory["output_size_in_bytes"],
                   "generated_code_size_in_bytes": None},
        "argument_groups": memory["argument_groups"],
        "null_reasons": NULL_REASONS,
        "estimates": ESTIMATES,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default="reports/dryrun_torch")
    ap.add_argument("--override", action="append", default=[],
                    help="cfg overrides, e.g. gqa_mode=tiled moe.dispatch=sort")
    args = ap.parse_args(argv)
    overrides = {}
    for ov in args.override:
        k, v = ov.split("=", 1)
        overrides[k] = int(v) if v.lstrip("-").isdigit() else v

    os.makedirs(args.out, exist_ok=True)
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    n_ok = n_fail = n_skip = 0
    for arch, shape, ok, why in iter_cells():
        if args.arch not in ("all", arch):
            continue
        if args.shape not in ("all", shape.name):
            continue
        for multi in meshes:
            tag = f"{arch}__{shape.name}__{'multi' if multi else 'single'}"
            path = os.path.join(args.out, tag + ".json")
            if not ok:
                with open(path, "w") as f:
                    json.dump({"arch": arch, "shape": shape.name,
                               "ok": False, "skipped": True,
                               "reason": why}, f, indent=1)
                print(f"SKIP {tag}: {why}")
                n_skip += 1
                continue
            try:
                res = run_cell(arch, shape.name, multi, overrides)
                with open(path, "w") as f:
                    json.dump(res, f, indent=1)
                print(f"OK   {tag}: trace={res['trace_s']:.1f}s "
                      f"flops/dev={res['hlo_flops_per_device']:.3e} "
                      f"args/dev={res['memory']['argument_size_in_bytes']}B")
                n_ok += 1
            except Exception as e:  # noqa: BLE001 — report, continue sweep
                with open(path, "w") as f:
                    json.dump({"arch": arch, "shape": shape.name,
                               "mesh": "multi" if multi else "single",
                               "ok": False,
                               "error": f"{type(e).__name__}: {e}"},
                              f, indent=1)
                print(f"FAIL {tag}: {type(e).__name__}: {e}")
                traceback.print_exc(limit=3)
                n_fail += 1
    print(f"dry-run complete: {n_ok} ok, {n_fail} failed, {n_skip} skipped")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
