"""Dry run of every (arch x shape x mesh) cell: the step counted on meta
tensors, the plan's bytes a rank, the roofline terms.

The twin of the JAX package's ``launch/dryrun.py``, which lowers and
compiles each cell's step for a TPU pod over 512 placeholder devices and
reads XLA's memory and cost analyses.  The port has no compiler to ask,
so for each cell it:

  1. builds the full-size config, its sharding plan
     (``launch/shardings.make_plan``: the divisibility fallbacks
     recorded) and the model with ``build_model(cfg, device="meta")`` --
     ``init_cache`` takes the model's device, so a model built for the
     host would make a full-size cache there;
  2. sums the bytes a rank holds of the step's arguments -- params (or
     the train state), cache and batch -- from the plan's specs on the
     mesh, each dim divided by its mesh axes and rounded up (the twin of
     ``memory_analysis``'s argument size), and says whether that and the
     temp term fit one card's 80 GB;
  3. runs the step on meta tensors under ``launch/cost_analysis``'s
     counter: ``train_step`` with AdamW (int8 moments above 5e10
     parameters, their square root taken through f64 as
     ``optim/adamw.py`` does, so those cells' bytes and temp term hold
     that round trip; ``n_micro`` as the reference derives it, 2 rows a
     device a microbatch), ``prefill`` or ``decode_step`` at the shape's
     global batch, inside the plan's rules (the MoE dispatch groups the
     data-parallel degree, as the reference's);
  4. writes ``experiments/torch/dryrun/<cell>.json`` (idempotent:
     existing files are skipped unless ``--force``).

**Per chip.**  The port runs no sharded model step: there is no SPMD
partitioner to split it.  So a chip's cost is the global count divided
evenly by the chips, and an LM cell's ``collectives`` is ``null`` with
that reason (the reference reads them from the partitioned module).
The temp term is the counter's largest sum of live intermediates,
divided likewise.

**Meshes.**  ``"single"`` and ``"multi"`` are the production meshes
(``launch/mesh.production_mesh``); ``"card"`` is a world of one H100.

``--all`` runs every (arch x shape) cell on ``single`` and ``multi``, a
subprocess each (one cell's failure leaves the other records intact),
``--jobs`` of them at once, the ``train_4k`` cells (the longest) first.
The step has one policy, so the reference's ``n_micro`` and
``remat_override`` knobs are not taken: ``n_micro`` is derived as the
reference derives it, and nothing is rematerialised but the loss head's
chunks.

    python -m repro_torch.launch.dryrun --arch gemma-2b --shape decode_32k
    python -m repro_torch.launch.dryrun --all --jobs 4
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time
from typing import Optional

import torch

from repro_torch.configs import ARCH_IDS, SHAPES, cell_runnable, get_config
from repro_torch.distributed.sharding import use_rules
from repro_torch.launch.cost_analysis import analyze
from repro_torch.launch.mesh import card_mesh, mesh_chips, production_mesh
from repro_torch.launch.roofline import (DRYRUN_DIR, HBM_PER_CHIP, terms,
                                         useful_flops)
from repro_torch.launch.shardings import (_axis_size, batch_pspecs,
                                          cache_pspecs, make_plan)
from repro_torch.models.attention import QuantKV
from repro_torch.models.model_factory import build_model
from repro_torch.models.params import named_specs, param_pspecs
from repro_torch.optim.adamw import AdamWConfig, QuantMoment, adamw
from repro_torch.optim.schedules import cosine
from repro_torch.training.train_state import (abstract_train_state,
                                              train_state_pspecs)
from repro_torch.training.train_step import make_train_step

__all__ = ["MESHES", "make_mesh", "cell_skip", "sharded_bytes",
           "argument_bytes", "run_cell", "main"]

MESHES = ("single", "multi", "card")
_QUANT_OPT_THRESHOLD = 5e10   # int8 optimizer state above 50B params
NO_COLLECTIVES = ("the port runs no sharded model step: a chip's cost is "
                  "the global count divided evenly by the chips, and no "
                  "collective is issued")


def make_mesh(kind: str):
    if kind == "card":
        return card_mesh()
    if kind not in ("single", "multi"):
        raise ValueError(f"unknown mesh {kind!r}: one of {MESHES}")
    return production_mesh(multi_pod=(kind == "multi"))


def cell_skip(arch_id: str, shape_name: str) -> Optional[str]:
    """The reference's ``cell_runnable`` reason, or None."""
    ok, reason = cell_runnable(get_config(arch_id), SHAPES[shape_name])
    return None if ok else reason


# --------------------------------------------------------------------------
# bytes a rank
# --------------------------------------------------------------------------
def sharded_bytes(shape, itemsize: int, spec: tuple, mesh) -> int:
    """Bytes one rank holds of a tensor of ``shape`` laid out by ``spec``
    on ``mesh``: each dim over its axes, rounded up (XLA pads a shard)."""
    entries = list(spec) + [None] * (len(shape) - len(spec))
    n = 1
    for d, e in zip(shape, entries):
        n *= -(-d // _axis_size(mesh, e))
    return n * itemsize


def _tree_bytes(tree, specs, mesh) -> int:
    """Bytes a rank of a tree of tensors (dicts, lists, QuantKV,
    QuantMoment) beside its spec tree."""
    if isinstance(tree, torch.Tensor):
        return sharded_bytes(tuple(tree.shape), tree.element_size(), specs,
                             mesh)
    if isinstance(tree, (QuantKV, QuantMoment)):
        return (_tree_bytes(tree.q, specs.q, mesh)
                + _tree_bytes(tree.scale, specs.scale, mesh))
    if isinstance(tree, dict):
        return sum(_tree_bytes(v, specs[k], mesh) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return sum(_tree_bytes(v, s, mesh) for v, s in zip(tree, specs))
    raise TypeError(f"no bytes for {type(tree).__name__}")


def _params_bytes(params, rules, mesh) -> int:
    specs = param_pspecs(named_specs(params), rules)
    return sum(sharded_bytes(tuple(p.shape), p.element_size(), specs[n],
                             mesh) for n, p in params.named_parameters())


def _state_bytes(state, model, opt, rules, mesh) -> int:
    sp = train_state_pspecs(model, opt, rules)
    out = 2 * 4                     # step and count: int32 scalars
    out += _params_bytes(state.params, rules, mesh)
    return out + _tree_bytes(state.opt_state["mu"], sp.opt_state["mu"], mesh)


def argument_bytes(cfg, shape, mesh, rules, model, *, state=None, opt=None,
                   params=None, cache=None, batch=None) -> dict:
    """The bytes a rank of the step's arguments, by part."""
    out = {}
    if state is not None:
        out["state_bytes"] = _state_bytes(state, model, opt, rules, mesh)
    if params is not None:
        out["params_bytes"] = _params_bytes(params, rules, mesh)
    if cache is not None:
        quant = shape.kind == "decode" and cfg.kv_quant_decode
        out["cache_bytes"] = _tree_bytes(
            cache, cache_pspecs(cfg, rules, quantized=quant), mesh)
    if batch is not None:
        out["batch_bytes"] = _tree_bytes(
            batch, batch_pspecs(cfg, shape, rules), mesh)
    if shape.kind == "decode":
        out["step_bytes"] = 4                      # the int32 position
    out["argument_size_in_bytes"] = sum(out.values())
    return out


# --------------------------------------------------------------------------
# the step on meta tensors
# --------------------------------------------------------------------------
def _count_cell(cfg, shape, mesh, plan):
    model = build_model(cfg, device="meta")
    rules = plan.rules
    batch = model.input_specs(shape)
    extra: dict = {}
    with use_rules(mesh, rules):
        if shape.kind == "train":
            quant = model.n_params > _QUANT_OPT_THRESHOLD
            opt = adamw(cosine(3e-4, 10_000, 500),
                        AdamWConfig(quantized_state=quant))
            dp = math.prod(mesh.shape.get(a, 1) for a in ("pod", "data"))
            b_local = max(shape.global_batch // dp, 1)
            n_micro = max(1, b_local // 2)   # 2 rows/device/microbatch
            state = abstract_train_state(model, opt)
            state.params.requires_grad_(True)
            mem = argument_bytes(cfg, shape, mesh, rules, model, state=state,
                                 opt=opt, batch=batch)
            step_fn = make_train_step(model, opt, n_micro=n_micro)
            _, cost = analyze(step_fn, state, batch)
            extra = {"n_micro": n_micro, "quantized_opt_state": quant}
        else:
            params = model.make_params("meta")
            quant_kv = shape.kind == "decode" and cfg.kv_quant_decode
            cache = model.init_cache(shape.global_batch, shape.seq_len,
                                     quant_kv)
            mem = argument_bytes(cfg, shape, mesh, rules, model,
                                 params=params, cache=cache, batch=batch)
            with torch.no_grad():
                if shape.kind == "prefill":
                    _, cost = analyze(model.prefill, params, batch, cache)
                else:
                    _, cost = analyze(model.decode_step, params, cache, batch,
                                      shape.seq_len - 1)
                    extra = {"kv_quant": quant_kv}
    return model, mem, cost, extra


def run_cell(arch_id: str, shape_name: str, mesh_kind: str, out_dir: str,
             *, variant: str = "baseline") -> dict:
    """One cell's record (``skipped`` with the reference's reason where
    ``cell_runnable`` refuses it)."""
    os.makedirs(out_dir, exist_ok=True)
    cfg = get_config(arch_id)
    shape = SHAPES[shape_name]
    record: dict = {
        "arch": arch_id, "shape": shape_name, "mesh": mesh_kind,
        "variant": variant,
        "seq_len": shape.seq_len, "global_batch": shape.global_batch,
        "kind": shape.kind,
    }
    skip = cell_skip(arch_id, shape_name)
    if skip is not None:
        record["skipped"] = skip
        return record

    mesh = make_mesh(mesh_kind)
    plan = make_plan(cfg, shape, mesh)
    chips = mesh_chips(mesh)
    t0 = time.time()
    model, mem, cost, extra = _count_cell(cfg, shape, mesh, plan)
    seconds = time.time() - t0
    total = cost.as_dict()
    temp = total["peak_live_bytes"] // chips
    mem["temp_size_in_bytes"] = temp
    fits = mem["argument_size_in_bytes"] + temp <= HBM_PER_CHIP
    record.update(
        chips=chips,
        n_params=model.n_params,
        n_active_params=model.n_active_params,
        sharding_fallbacks=plan.fallbacks,
        count_seconds=round(seconds, 2),
        memory=mem,
        fits_hbm=fits,
        cost={"flops": total["flops"] / chips,
              "flops_by_dtype": {d: f / chips for d, f in
                                 total["flops_by_dtype"].items()},
              "bytes_accessed": total["bytes_accessed"] / chips,
              "collective_wire_bytes": None},
        global_cost=total,
        collectives=None,
        collectives_reason=NO_COLLECTIVES,
        model_flops=useful_flops(arch_id, shape_name),
        **extra,
    )
    record["terms"] = terms(record)
    t = record["terms"]
    print(f"== {arch_id} x {shape_name} x {mesh_kind} [{variant}] ==")
    print(f"bytes a rank: {json.dumps(mem)} -> "
          f"{'fits' if fits else 'does NOT fit'} {HBM_PER_CHIP / 1e9:.0f} GB")
    print(f"counted (a chip): flops={record['cost']['flops']:.3e} "
          f"bytes={record['cost']['bytes_accessed']:.3e} "
          f"({total['ops']} ops in {seconds:.1f} s)")
    print(f"terms: compute {t['compute_s']:.3e} s, memory "
          f"{t['memory_s']:.3e} s -> {t['dominant']}")
    return record


def cell_name(arch: str, shape: str, mesh: str, variant: str) -> str:
    safe = arch.replace(".", "_")
    return f"{safe}--{shape}--{mesh}--{variant}"


def write_record(out_dir: str, record: dict) -> str:
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, cell_name(
        record["arch"], record["shape"], record["mesh"],
        record.get("variant", "baseline")) + ".json")
    with open(path + ".tmp", "w") as f:
        json.dump(record, f, indent=1)
    os.replace(path + ".tmp", path)
    return path


def _run_all(args) -> int:
    todo = []
    for shape_name in SHAPES:
        for mesh_kind in ("single", "multi"):
            for arch_id in ARCH_IDS:
                name = cell_name(arch_id, shape_name, mesh_kind, args.variant)
                if (os.path.exists(os.path.join(args.out, name + ".json"))
                        and not args.force):
                    print(f"skip (exists): {name}")
                    continue
                todo.append((name, [
                    sys.executable, "-m", "repro_torch.launch.dryrun",
                    "--arch", arch_id, "--shape", shape_name,
                    "--mesh", mesh_kind, "--out", args.out,
                    "--variant", args.variant]))
    t0 = time.time()
    failures, running = [], []
    while todo or running:
        while todo and len(running) < max(args.jobs, 1):
            name, cmd = todo.pop(0)
            print(">>", " ".join(cmd), flush=True)
            running.append((name, subprocess.Popen(cmd)))
        time.sleep(0.2)
        for item in list(running):
            if item[1].poll() is not None:
                running.remove(item)
                if item[1].returncode != 0:
                    failures.append(item[0])
    print(f"sweep seconds: {time.time() - t0:.1f}")
    if failures:
        print("FAILED cells:", failures)
        return 1
    print("all cells complete")
    return 0


def main(argv: Optional[list[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=tuple(SHAPES))
    ap.add_argument("--mesh", choices=MESHES, default="single")
    ap.add_argument("--all", action="store_true",
                    help="every (arch x shape) cell on single and multi, "
                         "a subprocess each")
    ap.add_argument("--jobs", type=int, default=1,
                    help="--all: subprocesses at once")
    ap.add_argument("--out", default=DRYRUN_DIR)
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    if args.all:
        return _run_all(args)
    if not args.arch or not args.shape:
        ap.error("--arch and --shape required (or --all)")
    record = run_cell(args.arch, args.shape, args.mesh, args.out,
                      variant=args.variant)
    print("wrote", write_record(args.out, record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
