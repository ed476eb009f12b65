#!/usr/bin/env python3
"""Time one int8 AdamW step with its square root through f64 and in f32.

    python3 tools/int8_adamw_sqrt_ab.py [--windows 5]

``optim/adamw.py`` stores sqrt(v) of an int8 leaf through ``_sqrt_rn``,
an f64 round trip, because CUDA's f32 ``torch.sqrt`` is not correctly
rounded and the stored moments would then differ from the CPU's.  This
script prices that round trip on a GPU.  It runs ``adamw(...).update``
with ``AdamWConfig(quantized_state=True)`` on one leaf of the shape of
the largest leaf of dbrx-132b and of llama4-maverick-400b-a17b (the two
families whose training keeps int8 moments), its expert axis cut so the
leaf holds at most 2^28 values.  Parameters and gradients are seeded
bf16 normals; one update fills the moments first.

Each leaf is timed with ``_sqrt_rn`` as committed ("f64") and with
``torch.sqrt`` put in its place ("f32"), in turns f64, f32, f32, f64 in
``--windows`` windows each, by ``chip_smoke.time_ms`` (CUDA events, a
spin kernel queued first).  It also reads the peak memory one step adds
and how many stored int8 values and block scales the f32 root changes.
Prints one JSON line a leaf and one with the card's name and power
limit.  Exits 2 without a CUDA device.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("dbrx-132b", "llama4-maverick-400b-a17b")
MAX_VALUES = 1 << 28


def _leaf_shape(arch: str) -> tuple[str, tuple, tuple]:
    """(name, full shape, timed shape) of ``arch``'s largest leaf."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    params = build_model(get_config(arch), device="meta").make_params("meta")
    name, p = max(params.named_parameters(), key=lambda kv: kv[1].numel())
    full = tuple(p.shape)
    rest = p.numel() // full[0]
    return name, full, (max(1, MAX_VALUES // rest),) + full[1:]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--windows", type=int, default=5)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("int8_adamw_sqrt_ab: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke                      # puts this checkout's src first
    # the module, not the function that repro_torch.optim exports by its name
    adamw_mod = importlib.import_module("repro_torch.optim.adamw")

    dev = torch.device("cuda")
    spin = chip_smoke.spin_cycles_per_ms(torch)
    roots = {"f64": adamw_mod._sqrt_rn, "f32": torch.sqrt}
    for arch in ARCHS:
        name, full, shape = _leaf_shape(arch)
        gen = torch.Generator(device=dev).manual_seed(0)
        p = (torch.randn(shape, generator=gen, device=dev) * 0.02).to(
            torch.bfloat16)
        g = (torch.randn(shape, generator=gen, device=dev) * 1e-3).to(
            torch.bfloat16)
        opt = adamw_mod.adamw(1e-4, adamw_mod.AdamWConfig(
            quantized_state=True))
        params, grads = {"w": p}, {"w": g}
        _, state = opt.update(params, grads, opt.init(params))
        out = {"arch": arch, "leaf": name, "full_shape": list(full),
               "shape": list(shape), "values": p.numel()}
        stored = {}
        for root_name, root in roots.items():
            adamw_mod._sqrt_rn = root
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            _, stored[root_name] = opt.update(dict(params), grads, state)
            torch.cuda.synchronize()
            out[f"{root_name}_peak_extra_bytes"] = (
                torch.cuda.max_memory_allocated() - base)
        times = {"f64": [], "f32": []}
        for _ in range(args.windows):
            for root_name in ("f64", "f32", "f32", "f64"):
                adamw_mod._sqrt_rn = roots[root_name]
                times[root_name].append(chip_smoke.time_ms(
                    torch, lambda: opt.update(params, grads, state),
                    args.reps, spin))
        adamw_mod._sqrt_rn = roots["f64"]
        for root_name, ts in times.items():
            ts.sort()
            out[f"{root_name}_ms"] = ts[len(ts) // 2]
            out[f"{root_name}_ms_min_max"] = [ts[0], ts[-1]]
        out["f64_over_f32"] = out["f64_ms"] / out["f32_ms"]
        v64, v32 = (stored[k]["mu"]["w"]["v"] for k in ("f64", "f32"))
        out["v_q_differ"] = int((v64.q != v32.q).sum())
        out["v_scale_differ"] = int((v64.scale != v32.scale).sum())
        out["windows"], out["reps"] = args.windows, args.reps
        print(json.dumps(out), flush=True)
        del p, g, params, grads, state, stored, v64, v32
        torch.cuda.empty_cache()
    print(json.dumps({"device": chip_smoke.nvidia_smi()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
