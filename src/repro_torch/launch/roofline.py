"""Roofline terms per (arch x shape x mesh) from the port's dry-run records.

The twin of the JAX package's ``launch/roofline.py``, with the published
peaks of one NVIDIA H100 SXM (``NVIDIA H100 80GB HBM3, 700.00 W`` as
``nvidia-smi`` reports the card these numbers are held against) in
place of the TPU's:

    peak compute   989 TFLOP/s dense bf16 (tensor cores)
                    67 TFLOP/s FP32 (CUDA cores, no tensor cores)
    HBM bandwidth  3.35 TB/s
    NVLink         450 GB/s each way
    HBM            80 GB

Terms (seconds a step, a chip), as the reference's:
    compute    = bf16 flops  / PEAK_FLOPS + other flops / PEAK_FP32
    memory     = bytes       / HBM_BW
    collective = wire_bytes  / LINK_BW

The compute term is split by the counted matmuls' dtype (``cost
["flops_by_dtype"]``): bf16 and f16 at the tensor cores' peak, every
other dtype -- the port's f32 attention, complex64 FFT matmuls, the f32
kernels -- at the FP32 peak (the port leaves TF32 off).  The reference
takes every flop at one peak.

``flops``, ``bytes`` and ``wire_bytes`` are the dry run's counts a chip
(``launch/dryrun.py``: the global step counted as dispatched, divided
evenly by the chips).  ``useful_flops`` is the analytic work of a cell,
the reference's formulas family by family on the port's
``n_active_params``; MODEL/COUNTED flops exposes recompute and waste.
``launch/report.py`` renders the tables.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Optional

from repro_torch.configs import SHAPES, get_config

__all__ = ["PEAK_FLOPS", "PEAK_FP32", "HBM_BW", "LINK_BW", "HBM_PER_CHIP",
           "DEVICE", "DRYRUN_DIR", "TENSOR_CORE_DTYPES", "useful_flops",
           "terms", "load_records", "render_table"]

DEVICE = "NVIDIA H100 80GB HBM3, 700.00 W"
PEAK_FLOPS = 989e12     # bf16 dense flop/s a card (tensor cores)
PEAK_FP32 = 67e12       # FP32 flop/s a card (CUDA cores)
HBM_BW = 3.35e12        # HBM3 bytes/s a card
LINK_BW = 450e9         # NVLink bytes/s a card, each way
HBM_PER_CHIP = 80e9     # HBM bytes a card
# matmul operand dtypes at PEAK_FLOPS; every other at PEAK_FP32
TENSOR_CORE_DTYPES = ("bfloat16", "float16")

DRYRUN_DIR = os.path.join("experiments", "torch", "dryrun")


def useful_flops(arch_id: str, shape_name: str) -> dict:
    """Analytic 'useful' FLOPs for one cell (GLOBAL, not per chip).

    * linear term: 6·N_active·D (train), 2·N_active·D (prefill),
      2·N_active·B (decode: D = B tokens, one per sequence).
    * attention term: 2 matmuls (QK^T, AV) x 2 flops, causal halving,
      window-clipped KV length; x3 for training (bwd = 2x fwd).
      Attention-free families have none; hybrids count their attn third;
      RWKV-6 counts its WKV state update, 4·d·hs a token and layer.
    """
    cfg = get_config(arch_id)
    shape = SHAPES[shape_name]
    b, s = shape.global_batch, shape.seq_len
    n = cfg.n_layers

    if shape.kind == "train":
        tokens = b * s
        mult = 3.0
    elif shape.kind == "prefill":
        tokens = b * s
        mult = 1.0
    else:
        tokens = b  # one new token per sequence
        mult = 1.0

    from repro_torch.models.model_factory import build_model

    n_act = build_model(cfg, device="meta").n_active_params
    per_tok = 6.0 if shape.kind == "train" else 2.0
    lin = per_tok * n_act * tokens

    attn = 0.0
    if cfg.family in ("dense", "moe", "vlm", "encdec"):
        attn_layers = n + (cfg.encoder_layers or 0)
        kv_len = s if cfg.attn_window is None else min(s, cfg.attn_window)
        if shape.kind == "decode":
            q_len = 1.0
            causal = 1.0
        else:
            q_len = float(s)
            causal = 0.5 if cfg.attn_window is None else 1.0
        attn = (4.0 * b * attn_layers * cfg.n_heads * cfg.head_dim
                * q_len * kv_len * causal) * mult
    elif cfg.family == "hybrid":
        pat = cfg.recurrent.block_pattern
        n_attn = round(n * pat.count("attn") / len(pat))
        kv_len = min(s, cfg.attn_window or s)
        q_len = 1.0 if shape.kind == "decode" else float(s)
        attn = (4.0 * b * n_attn * cfg.n_heads * cfg.head_dim
                * q_len * kv_len) * mult
    elif cfg.family == "ssm":
        hs = cfg.rwkv.head_size
        toks = b * (1.0 if shape.kind == "decode" else float(s))
        attn = 4.0 * cfg.n_layers * cfg.d_model * hs * toks * mult

    return {"linear": lin, "attention": attn, "total": lin + attn}


def terms(record: dict) -> Optional[dict]:
    """Roofline terms (seconds) for one dry-run record, or None (skipped,
    or no cost)."""
    if record.get("skipped"):
        return None
    hc = record.get("cost")
    if not hc:
        return None
    fast = sum(f for d, f in hc["flops_by_dtype"].items()
               if d in TENSOR_CORE_DTYPES)
    compute_bf16 = fast / PEAK_FLOPS
    compute_fp32 = (hc["flops"] - fast) / PEAK_FP32
    compute = compute_bf16 + compute_fp32
    memory = hc["bytes_accessed"] / HBM_BW
    collective = (hc.get("collective_wire_bytes") or 0.0) / LINK_BW
    dominant = max(("compute", compute), ("memory", memory),
                   ("collective", collective), key=lambda kv: kv[1])[0]
    bound = max(compute, memory, collective)
    mf = (record.get("model_flops") or {}).get("total")
    chips = record.get("chips", 1)
    return {
        "compute_s": compute,
        "compute_bf16_s": compute_bf16,
        "compute_fp32_s": compute_fp32,
        "memory_s": memory,
        "collective_s": collective,
        "dominant": dominant,
        "step_lower_bound_s": bound,
        # the share of the bound that is useful compute at peak
        "roofline_fraction": ((mf / chips / PEAK_FLOPS) / bound
                              if mf and bound else None),
        "model_vs_counted_flops": ((mf / chips) / hc["flops"]
                                   if mf and hc["flops"] else None),
    }


def _fmt_s(x: float) -> str:
    if x >= 1.0:
        return f"{x:.2f}s"
    if x >= 1e-3:
        return f"{x * 1e3:.1f}ms"
    return f"{x * 1e6:.0f}us"


def load_records(dryrun_dir: str) -> list[dict]:
    out = []
    for path in sorted(glob.glob(os.path.join(dryrun_dir, "*.json"))):
        with open(path) as f:
            out.append(json.load(f))
    return out


def render_table(dryrun_dir: str = DRYRUN_DIR, mesh: str = "single",
                 variant: str = "baseline") -> str:
    rows = []
    for rec in load_records(dryrun_dir):
        if rec.get("mesh") != mesh or rec.get("variant", "baseline") != variant:
            continue
        rows.append((rec["arch"], rec["shape"], terms(rec), rec))
    lines = [
        "| arch | shape | compute | of it fp32 | memory | collective | "
        "dominant | roofline frac | model/counted flops |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    order = {s: i for i, s in enumerate(SHAPES)}
    rows.sort(key=lambda r: (r[0], order.get(r[1], 9)))
    for arch, shape, t, rec in rows:
        if t is None:
            lines.append(f"| {arch} | {shape} | — | — | — | — | SKIP | — | "
                         f"{rec.get('skipped', '?')} |")
            continue
        rf = f"{t['roofline_fraction']:.1%}" if t["roofline_fraction"] else "—"
        mh = (f"{t['model_vs_counted_flops']:.2f}"
              if t["model_vs_counted_flops"] else "—")
        lines.append(
            f"| {arch} | {shape} | {_fmt_s(t['compute_s'])} | "
            f"{_fmt_s(t['compute_fp32_s'])} | {_fmt_s(t['memory_s'])} | "
            f"{_fmt_s(t['collective_s'])} | "
            f"{t['dominant']} | {rf} | {mh} |")
    return "\n".join(lines)

