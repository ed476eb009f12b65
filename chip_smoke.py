#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds every CUDA kernel of the port from ``src/repro_torch/kernels/csrc``
(one ``nvcc`` per source, in parallel), holds each kernel against its
plain PyTorch version on the card at the shapes its main path gives it
(``fourstep_stage2``'s row FFT also at B = 384 and at the prime B =
4093, ``fourstep_streaming``'s column FFTs at (16, 384, 384) and at the
prime A of (16, 4093, 4), ``encode_fourstep_fused`` past its fold at
m = 32, B = 512, three launches, and both its routes forced where both
fit a block), prints the FFT kernels' ptxas
registers and spills (failing if the c2c, r2c or c2r bucket kernel, the
one-block ``fft_block_kernel``, the recombine's tile design or the WKV
kernel spills),
times both designs of the recombine forced at m = 4..64 (the timings its
route by m is chosen from),
times the c2c, r2c and c2r bucket kernels, ``fourstep_fused``, both modes
of ``multistep_fused``, the recombine rows and ``wkv`` in seven windows each
(median, min and max) and traces one call of each bucket,
``fourstep_fused`` and ``multistep_fused``, which must launch once (k
times per stage) and run its own kernels alone -- ``fft_block_kernel``
for ``fourstep_fused`` and block mode, the per-stage mode
``fft_cols_kernel`` and ``fft_rows_kernel`` --,
then drives the main paths at two sizes each,
for each 1-D kind: the service's ``submit_batch`` with kind c2c, r2c
and c2r (the kind's whole-bucket kernel at s=4096; at s=2^20 the
masked streaming c2c bucket kernel and the stage kernels for the real
kinds; the c2c stage kernels at s=2^21), on the device-decode path and on the host
decode-matrix path (``device_decode=False``: the planes bucket kernels
at s=4096, the streaming c2c bucket kernel at s=2^20, and the stage
kernels past ``LAGRANGE_MAX_M`` at m=64, N=128), the service's
``plan.run`` executor (``decode_method="ifft"``), ``run`` of
``CodedFFT``, ``CodedRFFT`` and ``CodedIRFFT`` on their default kernel
backend (the cmatmul encode and decode, and the fused four-step worker
at s=4096 or the two-pass one at s=2^20), ``CodedFFT`` at s=2^20 with a
``worker_fn`` on the streaming four-step, and the single-request
recombine (``ops.recombine_fused``).  Those phases run with an empty
four-step autotune table (services built with ``autotune=False``); then
the tuned path: the default service's warmup search (which times the
mixed-radix ``multistep_fused`` among its candidates; its winners are
printed) and a second
warmup that reads the table, ``CodedFFT.run`` through recorded
multistep plans at s=4096 (the block mode) and s=2^20 (per stage) and
once under the measured table (then every search candidate timed on
that run's 512 worker rows, beside the winner and the empty table's
route), and a near-prime c2c service (s=16396,
a 4099-point shard: the stage route's two-pass encode on ``cmatmul``).
Before the tuned path, the n-D paths (``nd_transforms``): the
service's rfftn and irfftn kinds on 16 real 2048 x 2048 fields,
``CodedFFTND.run`` on a 256^3 volume and ``CodedFFTMultiInput.run`` on
eight 512 x 512 fields (the ``cmatmul`` encode and decode, the
four-step kernels swept over each shard axis), and that sweep held
against its plain twin at shard axes of 1, 2, 3 and 6 points.  Then
the fault runtime and the open-loop front-end (``fault_runtime``):
deadline masks from kill and delay faults on the masked c2c (s=4096,
2^20), r2c and c2r bucket kernels; ``verify="correct"`` and
``"detect"`` with corrupt workers on ``cmatmul`` and
``fourstep_fused``; an elastic pool growing N from 8 to 9; the measured
thread-per-worker runtime's rows from the card; and
``StreamingFFTService`` under Poisson arrivals, streaming against the
naive baseline, then mixed tiers.  After the strategy zoo, the
multi-device runtime (``mesh_runtime``), each world in child processes:
a world of one on NCCL (``DistributedCodedPlan.run`` of the 1-D, real,
n-D and strategy plans, ``run_sharded``, ``FFTService(mesh=)``: the
``cmatmul`` encode, the four-step workers, the ``bcmatmul`` decode) and
four ``gloo`` ranks sharing the card (``run``, ``run_sharded``, the
service and a ``reshard`` 4 -> 2 -> 4 ranks, against the world of one).
Then bf16 planes (``bf16_planes``): every ``*_bf16`` kernel entry
beside its f32 twin in the same seven windows, held to its plain twin
and to ``torch.fft`` within ``BF16_RTOL``, and ``precision="bf16"``
services probed from an empty autotune table (each verdict ``ok``, the
bf16 entries counted); the ptxas report pairs each bf16 instance with
its f32 twin and fails where it spills more.
The autotune cache lives under ``build/``.  Last, RWKV-6 generation:
``GenerationEngine`` on rwkv6-3b at full width and depth (bf16, seeded
weights) serves 4 prompts of 512 tokens and 16 new tokens, its prefill
running the ``wkv`` kernel once a layer (checks in ``lm_rwkv6_3b``);
then the decoder-only transformer (``lm_dense``): gemma-2b at full width
and depth on 4 x 512 and on 2 x 8,176 tokens (its 8,192-token context),
qwen2.5-14b at full width and 4 layers, minicpm-2b whole, qwen1.5-32b
whole (its decode on the int8 KV cache beside the bf16 one) and
paligemma-3b whole behind 256 patch embeddings, on plain torch
attention over a KV cache, launching none of the port's kernels; then
the MoE family (``lm_moe``: llama4-maverick-400b-a17b at full width and
2 layers, dbrx-132b at full width and 10, capacity-routed experts) and
the hybrid (``lm_hybrid``: recurrentgemma-9b whole on 4 x 512 and on
2 x 4,096 past its 2,048-token window, the RG-LRU's doubling scan and
local attention over a ring cache), likewise on plain torch; then the
encoder-decoder (``lm_encdec``: whisper-medium whole on 4 x 1500 frames,
prefill and 32 decode steps through the model API, plain torch) and the
coded spectral mixer (``spectral_coded``: 4096 rows of 4096 points
through ``CodedFFT`` with two of six workers down, exactly two
``cmatmul`` launches and one ``fourstep_fused``, and again for its
gradient with respect to the input); then training (``lm_train``:
gemma-2b at full width and depth, 4 steps of exact AdamW on 4 x 512
tokens, the loss falling, and the trainer's bit-exact restart from a
checkpoint on reduced gemma-2b); last, gradient aggregation
(``grad_aggregation``: gemma-2b at full width and 8 layers, its 4
partition gradients through ``CyclicGradientCode(4, 1)``, every 3-of-4
decode against the f64 sum; ``compressed_psum`` on four ``gloo`` ranks
sharing the card and over the whole gradient in an NCCL world of one;
a training state placed by its sharding plan on a (data 2, model 2)
mesh and gathered back bit for bit), on plain torch; then the launch
tools (``launch_tools``: dry runs on meta tensors, gemma-2b's serving
step through ``make_serve_fns`` and rwkv6-3b's prefill counted on CUDA
and on meta alike, ``launch.fft_dryrun`` and the quickstart).
Each FFT run's
output is checked against ``torch.fft`` in float64/complex128, and its
launch counters show which kernels it ran; one more call of each is
traced with ``torch.profiler`` for the device's busy time and idle
share.  Prints one JSON object per phase, the kernels
table, the card's name and power limit, and last
``{"ok": true, "device": {...}}``.  Exits non-zero, with no result line,
when there is no CUDA device or any check fails.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path
from typing import NamedTuple, Optional

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM data-sheet peaks (dense, no sparsity), from the port's one
# source: HBM3 bytes/s, FP32 (non-tensor) and bf16 (tensor core) flop/s --
# the rates the bounds below divide by
from repro_torch.launch.roofline import (  # noqa: E402
    HBM_BW as PEAK_BYTES_S,
    PEAK_FLOPS as PEAK_BF16_S,
    PEAK_FP32 as PEAK_FP32_S,
)

F32 = 4
# the FFT kernels' names: the profiled calls sum each one's device ms
# multistep_fused's launch counters, f32 and bf16 entries: their rows
# take the launches of the runs in their own mode
MULTISTEP_NAMES = ("multistep_fused", "multistep_fused[bf16]")
FFT_KERNELS = ("fft_cols_kernel", "fft_rows_kernel", "encode_rows_kernel",
               "fft_block_kernel")
# torch.profiler maps each kernel's device timestamp onto the host's clock
# and drops a kernel that lands outside its capture window.  On an H100
# 80GB HBM3 that mapping ran up to 7.0 ms early, and a call traced at the
# window's start lost a kernel in 24 of 2,400 traces, none with 25 ms
# before and after it (tools/trace_window_probe.py).  A traced call
# starts twice that far into the window, which stays open as long after.
TRACE_MARGIN_S = 0.05


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def ptxas_report(log: Path) -> list[str]:
    """Per entry function of one ``-Xptxas=-v`` log: its mangled name,
    its spill line and its register line, joined."""
    if not log.exists():
        return []
    out, name, spill = [], None, ""
    for ln in log.read_text().splitlines():
        if "Function properties for" in ln:
            name, spill = ln.split("for", 1)[1].strip(), ""
        elif "spill stores" in ln:
            spill = ln.strip()
        elif "Used" in ln and "registers" in ln and name:
            used = ln.split(":", 1)[1].strip()
            out.append(f"{name} | {spill} | {used}")
            name = None
    return out


def fft_flops(n: int) -> float:
    """FP32 flops of one n-point complex FFT, by the usual 5 n log2(n)
    count: the least work a DFT needs, whatever the kernel does."""
    return 5.0 * n * math.log2(n) if n > 1 else 0.0


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes = nbytes / PEAK_BYTES_S
    t_ops = flops / PEAK_FP32_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def spin_cycles_per_ms(torch) -> float:
    """Clock cycles of ``torch.cuda._sleep`` per millisecond on this card."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    torch.cuda._sleep(20_000_000)
    stop.record()
    torch.cuda.synchronize()
    return 20_000_000 / start.elapsed_time(stop)


def time_ms(torch, fn, reps: int, spin_rate: float) -> float:
    """Mean device time of ``fn()`` over ``reps`` back-to-back calls,
    after two warm-up calls (CUDA events).

    A spin kernel queued first keeps the card busy while the host queues
    the calls, so the time is the card's and not the host's launch
    overhead, which exceeds a short kernel's time on a shared host.
    """
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    one_call_ms = (time.perf_counter() - t0) * 1e3
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(1.5 * reps * one_call_ms * spin_rate) + 1)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def profile_call(torch, fn, track=(), names=False,
                 margin_s=TRACE_MARGIN_S) -> dict:
    """One call of ``fn`` under ``torch.profiler``, ``margin_s`` seconds
    inside the window at both ends: its host wall time,
    the summed device time of the kernels it ran (one stream, so the sum
    is the busy time), the idle share, and the kernels that took most;
    ``track``: name fragments whose kernels' device ms are summed apart;
    ``names``: also every kernel's name and launch count."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(margin_s)
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        time.sleep(margin_s)
    kernels = sorted(
        ((e.self_device_time_total / 1e3, e.key, e.count)
         for e in prof.key_averages()
         if e.device_type == torch.autograd.DeviceType.CUDA
         and e.self_device_time_total > 0), reverse=True)
    busy_ms = sum(k[0] for k in kernels)
    tracked = {frag: sum(ms for ms, name, _ in kernels if frag in name)
               for frag in track}
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": 1.0 - busy_ms / wall_ms,
            "device_kernels": sum(k[2] for k in kernels),
            "top": [{"kernel": name[:60], "device_ms": ms, "count": n}
                    for ms, name, n in kernels[:6]],
            **({"tracked_ms": tracked} if track else {}),
            **({"kernel_names": {name: n for _, name, n in kernels}}
               if names else {})}


def compare(torch, got, want) -> tuple[float, float]:
    """(max abs err, max abs err / max |want|) over planar pairs."""
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    scale = max(float(w.abs().max()) for w in want) or 1.0
    return err, err / scale


def recombine_crossover(torch, randn, spin_rate, windows=7) -> list[dict]:
    """Both designs of ``csrc/recombine.cu`` forced, at m = 4, 8, 16, 32
    and 64, at the stage route's two bucket shapes (64 requests of s =
    4096, 16 of s = 2^20): each held against the plain twin (1e-5), then
    timed in ``windows`` windows (median, min, max) beside the route
    ``recombine.recombine_design`` takes.  The crossover in m is read
    from these rows.  Launches here are counted under the batched
    entry's name, outside every main-path run."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import recombine as rc

    dev = torch.device("cuda")
    rows = []
    for q, s, reps in ((64, 4096, 50), (16, 1 << 20, 5)):
        for m in (4, 8, 16, 32, 64):
            ell = s // m
            cr, ci = randn(q, m, ell), randn(q, m, ell)
            planes = ops._on_device(ops._recombine_planes, (s, m), dev)
            want = rc.recombine_batched_body(cr, ci, *planes)
            row = {"q": q, "s": s, "m": m, "L": ell,
                   "route": rc.recombine_design(m)}
            for design in ("column", "tile"):
                run = lambda: rc._launch("recombine_twiddle_dft_batched",
                                         cr, ci, *planes, design=design)
                got = run()
                torch.cuda.synchronize()
                _, rel = compare(torch, got, want)
                if not rel < 1e-5:
                    fail(f"recombine {design} design (q={q}, s={s}, m={m})"
                         f": rel err {rel} >= 1e-5")
                ts = sorted(time_ms(torch, run, reps, spin_rate)
                            for _ in range(windows))
                row[f"{design}_ms"] = ts[len(ts) // 2]
                row[f"{design}_ms_min"], row[f"{design}_ms_max"] = ts[0], \
                    ts[-1]
                row[f"{design}_max_rel_err"] = rel
            rows.append(row)
            del cr, ci, want, got
        torch.cuda.empty_cache()
    return rows


def lm_rwkv6_3b(torch, rng, counted) -> None:
    """The generation engine on rwkv6-3b (32 layers, d_model 2560, 40
    heads of 64, vocab 65536; bf16 weights from a seeded init on the
    card): 4 prompts of 512 tokens, 16 new tokens, greedy.  The run must
    launch ``wkv`` once a layer in the prefill and nowhere else.

    Random weights make the 32-layer stack chaotic: a rounding difference
    at one layer grows about 1.6x a layer (f32 weights: 2e-8 at layer 0,
    8e-2 at layer 31, with every layer's WKV equal to 2e-7 on the same
    inputs).  So the kernel is held, at every layer, against ``wkv_body``
    on the inputs the prefill gives it (1e-5 of the largest magnitude);
    the whole prefill on the plain WKV must agree at layer 0 (1e-4), its
    deeper layers and logits are printed with the growth per layer;
    prefill(T) against prefill(T-1) and one decode step must agree in
    layer 0's state (bf16: 1e-2, a few roundings of the last token's bf16
    projections; f32: 1e-4), and on f32 weights also in the next token
    and the logits (within 5%); and the head's bf16 product with f32
    accumulation is held against the same product in f32 (1e-5)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.wkv import wkv_body
    from repro_torch.models import build_model, rwkv6
    from repro_torch.models.layers import layer_norm

    from repro_torch.serving import EngineConfig, GenerationEngine

    cfg = get_config("rwkv6-3b")
    dev = torch.device("cuda")
    b, t, new = 4, 512, 16
    t0 = time.perf_counter()
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    engine = GenerationEngine(model, params, EngineConfig(
        batch_size=b, prompt_len=t, max_new_tokens=new))
    prompts = [list(rng.integers(1, cfg.vocab_size, t)) for _ in range(b)]
    t0 = time.perf_counter()
    outs, counts = counted(lambda: engine.generate(prompts))
    first_s = time.perf_counter() - t0
    if counts != {"wkv": cfg.n_layers}:
        fail(f"rwkv6-3b generate: launches {counts}, expected "
             f"{{'wkv': {cfg.n_layers}}} (one a layer, in the prefill)")
    if (len(outs) != b or any(len(o) != new for o in outs)
            or not all(0 <= x < cfg.vocab_size for o in outs for x in o)):
        fail(f"rwkv6-3b generate: outputs {[len(o) for o in outs]}")
    tokens = torch.as_tensor(engine._pad_prompts(prompts), device=dev)
    rel = lambda g, w: float((g - w).abs().max() / w.abs().max())

    def consistency(mdl, prm):
        """(kernel prefill, plain-WKV prefill, every layer's kernel-vs-
        twin errors on the kernel prefill's own WKV inputs, logits of
        prefill(T-1) + one decode step).  No parameter requires a
        gradient, so none of these calls records one."""
        def prefill(toks):
            return rwkv6.rwkv_prefill(prm, {"tokens": toks},
                                      mdl.init_cache(b))

        kernel_wkv, errs = rwkv6.wkv, []

        def checked(*args):
            got, want = kernel_wkv(*args), wkv_body(*args)
            errs.append([rel(g, w) for g, w in zip(got, want)])
            return got

        try:
            rwkv6.wkv = checked
            kern = prefill(tokens)
            rwkv6.wkv = wkv_body
            plain = prefill(tokens)
        finally:
            rwkv6.wkv = kernel_wkv
        _, st = prefill(tokens[:, :-1])
        dec = rwkv6.rwkv_decode_step(prm, st, {"tokens": tokens[:, -1:]})
        torch.cuda.synchronize()
        return kern, plain, errs, dec

    def summary(kern, plain, errs, decoded):
        (lk, sk), (lp, sp), (dec, sd) = kern, plain, decoded
        per_layer = [rel(sk["wkv"][i], sp["wkv"][i])
                     for i in range(cfg.n_layers)]
        return {
            "finite": all(bool(torch.isfinite(x).all()) for x in (
                lk, lp, dec, *sk.values(), *sp.values())),
            "layer_wkv_kernel_vs_twin_max_rel": {
                "o": max(e[0] for e in errs),
                "state": max(e[1] for e in errs), "layers": len(errs)},
            "plain_prefill_layer0_state_rel": per_layer[0],
            "plain_prefill_state_rel_by_layer": per_layer,
            "plain_prefill_growth_per_layer": (
                (per_layer[-1] / per_layer[1]) ** (1 / (cfg.n_layers - 2))
                if cfg.n_layers > 2 and per_layer[1] > 0 else None),
            "plain_prefill_state_rel": rel(sk["wkv"], sp["wkv"]),
            "plain_prefill_logits_rel": rel(lk, lp),
            "plain_prefill_same_token": bool(torch.equal(lk.argmax(-1),
                                                         lp.argmax(-1))),
            "decode_layer0_state_rel": max(rel(sd[k][0], sk[k][0])
                                           for k in sk),
            "decode_logits_rel": rel(dec, lk),
            "decode_same_token": bool(torch.equal(dec.argmax(-1),
                                                  lk.argmax(-1))),
        }

    kern, plain, errs, dec = consistency(model, params)
    bf16 = summary(kern, plain, errs, dec)
    greedy = kern[0].argmax(-1)
    bf16["engine_first_token_is_prefill_argmax"] = (
        [o[0] for o in outs] == greedy.reshape(-1).tolist())
    # the head on the card (bf16 product, f32 accumulation) against the
    # same product in f32 (exact products of bf16 values; TF32 is off)
    x = torch.randn((b, 1, cfg.d_model), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(1)
                    ).to(torch.bfloat16)
    xn = layer_norm(x, params.final_norm.w, params.final_norm.b)
    bf16["head_vs_f32_product_rel"] = rel(
        rwkv6._head(params, x),
        xn.to(torch.bfloat16).float() @ params.unembed.float())
    lw = bf16["layer_wkv_kernel_vs_twin_max_rel"]
    if not (bf16["finite"] and lw["layers"] == cfg.n_layers
            and max(lw["o"], lw["state"]) < 1e-5
            and bf16["plain_prefill_layer0_state_rel"] < 1e-4
            and bf16["decode_layer0_state_rel"] < 1e-2
            and bf16["head_vs_f32_product_rel"] < 1e-5
            and bf16["engine_first_token_is_prefill_argmax"]):
        fail(f"rwkv6-3b bf16 checks: {bf16}")

    # rates: the prefill alone (3 calls) and the decode step alone (16
    # steps from the prefill's state), host clock around a synchronize
    def prefill(toks):
        return rwkv6.rwkv_prefill(params, {"tokens": toks},
                                  model.init_cache(b))

    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for _ in range(3):
        prefill(tokens)
    torch.cuda.synchronize()
    prefill_s = (time.perf_counter() - t1) / 3
    st, tok = kern[1], greedy.to(torch.int32)
    t1 = time.perf_counter()
    for _ in range(new):
        lg, st = rwkv6.rwkv_decode_step(params, st, {"tokens": tok})
        tok = lg.argmax(-1).to(torch.int32)
    torch.cuda.synchronize()
    decode_s = (time.perf_counter() - t1) / new
    t1 = time.perf_counter()
    engine.generate(prompts)
    torch.cuda.synchronize()
    generate_s = time.perf_counter() - t1
    trace_prefill = profile_call(torch, lambda: prefill(tokens),
                                 track=("wkv",))
    trace_generate = profile_call(torch, lambda: engine.generate(prompts),
                                  track=("wkv",))
    trace_decode = profile_call(torch, lambda: rwkv6.rwkv_decode_step(
        params, kern[1], {"tokens": greedy.to(torch.int32)}))
    max_gb = torch.cuda.max_memory_allocated() / 1e9
    del params, engine, kern, plain, dec, st, lg
    torch.cuda.empty_cache()

    # the same checks on f32 weights (the same seed), where prefill(T)
    # against prefill(T-1) + decode is well posed at full depth
    model32 = build_model(cfg, dtype=torch.float32)
    params32 = model32.init(torch.Generator(device=dev).manual_seed(0))
    f32 = summary(*consistency(model32, params32))
    lw = f32["layer_wkv_kernel_vs_twin_max_rel"]
    if not (f32["finite"] and max(lw["o"], lw["state"]) < 1e-5
            and f32["plain_prefill_layer0_state_rel"] < 1e-4
            and f32["decode_layer0_state_rel"] < 1e-4
            and f32["decode_same_token"] and f32["decode_logits_rel"] < 0.05):
        fail(f"rwkv6-3b f32 checks: {f32}")
    del params32, model32
    torch.cuda.empty_cache()

    emit({"phase": "lm_rwkv6_3b", "arch": cfg.name,
          "layers": cfg.n_layers, "d_model": cfg.d_model,
          "heads": cfg.n_heads, "vocab": cfg.vocab_size, "dtype": "bfloat16",
          "n_params": model.n_params, "batch": b, "prompt_len": t,
          "new_tokens": new, "launches": counts,
          "tolerances": {"layer_wkv_kernel_vs_twin": 1e-5,
                         "plain_prefill_layer0_state": 1e-4,
                         "bf16_decode_layer0_state": 1e-2,
                         "f32_decode_layer0_state": 1e-4,
                         "head_vs_f32_product": 1e-5,
                         "f32_decode_logits": 0.05},
          "bf16": bf16, "f32": f32,
          "init_s": init_s, "first_generate_s": first_s,
          "generate_s": generate_s, "prefill_s": prefill_s,
          "prefill_tokens_per_s": b * t / prefill_s,
          "decode_ms_per_step": decode_s * 1e3,
          "decode_tokens_per_s": b / decode_s,
          "max_memory_gb": max_gb,
          "profiled_prefill": trace_prefill,
          "profiled_generate": trace_generate,
          "profiled_decode_step": trace_decode,
          "nvidia_smi": nvidia_smi()})


class LMCell(NamedTuple):
    """One generation cell: ``arch`` at ``layers`` (None: all of them),
    ``batch`` prompts of ``prompt`` tokens (after the vlm's patch prefix),
    ``new`` tokens, a cache of ``cache`` slots; the f32 consistency model
    at ``f32_layers`` (None: no f32 check) on the cell's own prompts, or
    on one prompt of ``f32_tokens`` tokens where that is set."""

    arch: str
    layers: Optional[int]
    batch: int
    prompt: int
    new: int
    cache: int
    f32_layers: Optional[int]
    f32_tokens: Optional[int] = None


# the decoder-only transformer (dense and vlm): gemma-2b whole at 4 x 512
# and at its published 8,192-token context (8 prefill KV chunks, 4
# decode chunks), qwen2.5-14b at 4 of 48 layers, minicpm-2b whole,
# qwen1.5-32b whole (its f32 consistency model at 4 layers: whole, it
# would not fit) and paligemma-3b whole behind its 256 patches (1,280
# positions: the bidirectional prefix in the first of two KV chunks)
DENSE_CELLS = (
    LMCell("gemma-2b", None, 4, 512, 16, 1024, 18),
    LMCell("gemma-2b", None, 2, 8176, 16, 8192, 18),
    LMCell("qwen2.5-14b", 4, 2, 512, 8, 1024, 4),
    LMCell("minicpm-2b", None, 4, 512, 16, 1024, 40),
    LMCell("qwen1.5-32b", None, 2, 512, 8, 1024, 4),
    LMCell("paligemma-3b", None, 4, 1024, 16, 1296, 18),
)
# the MoE family: llama4-maverick at 2 of 48 layers (one dense + MoE
# superblock: a second would not fit beside the init's f32 draw of an
# expert stack), dbrx-132b at 10 of 40; the f32 check at 1 x 8, where
# capacity drops nothing
MOE_CELLS = (
    LMCell("llama4-maverick-400b-a17b", 2, 2, 512, 8, 1024, None, 8),
    LMCell("dbrx-132b", 10, 2, 512, 8, 1024, 1, 8),
)
# recurrentgemma-9b whole: a cache shorter than its 2,048-token window
# (no ring), then 2 x 4,096 past it (a 2,048-slot ring: the prefill keeps
# the last 2,048 tokens by slot, decode wraps step % 2048)
HYBRID_CELLS = (
    LMCell("recurrentgemma-9b", None, 4, 512, 16, 1024, 5, 8),
    LMCell("recurrentgemma-9b", None, 2, 4096, 16, 4112, 5),
)
LONG_ATTENTION_ROWS = 64     # query rows held against a float64 softmax


def _cell_config(cell: LMCell):
    import dataclasses

    from repro_torch.configs import get_config

    cfg = get_config(cell.arch)
    if cell.layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=cell.layers)
    return cfg


def _tree_bytes(tree) -> int:
    """Bytes of every tensor in a cache or state (dicts, lists, QuantKV)."""
    from repro_torch.models.attention import QuantKV

    if isinstance(tree, dict):
        return sum(_tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_tree_bytes(v) for v in tree)
    if isinstance(tree, QuantKV):
        return _tree_bytes([tree.q, tree.scale])
    return tree.numel() * tree.element_size()


def lm_cell_bytes(cell: LMCell) -> dict:
    """The cell's device bytes reckoned on meta tensors: its bf16
    weights, the init's one f32 draw of the largest leaf, its caches (a
    bf16 cache of the cell's batch and slots, and for the transformer an
    int8 one beside it) and their sum; then the f32 consistency model's
    weights, its draw and its two caches."""
    import dataclasses

    import torch

    from repro_torch.models import build_model

    cfg = _cell_config(cell)

    def reckon(c, dtype, b, int8):
        model = build_model(c, dtype=dtype, device="meta")
        leaves = list(model.make_params().parameters())
        weights = sum(p.numel() * p.element_size() for p in leaves)
        draw = 4 * max(p.numel() for p in leaves)
        caches = _tree_bytes(model.init_cache(b, cell.cache))
        if int8:
            caches += _tree_bytes(model.init_cache(b, cell.cache,
                                                   quantized=True))
        return weights, draw, caches

    weights, draw, caches = reckon(cfg, torch.bfloat16, cell.batch,
                                   cfg.family in ("dense", "vlm"))
    out = {"weights": weights, "f32_draw": draw, "caches": caches,
           "total": weights + draw + caches}
    if cell.f32_layers is not None:
        w32, d32, c32 = reckon(
            dataclasses.replace(cfg, n_layers=cell.f32_layers),
            torch.float32, cell.batch if cell.f32_tokens is None else 1,
            False)
        out["f32_total"] = w32 + d32 + 2 * c32
    return out


def _moe_first_layer_drops(torch, model, params, tokens, cache_len) -> dict:
    """One prefill of ``tokens`` with the first MoE layer's routing
    recorded (a wrapper around ``moe.moe_ffn`` for this call): its
    assignments, capacity, largest expert load and the share capacity
    dropped."""
    from repro_torch.models import moe

    real, rec = moe.moe_ffn, {}

    def first(x, p, m, *, router_style="softmax"):
        if not rec:
            b, s, d = x.shape
            g = moe._dp_groups(b * s)
            cap = moe.moe_capacity(b * s // g, m)
            r = moe.route_tokens(x.reshape(g, -1, d), p.router, m, cap,
                                 router_style)
            load = torch.bincount(r.se.reshape(-1), minlength=m.num_experts)
            rec.update(assignments=int(r.keep.numel()), capacity=cap,
                       groups=g, max_expert_load=int(load.max()),
                       experts_over_capacity=int((load > cap).sum()),
                       dropped_share=float(1.0 - r.keep.float().mean()))
        return real(x, p, m, router_style=router_style)

    moe.moe_ffn = first
    try:
        model.prefill(params, {"tokens": tokens},
                      model.init_cache(tokens.shape[0], cache_len))
    finally:
        moe.moe_ffn = real
    return rec


def _long_attention(torch, cfg, s: int, prefix_len) -> dict:
    """At the model's head shapes, standard-normal f32 q/k/v over one
    prompt of ``s`` positions with the model's mask (causal; its window;
    the vlm's bidirectional prefix): ``chunked_attention`` at
    ``ATTN_CHUNK`` against one chunk of ``s``, over every row, and the
    last LONG_ATTENTION_ROWS query rows of both against a float64
    softmax, each relative to the largest magnitude (TF32 off)."""
    from repro_torch.models.attention import chunked_attention
    from repro_torch.models.layers import softcap
    from repro_torch.models.transformer import ATTN_CHUNK

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(4)
    h, kh, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = torch.randn((1, s, h, d), device=dev, generator=g)
    k, v = (torch.randn((1, s, kh, d), device=dev, generator=g)
            for _ in range(2))
    kw = dict(causal=True, window=cfg.attn_window, prefix_len=prefix_len,
              logit_cap=cfg.logit_cap)
    chunked = chunked_attention(q, k, v, chunk=ATTN_CHUNK, **kw)
    one = chunked_attention(q, k, v, chunk=s, **kw)
    rows = LONG_ATTENTION_ROWS
    kv_head = torch.arange(h, device=dev) // (h // kh)
    kd, vd = k[0].double()[:, kv_head], v[0].double()[:, kv_head]
    scores = softcap(torch.einsum("rhd,shd->hrs",
                                  q[0, -rows:].double() * d ** -0.5, kd),
                     cfg.logit_cap)
    qpos = torch.arange(s - rows, s, device=dev)[:, None]
    kpos = torch.arange(s, device=dev)[None, :]
    allowed = kpos <= qpos
    if cfg.attn_window is not None:
        allowed &= kpos > qpos - cfg.attn_window
    if prefix_len is not None:
        allowed |= kpos < prefix_len
    p = torch.softmax(scores.masked_fill(~allowed, float("-inf")), -1)
    want = torch.einsum("hrs,shd->rhd", p, vd)
    rel = lambda a, b: float((a.double() - b).abs().max() / b.abs().max())
    return {"positions": s, "chunk": ATTN_CHUNK, "window": cfg.attn_window,
            "prefix_len": prefix_len,
            "chunked_vs_one_chunk_rel": rel(chunked, one.double()),
            "chunked_vs_f64_rel": rel(chunked[0, -rows:], want),
            "one_chunk_vs_f64_rel": rel(one[0, -rows:], want),
            "f64_rows": rows}


def _prefix_check(torch, params, batch) -> dict:
    """The vlm's prefix-LM mask on the card (``tests/
    test_torch_transformer.py``'s prefix test at full width): a change to
    the last patch moves the first patch position's hidden state; a
    change to the last text token leaves every earlier position
    bit-equal and moves the last."""
    from repro_torch.models import transformer

    def hidden(b):
        embeds, prefix = transformer._prep_embeds(params, b)
        return transformer.decoder_hidden(params, embeds, mode="prefill",
                                          prefix_len=prefix)

    h0 = hidden(batch)
    patches = batch["patches"].clone()
    patches[:, -1] += 1.0
    first_moved = not torch.allclose(
        h0[:, 0], hidden(dict(batch, patches=patches))[:, 0])
    tokens = batch["tokens"].clone()
    tokens[:, -1] = tokens[:, -1] % (params.cfg.vocab_size - 1) + 1
    h2 = hidden(dict(batch, tokens=tokens))
    return {"last_patch_moves_first_position": first_moved,
            "last_token_leaves_earlier_bit_equal": bool(
                torch.equal(h0[:, :-1], h2[:, :-1])),
            "earlier_max_abs_diff": float((h0[:, :-1] - h2[:, :-1])
                                          .abs().max()),
            "last_token_moves_last_position": not torch.allclose(
                h0[:, -1], h2[:, -1])}


def _lm_cell(torch, rng, counted, phase, cell: LMCell, extra=None) -> None:
    """One generation cell on the card: bf16 weights from a seeded init,
    greedy, through ``GenerationEngine`` (the vlm, whose prompts carry
    patch embeddings the engine does not take, through the model's
    ``prefill`` and ``decode_step``); no hand-written kernel may launch.

    Checks, each gating the run: the outputs in range and the logits
    finite; the first token the prefill's argmax; prefill(T) against
    prefill(T-1) and one decode step at T-1 (the cell's prompts, or 1 x
    ``f32_tokens``): finite, and on f32 weights at ``f32_layers`` (the
    same seed) the same next token and logits within 5% (the bf16
    model's figures printed).  The transformer (dense, vlm) also: the
    head's bf16 product against the same product in f32 (1e-5, TF32 off);
    at the head shapes, standard-normal q/k/v, attention over the int8
    cache within the reference's max-abs 0.05 of the unquantized one
    (``tests/test_attention.py``); the decode steps on the int8 cache
    (the config's ``kv_quant_decode`` serving) fed the bf16 steps' tokens,
    finite, their largest relative logits difference and argmax
    agreement printed.  Past one attention chunk, ``_long_attention`` at
    the model's head shapes (2e-5); the vlm, ``_prefix_check`` on the f32
    weights.  Prints prefill tokens/s, decode ms a step (host clock
    around a synchronize; bf16 and int8 caches) beside the bytes bound of
    the weights a step reads (every expert, as the batched product reads
    them; of an untied embedding only its B rows), generate seconds, the
    meta reckoning beside the peak memory, the profiled busy and idle
    shares of a prefill and a decode step, and ``extra(model, params,
    tokens)``."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import build_model, transformer
    from repro_torch.models.attention import chunked_attention, quantize_kv
    from repro_torch.serving import EngineConfig, GenerationEngine

    dev = torch.device("cuda")
    rel = lambda g, w: float((g - w).abs().max() / w.abs().max())
    finite = lambda *xs: all(bool(torch.isfinite(x).all()) for x in xs)
    gen = lambda seed: torch.Generator(device=dev).manual_seed(seed)
    b, t, new, c_len = cell.batch, cell.prompt, cell.new, cell.cache
    cfg = _cell_config(cell)
    n_pre = cfg.num_prefix_tokens       # the vlm's patches ahead of the text
    kv_cache = cfg.family in ("dense", "vlm")
    reckoned = {k: v / 1e9 for k, v in lm_cell_bytes(cell).items()}
    torch.cuda.empty_cache()
    resident_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_model(cfg)
    params = model.init(gen(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    # the init's peak holds one f32 draw of the largest weight beside
    # the model; serving's peak is read apart
    init_gb = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    tokens = torch.as_tensor(rng.integers(1, cfg.vocab_size, (b, t)),
                             dtype=torch.int32, device=dev)
    # the SigLIP stub: seeded bf16 patch embeddings
    patches = (torch.randn((b, n_pre, cfg.d_model), device=dev,
                           generator=gen(3)).to(torch.bfloat16)
               if n_pre else None)

    def inputs(toks):
        return ({"tokens": toks} if patches is None else
                {"tokens": toks, "patches": patches[:toks.shape[0]]})

    def prefill(mdl, prm, toks, quantized=False):
        return mdl.prefill(prm, inputs(toks), mdl.init_cache(
            toks.shape[0], c_len, quantized=quantized))

    engine = None
    if n_pre:
        def generate():
            logits, cache = prefill(model, params, tokens)
            tok = logits.argmax(-1).to(torch.int32)
            out = [tok]
            for i in range(new - 1):
                logits, cache = model.decode_step(params, cache,
                                                  {"tokens": tok},
                                                  n_pre + t + i)
                tok = logits.argmax(-1).to(torch.int32)
                out.append(tok)
            return torch.cat(out, 1).tolist()
    else:
        engine = GenerationEngine(model, params, EngineConfig(
            batch_size=b, prompt_len=t, max_new_tokens=new,
            cache_len=c_len))
        generate = lambda: engine.generate(tokens.tolist())
    t0 = time.perf_counter()
    outs, counts = counted(generate)
    first_s = time.perf_counter() - t0
    if counts:
        fail(f"{cfg.name} generate launched hand-written kernels: {counts}")
    if (len(outs) != b or any(len(o) != new for o in outs)
            or not all(0 <= x < cfg.vocab_size for o in outs for x in o)):
        fail(f"{cfg.name} generate: outputs {[len(o) for o in outs]}")

    def consistency(mdl, prm):
        """prefill(T) and prefill(T-1) + one decode step at T-1, each
        cache freed before the next is made."""
        bb, tt = (b, t) if cell.f32_tokens is None else (1, cell.f32_tokens)
        toks = tokens[:bb, :tt]
        full, cache = prefill(mdl, prm, toks)
        del cache
        _, cache = prefill(mdl, prm, toks[:, :-1])
        dec, _ = mdl.decode_step(prm, cache, {"tokens": toks[:, -1:]},
                                 n_pre + tt - 1)
        del cache
        torch.cuda.synchronize()
        return {"batch": bb, "positions": n_pre + tt,
                "finite": finite(full, dec),
                "decode_logits_rel": rel(dec, full),
                "decode_same_token": bool(torch.equal(full.argmax(-1),
                                                      dec.argmax(-1)))}

    bf16 = {"prefill_then_decode": consistency(model, params)}
    logits, cache = prefill(model, params, tokens)
    greedy = logits.argmax(-1).to(torch.int32)
    bf16["finite"] = finite(logits)
    bf16["first_token_is_prefill_argmax"] = (
        [o[0] for o in outs] == greedy.reshape(-1).tolist())
    ok = (bf16["finite"] and bf16["first_token_is_prefill_argmax"]
          and bf16["prefill_then_decode"]["finite"])
    if kv_cache:
        # the head on the card against the same product in f32
        x = torch.randn((b, 1, cfg.d_model), device=dev,
                        generator=gen(1)).to(torch.bfloat16)
        want = x.float() @ transformer.unembed_matrix(params).float()
        bf16["head_vs_f32_product_rel"] = rel(
            transformer._head(params, x), want / cfg.logit_divisor)
        del want
        # int8 cache: attention at the head shapes
        g = gen(2)
        q = torch.randn((b, 1, cfg.n_heads, cfg.head_dim), device=dev,
                        generator=g)
        k, v = (torch.randn((b, c_len, cfg.n_kv_heads, cfg.head_dim),
                            device=dev, generator=g) for _ in range(2))
        pos = dict(q_positions=torch.arange(c_len - 1, c_len, device=dev),
                   kv_positions=torch.arange(c_len, device=dev),
                   chunk=min(2048, c_len))
        bf16["int8_attention_max_abs_err"] = float(
            (chunked_attention(q, quantize_kv(k), quantize_kv(v), **pos)
             - chunked_attention(q, k, v, **pos)).abs().max())
        del q, k, v
        ok = (ok and bf16["head_vs_f32_product_rel"] < 1e-5
              and bf16["int8_attention_max_abs_err"] < 0.05)
    long = None
    if n_pre + t > transformer.ATTN_CHUNK:
        long = _long_attention(torch, cfg, n_pre + t, n_pre or None)
        ok = ok and all(long[k] < 2e-5 for k in (
            "chunked_vs_one_chunk_rel", "chunked_vs_f64_rel",
            "one_chunk_vs_f64_rel"))
    if extra is not None:
        bf16.update(extra(model, params, tokens))
    if not ok:
        fail(f"{cfg.name} bf16 checks: {bf16}, long attention {long}")

    # rates: the prefill alone (3 calls) and the decode step alone (``new``
    # steps on the prefill's cache), host clock around a synchronize; for
    # the transformer the same steps again on the int8 cache, fed the bf16
    # steps' tokens
    step0 = n_pre + t
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for _ in range(3):
        prefill(model, params, tokens)
    torch.cuda.synchronize()
    prefill_s = (time.perf_counter() - t1) / 3
    tok, fed, steps = greedy, [], []
    t1 = time.perf_counter()
    for i in range(new):
        fed.append(tok)
        lg, cache = model.decode_step(params, cache, {"tokens": tok},
                                      step0 + i)
        steps.append(lg)
        tok = lg.argmax(-1).to(torch.int32)
    torch.cuda.synchronize()
    decode_s = (time.perf_counter() - t1) / new
    if not finite(*steps):
        fail(f"{cfg.name} decode logits not finite")
    int8 = None
    if kv_cache:
        _, qcache = prefill(model, params, tokens, quantized=True)
        qsteps = []
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for i, tk in enumerate(fed):
            qlg, qcache = model.decode_step(params, qcache, {"tokens": tk},
                                            step0 + i)
            qsteps.append(qlg)
            qlg.argmax(-1).to(torch.int32)
        torch.cuda.synchronize()
        int8_s = (time.perf_counter() - t1) / new
        int8 = {"decode_ms_per_step": int8_s * 1e3,
                "decode_tokens_per_s": b / int8_s,
                "finite": finite(*qsteps),
                "logits_max_rel_vs_bf16": max(
                    rel(a, w) for a, w in zip(qsteps, steps)),
                "argmax_agreement": float(torch.mean(torch.stack(
                    [(a.argmax(-1) == w.argmax(-1)).float().mean()
                     for a, w in zip(qsteps, steps)])))}
        del qcache, qsteps
        if not int8["finite"]:
            fail(f"{cfg.name} int8-cache decode: {int8}")
    t1 = time.perf_counter()
    generate()
    torch.cuda.synchronize()
    generate_s = time.perf_counter() - t1
    trace_prefill = profile_call(torch, lambda: prefill(model, params,
                                                        tokens))
    # the last decode step again (the cache may hold no slot past it)
    trace_decode = profile_call(torch, lambda: model.decode_step(
        params, cache, {"tokens": fed[-1]}, step0 + new - 1))
    max_gb = torch.cuda.max_memory_allocated() / 1e9
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in params.parameters())
    if not cfg.tie_embeddings:
        weight_bytes -= params.embed.numel() * params.embed.element_size()
    n_params, n_active = model.n_params, model.n_active_params
    del params, cache, logits, lg, steps, fed, model, generate, engine
    torch.cuda.empty_cache()

    f32 = None
    if cell.f32_layers is not None:
        cfg32 = dataclasses.replace(cfg, n_layers=cell.f32_layers)
        model32 = build_model(cfg32, dtype=torch.float32)
        params32 = model32.init(gen(0))
        f32 = consistency(model32, params32)
        f32["layers"] = cell.f32_layers
        ok = (f32["finite"] and f32["decode_same_token"]
              and f32["decode_logits_rel"] < 0.05)
        if n_pre:
            f32["prefix"] = _prefix_check(torch, params32, {
                "tokens": tokens, "patches": patches.float()})
            ok = ok and all(f32["prefix"][k] for k in (
                "last_patch_moves_first_position",
                "last_token_leaves_earlier_bit_equal",
                "last_token_moves_last_position"))
        del params32, model32
        torch.cuda.empty_cache()
        if not ok:
            fail(f"{cfg.name} f32 checks: {f32}")

    emit({"phase": phase, "arch": cfg.name, "family": cfg.family,
          "layers": cfg.n_layers,
          "layers_published": get_config(cell.arch).n_layers,
          "d_model": cfg.d_model, "heads": cfg.n_heads,
          "kv_heads": cfg.n_kv_heads, "head_dim": cfg.head_dim,
          "vocab": cfg.vocab_size, "dtype": "bfloat16",
          "n_params": n_params, "n_active_params": n_active,
          "batch": b, "prefix_positions": n_pre, "prompt_len": t,
          "new_tokens": new, "cache_len": c_len,
          "kv_quant_decode": cfg.kv_quant_decode, "launches": counts,
          "tolerances": {"f32_decode_logits": 0.05,
                         **({"head_vs_f32_product": 1e-5,
                             "int8_attention_max_abs": 0.05}
                            if kv_cache else {}),
                         **({"long_attention": 2e-5} if long else {})},
          "bf16": bf16, "int8_cache": int8, "long_attention": long,
          "f32": f32,
          "init_s": init_s, "first_generate_s": first_s,
          "generate_s": generate_s, "prefill_s": prefill_s,
          "prefill_tokens_per_s": b * t / prefill_s,
          "decode_ms_per_step": decode_s * 1e3,
          "decode_tokens_per_s": b / decode_s,
          "decode_weights_bytes": weight_bytes,
          "decode_weights_bytes_bound_ms": (weight_bytes / PEAK_BYTES_S
                                            * 1e3),
          "reckoned_gb": reckoned, "resident_gb_before": resident_gb,
          "max_memory_gb": max_gb, "init_max_memory_gb": init_gb,
          "profiled_prefill": trace_prefill,
          "profiled_decode_step": trace_decode,
          "nvidia_smi": nvidia_smi()})


def lm_dense(torch, rng, counted) -> None:
    """The generation engine on the decoder-only transformer at full
    width (``DENSE_CELLS``): gemma-2b whole (18 layers, d_model 2048, MQA
    with head_dim 256, vocab 256,000) on 4 x 512 and on 2 x 8,176 (its
    8,192-token context), qwen2.5-14b at 4 of 48 layers (GQA 40/8, QKV
    bias), minicpm-2b whole (40 layers, its muP scalings), qwen1.5-32b
    whole (64 layers, MHA 40 x 128, QKV bias, its decode on the int8
    cache its config serves beside the bf16 one) and paligemma-3b whole
    behind 256 patch embeddings (the prefix-LM mask), each freed before
    the next.  Attention is plain torch (no hand-written kernel).  The
    checks are ``_lm_cell``'s."""
    for cell in DENSE_CELLS:
        _lm_cell(torch, rng, counted, "lm_dense", cell)


def lm_moe(torch, rng, counted) -> None:
    """The generation engine on the MoE family at full width
    (``MOE_CELLS``): llama4-maverick-400b-a17b at 2 of its 48 layers (one
    dense + MoE superblock: 128 experts of 5120 x 8192 top-1 with the
    shared expert, vocab 202,048 untied; 37.4 GB of bf16 weights) and
    dbrx-132b at 10 of 40 (16 experts of 6144 x 10752, top-4; 67.6 GB),
    each on 2 prompts of 512 tokens and 8 new, freed before the next.
    Capacity-routed experts on plain torch (a stable argsort, the
    kept-only scatter, batched expert products over every expert): no
    hand-written kernel launches.  Prints the share of the prefill's
    assignments that capacity dropped in the first MoE layer; the f32
    consistency check runs dbrx at 1 layer (18 GB)."""
    for cell in MOE_CELLS:
        _lm_cell(torch, rng, counted, "lm_moe", cell,
                 extra=lambda m, p, toks: {
                     "first_moe_layer_prefill": _moe_first_layer_drops(
                         torch, m, p, toks, cell.cache)})


def lm_hybrid(torch, rng, counted) -> None:
    """The generation engine on recurrentgemma-9b whole (38 layers: 26
    RG-LRU recurrent and 12 local-attention, d_model and d_rnn 4096, MQA
    with head_dim 256, window 2048, vocab 256,000 tied; 18.8 GB of bf16
    weights), ``HYBRID_CELLS``: 4 x 512 on a cache of 1024 slots (shorter
    than the window: no ring), then 2 x 4,096 on a 2,048-slot ring; the
    doubling scan in prefill, one recurrence step a decode step; no
    hand-written kernel launches.  The f32 consistency check runs 5
    layers (one superblock and the tail).  Prints the FP32 gate products'
    operations (``wa`` and ``wx``: 2 x 2 x B x T x d_rnn^2 a recurrent
    layer, TF32 off)."""
    from repro_torch.models import rglru

    for cell in HYBRID_CELLS:
        cfg = _cell_config(cell)
        n_rec = rglru.layer_kinds(cfg).count("rec")
        flop = 2 * 2 * cell.batch * cell.prompt * cfg.recurrent.d_rnn ** 2 \
            * n_rec
        _lm_cell(torch, rng, counted, "lm_hybrid", cell,
                 extra=lambda m, p, toks: {
                     "recurrent_layers": n_rec,
                     "prefill_fp32_gate_products_tflop": flop / 1e12,
                     "fp32_gate_products_bound_ms": (
                         flop / PEAK_FP32_S * 1e3)})


# whisper-medium whole: (arch, prompts, frames, prompt tokens, new tokens,
# cache slots) -- Whisper's 30 s window of 1500 frames and its 448-token
# text context
ENCDEC_CELL = ("whisper-medium", 4, 1500, 32, 32, 448)
# the decode steps whose logits are held against a fresh prefill
ENCDEC_CHECK_STEPS = (0, 15, 31)


def lm_encdec(torch, np, rng, counted) -> None:
    """whisper-medium at full width and depth (24 encoder and 24 decoder
    layers, d_model 1024, 16 heads, vocab 51,865 tied; 1.52 GB of bf16
    weights from a seeded init) through the model API, as the reference
    serves it: ``prefill(params, {"frames", "tokens"}, cache)`` on 4 x
    1500 seeded frame embeddings and a 32-token prompt, then 32 greedy
    ``decode_step``s on a cache of 448 slots.  Plain torch: no
    hand-written kernel may launch.

    Checks: logits finite and tokens in range; the cross K/V as long as
    the frames (1500, not the cache's 448 slots); the decode step's
    logits at steps 0, 15 and 31 against a fresh prefill of the prompt
    and the tokens generated up to that step (within 5%, the bf16
    tolerance of ``tests/test_torch_encdec.py``; the same argmax
    printed).  Prints the prefill's ms split into the encoder and the
    decoder, the decode ms a step and tokens/s (host clock around a
    synchronize), the step's bytes bound (what the code reads: the
    decoder's weights but the cross ``wk``/``wv``, the whole embedding
    for the head, both caches whole; the logits written) at 3.35 TB/s,
    one profiled prefill and decode step (busy, idle, kernels) and the
    peak memory of serving."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model, encdec

    arch, b, t_enc, t, new, c_len = ENCDEC_CELL
    dev = torch.device("cuda")
    rel = lambda g, w: float((g - w).abs().max() / w.abs().max())
    cfg = get_config(arch)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    frames = torch.as_tensor(
        rng.standard_normal((b, t_enc, cfg.d_model)).astype(np.float32),
        device=dev).to(torch.bfloat16)
    prompt = torch.as_tensor(
        rng.integers(1, cfg.vocab_size, (b, t)).astype(np.int32), device=dev)

    def prefill(toks):
        return model.prefill(params, {"frames": frames, "tokens": toks},
                             model.init_cache(b, c_len))

    def generate():
        logits, cache = prefill(prompt)
        toks, steps = [logits.argmax(-1).to(torch.int32)], []
        for i in range(new):
            lg, cache = model.decode_step(params, cache,
                                          {"tokens": toks[-1]}, t + i)
            steps.append(lg)
            toks.append(lg.argmax(-1).to(torch.int32))
        torch.cuda.synchronize()
        return logits, cache, toks, steps

    t0 = time.perf_counter()
    (logits, cache, toks, steps), counts = counted(generate)
    first_s = time.perf_counter() - t0
    if counts:
        fail(f"{arch} launched hand-written kernels: {counts}")
    gen = torch.cat(toks, dim=1)
    cross = tuple(cache["cross"]["k"].shape)
    checks = {
        "finite": all(bool(torch.isfinite(x).all()) for x in [logits] + steps),
        "tokens_in_range": bool(((gen >= 0) & (gen < cfg.vocab_size)).all()),
        "cross_kv_shape": list(cross),
        "cross_kv_len_is_frames": (cross == (cfg.n_layers, b, t_enc,
                                             cfg.n_kv_heads, cfg.head_dim)
                                   and tuple(cache["cross"]["v"].shape)
                                   == cross),
        "self_kv_len": int(cache["self"]["k"].shape[2])}
    steps_vs_prefill = []
    for i in ENCDEC_CHECK_STEPS:
        full, _ = prefill(torch.cat([prompt, gen[:, :i + 1]], dim=1))
        steps_vs_prefill.append({
            "step": i, "logits_rel": rel(steps[i], full),
            "same_argmax": bool(torch.equal(steps[i].argmax(-1),
                                            full.argmax(-1)))})
    checks["decode_vs_fresh_prefill"] = steps_vs_prefill
    if not (checks["finite"] and checks["tokens_in_range"]
            and checks["cross_kv_len_is_frames"]
            and all(r["logits_rel"] < 0.05 for r in steps_vs_prefill)):
        fail(f"{arch} checks: {checks}")

    # rates, host clock around a synchronize: the encoder alone, the
    # decoder's prefill on its output, the whole prefill (3 calls each);
    # ``new`` decode steps on the prefill's cache
    def timed(fn, reps=3):
        fn()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(reps):
            out = fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t1) / reps * 1e3, out

    encoder_ms, enc_out = timed(lambda: encdec.encode(params, frames))
    decoder_ms, _ = timed(lambda: encdec._head(params, encdec._decoder(
        params, prompt, model.init_cache(b, c_len), mode="prefill",
        enc_out=enc_out)[0][:, -1:]))
    prefill_ms, (_, cache) = timed(lambda: prefill(prompt))
    tok = toks[0]
    t1 = time.perf_counter()
    for i in range(new):
        lg, cache = model.decode_step(params, cache, {"tokens": tok}, t + i)
        tok = lg.argmax(-1).to(torch.int32)
    torch.cuda.synchronize()
    decode_s = (time.perf_counter() - t1) / new
    trace_prefill = profile_call(torch, lambda: prefill(prompt))
    trace_decode = profile_call(torch, lambda: model.decode_step(
        params, cache, {"tokens": tok}, t + new - 1))
    max_gb = torch.cuda.max_memory_allocated() / 1e9

    # the bytes a decode step must move: the decoder's weights but the
    # cross K/V projections (their products are cached), the final norm,
    # the whole embedding (the head), both caches read whole, one self
    # K/V slot a layer written, the f32 logits written
    nbytes = lambda ts: sum(x.numel() * x.element_size() for x in ts)
    dec_weights = [p for name, p in params.dec_layers.named_parameters()
                   if not name.endswith(("cross_attn.wk", "cross_attn.wv"))]
    kv = [cache[part][k] for part in ("self", "cross") for k in ("k", "v")]
    step_bytes = (nbytes(dec_weights) + nbytes(params.dec_ln_post.parameters())
                  + nbytes([params.embed]) + nbytes(kv)
                  + 2 * cfg.n_layers * b * cfg.n_kv_heads * cfg.head_dim
                  * cache["self"]["k"].element_size()
                  + b * cfg.vocab_size * F32)
    n_params = model.n_params
    del params, cache, logits, steps, lg, enc_out, model, frames
    torch.cuda.empty_cache()
    emit({"phase": "lm_encdec", "arch": cfg.name, "family": cfg.family,
          "encoder_layers": cfg.encoder_layers, "decoder_layers": cfg.n_layers,
          "d_model": cfg.d_model, "heads": cfg.n_heads,
          "head_dim": cfg.head_dim, "d_ff": cfg.d_ff,
          "vocab": cfg.vocab_size, "dtype": "bfloat16", "n_params": n_params,
          "batch": b, "frames": t_enc, "prompt_len": t, "new_tokens": new,
          "cache_len": c_len, "launches": counts,
          "tolerances": {"decode_vs_fresh_prefill_logits": 0.05},
          "checks": checks, "init_s": init_s, "first_generate_s": first_s,
          "prefill_ms": prefill_ms, "prefill_encoder_ms": encoder_ms,
          "prefill_decoder_ms": decoder_ms,
          "decode_ms_per_step": decode_s * 1e3,
          "decode_tokens_per_s": b / decode_s,
          "decode_step_bytes": step_bytes,
          "decode_step_bytes_bound_ms": step_bytes / PEAK_BYTES_S * 1e3,
          "max_memory_gb": max_gb,
          "profiled_prefill": trace_prefill,
          "profiled_decode_step": trace_decode,
          "nvidia_smi": nvidia_smi()})


# the coded spectral mixer: (B, S, D), filter taps, and the plan (s, m, N)
# with the example's workers 1 and 4 down
TRAIN_CELL = ("gemma-2b", 4, 512, 4)     # arch, batch, seq, steps
TRAIN_RESTART = ("gemma-2b", 4, 32, 8, 5)  # reduced; batch, seq, total, ckpt


def lm_train(torch, counted) -> None:
    """The training core on the card.  (a) gemma-2b at full width and
    depth (18 layers, d_model 2048, vocab 256,000, ~2.5 B parameters,
    bf16 weights from a seeded init): ``make_train_step`` with exact
    AdamW, ``cosine(3e-4, 8, 1)``, clip 1.0, ``n_micro=1``, for 4 steps
    on one fixed batch of 4 x 512 synthetic tokens.  Plain torch: the
    step must launch none of the port's kernels.  Checks: the loss and
    the grad norm finite at every step, the loss lower at step 4 than at
    step 1, every parameter leaf changed (against a host copy).  Prints
    each step's ms (host clock around a synchronize), tokens/s and the
    share of the card's dense bf16 peak that 6 N tokens a step reaches
    (steps 2-4), ``max_memory_allocated``, and a fifth step profiled
    (busy, idle, the largest kernels).  (b) The restart on the
    card, the reference's ``test_trainer_restart_bit_exact``: reduced
    gemma-2b, 8 steps straight against 5 steps with a checkpoint at step
    5 resumed to 8, under ``CUBLAS_WORKSPACE_CONFIG=:4096:8`` and
    ``torch.use_deterministic_algorithms(True)`` (this check only): the
    final loss and every tensor of the state bit-equal."""
    from repro_torch.configs import ShapeConfig, get_config, \
        get_reduced_config
    from repro_torch.data import make_pipeline
    from repro_torch.models import build_model
    from repro_torch.optim import adamw, cosine
    from repro_torch.training import (Trainer, TrainerConfig,
                                      init_train_state, make_train_step)

    dev = torch.device("cuda")
    arch, b, t, steps = TRAIN_CELL
    cfg = get_config(arch)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg)
    opt = adamw(cosine(3e-4, 8, 1))
    state = init_train_state(model, opt,
                             torch.Generator(device=dev).manual_seed(0))
    batch = make_pipeline(cfg, ShapeConfig("lm_train", t, b, "train"),
                          seed=0).batch(0)
    host = {n: p.detach().to("cpu", copy=True)
            for n, p in state.params.named_parameters()}
    step_fn = make_train_step(model, opt, n_micro=1)
    rows = []
    for i in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (state, metrics), counts = counted(lambda: step_fn(state, batch))
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        if counts:
            fail(f"lm_train step launched hand-written kernels: {counts}")
        rows.append({"step": i + 1, "ms": ms,
                     **{k: float(v) for k, v in metrics.items()}})
    peak = torch.cuda.max_memory_allocated()
    changed = {n: not torch.equal(p.detach().cpu(), host[n])
               for n, p in state.params.named_parameters()}
    finite = all(math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"])
                 for r in rows)
    if not finite or rows[-1]["loss"] >= rows[0]["loss"] or not all(
            changed.values()):
        fail(f"lm_train: steps {rows}, unchanged leaves "
             f"{[n for n, c in changed.items() if not c]}")
    steady = sorted(r["ms"] for r in rows[1:])[len(rows[1:]) // 2]
    tokens = b * t
    profiled = profile_call(torch, lambda: step_fn(state, batch))
    emit({"phase": "lm_train", "arch": arch, "n_params": model.n_params,
          "layers": cfg.n_layers, "d_model": cfg.d_model,
          "vocab": cfg.vocab_size, "batch": b, "seq": t,
          "optimizer": "adamw exact, cosine(3e-4, 8, 1), clip 1.0",
          "steps": rows, "steady_step_ms": steady,
          "tokens_per_s": tokens / steady * 1e3,
          "model_flops_per_step": 6.0 * model.n_params * tokens,
          "bf16_peak_share": 6.0 * model.n_params * tokens
          / (steady * 1e-3) / PEAK_BF16_S,
          "max_memory_allocated_gb": peak / 1e9,
          "leaves_changed": f"{sum(changed.values())}/{len(changed)}",
          "profiled_step_5": profiled, "nvidia_smi": nvidia_smi()})
    del state, host, batch, metrics, model, step_fn
    torch.cuda.empty_cache()

    # (b) the restart, bit for bit, on the card
    arch, b, t, total, ckpt_at = TRAIN_RESTART
    cfg = get_reduced_config(arch)
    model = build_model(cfg)
    pipe = make_pipeline(cfg, ShapeConfig("restart", t, b, "train"))
    opt = adamw(cosine(3e-3, 10, 2))
    quiet = dict(log_fn=lambda *_: None)
    ckpt = ROOT / "build" / f"lm-train-ckpt-{os.getpid()}"
    shutil.rmtree(ckpt, ignore_errors=True)
    old_ws = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True)
    try:
        t0 = time.perf_counter()
        ref_state, ref = Trainer(model, opt, pipe, TrainerConfig(
            total_steps=total, checkpoint_every=100, log_every=100),
            **quiet).run()
        Trainer(model, opt, pipe, TrainerConfig(
            total_steps=ckpt_at, checkpoint_every=ckpt_at,
            checkpoint_dir=str(ckpt), log_every=100), **quiet).run()
        state, resumed = Trainer(model, opt, pipe, TrainerConfig(
            total_steps=total, checkpoint_every=ckpt_at,
            checkpoint_dir=str(ckpt), log_every=100), **quiet).run()
        torch.cuda.synchronize()
        restart_s = time.perf_counter() - t0
    finally:
        torch.use_deterministic_algorithms(False)
        if old_ws is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = old_ws
        shutil.rmtree(ckpt, ignore_errors=True)
    ref_tree, tree = ref_state.tree(), state.tree()
    unequal = [n for n, v in ref_tree.items() if not torch.equal(v, tree[n])]
    if ref["loss"] != resumed["loss"] or unequal or state.step != total:
        fail(f"lm_train restart: loss {ref['loss']} vs {resumed['loss']}, "
             f"step {state.step}, unequal tensors {unequal[:8]}")
    emit({"phase": "lm_train_restart", "arch": cfg.name, "batch": b,
          "seq": t, "steps": total, "checkpoint_at": ckpt_at,
          "final_loss": ref["loss"], "resumed_final_loss": resumed["loss"],
          "tensors_bit_equal": len(ref_tree), "seconds": restart_s})


GRAD_CELL = ("gemma-2b", 8, 4, 512)       # arch, layers, batch, seq
GRAD_CODE = (4, 1)                         # workers, stragglers
GRAD_PSUM = ((2048, 16384), 8, 4)          # gemma-2b's wi, steps, ranks


def _grad_world_gloo(torch, np, mesh, rank):
    """(b) and (c) on four ranks sharing the card over gloo: GRAD_PSUM's
    error-feedback steps of ``compressed_psum`` on seeded f32 gradients
    (each step's mean as a sha256 for the bit-equality check; rank 0
    replays every rank's codes for decompress-then-mean and the
    error-feedback bound), then reduced gemma-2b's exact-AdamW state
    placed on (data 2, model 2) by its sharding plan and gathered back."""
    import hashlib

    import torch.distributed as dist

    from repro_torch.configs import SHAPES, get_reduced_config
    from repro_torch.distributed import test_mesh
    from repro_torch.distributed.sharding import global_tensor, place
    from repro_torch.launch.shardings import make_plan
    from repro_torch.models import build_model
    from repro_torch.optim import (adamw, compress, compressed_psum,
                                   compression, decompress, init_residual)
    from repro_torch.training import init_train_state, train_state_pspecs

    dev = torch.device("cuda")
    shape, steps, world = GRAD_PSUM

    def grad(t, r):
        gen = torch.Generator(device=dev).manual_seed(1000 * t + r)
        return torch.randn(shape, generator=gen, device=dev) * 0.01

    info = {"rank": rank, "mean_sha256": []}
    res = init_residual(grad(0, rank))
    replica = [init_residual(res) for _ in range(world)] if rank == 0 \
        else None
    acc = acc_true = None
    worst, step_ms = 0.0, []
    for t in range(steps):
        g = grad(t, rank)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mean, res = compressed_psum(g, res)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        info["mean_sha256"].append(hashlib.sha256(
            mean.cpu().numpy().tobytes()).hexdigest())
        if rank == 0:                # decompress-then-mean of all 4 codes
            deq, true, last_scale = None, None, 0.0
            for r in range(world):
                code, replica[r] = compress(grad(t, r), replica[r])
                d = decompress(code, shape)
                deq = d if deq is None else deq + d
                true = grad(t, r) if true is None else true + grad(t, r)
                last_scale = max(last_scale, float(code.scale.max()))
            deq, true = deq / world, true / world
            worst = max(worst, float((mean - deq).abs().max()
                                     / deq.abs().max()))
            acc = mean.clone() if acc is None else acc + mean
            acc_true = true if acc_true is None else acc_true + true
    info["psum_ms"] = step_ms
    info["collectives"] = list(compression.last_collectives)
    if rank == 0:
        if not torch.equal(replica[0], res):
            raise RuntimeError("rank 0's replayed residual is not its own")
        mean_res = sum(replica) / world
        info["decompress_then_mean_rel_err"] = worst
        info["error_feedback_err"] = float(
            (acc + mean_res - acc_true).abs().max())
        info["one_step_quant_err"] = last_scale / 2

    # (c) the sharding plan on (data 2, model 2)
    mesh2 = test_mesh((2, 2), ("data", "model"), device_type="cuda")
    model = build_model(get_reduced_config("gemma-2b"))
    opt = adamw(1e-3)
    plan = make_plan(model.cfg, SHAPES["train_4k"], mesh2)
    state = init_train_state(model, opt,
                             torch.Generator(device=dev).manual_seed(0))
    with torch.no_grad():
        for st in state.opt_state["mu"].values():
            st["m"].normal_(generator=torch.Generator(device=dev)
                            .manual_seed(1))
    specs = train_state_pspecs(model, opt, plan.rules)
    named = plan.named(specs)
    tree = state.tree()
    flat = {f"params.{n}": (s, named.params[n])
            for n, s in specs.params.items()}
    for n in specs.params:
        for mv in ("m", "v"):
            flat[f"opt_state.mu.{n}.{mv}"] = (specs.opt_state["mu"][n][mv],
                                              named.opt_state["mu"][n][mv])
    coord = mesh2.get_coordinate()
    bytes_local = bytes_plan = 0
    wrong, unequal = [], []
    for key, (spec, placements) in flat.items():
        x = tree[key].detach()
        dt = place(x, mesh2, placements)
        # the plan's shard: torch.chunk pieces over the mesh dimensions
        # each entry names, in mesh order
        want = list(x.shape)
        for d, entry in enumerate(spec):
            axes = () if entry is None else (
                entry if isinstance(entry, tuple) else (entry,))
            for i in sorted(mesh2.mesh_dim_names.index(a) for a in axes):
                chunk = -(-want[d] // mesh2.size(i))
                want[d] = len(range(want[d])[coord[i] * chunk:
                                             (coord[i] + 1) * chunk])
        local = dt.to_local()
        if list(local.shape) != want:
            wrong.append(key)
        bytes_local += local.numel() * x.element_size()
        bytes_plan += math.prod(want) * x.element_size()
        if not torch.equal(global_tensor(dt), x):
            unequal.append(key)
    info.update(plan_fallbacks=plan.fallbacks, plan_tensors=len(flat),
                plan_wrong_shape=wrong, plan_unequal=unequal,
                plan_bytes_local=bytes_local, plan_bytes=bytes_plan,
                coordinate=list(coord))
    dist.barrier()
    return info, {}


def grad_aggregation(torch, np, counted) -> None:
    """Coded and compressed gradient aggregation and the sharding plan on
    the card (plain torch: no hand-written kernel on this path).

    * (a) gemma-2b at full width, depth cut to GRAD_CELL's 8 of 18 layers
      to fit the card (1.405 B parameters, bf16 weights seeded as in
      ``lm_train``): a 4 x 512 batch from the port's pipeline split into
      4 partitions of one row, each partition's gradient through
      ``BuiltModel.loss`` and ``optim.accumulate_grads``;
      ``CyclicGradientCode(4, 1)``'s 4 messages, a decode from EVERY
      3-of-4 subset, each within 1e-5 of its largest magnitude of the f64
      sum of the 4 gradients (one leaf at a time); encode ms a message
      and decode ms a subset against their bytes bounds; peak memory.
    * (b) four gloo ranks sharing the card (spawned as ``mesh_runtime``
      spawns them): 8 error-feedback steps of ``compressed_psum`` on
      seeded f32 gradients of gemma-2b's MLP ``wi`` shape; every rank's
      mean bit-equal; within 1e-6 of decompress-then-mean of all four
      ranks' codes; the accumulated means plus the mean residual against
      the accumulated true means within one step's quantization error;
      the wire bytes a rank the int8 code and the scales, at
      ``compression_ratio``.  Then, in an NCCL world of one in this
      process, ``compressed_psum`` over every leaf of (a)'s decoded f32
      gradient, the median ms of three calls against its bytes bound.
    * (c) the same four ranks as a (data 2, model 2) mesh: reduced
      gemma-2b's exact-AdamW state placed by ``train_state_pspecs`` of
      ``make_plan(..., train_4k, mesh)`` through ``to_named``/``place``:
      each rank's local shapes the plan's, ``global_tensor`` the state
      bit for bit, each rank's bytes against the plan's."""
    import dataclasses
    import itertools
    import multiprocessing as mp

    import torch.distributed as dist

    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.data import make_pipeline
    from repro_torch.models import build_model
    from repro_torch.optim import (CyclicGradientCode, accumulate_grads,
                                   compressed_psum, compression,
                                   compression_ratio, init_residual)

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    arch, layers, b, t = GRAD_CELL
    cfg = dataclasses.replace(get_config(arch), n_layers=layers)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    params.requires_grad_(True)
    batch = make_pipeline(cfg, ShapeConfig("grad_aggregation", t, b,
                                           "train"), seed=0).batch(0)
    n_work, n_strag = GRAD_CODE
    if b != n_work:
        fail(f"grad_aggregation: {b} rows for {n_work} partitions")

    def partition_grads():
        out = []
        for j in range(n_work):
            part = {k: v[j:j + 1] for k, v in batch.items()}
            _, _, g = accumulate_grads(model.loss, params, part, 1)
            out.append(g)
        return out

    parts, counts = counted(partition_grads)
    if counts:
        fail(f"grad_aggregation: gradients launched kernels {counts}")
    params.requires_grad_(False)
    n_el = sum(g.numel() for g in parts[0].values())
    code = CyclicGradientCode(n_work, n_strag)

    def timed(fn):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        out = fn()
        stop.record()
        torch.cuda.synchronize()
        return out, start.elapsed_time(stop)

    code.encode_worker_grad(0, parts)          # warm the allocator
    msgs, enc_ms = [], []
    for k in range(n_work):
        m, ms = timed(lambda: code.encode_worker_grad(k, parts))
        msgs.append(m)
        enc_ms.append(ms)
    # the f64 truth, one leaf at a time: its largest magnitude first
    names = list(parts[0])

    def truth(name):
        out = parts[0][name].double()
        for p in parts[1:]:
            out.add_(p[name])
        return out

    scale = max(float(truth(nm).abs().max()) for nm in names)
    subsets, dec_ms = [], []
    combos = list(itertools.combinations(range(n_work), n_work - n_strag))
    for i, subset in enumerate(combos):
        sub = np.asarray(subset)
        dec, ms = timed(lambda: code.decode(sub, [msgs[i] for i in subset]))
        dec_ms.append(ms)
        err = max(float(truth(nm).sub_(dec[nm]).abs_().max())
                  for nm in names)
        a = code.decode_vector(sub)
        subsets.append({"subset": list(subset), "rel_err": err / scale,
                        "max_abs_a": float(np.abs(a).max()),
                        "decode_ms": ms})
        if not err / scale < 1e-5:
            fail(f"grad_aggregation: decode from {subset} off the f64 sum "
                 f"by {err / scale} of its largest magnitude")
        if i + 1 < len(combos):
            del dec                  # one decode alive at a time
    last = dec
    peak = torch.cuda.max_memory_allocated()
    bf16, f32 = 2, 4
    enc_bytes = n_el * (n_strag + 1) * bf16 + n_el * f32
    dec_bytes = n_el * (n_work - n_strag) * f32 + n_el * f32
    emit({"phase": "grad_aggregation_coded", "arch": arch,
          "layers": layers, "d_model": cfg.d_model, "n_params": n_el,
          "partitions": f"{n_work} x (1 x {t})", "code": list(GRAD_CODE),
          "max_abs_B": float(np.abs(code.matrix).max()),
          "subsets": subsets,
          "encode_ms": enc_ms, "encode_bound_ms": enc_bytes
          / PEAK_BYTES_S * 1e3, "decode_ms": dec_ms,
          "decode_bound_ms": dec_bytes / PEAK_BYTES_S * 1e3,
          "message_gb": n_el * f32 / 1e9,
          "max_memory_allocated_gb": peak / 1e9})
    del msgs, parts, params, model, batch
    torch.cuda.empty_cache()

    # (b) and (c): four gloo ranks sharing the card
    shape, steps, world = GRAD_PSUM
    ctx = mp.get_context("spawn")
    outdir = ROOT / "build" / f"grad-{os.getpid()}"
    shutil.rmtree(outdir, ignore_errors=True)
    outdir.mkdir(parents=True)
    t0 = time.perf_counter()
    procs = [ctx.Process(target=_mesh_child,
                         args=(_grad_world_gloo, r, world, "gloo",
                               str(outdir)))
             for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=300)
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    errs = "".join(f.read_text() for f in sorted(outdir.glob("*.err")))
    if any(p.exitcode != 0 for p in procs) or errs:
        fail(f"grad_aggregation gloo world: exit codes "
             f"{[p.exitcode for p in procs]}\n{errs[-4000:]}")
    ranks = [json.loads((outdir / f"rank{r}.json").read_text())
             for r in range(world)]
    shutil.rmtree(outdir, ignore_errors=True)
    r0 = ranks[0]
    nblocks = -(-math.prod(shape) // 256)
    wire = sum(c["send_bytes"] for c in r0["collectives"])
    if any(r["mean_sha256"] != r0["mean_sha256"] for r in ranks):
        fail("grad_aggregation: compressed_psum's means differ across ranks")
    if not r0["decompress_then_mean_rel_err"] < 1e-6:
        fail(f"grad_aggregation: compressed_psum off decompress-then-mean "
             f"by {r0['decompress_then_mean_rel_err']}")
    if not r0["error_feedback_err"] < r0["one_step_quant_err"]:
        fail(f"grad_aggregation: error feedback {r0['error_feedback_err']} "
             f"past one step's quantization error "
             f"{r0['one_step_quant_err']}")
    ratio = math.prod(shape) * 4 / wire
    if wire != nblocks * 256 + nblocks * 4 or ratio != compression_ratio(
            shape):
        fail(f"grad_aggregation: {wire} wire bytes a rank, ratio {ratio}")
    for r in ranks:
        if r["plan_wrong_shape"] or r["plan_unequal"] or \
                r["plan_bytes_local"] != r["plan_bytes"]:
            fail(f"grad_aggregation plan on rank {r['rank']}: shapes "
                 f"{r['plan_wrong_shape']}, unequal {r['plan_unequal']}, "
                 f"bytes {r['plan_bytes_local']} against {r['plan_bytes']}")
    emit({"phase": "grad_aggregation_compressed", "ranks": world,
          "backend": "gloo (one card)", "shape": list(shape),
          "steps": steps, "bit_equal_across_ranks": True,
          "decompress_then_mean_rel_err": r0["decompress_then_mean_rel_err"],
          "error_feedback_err": r0["error_feedback_err"],
          "one_step_quant_err": r0["one_step_quant_err"],
          "wire_bytes_a_rank": wire, "f32_bytes": math.prod(shape) * 4,
          "ratio": ratio, "collectives": r0["collectives"],
          "step_ms_rank0": r0["psum_ms"],
          "seconds": time.perf_counter() - t0})
    emit({"phase": "grad_aggregation_plan", "arch": "gemma-2b-reduced",
          "shape": "train_4k", "mesh": {"data": 2, "model": 2},
          "fallbacks": r0["plan_fallbacks"], "tensors": r0["plan_tensors"],
          "ranks": [{"rank": r["rank"], "coordinate": r["coordinate"],
                     "bytes": r["plan_bytes_local"],
                     "plan_bytes": r["plan_bytes"]} for r in ranks]})

    # compressed_psum over (a)'s decoded f32 tree, NCCL world of one
    rdv = ROOT / "build" / f"grad-nccl-{os.getpid()}"
    rdv.unlink(missing_ok=True)
    dist.init_process_group("nccl", init_method=f"file://{rdv}", rank=0,
                            world_size=1)
    try:
        def psum_tree():
            res = {k: init_residual(v) for k, v in last.items()}
            for k, v in last.items():
                _, res[k] = compressed_psum(v, res[k])
            return res

        (_, counts) = counted(psum_tree)
        if counts:
            fail(f"grad_aggregation: compressed_psum launched {counts}")
        tree_ms = [timed(psum_tree)[1] for _ in range(3)]
    finally:
        dist.destroy_process_group()
        rdv.unlink(missing_ok=True)
    nbl = sum(-(-v.numel() // 256) for v in last.values())
    tree_bytes = 3 * n_el * 4 + nbl * 256 + nbl * 4
    emit({"phase": "grad_aggregation_psum_tree", "backend": "nccl, world 1",
          "elements": n_el, "leaves": len(last),
          "ms": sorted(tree_ms)[1], "ms_calls": tree_ms,
          "bound_ms": tree_bytes / PEAK_BYTES_S * 1e3,
          "bound_by": "bytes", "collectives_last_leaf":
          compression.last_collectives})
    del last
    torch.cuda.empty_cache()
    emit({"phase": "grad_aggregation_done",
          "seconds": time.perf_counter() - t_phase})
    print(nvidia_smi(), flush=True)


SPECTRAL_CELL = ((4, 2048, 1024), 2048, (4096, 4, 6))
SPECTRAL_MASK = (True, False, True, True, False, True)


def spectral_coded(torch, np, rng, counted, spin_rate) -> None:
    """The coded spectral mixer (``models/spectral.py``) at (B, S, D) =
    (4, 2048, 1024) with 2048-tap filters: its 4096 rows of 4096
    complex64 points through ``CodedFFT(s=4096, m=4, n_workers=6)`` with
    workers 1 and 4 down -- one ``cmatmul`` encode, one
    ``fourstep_fused`` pass over the 24,576 coded rows of L = 1024, one
    ``cmatmul`` decode (run with an empty autotune table, so L = 1024
    routes to ``fourstep_fused``).  Its launches must be exactly those,
    with no ``torch.fft`` call inside the plan (the filter's transforms
    and the inverse are ``torch.fft``, as in the reference).

    Checks: coded against the plain mixer (``torch.fft.rfft``) within
    max-abs 1e-3, the example's bound; the gradient of ``mean(y**2)``
    with respect to the filter ``h`` through both within max-abs 1e-4;
    the gradient with respect to ``x`` (the plan run again on the
    conjugated gradient) within 1e-4 of the plain mixer's largest entry,
    its backward exactly ``cmatmul`` 2 and ``fourstep_fused`` 1 and no
    ``torch.fft`` inside the plan.  Prints the ms of the coded and plain
    mixers and of the x gradient's backward, medians of 7 windows (CUDA
    events), and one profiled coded call (busy, idle, the largest
    kernels)."""
    from repro_torch.core import CodedFFT
    from repro_torch.kernels import ops
    from repro_torch.models import spectral

    (b, s, d), taps, (n, m, workers) = SPECTRAL_CELL
    dev = torch.device("cuda")
    p = spectral.decaying_filter_init(torch.Generator(device=dev).manual_seed(0),
                                      d, taps, device=dev)
    x = torch.as_tensor(rng.standard_normal((b, s, d)).astype(np.float32),
                        device=dev)
    plan = CodedFFT(s=n, m=m, n_workers=workers)
    route = ops.fourstep_route(plan.shard_len, device=dev)
    if (plan.device.type != "cuda" or plan.resolved_backend != "kernel"
            or route[0] != "fused"):
        fail(f"spectral plan on {plan.device}, {plan.resolved_backend}, "
             f"worker route {route}")
    mask = torch.tensor(SPECTRAL_MASK, device=dev)
    real_run, fft_calls = spectral._run_rows, []

    def run_rows(*args):
        with _TorchFftCalls(torch) as calls:
            out = real_run(*args)
        fft_calls.append(calls.calls)
        return out

    coded = lambda pp: spectral.spectral_apply_coded(pp, x, plan, mask=mask)
    plain = lambda pp: spectral.spectral_apply(pp, x)

    def grad_h(mixer):
        pp = {k: v.clone().requires_grad_() for k, v in p.items()}
        return torch.autograd.grad((mixer(pp) ** 2).mean(), pp["h"])[0]

    spectral._run_rows = run_rows
    try:
        y, counts = counted(lambda: coded(p))
        g_coded, grad_counts = counted(lambda: grad_h(coded))
    finally:
        spectral._run_rows = real_run
    expect = {"cmatmul": 2, "fourstep_fused": 1}
    if counts != expect or grad_counts != expect or any(fft_calls):
        fail(f"spectral_coded: launches {counts} (forward), {grad_counts} "
             f"(gradient), torch.fft calls inside the plan {fft_calls}; "
             f"expected {expect} and none")
    y_plain, g_plain = plain(p), grad_h(plain)
    torch.cuda.synchronize()
    err = float((y - y_plain).abs().max())
    gerr = float((g_coded - g_plain).abs().max())
    if not (err < 1e-3 and gerr < 1e-4):
        fail(f"spectral_coded: coded vs plain {err} (< 1e-3), filter "
             f"gradient {gerr} (< 1e-4)")

    # the gradient with respect to x: the plan once more, on conj(g)
    xg = x.clone().requires_grad_()
    loss_x = (spectral.spectral_apply_coded(p, xg, plan, mask=mask)
              ** 2).mean()
    back = lambda: torch.autograd.grad(loss_x, xg, retain_graph=True)[0]
    fft_calls.clear()
    spectral._run_rows = run_rows
    try:
        gx, back_counts = counted(back)
    finally:
        spectral._run_rows = real_run
    xp = x.clone().requires_grad_()
    gx_plain = torch.autograd.grad((spectral.spectral_apply(p, xp) ** 2)
                                   .mean(), xp)[0]
    torch.cuda.synchronize()
    xerr = float((gx - gx_plain).abs().max() / gx_plain.abs().max())
    if back_counts != expect or fft_calls != [0] or not xerr < 1e-4:
        fail(f"spectral_coded: x gradient launches {back_counts}, torch.fft "
             f"calls inside the plan {fft_calls}, against the plain "
             f"mixer's {xerr} (< 1e-4 of its largest entry)")

    def windows(fn):
        ts = sorted(time_ms(torch, fn, 5, spin_rate) for _ in range(7))
        return {"ms": ts[3], "ms_min": ts[0], "ms_max": ts[-1]}

    emit({"phase": "spectral_coded", "batch": b, "seq": s, "d_model": d,
          "filter_taps": taps, "plan": {"s": n, "m": m, "n_workers": workers},
          "mask": list(SPECTRAL_MASK), "rows": b * d,
          "worker_rows": b * d * workers, "worker_route": [route[0],
                                                           list(route[1])],
          "launches": counts, "gradient_launches": grad_counts,
          "torch_fft_calls_in_plan": sum(fft_calls),
          "coded_vs_plain_max_abs": err, "coded_vs_plain_tol": 1e-3,
          "filter_grad_max_abs": gerr, "filter_grad_tol": 1e-4,
          "input_grad_launches": back_counts,
          "input_grad_max_abs_rel": xerr, "input_grad_tol": 1e-4,
          "input_grad_backward": windows(back),
          "coded": windows(lambda: coded(p)),
          "plain": windows(lambda: plain(p)),
          "profiled_coded": profile_call(torch, lambda: coded(p),
                                         track=FFT_KERNELS),
          "nvidia_smi": nvidia_smi()})
    del x, y, y_plain, g_coded, g_plain, p, xg, loss_x, gx, gx_plain
    torch.cuda.empty_cache()


class _TorchFftCalls:
    """Counts calls of the ``torch.fft`` transforms while active: a
    complex64 kernel-backend path must make none."""

    NAMES = ("fft", "ifft", "fftn", "ifftn", "rfft", "irfft", "rfftn",
             "irfftn", "fft2", "ifft2")

    def __init__(self, torch):
        self.mod, self.calls, self.saved = torch.fft, 0, {}

    def __enter__(self):
        for name in self.NAMES:
            real = self.saved[name] = getattr(self.mod, name)

            def counting(*args, _real=real, **kw):
                self.calls += 1
                return _real(*args, **kw)

            setattr(self.mod, name, counting)
        return self

    def __exit__(self, *exc):
        for name, real in self.saved.items():
            setattr(self.mod, name, real)
        return False


def nd_transforms(torch, np, rng, dev, counted, service_masks) -> None:
    """The n-D main paths on the card: ``FFTService.submit_batch`` with
    kind rfftn then irfftn (m = 4, N = 8: 16 real 2048 x 2048 fields,
    factors (4, 1) from ``plan_factors``, each worker's packed shard
    (512, 1024) complex64), ``CodedFFTND.run`` on a 256^3 complex64
    volume (m = 8 as (2, 2, 2), N = 12: one mask, then a batch of two
    with per-request masks), ``CodedFFTMultiInput.run`` (q = 8 fields of
    512 x 512, m_tilde = 2, factors (2, 1), N = 8), and the n-D sweep
    ``ops.make_kernel_fftn_fn`` at shard axes of 1, 2, 3 and 6 points held
    against its plain twin (the same sweep on ``fourstep_body``, the
    fused kernel's plain version, on the card) at 1e-5.

    Each phase: the launches of one call (exactly ``cmatmul`` and
    ``fourstep_fused``, and no ``torch.fft`` call), the output against
    ``numpy.fft`` in float64 (max-abs error over the largest magnitude
    under 1e-3), ms per call over three steady calls (host wall clock,
    the result's copy to the host included), and one traced call's busy
    ms and idle share (``profile_call``)."""
    from repro_torch import FFTService, FFTServiceConfig
    from repro_torch.core import CodedFFTMultiInput, CodedFFTND, plan_factors
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.fourstep_fft import fourstep_body

    tol = 1e-3

    def rel64(got, want) -> float:
        got = np.asarray(got)
        if got.shape != want.shape or not np.isfinite(got).all():
            return math.inf
        return float(np.abs(got - want).max() / np.abs(want).max())

    def phase(name, run, want, expect, **info):
        """One counted call of ``run`` (its launches exactly ``expect``,
        no ``torch.fft``), its error against ``want`` (float64, numpy),
        three steady calls and one traced call."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with _TorchFftCalls(torch) as calls:
            out, counts = counted(lambda: to_host(run()))
        first = time.perf_counter() - t0
        if counts != expect or calls.calls:
            fail(f"{name}: launches {counts} and {calls.calls} torch.fft "
                 f"calls, expected {expect} and none")
        err = rel64(out, want)
        if not err < tol:
            fail(f"{name}: max-abs err / max |want| {err} >= {tol}")
        del out
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(3):
            to_host(run())
        ms = (time.perf_counter() - t1) / 3 * 1e3
        trace = profile_call(torch, lambda: to_host(run()),
                             track=FFT_KERNELS)
        emit({"phase": name, "launches": counts, "torch_fft_calls": 0,
              "rel_err": err, "rel_tol": tol, "first_call_s": first,
              "ms_per_call": ms, "profiled_call": trace, **info})
        torch.cuda.empty_cache()

    def to_host(out):
        if isinstance(out, list):
            return np.stack(out)
        return out.cpu().numpy()

    # (a) the service's n-D kinds: 16 real 2048 x 2048 fields (16 MiB
    # each); rfftn, then irfftn on their spectra
    shape, q = (2048, 2048), 16
    cfg = FFTServiceConfig(m=4, n_workers=8, autotune=False)
    svc = FFTService(cfg)
    factors = plan_factors(shape, cfg.m, even_last_shard=True)
    fields = rng.standard_normal((q,) + shape).astype(np.float32)
    want = np.fft.rfftn(fields.astype(np.float64), axes=(1, 2))
    plan = svc._plan_for(shape, "rfftn")
    info = {"kind": "rfftn", "shape": list(shape), "requests": q,
            "m": cfg.m, "n_workers": cfg.n_workers,
            "factors": list(factors),
            "worker_shard": list(plan.worker_shard_shape),
            "coded_mib_per_call": q * cfg.n_workers * 8
            * math.prod(plan.worker_shard_shape) / 2**20}
    reqs = list(fields)
    phase("service_rfftn", lambda: svc.submit_batch(reqs, kind="rfftn"),
          want, {"cmatmul": 1, "fourstep_fused": 2}, **info)
    spectra = [y.astype(np.complex64) for y in want]
    del want
    want = np.fft.irfftn(np.stack(spectra).astype(np.complex128), s=shape,
                         axes=(1, 2))
    phase("service_irfftn",
          lambda: svc.submit_batch(spectra, kind="irfftn"), want,
          {"cmatmul": 1, "fourstep_fused": 2},
          **{**info, "kind": "irfftn"})
    del fields, spectra, want, svc, reqs

    # (b) CodedFFTND on a 256^3 complex64 volume (128 MiB), m = 8, N = 12
    shape, factors, n = (256, 256, 256), (2, 2, 2), 12
    plan = CodedFFTND(shape=shape, factors=factors, n_workers=n)
    if plan.device.type != "cuda" or plan.resolved_backend != "kernel":
        fail(f"CodedFFTND on {plan.device}, {plan.resolved_backend}")
    x = (rng.standard_normal((2,) + shape)
         + 1j * rng.standard_normal((2,) + shape)).astype(np.complex64)
    want = np.fft.fftn(x.astype(np.complex128), axes=(1, 2, 3))
    xt = torch.as_tensor(x, device=dev)
    masks = service_masks(2, n, plan.m)
    info = {"shape": list(shape), "factors": list(factors), "m": plan.m,
            "n_workers": n, "worker_shard": list(plan.worker_shard_shape)}
    phase("plan_fftn", lambda: plan.run(xt[0], mask=masks[0]), want[0],
          {"cmatmul": 2, "fourstep_fused": 3}, requests=1,
          decode="one mask: subset_decode_matrix then cmatmul", **info)
    phase("plan_fftn", lambda: plan.run(xt, mask=masks), want,
          {"cmatmul": 1, "fourstep_fused": 3}, requests=2,
          decode="per-request masks: torch.linalg.solve", **info)
    del x, xt, want

    # (c) CodedFFTMultiInput: q = 8 fields of 512 x 512
    qn, shape = 8, (512, 512)
    plan = CodedFFTMultiInput(q=qn, shape=shape, m_tilde=2, factors=(2, 1),
                              n_workers=8)
    x = (rng.standard_normal((qn,) + shape)
         + 1j * rng.standard_normal((qn,) + shape)).astype(np.complex64)
    want = np.fft.fftn(x.astype(np.complex128), axes=(1, 2))
    xt = torch.as_tensor(x, device=dev)
    mask = service_masks(1, 8, plan.m)[0]
    phase("plan_multi_input", lambda: plan.run(xt, mask=mask), want,
          {"cmatmul": 2, "fourstep_fused": 2}, q=qn, shape=list(shape),
          m_tilde=2, factors=[2, 1], m=plan.m, n_workers=8,
          worker_shard=list(plan.worker_shard_shape))
    del x, xt, want

    # (d) the n-D sweep at shard axes of 1, 2, 3 and 6 points: 64 requests
    # of N = 8 packed shards of rfftn (8, 4, 4) / (2, 1, 2), (16, 4) /
    # (4, 1), (12, 6) / (2, 3), c2c shards of (12, 12) / (2, 2) and
    # (6, 6) / (2, 2), and every length at once
    def sweep_plain(a, nd):
        for ax in range(a.ndim - nd, a.ndim):
            moved = a.movedim(ax, -1).contiguous()
            lead, ell = tuple(moved.shape[:-1]), moved.shape[-1]
            fa, fb = ops.split_factor(ell)
            xr, xi = ref.planar(moved.reshape(-1, fa, fb))
            outr, outi = fourstep_body(xr, xi,
                                       *ops._fourstep_planes(fa, fb, dev))
            a = ref.unplanar(outr.transpose(-1, -2), outi.transpose(-1, -2)
                             ).reshape(lead + (ell,)).movedim(-1, ax)
        return a

    for shape in ((64, 8, 4, 4, 1), (64, 8, 4, 2), (64, 8, 6, 1),
                  (64, 8, 6, 6), (64, 8, 3, 3), (64, 1, 2, 3, 6)):
        nd = len(shape) - 2
        routes = [ops.fourstep_route(ell, device=dev) for ell in shape[2:]]
        if any(v != "fused" for v, _ in routes):
            fail(f"ndim_axis_lengths {shape}: routes {routes}")
        a = (rng.standard_normal(shape)
             + 1j * rng.standard_normal(shape)).astype(np.complex64)
        at = torch.as_tensor(a, device=dev)
        sweep = ops.make_kernel_fftn_fn(nd)
        got = sweep(at)
        plain = sweep_plain(at, nd)
        torch.cuda.synchronize()
        twin = float((got - plain).abs().max() / plain.abs().max())
        if not twin < 1e-5:
            fail(f"ndim_axis_lengths {shape}: kernel vs plain {twin}")
        phase("ndim_axis_lengths", lambda: sweep(at),
              np.fft.fftn(a.astype(np.complex128),
                          axes=tuple(range(2, 2 + nd))),
              {"fourstep_fused": nd}, shape=list(shape),
              routes=[[v, list(f)] for v, f in routes],
              kernel_vs_plain=twin, kernel_vs_plain_tol=1e-5)


def fault_runtime(torch, np, rng, counted) -> None:
    """The fault runtime and the open-loop front-end on the card, five
    phases (m = 4, N = 8, services with ``autotune=False`` like every
    phase before the tuned path):

    * ``service_faults`` -- ``health=True`` and ``FaultPlan(seed=0)
      .kill(2, rounds=3).delay(5, 0.4, rounds=8)``: 64 c2c requests at
      s=4096 (exactly one ``coded_fft_bucket_masked`` launch, fed the
      deadline masks), 16 at 2^20 (the masked streaming bucket's four),
      then one r2c and one c2r bucket of 64 at s=4096 (their masked
      whole-bucket kernels);
    * ``service_verify`` -- 64 c2c requests at s=4096, complex64, every
      worker arriving: ``verify="correct"`` with two corrupt workers (the
      ``cmatmul`` encode, one ``fourstep_fused``, a ``cmatmul`` decode a
      request), with three (every request the typed
      ``corrupt_uncorrectable``), ``verify="detect"`` with two, and on
      clean rounds (its false detections, and the largest clean-round
      syndrome against ``detect_errors``' 1e-6);
    * ``service_elastic`` -- an ``ElasticWorkerPool``: all live, a
      leave, then a refill and a join that grows N from 8 to 9 (the
      bucket kernel on the grown generator);
    * ``measured_runtime`` -- ``measured=True`` with one killed worker
      (rows on the card: ``cmatmul`` and ``fourstep_fused`` on each
      worker's stream), ``t_met`` and ``t_last`` of the call; then
      ``require_all=True`` (``retries_exhausted``) and a pool with 3 live
      (``insufficient_workers``);
    * ``streaming_open_loop`` -- ``StreamingFFTService`` over the warmed
      s=2048, max_batch=32 service as the reference's open-loop bench
      sets it up: Poisson arrivals at 500, 1000 and 2000 req/s, 600
      each, ``slack_s=5e-3``, the streaming mode and the naive baseline;
      then a mixed-tier run at 1000 req/s (interactive 2 ms, standard
      5 ms, batch 50 ms).

    Every served result is held to complex128 ``numpy.fft`` at the
    reference's limits (3e-4 on buckets, 1e-3 at 2^20); every call's
    launches are checked (no ``torch.fft`` call); each line prints the
    call's ms (three steady calls, host wall clock) and one traced
    call's device busy and idle (``profile_call``)."""
    from repro_torch import FFTService, FFTServiceConfig, ServiceStats
    from repro_torch.core import mds
    from repro_torch.core.fault_tolerance import syndromes
    from repro_torch.distributed import (
        ElasticWorkerPool,
        FaultPlan,
        StragglerModel,
    )
    from repro_torch.serving import (
        AdmissionError,
        DegradedResult,
        StreamConfig,
        StreamingFFTService,
    )

    fields = ("requests", "retries", "redispatched_shards", "degraded",
              "detected", "corrected", "coded_latency", "uncoded_latency",
              "stragglers_tolerated")

    def make(kind, q, s):
        """``q`` requests of ``kind`` and their float64 truths."""
        if kind == "r2c":
            x = rng.standard_normal((q, s)).astype(np.float32)
            return list(x), np.fft.rfft(x.astype(np.float64), axis=-1)
        if kind == "c2r":
            y = np.fft.rfft(rng.standard_normal((q, s)), axis=-1)
            y = y.astype(np.complex64)
            return list(y), np.fft.irfft(y.astype(np.complex128), n=s,
                                         axis=-1)
        x = (rng.standard_normal((q, s))
             + 1j * rng.standard_normal((q, s))).astype(np.complex64)
        return list(x), np.fft.fft(x.astype(np.complex128), axis=-1)

    def cfg(**kw):
        base = dict(s=4096, m=4, n_workers=8, autotune=False)
        base.update(kw)
        return FFTServiceConfig(**base)

    def drive(phase, svc, kind, reqs, want, tol, expect, *, match="exact",
              degraded=None, **info):
        """One counted ``submit_batch`` (its launches ``expect`` exactly,
        or by ``match="keys"`` its kernels, ``"subset"`` within them; no
        ``torch.fft``); ``degraded``: None (every row served), a reason
        (every row that reason) or ``"any"``.  Served rows within ``tol``
        of ``want``; then three steady calls and one traced call."""
        before = {f: getattr(svc.stats, f) for f in fields}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with _TorchFftCalls(torch) as calls:
            out, counts = counted(lambda: svc.submit_batch(reqs, kind=kind))
        first = time.perf_counter() - t0
        delta = {f: getattr(svc.stats, f) - before[f] for f in fields}
        launch_ok = {"exact": counts == expect,
                     "keys": set(counts) == set(expect),
                     "subset": set(counts) <= set(expect)}[match]
        if calls.calls or not launch_ok:
            fail(f"{phase} {info}: launches {counts} ({match} {expect}), "
                 f"{calls.calls} torch.fft calls")
        bad = [i for i, y in enumerate(out) if isinstance(y, DegradedResult)]
        reasons = sorted({out[i].reason for i in bad})
        if degraded is None and bad:
            fail(f"{phase} {info}: {len(bad)} degraded rows {reasons}")
        if degraded not in (None, "any") and (len(bad) != len(out)
                                              or reasons != [degraded]):
            fail(f"{phase} {info}: degraded {len(bad)}/{len(out)} "
                 f"{reasons}, expected every row {degraded}")
        err = 0.0
        for i, y in enumerate(out):
            if i in bad:
                continue
            y = np.asarray(y)
            if y.shape != want[i].shape or not np.isfinite(y).all():
                fail(f"{phase} {info}: row {i} {y.shape} not finite or "
                     f"not {want[i].shape}")
            err = max(err, float(np.abs(y - want[i]).max()
                                 / np.abs(want[i]).max()))
        if not err < tol:
            fail(f"{phase} {info}: max-abs err / max |want| {err} >= {tol}")
        t1 = time.perf_counter()
        for _ in range(3):
            svc.submit_batch(reqs, kind=kind)
        ms = (time.perf_counter() - t1) / 3 * 1e3
        trace = profile_call(torch, lambda: svc.submit_batch(reqs, kind=kind),
                             track=FFT_KERNELS)
        line = {"phase": phase, **info, "kind": kind,
                "requests": len(reqs), "launches": counts,
                "torch_fft_calls": 0, "rel_err": err, "rel_tol": tol,
                "served": len(out) - len(bad), "degraded_rows": len(bad),
                "reasons": reasons, "call_stats": delta,
                "first_call_s": first, "ms_per_call": ms,
                "profiled_call": trace}
        emit(line)
        torch.cuda.empty_cache()
        return line

    # -- service_faults: deadline masks on the masked bucket kernels -----
    plan = FaultPlan(seed=0).kill(2, rounds=3).delay(5, 0.4, rounds=8)
    svc = FFTService(cfg(health=True, faults=plan, on_failure="degrade"))
    svc.warmup(lengths=[4096], kinds=("c2c", "r2c", "c2r"), buckets=[64])
    svc.warmup(lengths=[1 << 20], buckets=[16])
    info = {"faults": "kill(2, rounds=3).delay(5, 0.4, rounds=8)",
            "health": True}
    reqs, want = make("c2c", 64, 4096)
    drive("service_faults", svc, "c2c", reqs, want, 3e-4,
          {"coded_fft_bucket_masked": 1}, degraded="any", s=4096, **info)
    reqs, want = make("c2c", 16, 1 << 20)
    drive("service_faults", svc, "c2c", reqs, want, 1e-3,
          {"coded_fft_bucket_streaming_masked": 4}, degraded="any",
          s=1 << 20, **info)
    del reqs, want
    for kind, kernel in (("r2c", "coded_rfft_bucket_masked"),
                         ("c2r", "coded_irfft_bucket_masked")):
        reqs, want = make(kind, 64, 4096)
        drive("service_faults", svc, kind, reqs, want, 3e-4, {kernel: 1},
              degraded="any", s=4096, **info)
    emit({"phase": "service_faults_health", "rounds": svc._round,
          "health": svc.health.summary(),
          "stats": {f: getattr(svc.stats, f) for f in fields}})

    # -- service_verify: the kernel-backend plan and the syndromes ------
    tight = StragglerModel(t0=1.0, mu=1e6)       # every worker arrives
    two = FaultPlan(seed=1).corrupt(1, rounds=999).corrupt(6, rounds=999)
    three = (FaultPlan(seed=2).corrupt(1, rounds=999).corrupt(4, rounds=999)
             .corrupt(6, rounds=999))
    reqs, want = make("c2c", 64, 4096)
    served = {"cmatmul": 1 + len(reqs), "fourstep_fused": 1}
    refused = {"cmatmul": 1, "fourstep_fused": 1}
    for case, faults, verify, expect, degraded in (
            ("correct, 2 corrupt", two, "correct", served, None),
            ("correct, 3 corrupt", three, "correct", refused,
             "corrupt_uncorrectable"),
            ("detect, 2 corrupt", two, "detect", refused,
             "corrupt_uncorrectable"),
            ("detect, clean", None, "detect", served, "any")):
        svc = FFTService(cfg(straggler=tight, faults=faults, verify=verify,
                             on_failure="degrade"))
        extra = {}
        if faults is None:
            # the largest clean-round syndrome of the card's rows, over
            # the largest row, against detect_errors' 1e-6
            kplan = svc._instrumented_plan(4096, "c2c")
            b = kplan.worker_compute(kplan.encode(torch.as_tensor(
                np.stack(reqs), device="cuda"))).cpu().numpy()
            nodes = mds.rs_nodes(8, torch.complex128).numpy()
            extra["clean_syndrome_max"] = max(
                float(np.abs(syndromes(nodes, r.astype(np.complex128), 4))
                      .max() / max(np.abs(r).max(), 1.0))
                for r in b.reshape(len(reqs), 8, -1))
            extra["syndrome_tol"] = 1e-6
        line = drive("service_verify", svc, "c2c", reqs, want, 3e-4, expect,
                     degraded=degraded, case=case, verify=verify,
                     dtype="complex64", s=4096, **extra)
        if faults is None:
            line_fd = line["call_stats"]["detected"]
            emit({"phase": "service_verify_clean", "false_detections":
                  line_fd, "of_requests": len(reqs), **extra})

    # -- service_elastic: a leave, then a growth to N = 9 ---------------
    pool = ElasticWorkerPool(8, 4)
    svc = FFTService(cfg(), pool=pool)
    drive("service_elastic", svc, "c2c", reqs, want, 3e-4,
          {"coded_fft_bucket_masked": 1}, step="all live", n_workers=8,
          s=4096)
    pool.leave(3)
    drive("service_elastic", svc, "c2c", reqs, want, 3e-4,
          {"coded_fft_bucket_masked": 1}, step="leave 3", n_workers=8,
          s=4096)
    pool.join()                                  # refills slot 3
    grown = pool.join()                          # a new slot: N = 9
    gr, gi = svc.generator_planes()
    g9 = mds.rs_generator(9, 4, torch.complex64, gr.device)
    if (grown != 8 or svc._n_workers() != 9 or tuple(gr.shape) != (9, 4)
            or not torch.equal(gr, g9.real) or not torch.equal(gi, g9.imag)):
        fail(f"service_elastic: slot {grown}, N {svc._n_workers()}, "
             f"planes {tuple(gr.shape)}")
    drive("service_elastic", svc, "c2c", reqs, want, 3e-4,
          {"coded_fft_bucket_masked": 1}, step="join: N=9", n_workers=9,
          s=4096, pool=pool.summary())

    # -- measured_runtime: rows from the card on per-worker streams -----
    reqs, want = make("c2c", 16, 4096)
    svc = FFTService(cfg(measured=True, max_retries=6, on_failure="degrade",
                         faults=FaultPlan().kill(3, rounds=999)))
    for _ in range(2):                           # warm: learn the times
        svc.submit_batch(reqs)
    line = drive("measured_runtime", svc, "c2c", reqs, want, 3e-4,
                 {"cmatmul": 0, "fourstep_fused": 0}, match="keys",
                 case="coded, worker 3 killed", max_retries=6, s=4096)
    n = line["requests"]
    emit({"phase": "measured_runtime_times",
          "t_met_ms": line["call_stats"]["coded_latency"] / n * 1e3,
          "t_last_ms": line["call_stats"]["uncoded_latency"] / n * 1e3,
          "health_ewma_ms": [None if v is None else v * 1e3
                             for v in svc.health.summary()["ewma_s"]],
          "min_deadline_ms": 2.0})
    svc.close(wait=True)
    svc = FFTService(cfg(measured=True, require_all=True, max_retries=0,
                         on_failure="degrade",
                         faults=FaultPlan().kill(3, rounds=999)))
    drive("measured_runtime", svc, "c2c", reqs, want, 3e-4,
          {"cmatmul": 0, "fourstep_fused": 0}, match="subset",
          degraded="retries_exhausted", case="require_all, worker 3 killed",
          s=4096)
    svc.close(wait=True)
    pool = ElasticWorkerPool(8, 4)
    for w in range(5):
        pool.leave(w)
    svc = FFTService(cfg(measured=True, on_failure="degrade"), pool=pool)
    drive("measured_runtime", svc, "c2c", reqs, want, 3e-4,
          {"cmatmul": 0, "fourstep_fused": 0}, match="subset",
          degraded="insufficient_workers", case="3 live of 8", s=4096)
    svc.close(wait=True)
    del reqs, want

    # -- streaming_open_loop: Poisson arrivals, both modes --------------
    svc = FFTService(FFTServiceConfig(
        s=2048, m=4, n_workers=8, straggler=StragglerModel(t0=1.0, mu=1.0),
        seed=0, max_batch=32, autotune=False))
    svc.warmup()
    pool_x, pool_want = make("c2c", 32, 2048)

    def open_loop(scfg, rate, n_per, tiers=None):
        """Poisson arrivals at ``rate`` req/s; ``rate=None``: a burst, all
        ``n_per`` submitted back to back with no sleeps."""
        svc.stats = ServiceStats()               # a fresh window per drive
        stream = StreamingFFTService(svc, scfg)
        arrivals = (np.zeros(n_per) if rate is None else
                    np.cumsum(rng.exponential(1.0 / rate, size=n_per)))
        names = list(tiers or ())
        pick = (rng.integers(len(names), size=n_per) if names
                else np.zeros(n_per, int))
        futs, rejected = [], 0
        t0 = time.perf_counter()
        for i, t_arr in enumerate(arrivals):
            lag = t_arr - (time.perf_counter() - t0)
            if lag > 0:
                time.sleep(lag)
            tier = names[pick[i]] if names else None
            try:
                futs.append((i, tier, stream.submit(pool_x[i % 32],
                                                    tier=tier)))
            except AdmissionError:
                rejected += 1
        stream.drain()
        stream.close()
        wall = time.perf_counter() - t0
        worst = 0.0
        for i, _, f in futs:
            w = pool_want[i % 32]
            worst = max(worst, float(np.abs(f.result() - w).max()
                                     / np.abs(w).max()))
        st = svc.stats.summary()
        if (len(futs) + rejected != n_per
                or st["host_transfers"] != st["batches"]
                or st["latency"]["count"] != len(futs)):
            fail(f"streaming_open_loop {rate} req/s: {len(futs)} + "
                 f"{rejected} of {n_per}, {st['host_transfers']} fetches "
                 f"for {st['batches']} buckets")
        if not worst < 3e-4:
            fail(f"streaming_open_loop {rate} req/s: err {worst} >= 3e-4")
        lats = np.asarray([f.latency_s for _, _, f in futs]) * 1e3
        row = {"offered_rps": rate, "n_offered": n_per,
               "completed": len(futs), "rejected": rejected,
               "wall_s": wall, "p50_ms": float(np.percentile(lats, 50)),
               "p99_ms": float(np.percentile(lats, 99)),
               "mean_ms": float(lats.mean()), "max_rel_err": worst,
               "buckets": st["batches"],
               "fill_dispatches": st["fill_dispatches"],
               "deadline_dispatches": st["deadline_dispatches"],
               "drain_dispatches": st["drain_dispatches"],
               "queue_peak": st["queue_peak"],
               "staging_overlap_s": st["staging_overlap_s"],
               "dispatch_s": st["dispatch_s"], "sync_s": st["sync_s"]}
        if names:
            for name in names:
                mine = np.asarray([f.latency_s for _, t, f in futs
                                   if t == name]) * 1e3
                row.setdefault("tiers", {})[name] = {
                    "count": int(mine.size),
                    "p50_ms": float(np.percentile(mine, 50)),
                    "p99_ms": float(np.percentile(mine, 99)),
                    "histogram": st["tiers"].get(name)}
        return row

    def counted_loop(scfg, rate, n_per, tiers=None):
        with _TorchFftCalls(torch) as calls:
            row, counts = counted(lambda: open_loop(scfg, rate, n_per,
                                                    tiers))
        if calls.calls or counts != {"coded_fft_bucket_masked":
                                     row["buckets"]}:
            fail(f"streaming_open_loop {rate} req/s: launches {counts}, "
                 f"{calls.calls} torch.fft calls, {row['buckets']} buckets")
        row["launches"] = counts
        return row

    slack = 5e-3
    modes = {"streaming": StreamConfig(slack_s=slack),
             "naive": StreamConfig(slack_s=slack, fill_only=True,
                                   pipelined=False)}
    for mode, scfg in modes.items():
        curve = [counted_loop(scfg, rate, 600) for rate in (500, 1000, 2000)]
        burst = {}
        if mode == "streaming":
            # the overlap gate: at these Poisson rates a bucket in flight
            # while the next stages is timing luck (the curve's sums read
            # 0.0 s in one run), so the gate reads a burst of 8 full
            # buckets submitted back to back, which must overlap
            burst = counted_loop(scfg, None, 8 * 32)
            if not burst["staging_overlap_s"] > 0.0:
                fail(f"streaming_open_loop: no staging overlap in a burst "
                     f"of 8 x 32 {burst}")
        trace = profile_call(torch, lambda: open_loop(scfg, 1000, 600))
        emit({"phase": "streaming_open_loop", "mode": mode, "s": 2048,
              "m": 4, "n_workers": 8, "max_batch": 32,
              "slack_ms": slack * 1e3, "curve": curve,
              "curve_staging_overlap_s": sum(r["staging_overlap_s"]
                                             for r in curve),
              **({"burst_8x32": burst} if burst else {}),
              "profiled_run_1000_rps": trace})
    tiers = {"interactive": 0.002, "standard": 0.005, "batch": 0.050}
    scfg = StreamConfig(slack_s=slack, tiers=tiers)
    row = counted_loop(scfg, 1000, 600, tiers)
    trace = profile_call(torch, lambda: open_loop(scfg, 1000, 600, tiers))
    emit({"phase": "streaming_open_loop", "mode": "streaming, mixed tiers",
          "tiers_ms": {k: v * 1e3 for k, v in tiers.items()}, **row,
          "profiled_run": trace})
    torch.cuda.empty_cache()


def strategy_zoo(torch, np, rng, dev, counted) -> None:
    """The strategy zoo on the card (m = 4, N = 8 unless named; services
    with ``autotune=False``, the autotune table still empty):

    * ``race`` -- the reference's strategy race
      (``benchmarks/bench_comm_load.py`` ``_service_race``: s=4096, N=8,
      m=2, mu=4, ``wire_frac`` 0.8 and 0.0, 30 rounds of 8 requests,
      seed 0, ``use_reference=True``) for mds, partial and
      comm_efficient: mean coverage, max relative error (< 5e-4) and
      stragglers tolerated; the folded payload must win at 0.8 and lose
      at 0.0, and partial's coverage never trail mds's;
    * ``service`` -- ``strategy="partial"`` (r=2) and
      ``"comm_efficient"`` (q=2) at s=4096 (64 requests) and s=2^20 (16):
      the reference's route (``plan.run`` on ``torch.fft`` and the batched
      solve), so no hand-written kernel launches; ms a call, busy and
      idle, the error against complex128 ``numpy.fft`` (5e-4, 1e-3 at
      2^20) on the service's own draws;
    * ``plan`` -- ``CodedPartialFFT`` and ``CodedCommEffFFT`` on the
      kernel backend at s=4096 and 2^20, a batch of 16 with per-request
      masks (evenly spread finished fragments for partial, the other
      rows NaN), then one request: the worker on ``fourstep_fused`` at
      4096 and on the two-pass pair at 2^20, and the comm-efficient
      single request's decode on ``cmatmul``; each held against the same
      plan on the reference backend on the card and against
      ``numpy.fft``;
    * ``repetition`` -- ``UncodedRepetitionFFT`` (``torch.matmul`` of the
      dense blocks) at s=4096, m=4, N=16 (one replica a block:
      ``worst_case_threshold() == 16``, a straggler refuses) and m=2,
      N=16 with one straggler a block;
    * ``faults`` -- ``strategy="partial"``, ``health=True`` and a kill and
      a delay at s=4096: retries, re-dispatched shards, degraded rows and
      reasons;
    * ``direct`` -- ``ops.coded_bucket_direct``, ``coded_rbucket_direct``
      and ``coded_irbucket_direct`` at s=4096, q=64, m=4, N=8 against the
      kind's masked whole-bucket kernel on the same masks and against
      ``numpy.fft``.

    ``dev`` may be the CPU (a rehearsal at cut sizes from a scratch copy:
    the plain twins, no ``nvidia-smi`` and no profiler)."""
    from repro_torch import FFTService, FFTServiceConfig
    from repro_torch.core import (
        CodedCommEffFFT,
        CodedPartialFFT,
        UncodedRepetitionFFT,
        mds,
    )
    from repro_torch.distributed import FaultPlan, StragglerModel
    from repro_torch.kernels import ops
    from repro_torch.serving import DegradedResult

    sz = dict(s=4096, big=1 << 20, q=64, q_big=16, q_plan=16, rounds=30,
              batch=8)
    s, big = sz["s"], sz["big"]
    smi = nvidia_smi() if dev.type == "cuda" else "cpu"
    sync = (torch.cuda.synchronize if dev.type == "cuda"
            else (lambda *a: None))

    def crand(shape):
        return (rng.standard_normal(shape)
                + 1j * rng.standard_normal(shape)).astype(np.complex64)

    def rel(got, want) -> float:
        got = np.asarray(got)
        if got.shape != want.shape or not np.isfinite(got).all():
            return math.inf
        return float(np.abs(got - want).max() / np.abs(want).max())

    def host(out):
        return (np.stack(out) if isinstance(out, list)
                else out.cpu().numpy())

    def timed(name, run, want, tol, expect, after=None, **info):
        """One counted call (its launches exactly ``expect``), its error
        against ``want``, three steady calls, one traced call; ``after``:
        a dict of figures read just after the counted call."""
        sync()
        t0 = time.perf_counter()
        out, counts = counted(lambda: host(run()))
        first = time.perf_counter() - t0
        if counts != expect:
            fail(f"strategy_zoo {name} {info}: launches {counts}, expected "
                 f"{expect}")
        err = rel(out, want)
        if not err < tol:
            fail(f"strategy_zoo {name} {info}: max-abs err / max |want| "
                 f"{err} >= {tol}")
        if after is not None:
            info["first_call"] = after()
        sync()
        t1 = time.perf_counter()
        for _ in range(3):
            host(run())
        ms = (time.perf_counter() - t1) / 3 * 1e3
        trace = (profile_call(torch, lambda: host(run()), track=FFT_KERNELS)
                 if dev.type == "cuda" else None)
        line = {"phase": "strategy_zoo", "part": name, **info,
                "launches": counts, "rel_err": err, "rel_tol": tol,
                "first_call_s": first, "ms_per_call": ms,
                "profiled_call": trace, "nvidia_smi": smi}
        emit(line)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        return line

    # -- race: the reference's service race through strategy= ----------
    t0 = time.perf_counter()
    race_rng = np.random.default_rng(1)
    xs = [(race_rng.standard_normal((sz["batch"], s))
           + 1j * race_rng.standard_normal((sz["batch"], s)))
          .astype(np.complex64) for _ in range(sz["rounds"])]
    refs = [np.fft.fft(xb.astype(np.complex128), axis=-1) for xb in xs]
    points = []
    for wf in (0.8, 0.0):
        row = {"wire_frac": wf}
        for strategy in ("mds", "partial", "comm_efficient"):
            svc = FFTService(FFTServiceConfig(
                s=s, m=2, n_workers=8, strategy=strategy,
                use_reference=True, autotune=False, seed=0,
                straggler=StragglerModel(t0=1.0, mu=4.0, wire_frac=wf)),
                device=dev)

            def race():
                worst = 0.0
                for xb, want in zip(xs, refs):
                    got = np.stack(svc.submit_batch(list(xb)))
                    worst = max(worst, rel(got, want))
                return worst

            err, counts = counted(race)
            if counts or not err < 5e-4:
                fail(f"strategy_zoo race {strategy} wire_frac={wf}: err "
                     f"{err}, launches {counts}")
            row[strategy] = {
                "mean_latency": svc.stats.coded_latency / svc.stats.requests,
                "max_rel_err": err,
                "stragglers_tolerated": svc.stats.stragglers_tolerated,
                "requests": svc.stats.requests}
        points.append(row)
    hi, lo = points
    if not (hi["comm_efficient"]["mean_latency"] < hi["mds"]["mean_latency"]
            and lo["comm_efficient"]["mean_latency"]
            > lo["mds"]["mean_latency"]
            and all(r["partial"]["mean_latency"]
                    <= r["mds"]["mean_latency"] + 1e-12 for r in points)):
        fail(f"strategy_zoo race: the crossover does not hold: {points}")
    emit({"phase": "strategy_zoo", "part": "race", "s": s, "m": 2,
          "n_workers": 8, "mu": 4.0, "rounds": sz["rounds"],
          "batch": sz["batch"], "seed": 0, "use_reference": True,
          "points": points, "seconds": time.perf_counter() - t0,
          "nvidia_smi": smi})
    del xs, refs

    # -- service: partial and comm_efficient at full width ---------------
    for length, q, tol in ((s, sz["q"], 5e-4), (big, sz["q_big"], 1e-3)):
        x = crand((q, length))
        want = np.fft.fft(x.astype(np.complex128), axis=-1)
        reqs = list(x)
        for strategy in ("partial", "comm_efficient"):
            svc = FFTService(FFTServiceConfig(
                s=length, m=4, n_workers=8, strategy=strategy,
                autotune=False), device=dev)
            timed("service", lambda: svc.submit_batch(reqs), want, tol, {},
                  strategy=strategy, param=svc.plan.fragments
                  if strategy == "partial" else svc.plan.q, s=length,
                  requests=q, route="plan.run on torch.fft and the batched "
                  "torch.linalg.solve (the reference's jnp executor)",
                  after=lambda: {f: getattr(svc.stats, f) for f in
                                 ("requests", "coded_latency",
                                  "stragglers_tolerated")})
        del x, want, reqs

    # -- plan: the kernel backend ----------------------------------------
    for length in (s, big):
        nq = sz["q_plan"]
        x = crand((nq, length))
        want = np.fft.fft(x.astype(np.complex128), axis=-1)
        xt = torch.as_tensor(x, device=dev)
        for cls, kw in ((CodedPartialFFT, {"r": 2}),
                        (CodedCommEffFFT, {"q": 2})):
            plans = {b: cls(s=length, m=4, n_workers=8, backend=b,
                            device=dev, **kw)
                     for b in ("kernel", "reference")}
            kplan = plans["kernel"]
            if kplan.resolved_backend != "kernel":
                fail(f"strategy_zoo plan {cls.__name__}: "
                     f"{kplan.resolved_backend}")
            partial = cls is CodedPartialFFT
            ell = kplan.frag_len if partial else kplan.shard_len
            variant, factors = ops.fourstep_route(ell, device=dev)
            worker = ({"fourstep_fused": 1} if variant == "fused" else
                      {"fourstep_stage1": 1, "fourstep_stage2": 1})
            if (variant == "fused") != (length == s):
                fail(f"strategy_zoo plan: L={ell} routes {variant}")
            if partial:
                # evenly spread finished fragments: the even or the odd
                # workers complete, alternately per request
                masks = np.zeros((nq, 8, 2), bool)
                masks[0::2, 0::2] = True
                masks[1::2, 1::2] = True
            else:
                masks = np.ones((nq, 8), bool)   # m*q = N: all eight
            mt = torch.as_tensor(masks, device=dev)
            key = "fragment_mask" if partial else "mask"

            def run(plan, xin, mk):
                b = plan.worker_compute(plan.encode(xin))
                b = b.masked_fill(~mk.reshape(mk.shape + (1,) * (
                    b.ndim - mk.ndim)), float("nan"))
                return plan.decode(b, **{key: mk})

            for xin, mk, w, tag in ((xt, mt, want, "batch"),
                                    (xt[0], mt[0], want[0], "one request")):
                expect = dict(worker)
                if not partial and tag == "one request":
                    expect["cmatmul"] = 1
                refout = host(run(plans["reference"], xin, mk))
                line = timed("plan", lambda: run(kplan, xin, mk), w,
                             5e-4 if length == s else 1e-3, expect,
                             plan=cls.__name__, s=length, m=4, n_workers=8,
                             requests=nq if tag == "batch" else 1,
                             case=tag, worker_route=[variant, factors],
                             masks="evenly spread fragments, the rest NaN"
                             if partial else "all eight (m*q = N)")
                got = host(run(kplan, xin, mk))
                vs_ref = rel(got, refout)
                if not vs_ref < 1e-3:
                    fail(f"strategy_zoo plan {cls.__name__} {tag}: kernel "
                         f"vs reference backend {vs_ref}")
                emit({"phase": "strategy_zoo", "part": "plan_vs_reference",
                      "plan": cls.__name__, "s": length, "case": tag,
                      "kernel_vs_reference_backend": vs_ref,
                      "vs_numpy": line["rel_err"]})
        del x, want, xt

    # -- repetition: the uncoded baseline --------------------------------
    x = crand((2, s))
    want = np.fft.fft(x.astype(np.complex128), axis=-1)
    xt = torch.as_tensor(x, device=dev)
    rep = UncodedRepetitionFFT(s=s, m=4, n_workers=16, device=dev)
    if rep.worst_case_threshold() != 16:
        fail(f"repetition: worst case {rep.worst_case_threshold()}")
    timed("repetition", lambda: rep.run(xt), want, 5e-4, {}, m=4,
          n_workers=16, case="all alive",
          worst_case_threshold=rep.worst_case_threshold())
    straggler = np.ones(16, bool)
    straggler[5] = False
    try:
        rep.run(xt, mask=straggler)
    except ValueError as err:
        refused = str(err)
    else:
        fail("repetition m=4, N=16: a straggler did not refuse")
    rep2 = UncodedRepetitionFFT(s=s, m=2, n_workers=16, device=dev)
    one_per_block = np.ones(16, bool)
    one_per_block[[0, 5, 10, 15]] = False   # blocks (0,0) (0,1) (1,0) (1,1)
    if not rep2.decodable(one_per_block):
        fail("repetition m=2: one straggler a block must decode")
    timed("repetition", lambda: rep2.run(xt, mask=one_per_block), want,
          5e-4, {}, m=2, n_workers=16, case="one straggler a block",
          worst_case_threshold=rep2.worst_case_threshold(),
          refused_at_m4=refused)
    del rep, rep2, x, xt

    # -- faults: the partial strategy's deadline machine -----------------
    faults = FaultPlan(seed=0).kill(2, rounds=3).delay(5, 0.4, rounds=8)
    svc = FFTService(FFTServiceConfig(
        s=s, m=4, n_workers=8, strategy="partial", health=True,
        faults=faults, on_failure="degrade", autotune=False), device=dev)
    x = crand((sz["q"], s))
    want = np.fft.fft(x.astype(np.complex128), axis=-1)
    fields = ("requests", "retries", "redispatched_shards", "degraded",
              "coded_latency", "stragglers_tolerated")
    before = {f: getattr(svc.stats, f) for f in fields}
    out, counts = counted(lambda: svc.submit_batch(list(x)))
    first = {f: getattr(svc.stats, f) - before[f] for f in fields}
    bad = [i for i, y in enumerate(out) if isinstance(y, DegradedResult)]
    served = [i for i in range(len(out)) if i not in bad]
    err = max((rel(out[i], want[i]) for i in served), default=0.0)
    if counts or not err < 5e-4:
        fail(f"strategy_zoo faults: err {err}, launches {counts}")
    rounds_stats = []
    for _ in range(3):
        svc.submit_batch(list(x))
        rounds_stats.append({f: getattr(svc.stats, f) for f in fields})
    emit({"phase": "strategy_zoo", "part": "faults", "strategy": "partial",
          "s": s, "requests": len(out),
          "faults": "kill(2, rounds=3).delay(5, 0.4, rounds=8)",
          "health": True, "served": len(served), "degraded_rows": len(bad),
          "reasons": sorted({out[i].reason for i in bad}), "rel_err": err,
          "first_call_stats": first, "after_rounds": rounds_stats, "launches": counts,
          "health_summary": svc.health.summary(), "nvidia_smi": smi})
    del x, want, out

    # -- direct: the off-accelerator bucket executors ---------------------
    q, m, n = sz["q"], 4, 8
    masks = np.zeros((q, n), bool)
    for row in masks:
        row[rng.choice(n, size=int(rng.integers(m, n + 1)),
                       replace=False)] = True
    mt = torch.as_tensor(masks, device=dev)
    subsets = ops.mask_subsets(mt, m)
    dvr, dvi = ops.lagrange_compact_planes(subsets, n)
    g = mds.rs_generator(n, m, torch.complex64, dev)
    gr, gi = g.real.contiguous(), g.imag.contiguous()
    x = crand((q, s))
    xr_ = torch.as_tensor(x.real.copy(), device=dev)
    xi_ = torch.as_tensor(x.imag.copy(), device=dev)
    y = np.fft.rfft(x.real.astype(np.float64), axis=-1).astype(np.complex64)
    yr_ = torch.as_tensor(y.real.copy(), device=dev)
    yi_ = torch.as_tensor(y.imag.copy(), device=dev)
    cases = {
        "c2c": (lambda: ops.coded_bucket_direct(xr_, xi_, dvr, dvi, subsets,
                                                gr, gi, s),
                lambda: ops.coded_bucket_masked(xr_, xi_, mt, gr, gi, s),
                np.fft.fft(x.astype(np.complex128), axis=-1)),
        "r2c": (lambda: ops.coded_rbucket_direct(xr_, dvr, dvi, subsets, gr,
                                                 gi, s),
                lambda: ops.coded_rbucket_masked(xr_, mt, gr, gi, s),
                np.fft.rfft(x.real.astype(np.float64), axis=-1)),
        "c2r": (lambda: ops.coded_irbucket_direct(yr_, yi_, dvr, dvi,
                                                  subsets, gr, gi, s),
                lambda: ops.coded_irbucket_masked(yr_, yi_, mt, gr, gi, s),
                np.fft.irfft(y.astype(np.complex128), n=s, axis=-1))}

    def as_np(out):
        if isinstance(out, tuple):
            return (out[0] + 1j * out[1]).cpu().numpy()
        return out.cpu().numpy()

    for kind, (direct, whole, truth) in cases.items():
        got, counts = counted(lambda: as_np(direct()))
        if counts:
            fail(f"strategy_zoo direct {kind}: launched {counts}")
        bucket = as_np(whole())        # a comparison: not counted
        err, vs_bucket = rel(got, truth), rel(got, bucket)
        if not (err < 3e-4 and vs_bucket < 3e-4):
            fail(f"strategy_zoo direct {kind}: err {err}, vs the masked "
                 f"bucket {vs_bucket}")
        sync()
        t1 = time.perf_counter()
        for _ in range(3):
            as_np(direct())
        ms = (time.perf_counter() - t1) / 3 * 1e3
        emit({"phase": "strategy_zoo", "part": "direct", "kind": kind,
              "s": s, "q": q, "m": m, "n_workers": n, "rel_err": err,
              "vs_masked_bucket_kernel": vs_bucket, "rel_tol": 3e-4,
              "ms_per_call": ms, "launches": counts, "nvidia_smi": smi})


# -- the multi-device runtime (mesh_runtime) ---------------------------------
# m = 4, N = 8 throughout; the 1-D shapes of the other phases
MESH_M, MESH_N, MESH_S, MESH_BIG = 4, 8, 4096, 1 << 20


def _mesh_inputs(np, big: bool = True):
    """Both worlds' inputs, alike in every process: 64 complex requests at
    s = 4096 (and one real and one half-spectrum batch) and, with ``big``,
    16 at 2^20 and one real 2048 x 2048 field; the masks are the
    service's own straggler draws (fastest m of N, per fragment for
    partial), from same-seed CPU services (their draws are numpy's
    alone)."""
    from repro_torch import FFTService, FFTServiceConfig

    rng = np.random.default_rng(31)

    def crand(*shape):
        return (rng.standard_normal(shape)
                + 1j * rng.standard_normal(shape)).astype(np.complex64)

    def draws(q, **kw):
        svc = FFTService(FFTServiceConfig(
            s=MESH_S, m=MESH_M, n_workers=MESH_N, seed=q, autotune=False,
            **kw), device="cpu")
        return svc._simulate_arrivals(q)[1]

    inp = {"x": crand(64, MESH_S), "masks": draws(64)}
    if big:
        inp.update(
            real=rng.standard_normal((64, MESH_S)).astype(np.float32),
            half=np.fft.rfft(rng.standard_normal((64, MESH_S))).astype(
                np.complex64),
            xbig=crand(16, MESH_BIG),
            field=rng.standard_normal((2048, 2048)).astype(np.float32),
            masks_big=draws(16), fmasks=draws(64, strategy="partial"),
            cmasks=draws(64, strategy="comm_efficient"))
    return inp


def _mesh_service_cfg(**kw):
    from repro_torch import FFTServiceConfig

    return FFTServiceConfig(s=MESH_S, m=MESH_M, n_workers=MESH_N, seed=7,
                            max_batch=64, autotune=False, **kw)


def _mesh_child(fn, rank: int, world: int, backend: str, outdir: str):
    """A rank of one world: the process group (``file://`` rendezvous in
    ``outdir``), ``fn(torch, np, mesh, rank)``'s results written to
    ``outdir``, a traceback there on failure."""
    import traceback

    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.distributed import test_mesh

    out = Path(outdir)
    try:
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        dist.init_process_group(backend,
                                init_method=f"file://{out / 'rendezvous'}",
                                rank=rank, world_size=world)
        try:
            mesh = test_mesh((world,), ("workers",), device_type="cuda")
            info, arrays = fn(torch, np, mesh, rank)
        finally:
            dist.destroy_process_group()
        np.savez(out / f"rank{rank}.npz", **arrays)
        (out / f"rank{rank}.json").write_text(json.dumps(info))
    except BaseException:
        (out / f"rank{rank}.err").write_text(traceback.format_exc())
        raise


def _mesh_counted(torch, run):
    """``run()`` with the launch counts set to 0 just before it; its
    result and the counts read just after."""
    from repro_torch.kernels import _build

    torch.cuda.synchronize()
    _build.reset_launch_counts()
    out = run()
    torch.cuda.synchronize()
    return out, _build.launch_counts()


def _mesh_timing(torch, run, track=("nccl",), profiled=True) -> dict:
    """Three steady calls' mean wall ms; ``profiled``: then one profiled
    call's busy and idle share and the collective's device ms."""
    t0 = time.perf_counter()
    for _ in range(3):
        run()
    torch.cuda.synchronize()
    row = {"ms": (time.perf_counter() - t0) * 1e3 / 3}
    if profiled:
        prof = profile_call(torch, run, track=track)
        row.update(busy_ms=prof["device_busy_ms"],
                   idle_share=prof["device_idle_share"],
                   collective_ms=prof["tracked_ms"])
    return row


def _mesh_case(torch, np, name, run, want, tol, expect, rows, arrays,
               timed=True, profiled=False):
    """One counted call (its launches exactly ``expect``), its error
    against ``want`` (complex128/float64 on the card), NaN-free; then
    (``timed``) three steady calls' mean wall ms and (``profiled``) one
    profiled call."""
    out, counts = _mesh_counted(torch, run)
    got = out.to_local() if hasattr(out, "to_local") else out
    if counts != expect:
        raise RuntimeError(f"{name}: launches {counts}, expected {expect}")
    if bool(torch.isnan(got).any()):
        raise RuntimeError(f"{name}: NaN reached the output")
    err = float((got.to(want.dtype) - want).abs().max() / want.abs().max())
    if not err < tol:
        raise RuntimeError(f"{name}: rel err {err} >= {tol}")
    row = {"case": name, "shape": list(got.shape), "launches": counts,
           "rel_err": err, "rel_tol": tol}
    if timed:
        row.update(_mesh_timing(torch, run, track=("nccl", "Memcpy"),
                                profiled=profiled))
    rows.append(row)
    arrays[name] = got.cpu().numpy()
    return out


def _mesh_world_one(torch, np, mesh, rank):
    """(a) the NCCL world of one on the card: every path at full width."""
    from repro_torch import FFTService
    from repro_torch.core import (
        CodedFFT,
        CodedIRFFT,
        CodedRFFT,
        CodedRFFTN,
        make_strategy,
        plan_factors,
    )
    from repro_torch.distributed import DistributedCodedPlan, reshard

    inp = _mesh_inputs(np)
    dev = torch.device("cuda")
    m, n, s, big = MESH_M, MESH_N, MESH_S, MESH_BIG
    nan = float("nan")

    def cuda(a):
        return torch.as_tensor(a, device=dev)

    x, xbig = cuda(inp["x"]), cuda(inp["xbig"])
    masks, masks_big = cuda(inp["masks"]), cuda(inp["masks_big"])
    fx = torch.fft.fft(x.to(torch.complex128), dim=-1)
    rows, arrays = [], {}
    small = {"cmatmul": 1, "fourstep_fused": 1, "bcmatmul": 1}
    two_pass = {"cmatmul": 1, "fourstep_stage1": 1, "fourstep_stage2": 1}

    def runtime(plan):
        return DistributedCodedPlan(plan, mesh, masked_fill=nan)

    d = runtime(CodedFFT(s=s, m=m, n_workers=n, device=dev))
    _mesh_case(torch, np, "fft_64x4096", lambda: d.run(x, masks), fx, 5e-4,
               small, rows, arrays, profiled=True)
    rows[-1]["collectives"] = d.last_collectives
    d = runtime(CodedFFT(s=big, m=m, n_workers=n, device=dev))
    want = torch.fft.fft(xbig.to(torch.complex128), dim=-1)
    _mesh_case(torch, np, "fft_16x2^20", lambda: d.run(xbig, masks_big),
               want, 1e-3, {**two_pass, "bcmatmul": 1}, rows, arrays,
               profiled=True)
    rows[-1]["collectives"] = d.last_collectives
    del want
    want = torch.fft.fft(xbig[0].to(torch.complex128)).reshape(m, -1)
    xm = _mesh_case(torch, np, "run_sharded_2^20",
                    lambda: d.run_sharded(xbig[0], masks_big[0]), want,
                    1e-3, two_pass, rows, arrays, profiled=True)
    rows[-1]["collectives"] = d.last_collectives
    full = reshard(xm, mesh, ()).to_local()
    if not torch.equal(full, xm.to_local()):
        raise RuntimeError("run_sharded: the replicated value differs")
    del want, xm, full

    real, half = cuda(inp["real"]), cuda(inp["half"])
    d = runtime(CodedRFFT(s=s, m=m, n_workers=n, device=dev))
    _mesh_case(torch, np, "rfft_64x4096", lambda: d.run(real, masks),
               torch.fft.rfft(real.double(), dim=-1), 5e-4, small, rows,
               arrays)
    d = runtime(CodedIRFFT(s=s, m=m, n_workers=n, device=dev))
    _mesh_case(torch, np, "irfft_64x4096", lambda: d.run(half, masks),
               torch.fft.irfft(half.to(torch.complex128), n=s, dim=-1),
               5e-4, small, rows, arrays)
    field = cuda(inp["field"])
    d = runtime(CodedRFFTN(shape=(2048, 2048), factors=plan_factors(
        (2048, 2048), m, even_last_shard=True), n_workers=n, device=dev))
    _mesh_case(torch, np, "rfftn_2048x2048",
               lambda: d.run(field, masks[0]),
               torch.fft.rfftn(field.double()), 1e-3,
               {"cmatmul": 1, "fourstep_fused": 2}, rows, arrays)
    for name, key in (("partial", "fmasks"), ("comm_efficient", "cmasks")):
        d = runtime(make_strategy(name, s, m, n, backend="kernel",
                                  device=dev))
        mk = cuda(inp[key])
        kw = ({"fragment_mask": mk} if name == "partial" else {"mask": mk})
        _mesh_case(torch, np, f"{name}_64x4096", lambda: d.run(x, **kw),
                   fx, 5e-4, small, rows, arrays)

    # the service with mesh= against a same-seed service without one: the
    # same draws (rng state) and coded latency after every call
    svc = FFTService(_mesh_service_cfg(), device=dev, mesh=mesh)
    twin = FFTService(_mesh_service_cfg(), device=dev)
    timed_svc = FFTService(_mesh_service_cfg(), device=dev, mesh=mesh)
    for kind, key, want, tol, expect in (
            ("c2c", "x", fx, 5e-4, small),
            ("r2c", "real", torch.fft.rfft(real.double(), dim=-1), 5e-4,
             small),
            ("c2r", "half", torch.fft.irfft(half.to(torch.complex128), n=s,
                                            dim=-1), 5e-4, small),
            ("c2c", "xbig", torch.fft.fft(xbig.to(torch.complex128), dim=-1),
             1e-3, {**two_pass, "bcmatmul": 1})):
        batch = list(inp[key])

        def call(svc=svc, kind=kind, batch=batch):
            return cuda(np.stack(svc.submit_batch(batch, kind=kind)))

        name = f"service_{kind}_{len(batch)}x{inp[key].shape[-1]}"
        _mesh_case(torch, np, name, call, want, tol, expect, rows, arrays,
                   timed=False)
        twin.submit_batch(batch, kind=kind)
        if (svc.rng.bit_generator.state != twin.rng.bit_generator.state
                or svc.stats.coded_latency != twin.stats.coded_latency):
            raise RuntimeError(f"{name}: draws differ from the same-seed "
                               f"service without a mesh")
        rows[-1]["coded_latency"] = svc.stats.coded_latency
        # timed on a service of its own, so the two above stay in step
        rows[-1].update(_mesh_timing(
            torch, lambda: call(svc=timed_svc), profiled=kind == "c2c"))
    return {"rows": rows}, arrays


def _mesh_world_gloo(torch, np, mesh, rank):
    """(b) four ranks sharing the card over gloo (n_local = 2)."""
    from repro_torch import FFTService
    from repro_torch.core import CodedFFT
    from repro_torch.distributed import (
        DistributedCodedPlan,
        reshard,
        test_mesh,
    )

    inp = _mesh_inputs(np, big=False)
    dev = torch.device("cuda")
    x = torch.as_tensor(inp["x"], device=dev)
    masks = torch.as_tensor(inp["masks"], device=dev)
    fx = torch.fft.fft(x.to(torch.complex128), dim=-1)
    rows, arrays = [], {}
    small = {"cmatmul": 1, "fourstep_fused": 1, "bcmatmul": 1}
    d = DistributedCodedPlan(
        CodedFFT(s=MESH_S, m=MESH_M, n_workers=MESH_N, device=dev), mesh,
        masked_fill=float("nan"))
    _mesh_case(torch, np, "fft_64x4096", lambda: d.run(x, masks), fx, 5e-4,
               small, rows, arrays, profiled=True)
    rows[-1]["collectives"] = d.last_collectives
    cols = MESH_S // MESH_M // mesh.size(0)
    xm = _mesh_case(torch, np, "run_sharded_4096",
                    lambda: d.run_sharded(x[0], masks[0]),
                    fx[0].reshape(MESH_M, -1)[:, rank * cols:(rank + 1) * cols],
                    5e-4, {"cmatmul": 1, "fourstep_fused": 1}, rows, arrays,
                    timed=False)
    rows[-1]["collectives"] = d.last_collectives
    arrays["run_sharded_full"] = reshard(xm, mesh, ()).to_local().cpu().numpy()
    svc = FFTService(_mesh_service_cfg(), device=dev, mesh=mesh)
    _mesh_case(torch, np, f"service_c2c_64x{MESH_S}",
               lambda: torch.as_tensor(
                   np.stack(svc.submit_batch(list(inp["x"]))), device=dev),
               fx, 5e-4, small, rows, arrays, timed=False)
    rows[-1]["coded_latency"] = svc.stats.coded_latency
    # reshard 4 -> 2 -> 4 ranks, bit for bit
    tree = {"w": torch.arange(64.0, device=dev).reshape(8, 8),
            "tw": torch.polar(torch.ones(16, device=dev),
                              torch.arange(16.0, device=dev)),
            "step": torch.tensor(7, dtype=torch.int32, device=dev)}
    specs = {"w": ("d", None), "tw": (), "step": ()}
    m4 = test_mesh((4,), ("d",), device_type="cuda")
    m2 = test_mesh((2,), ("d",), device_type="cuda")
    back = reshard(reshard(reshard(tree, m4, specs), m2, specs), m4, specs)
    whole = reshard(back, m4, None)
    exact = all(torch.equal(whole[k].to_local(), tree[k]) for k in tree)
    local = list(back["w"].to_local().shape)
    if not exact or local != [2, 8]:
        raise RuntimeError(f"reshard 4 -> 2 -> 4: exact {exact}, local "
                           f"shard {local}")
    return {"rows": rows, "reshard_exact": exact}, arrays


def mesh_runtime(torch, np, launches) -> None:
    """The multi-device runtime on the card, each world in child processes
    (spawned; a child's failure fails the run; the kernels are built
    already, so no rank builds one):

    * (a) a world of one on NCCL, m = 4, N = 8, ``masked_fill=nan``, the
      service's own straggler draws as masks: ``DistributedCodedPlan.run``
      of ``CodedFFT`` on 64 x 4096 and 16 x 2^20, ``run_sharded`` on one
      2^20 request, ``CodedRFFT`` / ``CodedIRFFT`` at 4096 and
      ``CodedRFFTN`` on one 2048 x 2048 field, the partial and
      comm_efficient kernel-backend plans at 4096, and ``FFTService(mesh=)``
      for c2c, r2c and c2r on 64 x 4096 and c2c on 16 x 2^20 (its rng state
      and coded latency those of a same-seed service without a mesh);
      each run's launches exactly ``cmatmul``, the four-step kernels and,
      batched, ``bcmatmul``; its error against complex128 ``torch.fft``
      (5e-4 at 4096, 1e-3 at 2^20 and n-D), no NaN; ms a call over three
      steady calls, one profiled call's busy and idle share and the
      collective's device ms;
    * (b) four ranks sharing the card over ``gloo`` (``("workers",)`` of 4,
      n_local = 2): ``run`` and ``run_sharded`` of ``CodedFFT`` and the
      service on 64 x 4096, every rank within 5e-4 of (a), the
      collectives each rank records, and a ``reshard`` 4 -> 2 -> 4 ranks,
      bit for bit.

    The children's launches add to ``launches``."""
    import multiprocessing as mp

    t_phase = time.perf_counter()
    ctx = mp.get_context("spawn")
    base = ROOT / "build" / f"mesh-{os.getpid()}"
    shutil.rmtree(base, ignore_errors=True)
    results = {}
    for tag, fn, world, backend in (
            ("one", _mesh_world_one, 1, "nccl"),
            ("gloo", _mesh_world_gloo, 4, "gloo")):
        outdir = base / tag
        outdir.mkdir(parents=True)
        t0 = time.perf_counter()
        procs = [ctx.Process(target=_mesh_child,
                             args=(fn, r, world, backend, str(outdir)))
                 for r in range(world)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(timeout=300)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        errs = "".join(f.read_text() for f in sorted(outdir.glob("*.err")))
        if any(p.exitcode != 0 for p in procs) or errs:
            fail(f"mesh_runtime world {tag}: exit codes "
                 f"{[p.exitcode for p in procs]}\n{errs[-4000:]}")
        ranks = [(json.loads((outdir / f"rank{r}.json").read_text()),
                  dict(np.load(outdir / f"rank{r}.npz")))
                 for r in range(world)]
        for info, _ in ranks:
            for row in info["rows"]:
                for k, v in row["launches"].items():
                    launches[k] = launches.get(k, 0) + v
        results[tag] = ranks
        emit({"phase": f"mesh_runtime_{tag}", "backend": backend,
              "world": world, "seconds": time.perf_counter() - t0,
              "rows": ranks[0][0]["rows"],
              **({"reshard_exact": [i["reshard_exact"] for i, _ in ranks]}
                 if tag == "gloo" else {})})
    one = results["one"][0][1]
    ell = MESH_S // MESH_M
    for rank, (info, arr) in enumerate(results["gloo"]):
        errs = {}
        for name, want in (("fft_64x4096", one["fft_64x4096"]),
                           (f"service_c2c_64x{MESH_S}",
                            one[f"service_c2c_64x{MESH_S}"]),
                           ("run_sharded_full",
                            one["fft_64x4096"][0].reshape(MESH_M, ell))):
            errs[name] = float(np.abs(arr[name] - want).max()
                               / np.abs(want).max())
            if not errs[name] < 5e-4:
                fail(f"mesh_runtime gloo rank {rank} {name}: rel err "
                     f"{errs[name]} against the NCCL world of one")
        coll = {row["case"]: row.get("collectives") for row in info["rows"]}
        want_coll = {
            "fft_64x4096": [{"kind": "all_gather", "group_size": 4,
                             "send_symbols": 2 * 64 * ell,
                             "recv_symbols": MESH_N * 64 * ell}],
            "run_sharded_4096": [{"kind": "all_to_all", "group_size": 4,
                                  "send_symbols": 2 * ell,
                                  "recv_symbols": MESH_N * ell // 4}]}
        for name, want in want_coll.items():
            if coll[name] != want:
                fail(f"mesh_runtime gloo rank {rank} {name}: collectives "
                     f"{coll[name]}, expected {want}")
        emit({"phase": "mesh_runtime_gloo_vs_one", "rank": rank,
              "rel_err": errs})
    shutil.rmtree(base, ignore_errors=True)
    emit({"phase": "mesh_runtime_done",
          "seconds": time.perf_counter() - t_phase})


LAUNCH_CELLS = (("gemma-2b", "prefill_32k", "single"),
                ("gemma-2b", "decode_32k", "single"),
                ("rwkv6-3b", "prefill_32k", "card"))
LAUNCH_SERVE = ("gemma-2b", 4, 512, 1024)     # arch, batch, prompt, cache
LAUNCH_RWKV = ("rwkv6-3b", 4, 512)            # arch, batch, prompt
LAUNCH_MEM_RTOL = 0.02


def launch_tools(torch, counted) -> None:
    """The launch tools (``launch/{dryrun,fft_dryrun,cost_analysis,
    roofline}.py``) and the serving and quickstart entry points on the
    card.  (a) Dry runs on meta tensors of gemma-2b's ``prefill_32k`` and
    ``decode_32k`` on the single-pod mesh and rwkv6-3b's ``prefill_32k``
    on one card (``wkv``'s meta path): each record's bytes a rank, FLOPs
    a chip, terms and fit verdict printed.  (b) gemma-2b at full width
    and depth, bf16 seeded weights, 4 x 512 through ``make_serve_fns``'s
    ``prefill_fn`` and one ``decode_fn`` step, counted by
    ``cost_analysis`` on CUDA tensors and again on meta tensors: FLOPs
    and bytes must be equal; the plan's bytes of the params and the
    1024-slot cache (a world of one) within 2% of what
    ``torch.cuda.memory_allocated`` grew by as they were made; the
    prefill's ms (median of 5, host clock around a synchronize, once the
    subprocesses of (d) and (e) have ended) printed beside
    ``roofline.terms``' bound, as a share.  (c) rwkv6-3b whole,
    4 x 512 prefill: the counter's ``wkv`` report equal on meta and on
    CUDA, ``launch_counts()["wkv"]`` 32 on CUDA and nothing on meta.
    (d) ``launch.fft_dryrun``'s two variants (a subprocess: a 256-rank
    fake process group): wire bytes a chip and their ratio.  (e)
    ``examples/quickstart_torch.py`` on the card, a subprocess."""
    import tempfile

    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.launch import dryrun, roofline
    from repro_torch.launch.cost_analysis import analyze
    from repro_torch.launch.mesh import card_mesh
    from repro_torch.launch.shardings import make_plan
    from repro_torch.models import build_model
    from repro_torch.serving import make_serve_fns

    dev = torch.device("cuda")
    t_phase = time.perf_counter()
    (ROOT / "build").mkdir(exist_ok=True)
    out_dir = tempfile.mkdtemp(prefix="launch-", dir=ROOT / "build")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    # (d) and (e) run beside (a) and (b)'s counts, and end before (b)'s
    # prefill is timed: the paper's cell as rank 0 of a 256-rank fake
    # process group, and the quickstart on the card
    subs = {
        "fft_dryrun": subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.fft_dryrun", "--out",
             out_dir], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True),
        "quickstart": subprocess.Popen(
            [sys.executable, str(ROOT / "examples" / "quickstart_torch.py")],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)}

    # (a) dry runs on meta
    cells = []
    for arch, shape, mesh in LAUNCH_CELLS:
        rec = dryrun.run_cell(arch, shape, mesh, out_dir)
        if rec.get("skipped") or rec["terms"] is None:
            fail(f"launch_tools: dry run {arch} x {shape} x {mesh}: {rec}")
        cells.append({k: rec[k] for k in (
            "arch", "shape", "mesh", "chips", "count_seconds", "memory",
            "fits_hbm", "cost", "terms", "model_flops")})
        if arch == "rwkv6-3b" and rec["global_cost"]["kernels"].get(
                "wkv", {}).get("calls") != get_config(arch).n_layers:
            fail(f"launch_tools: the rwkv6-3b dry run reported "
                 f"{rec['global_cost']['kernels']}, not one wkv a layer")

    # (b) gemma-2b through make_serve_fns, counted on CUDA and on meta
    arch, b, t, cache_len = LAUNCH_SERVE
    cfg = get_config(arch)
    shape = ShapeConfig("launch_smoke", t, b, "prefill")

    def serve(device, generator=None):
        model = build_model(cfg, device=device)
        params = (model.init(generator) if generator is not None
                  else model.make_params())
        cache = model.init_cache(b, cache_len)
        toks = torch.zeros((b, t + 1), dtype=torch.int32, device=device)
        if generator is not None:
            toks = torch.randint(0, cfg.vocab_size, (b, t + 1),
                                 generator=generator, device=device,
                                 dtype=torch.int32)
        return model, params, cache, toks

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    model, params, cache, toks = serve(
        dev, torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    grew = torch.cuda.memory_allocated() - before - toks.numel() * 4
    plan = make_plan(cfg, shape, card_mesh())
    mem = dryrun.argument_bytes(cfg, shape, card_mesh(), plan.rules, model,
                                params=params, cache=cache)
    planned = mem["params_bytes"] + mem["cache_bytes"]
    mem_rel = abs(grew - planned) / planned
    prefill_fn, decode_fn = make_serve_fns(model)

    def both(params, cache, toks):
        (logits, cache), c_pre = analyze(
            prefill_fn, params, {"tokens": toks[:, :t]}, cache)
        _, c_dec = analyze(decode_fn, params, cache, toks[:, t:], t)
        return logits, c_pre, c_dec

    with torch.no_grad():
        (logits, cu_pre, cu_dec), cu_launch = counted(
            lambda: both(params, cache, toks))
        torch.cuda.synchronize()
        if not bool(torch.isfinite(logits).all()):
            fail("launch_tools: gemma-2b prefill_fn logits not finite")
        outs = {}
        for name, proc in subs.items():
            stdout, stderr = proc.communicate(timeout=300)
            if proc.returncode != 0:
                fail(f"launch_tools: {name}: {stdout[-2000:]} "
                     f"{stderr[-2000:]}")
            outs[name] = stdout.strip().splitlines()
        ms = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            prefill_fn(params, {"tokens": toks[:, :t]}, cache)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        mparams = serve("meta")
        _, me_pre, me_dec = both(*mparams[1:])
    del model, params, cache, toks, logits, mparams
    torch.cuda.empty_cache()
    for what, cu, me in (("prefill", cu_pre, me_pre),
                         ("decode", cu_dec, me_dec)):
        if ((cu.flops, cu.flops_by_dtype, cu.bytes_accessed)
                != (me.flops, me.flops_by_dtype, me.bytes_accessed)):
            fail(f"launch_tools: gemma-2b {what} counted {cu.flops} flops, "
                 f"{cu.bytes_accessed} bytes on CUDA, {me.flops}, "
                 f"{me.bytes_accessed} on meta")
    if cu_launch:
        fail(f"launch_tools: gemma-2b serving launched {cu_launch}")
    if not mem_rel < LAUNCH_MEM_RTOL:
        fail(f"launch_tools: the plan's {planned} bytes of params and cache "
             f"against {grew} allocated ({mem_rel:.4f})")
    pre_terms = roofline.terms({"cost": cu_pre.as_dict(), "chips": 1})
    prefill_ms = sorted(ms)[len(ms) // 2]
    serve_row = {
        "arch": arch, "batch": b, "prompt": t, "cache_len": cache_len,
        "prefill_flops": cu_pre.flops, "prefill_bytes": cu_pre.bytes_accessed,
        "decode_flops": cu_dec.flops, "decode_bytes": cu_dec.bytes_accessed,
        "meta_equal": True, "planned_bytes": planned,
        "allocated_bytes": grew, "memory_rel": mem_rel,
        "prefill_ms": prefill_ms, "prefill_ms_all": ms,
        "prefill_terms": pre_terms,
        "prefill_bound_share": pre_terms["step_lower_bound_s"] * 1e3
        / prefill_ms}

    # (c) rwkv6-3b's prefill: the wkv report on meta and on CUDA
    arch, b, t = LAUNCH_RWKV
    cfg = get_config(arch)
    rw = {}
    for device in ("meta", "cuda"):
        model = build_model(cfg, device=device)
        params = (model.init(torch.Generator(device=dev).manual_seed(0))
                  if device == "cuda" else model.make_params())
        toks = torch.zeros((b, t), dtype=torch.int32, device=device)
        with torch.no_grad():
            (_, cost), launches = counted(lambda: analyze(
                model.prefill, params, {"tokens": toks},
                model.init_cache(b)))
        torch.cuda.synchronize()
        rw[device] = {"wkv": cost.kernels.get("wkv"), "launches": launches,
                      "flops": cost.flops, "bytes": cost.bytes_accessed}
        del model, params
        torch.cuda.empty_cache()
    if (rw["meta"]["wkv"] != rw["cuda"]["wkv"]
            or rw["meta"]["launches"] != {}
            or rw["cuda"]["launches"] != {"wkv": cfg.n_layers}
            or rw["cuda"]["wkv"]["calls"] != cfg.n_layers):
        fail(f"launch_tools: rwkv6-3b wkv reports {rw}")

    shutil.rmtree(out_dir, ignore_errors=True)
    fft = json.loads(outs["fft_dryrun"][-1])
    fft["lines"] = outs["fft_dryrun"][:-1]
    if "n-D real coded FFT service: OK" not in outs["quickstart"]:
        fail(f"launch_tools: quickstart_torch.py: {outs['quickstart']}")
    emit({"phase": "launch_tools", "device": roofline.DEVICE,
          "dryrun": cells, "serve": serve_row, "rwkv_prefill": rw,
          "fft_dryrun": fft, "quickstart": outs["quickstart"],
          "seconds": time.perf_counter() - t_phase})
    print(nvidia_smi(), flush=True)


def bf16_twin_spills(ptxas: dict) -> list[dict]:
    """Each bf16-table instance of a library's ptxas report beside its f32
    twin (the same template instance with ``float`` tables): its spill
    stores and the twin's, and ``worse`` where it spills more or has no
    twin."""
    def spill(line):
        part = line.split(" | ")[1]
        return int(part.split("bytes spill stores")[0].split()[-1]) \
            if "spill stores" in part else 0

    out = []
    for lib, lines in ptxas.items():
        f32 = {ln.split(" | ")[0].split("EEv")[0]: ln for ln in lines
               if "13__nv_bfloat16" not in ln}
        for ln in lines:
            name = ln.split(" | ")[0]
            if "13__nv_bfloat16" not in name:
                continue
            twin = f32.get(name.replace("13__nv_bfloat16", "f")
                           .split("EEv")[0])
            mine = spill(ln)
            theirs = None if twin is None else spill(twin)
            out.append({"lib": lib, "kernel": name[:90],
                        "spill_bytes": mine, "f32_spill_bytes": theirs,
                        "worse": theirs is None or mine > theirs})
    return out


def bf16_planes(torch, np, rng, dev, counted, spin_rate, table) -> None:
    """``precision="bf16"`` on the card: every bf16 kernel entry beside
    its f32 twin, then bf16 services probed from an empty autotune table.

    (a) Each wrapper the bf16 planes reach, at the kernel table's shapes,
    on bf16 planes: within ``ops.BF16_RTOL`` of its plain twin (the same
    bf16 planes widened) and of complex128 ``torch.fft``, different from
    its f32 entry; timed in seven windows with its f32 twin in the same
    windows (median, min, max), the plain twin and the library call in
    three; the bound counts each table entry at 2 bytes.  Each row joins
    the ``kernels`` line as ``<name>[bf16]``.
    (b) The main paths: ``precision="bf16"`` services at s=4096 (c2c, r2c,
    c2r, both decode paths, 64 requests) and c2c s=2^20 (both paths, 16
    requests), each with an f32 twin of the same seed: the first call
    probes the verdict, which must read ``ok``; the next is counted and
    must launch exactly the kind's ``[bf16]`` entry; three steady calls of
    each timed on the host clock.  Then ``ops.fourstep_planar(...,
    precision="bf16")`` on the four-step rows (fused, two-pass,
    streaming, multistep in both modes), counted.
    """
    from repro_torch import FFTService, FFTServiceConfig
    from repro_torch.core import mds
    from repro_torch.kernels import autotune
    from repro_torch.kernels import coded_pipeline as cp
    from repro_torch.kernels import fourstep_fft as ff
    from repro_torch.kernels import ops, ref
    from repro_torch.serving import DecodeMatrixCache

    tol = ops.BF16_RTOL
    bf16 = torch.bfloat16
    tab16 = 2                    # bytes of a bf16 table entry
    csrc = "src/repro_torch/kernels/csrc/"
    t_start = time.perf_counter()

    def randn(*shape):
        return torch.as_tensor(rng.standard_normal(shape).astype(np.float32),
                               device=dev)

    def masks_for(q, n, m):
        lat = rng.exponential(1.0, size=(q, n))
        kth = np.sort(lat, axis=1)[:, m - 1:m]
        return torch.as_tensor(lat <= kth, device=dev)

    def c128(out):
        if isinstance(out, tuple):
            return torch.complex(out[0].double(), out[1].double())
        return out.double()

    def rel(got, want):
        got, want = c128(got), want if not isinstance(want, tuple) \
            else c128(want)
        return float((got - want).abs().max() / want.abs().max())

    def windows(fn, reps, n):
        ts = sorted(time_ms(torch, fn, reps, spin_rate) for _ in range(n))
        return ts[n // 2], ts[0], ts[-1]

    rows = []

    def entry(name, source, replaces, run16, run32, plain16, library,
              oracle, nbytes, flops, reps, shape, natural=None, **info):
        """One bf16 row: checks, then the timings, appended to the
        kernels table as ``<name>[bf16]``."""
        natural = natural or (lambda o: c128(o))
        got, want, got32 = run16(), plain16(), run32()
        torch.cuda.synchronize()
        err_plain = rel(got, c128(want))
        err_oracle = float((natural(got) - oracle).abs().max()
                           / oracle.abs().max())
        abs_err = float((c128(got) - c128(want)).abs().max())
        diff = float((c128(got) - c128(got32)).abs().max())
        if not (err_plain < tol and err_oracle < tol and diff > 0):
            fail(f"{name}[bf16]: rel err {err_plain} vs plain, "
                 f"{err_oracle} vs torch.fft (tol {tol}), {diff} from f32")
        b16, b32 = [], []
        for _ in range(7):       # the two entries in the same windows
            b16.append(time_ms(torch, run16, reps, spin_rate))
            b32.append(time_ms(torch, run32, reps, spin_rate))
        b16.sort()
        b32.sort()
        plain_ms = windows(plain16, reps, 3)
        lib_ms = windows(library, reps, 3) if library else None
        bound_ms, bound_by = bound(nbytes, flops)
        row = {"name": f"{name}[bf16]", "route": "cuda", "source": source,
               "replaces": replaces, "launches": 0, "max_abs_err": abs_err,
               "rel_err_plain": err_plain, "rel_err_oracle": err_oracle,
               "tol": tol, "diff_from_f32": diff,
               "ms": b16[3], "ms_min": b16[0], "ms_max": b16[-1],
               "f32_ms": b32[3], "f32_ms_min": b32[0], "f32_ms_max": b32[-1],
               "ms_over_f32": b16[3] / b32[3],
               "plain_ms": plain_ms[0], "plain_ms_min": plain_ms[1],
               "plain_ms_max": plain_ms[2], "bound_ms": bound_ms,
               "bound_by": bound_by,
               "library_ms": None if lib_ms is None else lib_ms[0],
               "shape": shape, **info}
        emit({"phase": "kernel_bf16", **row})
        rows.append(row)
        table.append(row)

    def widened(planes):
        return tuple(p.float() for p in planes)

    # -- (a) the bucket entries at the kernel table's shapes --------------
    q, s, m, n = 64, 4096, 4, 8
    gr, gi = ref.planar(mds.rs_generator(n, m, device=dev))
    a, b = ops.split_factor(s // m)
    ell = a * b
    p16 = ops._bucket_planes(s, m, dev, bf16)
    p32 = ops._bucket_planes(s, m, dev)
    xr, xi = randn(q, s), randn(q, s)
    xc = torch.complex(xr, xi)
    truth = torch.fft.fft(xc.to(torch.complex128), dim=-1)
    masks = masks_for(q, n, m)
    fmasks = masks.to(torch.float32)
    g_host = (gr.cpu().numpy() + 1j * gi.cpu().numpy()).astype(np.complex64)
    dmats = DecodeMatrixCache(g_host).matrices(masks.cpu().numpy())
    dr, di = (torch.as_tensor(np.ascontiguousarray(x), device=dev)
              for x in (dmats.real, dmats.imag))
    flops_c2c = q * (m * fft_flops(ell)
                     + ell * (2 * 8 * m * m + 6 * m + fft_flops(m)))
    # x and the output, the masks, G; the bf16 tables of L and of s, F_m
    bytes_c2c = (F32 * (4 * q * s + q * n + 2 * n * m)
                 + tab16 * 2 * (ell + s + m * m))
    dbytes = F32 * (2 * q * m * n - q * n)
    entry("coded_fft_bucket_masked", csrc + "coded_bucket.cu",
          "src/repro/kernels/coded_pipeline.py:857",
          lambda: cp.coded_fft_bucket_masked(xr, xi, fmasks, gr, gi, *p16),
          lambda: cp.coded_fft_bucket_masked(xr, xi, fmasks, gr, gi, *p32),
          lambda: cp.bucket_body_masked(xr, xi, fmasks, gr, gi,
                                        *widened(p16)),
          lambda: torch.fft.fft(xc, dim=-1), truth, bytes_c2c, flops_c2c,
          50, [q, s, m, n])
    entry("coded_fft_bucket", csrc + "coded_bucket.cu",
          "src/repro/kernels/coded_pipeline.py:804",
          lambda: cp.coded_fft_bucket(xr, xi, dr, di, gr, gi, *p16),
          lambda: cp.coded_fft_bucket(xr, xi, dr, di, gr, gi, *p32),
          lambda: cp.bucket_body(xr, xi, dr, di, gr, gi, *widened(p16)),
          lambda: torch.fft.fft(xc, dim=-1), truth, bytes_c2c + dbytes,
          flops_c2c, 50, [q, s, m, n])
    del xr, xi, xc, truth
    n2 = s // m // 2
    sh = s // 2 + 1
    r16, r32 = (ops._rbucket_planes(s, m, dev, dt)
                for dt in (bf16, torch.float32))
    i16, i32 = (ops._irbucket_planes(s, m, dev, dt)
                for dt in (bf16, torch.float32))
    xreal = randn(q, s)
    rtruth = torch.fft.rfft(xreal.double(), dim=-1)
    yhalf = torch.fft.rfft(randn(q, s), dim=-1)
    yr, yi = yhalf.real.contiguous(), yhalf.imag.contiguous()
    itruth = torch.fft.irfft(yhalf.to(torch.complex128), n=s, dim=-1)
    flops_real = q * (m * fft_flops(n2) + n2 * 2 * 8 * m * m + m * n2 * 16
                      + 2 * n2 * m * (6 + 8 * (m // 2 + 1)))
    # beside the requests, the output and G: r2c the bf16 table of n2,
    # split twiddle, recombine twiddle and DFT rows; c2r the table, pack
    # twiddle, m-point DFT and the t <= n2 positions of its twiddle
    bytes_r2c = (F32 * (q * s + 2 * n * m + 2 * q * sh)
                 + tab16 * (2 * n2 + 2 * (n2 + 1) + 2 * m * 2 * n2
                            + 2 * (m // 2 + 1) * m))
    bytes_c2r = (F32 * (2 * q * sh + 2 * n * m + q * s)
                 + tab16 * (2 * n2 + 2 * (n2 + 1) + 2 * m * (n2 + 1)
                            + 2 * m * m))
    for name, src, line, w, wbytes, dec, body, args16, args32, lib, tr in (
            ("coded_rfft_bucket_masked", "coded_rbucket.cu", 510,
             cp.coded_rfft_bucket_masked, bytes_r2c + q * n, (masks,),
             cp.rbucket_body_masked, r16, r32,
             lambda: torch.fft.rfft(xreal, dim=-1), rtruth),
            ("coded_rfft_bucket", "coded_rbucket.cu", 447,
             cp.coded_rfft_bucket, bytes_r2c + F32 * 2 * q * m * n,
             (dr, di), cp.rbucket_body, r16, r32,
             lambda: torch.fft.rfft(xreal, dim=-1), rtruth),
            ("coded_irfft_bucket_masked", "coded_irbucket.cu", 768,
             cp.coded_irfft_bucket_masked, bytes_c2r + q * n, (masks,),
             cp.irbucket_body_masked, i16, i32,
             lambda: torch.fft.irfft(yhalf, n=s, dim=-1), itruth),
            ("coded_irfft_bucket", "coded_irbucket.cu", 721,
             cp.coded_irfft_bucket, bytes_c2r + F32 * 2 * q * m * n,
             (dr, di), cp.irbucket_body, i16, i32,
             lambda: torch.fft.irfft(yhalf, n=s, dim=-1), itruth)):
        data = (xreal,) if name.startswith("coded_rfft") else (yr, yi)
        pdec = tuple(d.to(torch.float32) if d.dtype == torch.bool else d
                     for d in dec)
        entry(name, csrc + src, f"src/repro/kernels/coded_pipeline.py:{line}",
              lambda: w(*data, *dec, gr, gi, *args16, s),
              lambda: w(*data, *dec, gr, gi, *args32, s),
              lambda: body(*data, *pdec, gr, gi, *widened(args16), s),
              lib, tr, wbytes, flops_real, 50, [q, s, m, n])
    del xreal, yhalf, yr, yi, rtruth, itruth

    # the streaming c2c bucket, both modes: 16 requests of 2^20
    q, s = 16, 1 << 20
    a, b = ops.split_factor(s // m)
    ell = a * b
    s16, s32 = (ops._bucket_planes(s, m, dev, dt)
                for dt in (bf16, torch.float32))
    xr, xi = randn(q, s), randn(q, s)
    xc = torch.complex(xr, xi)
    truth = torch.fft.fft(xc.to(torch.complex128), dim=-1)
    smasks = masks_for(q, n, m)
    fsm = smasks.to(torch.float32)
    dmats = DecodeMatrixCache(g_host).matrices(smasks.cpu().numpy())
    dr, di = (torch.as_tensor(np.ascontiguousarray(x), device=dev)
              for x in (dmats.real, dmats.imag))
    flops_s = q * (m * fft_flops(ell)
                   + ell * (2 * 8 * m * m + 6 * m + fft_flops(m)))
    # W, the bf16 tables of A and B, the recombine twiddle and F_m
    tabs = tab16 * 2 * (a * b + a + b + m * ell + m * m)
    entry("coded_fft_bucket_streaming", csrc + "coded_bucket_streaming.cu",
          "src/repro/kernels/coded_pipeline.py:1086",
          lambda: cp.coded_fft_bucket_streaming(xr, xi, dr, di, gr, gi,
                                                *s16),
          lambda: cp.coded_fft_bucket_streaming(xr, xi, dr, di, gr, gi,
                                                *s32),
          lambda: cp.bucket_body(xr, xi, dr, di, gr, gi, *widened(s16)),
          lambda: torch.fft.fft(xc, dim=-1), truth,
          F32 * (4 * q * s + 2 * q * m * n - q * n + 2 * n * m) + tabs,
          flops_s, 5, [q, s, m, n])
    entry("coded_fft_bucket_streaming_masked",
          csrc + "coded_bucket_streaming.cu",
          "src/repro/kernels/coded_pipeline.py:1086",
          lambda: cp.coded_fft_bucket_streaming_masked(xr, xi, smasks, gr,
                                                       gi, *s16),
          lambda: cp.coded_fft_bucket_streaming_masked(xr, xi, smasks, gr,
                                                       gi, *s32),
          lambda: cp.bucket_body_masked(xr, xi, fsm, gr, gi, *widened(s16)),
          lambda: torch.fft.fft(xc, dim=-1), truth,
          F32 * (4 * q * s + q * n + 2 * n * m) + tabs, flops_s, 5,
          [q, s, m, n])
    del xr, xi, xc, truth, dr, di
    torch.cuda.empty_cache()

    # -- the four-step entries: 512 rows of L = 1024, 128 of L = 2^18 ------
    nrows, a, b = 512, 32, 32
    ell = a * b
    x3r, x3i = randn(nrows, a, b), randn(nrows, a, b)
    f16 = ops._fourstep_planes(a, b, dev, bf16)
    f32p = ops._fourstep_planes(a, b, dev)
    truth = torch.fft.fft(torch.complex(x3r, x3i).reshape(nrows, ell)
                          .to(torch.complex128), dim=-1)
    xc = torch.complex(x3r, x3i).reshape(nrows, ell)

    def scrambled(o):    # out[c, d] = X[c + d*A]
        return c128(o).transpose(-1, -2).reshape(o[0].shape[0], -1)

    entry("fourstep_fused", csrc + "fft_block.cuh",
          "src/repro/kernels/fourstep_fft.py:117",
          lambda: ff.fourstep_fused(x3r, x3i, *f16),
          lambda: ff.fourstep_fused(x3r, x3i, *f32p),
          lambda: ff.fourstep_body(x3r, x3i, *widened(f16)),
          lambda: torch.fft.fft(xc, dim=-1), truth,
          F32 * 4 * nrows * ell + tab16 * 2 * ell, nrows * fft_flops(ell),
          50, [nrows, a, b], natural=scrambled)
    # multistep block mode on the same rows, plan (16, 16, 4)
    factors = (16, 16, 4)
    m16 = ops._on_device(ops._multistep_planes, (factors,), dev, bf16)
    m32 = ops._on_device(ops._multistep_planes, (factors,), dev)
    x2r, x2i = x3r.reshape(nrows, ell), x3i.reshape(nrows, ell)

    def digits(fs):      # the k-digit scrambled order, reversed
        perm = (0, *range(len(fs), 0, -1))
        return lambda o: c128(o).reshape(-1, *fs).permute(perm).reshape(
            o[0].shape[0], -1)

    entry("multistep_fused", csrc + "fft_block.cuh",
          "src/repro/kernels/fourstep_fft.py:374",
          lambda: ff.multistep_fused(x2r, x2i, m16, factors),
          lambda: ff.multistep_fused(x2r, x2i, m32, factors),
          lambda: ff.multistep_body(x2r, x2i, ff._parse_stage_planes(
              factors, widened(m16))),
          lambda: torch.fft.fft(xc, dim=-1), truth,
          F32 * 4 * nrows * ell + tab16 * 2 * ell, nrows * fft_flops(ell),
          50, [nrows, ell, *factors], natural=digits(factors),
          mode=ff.multistep_mode(factors))
    del x3r, x3i, x2r, x2i, xc, truth
    nrows, a, b = 128, 512, 512
    ell = a * b
    x3r, x3i = randn(nrows, a, b), randn(nrows, a, b)
    far, fai, wr, wi, fbr, fbi = f16 = ops._fourstep_planes(a, b, dev, bf16)
    f32p = ops._fourstep_planes(a, b, dev)
    x128 = torch.complex(x3r, x3i).to(torch.complex128)
    truth = torch.fft.fft(x128.reshape(nrows, ell), dim=-1)
    xc = torch.complex(x3r, x3i).reshape(nrows, ell)
    entry("fourstep_streaming", csrc + "fourstep.cu",
          "src/repro/kernels/fourstep_fft.py:533",
          lambda: ff.fourstep_streaming(x3r, x3i, *f16),
          lambda: ff.fourstep_streaming(x3r, x3i, *f32p),
          lambda: ff.fourstep_streaming_body(x3r, x3i, *widened(f16)),
          lambda: torch.fft.fft(xc, dim=-1), truth,
          F32 * 4 * nrows * ell + tab16 * 2 * (a * b + a + b),
          nrows * fft_flops(ell), 3, [nrows, a, b],
          natural=lambda o: c128(o).reshape(nrows, -1))
    # stage 1: the twiddled column DFT, its truth in complex128
    cc, bb = torch.meshgrid(torch.arange(a, device=dev),
                            torch.arange(b, device=dev), indexing="ij")
    w128 = torch.exp(-2j * math.pi * (cc * bb).double() / ell)
    t1truth = torch.fft.fft(x128, dim=1) * w128
    entry("fourstep_stage1", csrc + "fourstep.cu",
          "src/repro/kernels/fourstep_fft.py:243",
          lambda: ff.fourstep_stage1(x3r, x3i, far, fai, wr, wi),
          lambda: ff.fourstep_stage1(x3r, x3i, *f32p[:4]),
          lambda: ff.stage1_body(x3r, x3i, *widened((far, fai, wr, wi))),
          None, t1truth,
          F32 * 4 * nrows * ell + tab16 * 2 * (a * a + a * b),
          nrows * (b * fft_flops(a) + 6 * ell), 3, [nrows, a, b])
    del t1truth, w128, cc, bb
    t1r, t1i = ff.fourstep_stage1(x3r, x3i, *f32p[:4])
    t1c = torch.complex(t1r, t1i)
    t2truth = torch.fft.fft(t1c.to(torch.complex128), dim=-1)
    fb16 = widened((fbr, fbi))
    entry("fourstep_stage2", csrc + "fourstep.cu",
          "src/repro/kernels/fourstep_fft.py:281",
          lambda: ff.fourstep_stage2(t1r, t1i, precision="bf16"),
          lambda: ff.fourstep_stage2(t1r, t1i),
          lambda: ff.stage2_body(t1r, t1i, *fb16),
          lambda: torch.fft.fft(t1c, dim=-1), t2truth,
          F32 * 4 * nrows * ell + tab16 * 2 * b,
          nrows * a * fft_flops(b), 3, [nrows, a, b])
    del t1r, t1i, t1c, t2truth
    # multistep per-stage mode on the same rows, plan (64, 64, 64)
    factors = (64, 64, 64)
    m16 = ops._on_device(ops._multistep_planes, (factors,), dev, bf16)
    m32 = ops._on_device(ops._multistep_planes, (factors,), dev)
    st16 = ff._parse_stage_planes(factors, m16)
    x2r, x2i = x3r.reshape(nrows, ell), x3i.reshape(nrows, ell)
    entry("multistep_fused", csrc + "multistep.cu",
          "src/repro/kernels/fourstep_fft.py:374",
          lambda: ff.multistep_fused(x2r, x2i, m16, factors),
          lambda: ff.multistep_fused(x2r, x2i, m32, factors),
          lambda: ff.multistep_body(x2r, x2i, ff._parse_stage_planes(
              factors, widened(m16))),
          lambda: torch.fft.fft(xc, dim=-1), truth,
          F32 * 4 * nrows * ell
          + tab16 * (sum(2 * st[2].numel() for st in st16[:-1])
                     + 2 * sum(factors)),
          nrows * fft_flops(ell), 3, [nrows, ell, *factors],
          natural=digits(factors), mode=ff.multistep_mode(factors))
    del x3r, x3i, x2r, x2i, xc, truth, x128
    torch.cuda.empty_cache()
    kernels_s = time.perf_counter() - t_start

    # -- (b) the main paths ------------------------------------------------
    backend = autotune.backend_of(dev)
    if any(k.startswith("bf16|") for k in autotune.load_table(backend)):
        fail("the bf16 phase's autotune table is not empty")
    expect = {
        (True, "c2c"): {"coded_fft_bucket_masked[bf16]": 1},
        (True, "r2c"): {"coded_rfft_bucket_masked[bf16]": 1},
        (True, "c2r"): {"coded_irfft_bucket_masked[bf16]": 1},
        (False, "c2c"): {"coded_fft_bucket[bf16]": 1},
        (False, "r2c"): {"coded_rfft_bucket[bf16]": 1},
        (False, "c2r"): {"coded_irfft_bucket[bf16]": 1}}
    cells = [(kind, 4096, 64, dd) for dd in (True, False)
             for kind in ("c2c", "r2c", "c2r")]
    cells += [("c2c", 1 << 20, 16, dd) for dd in (True, False)]
    services = []
    for kind, s, n_req, dd in cells:
        svcs = {p: FFTService(FFTServiceConfig(
            s=s, device_decode=dd, autotune=False, seed=11, precision=p))
            for p in ("bf16", "f32")}
        xt = randn(n_req, s)
        if kind == "c2c":
            x = torch.complex(xt, randn(n_req, s))
            want = torch.fft.fft(x.to(torch.complex128), dim=-1)
        elif kind == "r2c":
            x, want = xt, torch.fft.rfft(xt.double(), dim=-1)
        else:
            x = torch.fft.rfft(xt, dim=-1)
            want = torch.fft.irfft(x.to(torch.complex128), n=s, dim=-1)
        xs = list(x.cpu().numpy())
        t0 = time.perf_counter()
        svcs["bf16"].submit_batch(xs, kind=kind)      # probes the verdict
        first = time.perf_counter() - t0
        verdict = autotune.lookup("bf16", backend=backend, s=s, m=4, k=kind,
                                  mode="kernel")
        if verdict != {"ok": True}:
            fail(f"bf16 verdict of ({s}, {kind}): {verdict}")
        if s > 4096:
            exp = ({"coded_fft_bucket_streaming_masked[bf16]": 4} if dd
                   else {"coded_fft_bucket_streaming[bf16]": 3})
        else:
            exp = expect[(dd, kind)]
        out, counts = counted(lambda: svcs["bf16"].submit_batch(xs,
                                                                kind=kind))
        if counts != exp:
            fail(f"bf16 service {kind} s={s} device_decode={dd}: "
                 f"launches {counts}, expected {exp}")
        out32 = svcs["f32"].submit_batch(xs, kind=kind)
        got = torch.as_tensor(np.stack(out), device=dev)
        err = float((got.to(want.dtype) - want).abs().max()
                    / want.abs().max())
        diff = float(np.abs(np.stack(out) - np.stack(out32)).max())
        if not (err < tol and diff > 0):
            fail(f"bf16 service {kind} s={s}: rel err {err} (tol {tol}), "
                 f"{diff} from the f32 service")
        ms = {}
        for _ in range(3):       # the two services in turns
            for p, svc in svcs.items():
                t0 = time.perf_counter()
                svc.submit_batch(xs, kind=kind)
                ms.setdefault(p, []).append(
                    (time.perf_counter() - t0) * 1e3)
        cell = {"kind": kind, "s": s, "requests": n_req,
                "decode": "device" if dd else "host", "verdict": verdict,
                "launches": counts, "rel_err": err, "rel_tol": tol,
                "diff_from_f32": diff, "first_call_s": first,
                "ms": float(np.median(ms["bf16"])),
                "f32_ms": float(np.median(ms["f32"])),
                "ms_calls": ms["bf16"], "f32_ms_calls": ms["f32"]}
        emit({"phase": "bf16_service", **cell})
        services.append(cell)
        del svcs, x, xt, want, got
        torch.cuda.empty_cache()
    verdicts = {k: v for k, v in autotune.load_table(backend).items()
                if k.startswith("bf16|")}
    if len(verdicts) != 4 or any(v != {"ok": True}
                                 for v in verdicts.values()):
        fail(f"bf16 verdicts probed in this call: {verdicts}")

    # fourstep_planar at bf16: the four-step rows through the dispatch op
    for ell, nrows, kw, exp, mode in (
            (1024, 512, dict(variant="fused"), {"fourstep_fused[bf16]": 1},
             None),
            (1 << 18, 128, dict(variant="two_pass"),
             {"fourstep_stage1[bf16]": 1, "fourstep_stage2[bf16]": 1}, None),
            (1 << 18, 128, dict(variant="streaming"),
             {"fourstep_streaming[bf16]": 2}, None),
            (1024, 512, dict(variant="fused", factors=(16, 16, 4)),
             {"multistep_fused[bf16]": 1}, "block"),
            (1 << 18, 128, dict(variant="fused", factors=(64, 64, 64)),
             {"multistep_fused[bf16]": 3}, "per_stage")):
        xr, xi = randn(nrows, ell), randn(nrows, ell)
        want = torch.fft.fft(torch.complex(xr, xi).to(torch.complex128),
                             dim=-1)
        out, counts = counted(lambda: ops.fourstep_planar(
            xr, xi, precision="bf16", **kw), ms_mode=mode)
        err = rel(out, want)
        if counts != exp or not err < tol:
            fail(f"fourstep_planar bf16 {kw} L={ell}: launches {counts}, "
                 f"rel err {err}")
        emit({"phase": "bf16_fourstep_planar", "L": ell, "rows": nrows,
              **{k: list(v) if isinstance(v, tuple) else v
                 for k, v in kw.items()},
              "launches": counts, "rel_err": err, "rel_tol": tol})
        del xr, xi, want, out
    torch.cuda.empty_cache()
    emit({"phase": "bf16_planes", "kernel_rows_s": kernels_s,
          "seconds": time.perf_counter() - t_start,
          "rows": [{"name": r["name"], "shape": r["shape"], "ms": r["ms"],
                    "f32_ms": r["f32_ms"], "ms_over_f32": r["ms_over_f32"],
                    "bound_ms": r["bound_ms"],
                    "rel_err_oracle": r["rel_err_oracle"]} for r in rows],
          "services": [{k: c[k] for k in ("kind", "s", "decode", "ms",
                                          "f32_ms", "rel_err")}
                       for c in services],
          "verdicts": verdicts})


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    import numpy as np

    from repro_torch import (
        CodedFFT,
        CodedIRFFT,
        CodedRFFT,
        FFTService,
        FFTServiceConfig,
    )
    from repro_torch.kernels import _build, autotune, coded_pipeline, ops
    from repro_torch.kernels.cmatmul import (
        bcmatmul,
        bcmatmul_body,
        cmatmul,
        cmatmul_body,
    )
    from repro_torch.kernels.fourstep_fft import (
        encode_fourstep_body,
        encode_fourstep_fused,
        encode_rows_fold,
        encode_rows_per_block,
        fft_cols_tile,
        fft_rows_per_block,
        fft_rows_plan,
        fourstep_body,
        fourstep_fused,
        fourstep_stage1,
        fourstep_stage2,
        fourstep_streaming,
        fourstep_streaming_body,
        multistep_body,
        multistep_fused,
        multistep_mode,
        multistep_stage_plan,
        stage1_body,
        stage2_body,
    )
    from repro_torch.kernels.fourstep_fft import (
        _encode_on_card,
        _parse_stage_planes,
    )
    from repro_torch.kernels.recombine import (
        recombine_batched_body,
        recombine_body,
        recombine_design,
        recombine_twiddle_dft,
        recombine_twiddle_dft_batched,
    )
    from repro_torch.kernels.wkv import design as wkv_design
    from repro_torch.kernels.wkv import wkv, wkv_body, wkv_cost
    from repro_torch.serving import DecodeMatrixCache

    dev = torch.device("cuda")
    t_start = time.perf_counter()

    def fresh_autotune_cache(name):
        """Point the autotune cache at an empty directory under build/
        and drop the in-memory table (a new process's state)."""
        path = ROOT / "build" / f"autotune-{name}-{os.getpid()}"
        shutil.rmtree(path, ignore_errors=True)
        os.environ["REPRO_AUTOTUNE_CACHE"] = str(path)
        autotune.clear()
        return path

    fresh_autotune_cache("smoke")
    # -- 1. device --------------------------------------------------------
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "nvidia_smi": smi, "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "allow_tf32": {"matmul": False, "cudnn": False}})

    # -- 2. build (parallel nvcc, one per source) -------------------------
    t0 = time.perf_counter()
    built = _build.build()
    optin = coded_pipeline.device_smem_optin(0)
    if optin != ops.SMEM_PER_BLOCK_OPTIN:
        fail(f"cudaDevAttrMaxSharedMemoryPerBlockOptin {optin} != the "
             f"gate's SMEM_PER_BLOCK_OPTIN {ops.SMEM_PER_BLOCK_OPTIN}")
    ptxas = {name: ptxas_report(_build.log_path(name))
             for name in _build.SOURCES}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "built": sorted(built), "dir": str(_build.build_dir().name),
          "smem_per_block_optin": optin, "ptxas": ptxas})
    # the Stockham FFT kernels' registers and spills, in each library that
    # builds them (fft_cols_kernel: the column pass of stage 1, of the
    # encode, of both streaming kernels and of multistep's stages;
    # encode_rows_kernel: the encode's row FFT with G in its store;
    # coded_bucket_kernel, coded_rbucket_kernel and coded_irbucket_kernel:
    # the whole c2c, r2c and c2r buckets on the row FFT's passes;
    # fft_block_kernel: fourstep_fused and multistep's block mode -- these
    # four must not spill) and the recombine's two designs
    fft_ptxas = {
        name: [ln for ln in ptxas[name] if "fft_cols" in ln
               or "fft_rows" in ln or "encode_rows" in ln
               or "fft_block_kernel" in ln
               or "coded_bucket_kernel" in ln
               or "coded_rbucket_kernel" in ln
               or "coded_irbucket_kernel" in ln
               or "recombine" in ln]
        for name in ("fourstep", "coded_bucket_streaming",
                     "encode_fourstep", "coded_bucket", "coded_rbucket",
                     "coded_irbucket", "multistep", "recombine")}
    emit({"phase": "ptxas_fft", **fft_ptxas})
    # sixteen bucket instances: MM in 4, 8, 16, 32, masked and planes, f32
    # and bf16 tables; two fft_block_kernel (f32, bf16) in each library
    # that launches it; the recombine's tile design at MM in 4, 8, 16, 32,
    # 64
    for libs, kernel, instances in (
            (("coded_bucket",), "coded_bucket_kernel", 16),
            (("coded_rbucket",), "coded_rbucket_kernel", 16),
            (("coded_irbucket",), "coded_irbucket_kernel", 16),
            (("fourstep", "multistep"), "fft_block_kernel", 4),
            (("recombine",), "recombine_tile_kernel", 5)):
        lines = [ln for lib in libs for ln in fft_ptxas[lib]
                 if kernel in ln]
        spills = [ln for ln in lines if " 0 bytes spill stores" not in ln]
        if spills or len(lines) != instances:
            fail(f"{kernel}: {len(lines)} instances reported, spills: "
                 f"{spills}")
    # every bf16 instance beside its f32 twin: it must not spill where
    # the twin does not (nor spill more)
    bf16_spills = bf16_twin_spills(ptxas)
    emit({"phase": "ptxas_bf16", "pairs": len(bf16_spills),
          "worse": [r for r in bf16_spills if r["worse"]]})
    if not bf16_spills or any(r["worse"] for r in bf16_spills):
        fail(f"bf16 instances against their f32 twins: {bf16_spills}")
    # the WKV kernel: one instance (K <= 64 masked past K), no spill
    wkv_lines = [ln for ln in ptxas["wkv"] if "wkv_kernel" in ln]
    emit({"phase": "ptxas_wkv", "wkv": wkv_lines})
    if (len(wkv_lines) != 1
            or " 0 bytes spill stores" not in wkv_lines[0]):
        fail(f"wkv_kernel: {len(wkv_lines)} instances reported, "
             f"{wkv_lines}")

    rng = np.random.default_rng(0)
    spin_rate = spin_cycles_per_ms(torch)

    def randn(*shape):
        return torch.as_tensor(rng.standard_normal(shape).astype(np.float32),
                               device=dev)

    def service_masks(q, n, m):
        # the service's own mask law: the fastest m of n shifted-exponential
        # draws respond
        lat = rng.exponential(1.0, size=(q, n))
        kth = np.sort(lat, axis=1)[:, m - 1:m]
        return torch.as_tensor(lat <= kth, device=dev)

    # the recombine's two designs forced at m = 4..64: the timings its
    # route by m (recombine.recombine_design) is chosen from
    emit({"phase": "recombine_designs",
          "rows": recombine_crossover(torch, randn, spin_rate)})

    def recombine_library_planes(planes):
        """The recombine's (m, L) twiddle and (m, m) DFT as complex
        tensors, for the library call (an einsum)."""
        wr, wi, fr, fi = planes
        return torch.complex(wr, wi), torch.complex(fr, fi)

    table = []

    def measure(name, run, plain, library, tol, nbytes, flops, reps,
                flush=None, windows=1):
        """Check ``run`` against ``plain`` on the card and time both and
        the library call (None where no one PyTorch call computes the
        same function).  ``flush`` (a tensor): each time is taken L2-cold,
        every call after a write of ``flush`` (the write's own time
        subtracted), and the warm kernel time is kept as ``l2_warm_ms``.
        ``windows`` > 1: each time is the median of that many windows of
        ``reps`` calls, their min and max beside it (``<key>_min``,
        ``<key>_max``), for kernels short enough that one window reads
        apart from the next."""
        got = run()
        want = plain()
        torch.cuda.synchronize()
        abs_err, rel_err = compare(torch, got, want)
        if not rel_err < tol:
            fail(f"{name}: kernel vs plain rel err {rel_err} >= {tol}")
        bound_ms, bound_by = bound(nbytes, flops)

        def timed(f):
            if flush is None:
                return time_ms(torch, f, reps, spin_rate)
            return (time_ms(torch, lambda: (flush.zero_(), f()), reps,
                            spin_rate)
                    - time_ms(torch, flush.zero_, reps, spin_rate))

        def spread(key, f):
            ts = sorted(timed(f) for _ in range(windows))
            return ({key: ts[len(ts) // 2]} if windows == 1 else
                    {key: ts[len(ts) // 2], f"{key}_min": ts[0],
                     f"{key}_max": ts[-1]})

        warm = ({} if flush is None
                else {"l2_warm_ms": time_ms(torch, run, reps, spin_rate)})
        return {"max_abs_err": abs_err, "max_rel_err": rel_err, "tol": tol,
                **spread("ms", run), **spread("plain_ms", plain),
                "bound_ms": bound_ms, "bound_by": bound_by,
                **(spread("library_ms", library) if library
                   else {"library_ms": None}),
                **warm}

    def kernel_row(name, source, replaces, run, plain, library, tol, nbytes,
                   flops, reps, shape, yardsticks=(), into=table, flush=None,
                   windows=1, plan=None, **info):
        """Measure one kernel and add its row to ``into``.  ``info`` adds
        measured values and labels to the row, ``yardsticks`` timed calls;
        ``plan`` (the wrapper's own reckoning of its launch, which this
        run does not measure) is printed in the phase line only."""
        row = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces, "launches": 0,
               **measure(name, run, plain, library, tol, nbytes, flops,
                         reps, flush, windows),
               "shape": shape, **info,
               **{k: time_ms(torch, f, reps, spin_rate)
                  for k, f in yardsticks}}
        emit({"phase": "kernel", **row, **(plan or {})})
        into.append(row)

    def check_route(name, kernels, run, shape, **info):
        """One call of ``run`` counts as many launches under ``name`` as
        ``kernels`` (name fragment -> launches a call) lists in all, and
        one traced call ran exactly those: every kernel's name holds one
        of the fragments, and each fragment's kernels ran as often as it
        says.  Prints the trace's split beside ``info`` (the wrapper's own
        reckoning of the launch).  A trace that recorded fewer of the
        route's kernels and nothing else -- none at all included -- lost
        part of the call in the profiler, not the route (the profiler
        drops a kernel whose mapped device timestamp lands outside its
        window, the first kernels of a call most often, ``PERF.md`` §7;
        a process that has run the card for a while returns wholly
        empty traces now and then, for seconds at a time): it is taken
        again, at most six times, the margin four times wider each time
        up to 3.2 s (0.2, 0.8, then 3.2 s), and the retakes and the last
        margin are printed as ``empty_traces`` and ``trace_margin_s``.
        The last trace must show the route exactly."""
        before = _build.launch_counts().get(name, 0)
        run()
        torch.cuda.synchronize()
        got = _build.launch_counts().get(name, 0) - before

        def tally(names):
            ran, strays = dict.fromkeys(kernels, 0), {}
            for kernel, count in names.items():
                frag = next((f for f in kernels if f in kernel), None)
                if frag is None:
                    strays[kernel[:60]] = count
                else:
                    ran[frag] += count
            return ran, strays

        empty, margin = 0, TRACE_MARGIN_S
        split = profile_call(torch, run, track=tuple(kernels), names=True)
        ran, strays = tally(split.pop("kernel_names"))
        while (not strays and ran != kernels and empty < 6
               and all(ran[f] <= kernels[f] for f in kernels)):
            empty += 1
            margin = min(margin * 4, 3.2)
            split = profile_call(torch, run, track=tuple(kernels),
                                 names=True, margin_s=margin)
            ran, strays = tally(split.pop("kernel_names"))
        if got != sum(kernels.values()) or strays or ran != kernels:
            fail(f"{name} {shape}: {got} launches a call, traced {ran} and "
                 f"outside the route {strays} ({empty} empty traces retaken"
                 f", to a {margin} s margin); expected only {kernels}")
        emit({"phase": "kernel_split", "name": name, "shape": shape,
              "launches_per_call": got, "traced_launches": ran, **info,
              "empty_traces": empty, "trace_margin_s": margin, **split})

    def encode_route(fold):
        return "folded" if fold else "fall-back"

    def encode_kernels(fold):
        """The encode's kernels and their launches a call on each route:
        the column FFT, then the folded row FFT with G in its store, or
        the row FFT and the G apply."""
        return ({"fft_cols_kernel": 1, "encode_rows_kernel": 1} if fold
                else {"fft_cols_kernel": 1, "fft_rows_kernel": 1,
                      "bcmatmul_kernel": 1})

    csrc = "src/repro_torch/kernels/csrc/"
    # -- 3. each kernel against its plain version, at the service shapes --
    # (a) whole bucket: the default config, 64 requests of s=4096, m=4, N=8
    q, s, m, n = 64, 4096, 4, 8
    a, b = ops.split_factor(s // m)
    ell = a * b
    from repro_torch.core import mds
    from repro_torch.kernels import ref
    gr, gi = ref.planar(mds.rs_generator(n, m, device=dev))
    xr, xi = randn(q, s), randn(q, s)
    masks = service_masks(q, n, m)
    planes = (*ops._fourstep_planes(a, b, dev),
              *ops._on_device(ops._recombine_planes_scrambled,
                              (s, m, a, b), dev))
    xc = torch.complex(xr, xi)
    # least work: the m shard FFTs, then per payload position the m
    # responders' coded results, the decode, the twiddle and an m-point FFT
    # (the planes kernel's least work is the same: only the m live columns
    # of each request's scatter decode matrix are needed)
    flops_c2c = q * (m * fft_flops(ell)
                     + ell * (2 * 8 * m * m + 6 * m + fft_flops(m)))
    # what the card reads and writes: x and the output, the masks, G, the
    # f32 tables of L (the shard FFTs) and of s (the recombine twiddle)
    # and F_m -- no F_A, F_B, W or recombine plane
    nbytes_c2c = F32 * (4 * q * s + q * n + 2 * n * m
                        + 2 * (ell + s + m * m))
    kernel_row(
        "coded_fft_bucket_masked", csrc + "coded_bucket.cu",
        "src/repro/kernels/coded_pipeline.py:857",
        lambda: coded_pipeline.coded_fft_bucket_masked(
            xr, xi, masks, gr, gi, *planes),
        lambda: coded_pipeline.bucket_body_masked(
            xr, xi, masks.to(torch.float32), gr, gi, *planes),
        lambda: torch.fft.fft(xc, dim=-1), 3e-4, nbytes_c2c, flops_c2c, 50,
        [q, s, m, n], windows=7)
    fmasks = masks.to(torch.float32)
    check_route(
        "coded_fft_bucket_masked", {"coded_bucket_kernel": 1},
        lambda: coded_pipeline.coded_fft_bucket_masked(
            xr, xi, fmasks, gr, gi, *planes), [q, s, m, n], windows=7,
        group_rows=coded_pipeline.bucket_fft_group(m, ell),
        radix_plan=list(fft_rows_plan(ell)))

    # (a') the real kinds' whole buckets at the same config: packed shards
    # of L/2 = A*B, half spectra of s//2+1 bins
    n2 = s // m // 2
    a, b = ops.split_factor(n2)
    sh = s // 2 + 1
    hplanes = ops._fourstep_planes(a, b, dev)
    # least work of both: the m packed-shard FFTs, the coded results and
    # the decode at each packed position, the Hermitian split or pack of
    # each (shard, position), the recombine twiddle and the m//2+1-row
    # (or m-point) butterfly at each of the L positions of every shard
    flops_real = q * (m * fft_flops(n2) + n2 * 2 * 8 * m * m + m * n2 * 16
                      + 2 * n2 * m * (6 + 8 * (m // 2 + 1)))
    # what the card reads beside the requests, the output, the masks (as
    # bytes) and G: both kinds the f32 table of n2 (their shard FFTs, no
    # F_A, F_B or W) and the (n2+1)-entry split (or pack) twiddle; r2c the
    # (m, L) recombine twiddle and the m//2+1 DFT rows, c2r the m-point
    # DFT and of its (m, L) conjugate twiddle the positions t <= n2
    nbytes_r2c = F32 * (q * s + 2 * n * m + 2 * n2 + 2 * (n2 + 1)
                        + 2 * m * 2 * n2 + 2 * (m // 2 + 1) * m + 2 * q * sh)
    nbytes_c2r = F32 * (2 * q * sh + 2 * n * m + 2 * n2 + 2 * (n2 + 1)
                        + 2 * m * (n2 + 1) + 2 * m * m + q * s)
    xreal = randn(q, s)
    rplanes = (*hplanes, *ops._on_device(ops._r2c_postdecode_planes,
                                         (s, m), dev))
    kernel_row(
        "coded_rfft_bucket_masked", csrc + "coded_rbucket.cu",
        "src/repro/kernels/coded_pipeline.py:510",
        lambda: coded_pipeline.coded_rfft_bucket_masked(
            xreal, masks, gr, gi, *rplanes, s),
        lambda: coded_pipeline.rbucket_body_masked(
            xreal, masks.to(torch.float32), gr, gi, *rplanes, s),
        lambda: torch.fft.rfft(xreal, dim=-1), 1e-4, nbytes_r2c + q * n,
        flops_real, 50, [q, s, m, n], windows=7)
    rbucket_plan = {
        "group_rows": coded_pipeline.bucket_fft_group(
            m, n2, dft_rows=m // 2 + 1),
        "radix_plan": list(fft_rows_plan(n2))}
    check_route(
        "coded_rfft_bucket_masked", {"coded_rbucket_kernel": 1},
        lambda: coded_pipeline.coded_rfft_bucket_masked(
            xreal, masks, gr, gi, *rplanes, s), [q, s, m, n], windows=7,
        **rbucket_plan)
    yhalf = torch.fft.rfft(randn(q, s), dim=-1)
    yr, yi = yhalf.real.contiguous(), yhalf.imag.contiguous()
    iplanes = (*hplanes, *ops._on_device(ops._c2r_message_planes,
                                         (s, m), dev))
    kernel_row(
        "coded_irfft_bucket_masked", csrc + "coded_irbucket.cu",
        "src/repro/kernels/coded_pipeline.py:768",
        lambda: coded_pipeline.coded_irfft_bucket_masked(
            yr, yi, masks, gr, gi, *iplanes, s),
        lambda: coded_pipeline.irbucket_body_masked(
            yr, yi, masks.to(torch.float32), gr, gi, *iplanes, s),
        lambda: torch.fft.irfft(yhalf, n=s, dim=-1), 1e-4,
        nbytes_c2r + q * n, flops_real, 50, [q, s, m, n], windows=7)
    irbucket_plan = {
        "group_rows": coded_pipeline.bucket_fft_group(m, n2, side=2 * m),
        "radix_plan": rbucket_plan["radix_plan"]}
    check_route(
        "coded_irfft_bucket_masked", {"coded_irbucket_kernel": 1},
        lambda: coded_pipeline.coded_irfft_bucket_masked(
            yr, yi, masks, gr, gi, *iplanes, s), [q, s, m, n], windows=7,
        **irbucket_plan)

    # (a'') the host decode-matrix path's planes buckets, same config and
    # masks: each request's (m, N) scatter decode planes from the port's
    # LRU take the masks' place in the bytes
    g_host = (gr.cpu().numpy() + 1j * gi.cpu().numpy()).astype(np.complex64)
    dmats = DecodeMatrixCache(g_host).matrices(masks.cpu().numpy())
    dr, di = (torch.as_tensor(np.ascontiguousarray(p), device=dev)
              for p in (dmats.real, dmats.imag))
    dbytes = F32 * (2 * q * m * n - q * n)
    kernel_row(
        "coded_fft_bucket", csrc + "coded_bucket.cu",
        "src/repro/kernels/coded_pipeline.py:804",
        lambda: coded_pipeline.coded_fft_bucket(
            xr, xi, dr, di, gr, gi, *planes),
        lambda: coded_pipeline.bucket_body(xr, xi, dr, di, gr, gi, *planes),
        lambda: torch.fft.fft(xc, dim=-1), 3e-4, nbytes_c2c + dbytes,
        flops_c2c, 50, [q, s, m, n], windows=7)
    check_route(
        "coded_fft_bucket", {"coded_bucket_kernel": 1},
        lambda: coded_pipeline.coded_fft_bucket(
            xr, xi, dr, di, gr, gi, *planes), [q, s, m, n], windows=7)
    kernel_row(
        "coded_rfft_bucket", csrc + "coded_rbucket.cu",
        "src/repro/kernels/coded_pipeline.py:447",
        lambda: coded_pipeline.coded_rfft_bucket(
            xreal, dr, di, gr, gi, *rplanes, s),
        lambda: coded_pipeline.rbucket_body(
            xreal, dr, di, gr, gi, *rplanes, s),
        lambda: torch.fft.rfft(xreal, dim=-1), 1e-4,
        nbytes_r2c + F32 * 2 * q * m * n, flops_real, 50, [q, s, m, n],
        windows=7)
    check_route(
        "coded_rfft_bucket", {"coded_rbucket_kernel": 1},
        lambda: coded_pipeline.coded_rfft_bucket(
            xreal, dr, di, gr, gi, *rplanes, s), [q, s, m, n], windows=7,
        group_rows=coded_pipeline.bucket_fft_group(
            m, n2, n=n, masked=False, dft_rows=m // 2 + 1),
        radix_plan=rbucket_plan["radix_plan"])
    kernel_row(
        "coded_irfft_bucket", csrc + "coded_irbucket.cu",
        "src/repro/kernels/coded_pipeline.py:721",
        lambda: coded_pipeline.coded_irfft_bucket(
            yr, yi, dr, di, gr, gi, *iplanes, s),
        lambda: coded_pipeline.irbucket_body(
            yr, yi, dr, di, gr, gi, *iplanes, s),
        lambda: torch.fft.irfft(yhalf, n=s, dim=-1), 1e-4,
        nbytes_c2r + F32 * 2 * q * m * n, flops_real, 50, [q, s, m, n],
        windows=7)
    check_route(
        "coded_irfft_bucket", {"coded_irbucket_kernel": 1},
        lambda: coded_pipeline.coded_irfft_bucket(
            yr, yi, dr, di, gr, gi, *iplanes, s), [q, s, m, n], windows=7,
        group_rows=coded_pipeline.bucket_fft_group(
            m, n2, n=n, masked=False, side=2 * m),
        radix_plan=rbucket_plan["radix_plan"])
    del xreal, yhalf, yr, yi, dr, di, xr, xi, xc

    # (a''') the streaming c2c bucket: the host path's 2^20-point bucket
    # of 16 requests, past the planes gate, with its LRU decode planes.
    # Its FFT phases read W and the f32 tables of A and B (no F_A or F_B
    # plane): those are its bytes beside the request, D, G, the
    # recombine twiddle and F_m
    q, s, m, n = 16, 1 << 20, 4, 8
    assert ops.bucket_route(s, m, n, "c2c", masked=False) == "streaming"
    a, b = ops.split_factor(s // m)
    ell = a * b
    xr, xi = randn(q, s), randn(q, s)
    xc = torch.complex(xr, xi)
    dmats = DecodeMatrixCache(g_host).matrices(
        service_masks(q, n, m).cpu().numpy())
    dr, di = (torch.as_tensor(np.ascontiguousarray(p), device=dev)
              for p in (dmats.real, dmats.imag))
    splanes = ops._bucket_planes(s, m, dev)
    kernel_row(
        "coded_fft_bucket_streaming", csrc + "coded_bucket_streaming.cu",
        "src/repro/kernels/coded_pipeline.py:1086",
        lambda: coded_pipeline.coded_fft_bucket_streaming(
            xr, xi, dr, di, gr, gi, *splanes),
        lambda: coded_pipeline.bucket_body(xr, xi, dr, di, gr, gi,
                                           *splanes),
        lambda: torch.fft.fft(xc, dim=-1), 3e-4,
        F32 * (4 * q * s + 2 * q * m * n - q * n + 2 * n * m
               + 2 * (a * b + a + b + m * ell + m * m)),
        q * (m * fft_flops(ell)
             + ell * (2 * 8 * m * m + 6 * m + fft_flops(m))),
        5, [q, s, m, n])
    # (a4) its masked mode: the device-decode path's 2^20-point bucket of
    # 16 requests, raw masks from the service's mask law (the decode
    # launch builds each request's planes from its mask row)
    assert ops.bucket_route(s, m, n, "c2c") == "streaming"
    smasks = service_masks(q, n, m)
    kernel_row(
        "coded_fft_bucket_streaming_masked",
        csrc + "coded_bucket_streaming.cu",
        "src/repro/kernels/coded_pipeline.py:1086",
        lambda: coded_pipeline.coded_fft_bucket_streaming_masked(
            xr, xi, smasks, gr, gi, *splanes),
        lambda: coded_pipeline.bucket_body_masked(
            xr, xi, smasks.to(torch.float32), gr, gi, *splanes),
        lambda: torch.fft.fft(xc, dim=-1), 1e-4,
        F32 * (4 * q * s + q * n + 2 * n * m
               + 2 * (a * b + a + b + m * ell + m * m)),
        q * (m * fft_flops(ell)
             + ell * (2 * 8 * m * m + 6 * m + fft_flops(m))),
        5, [q, s, m, n])
    del xr, xi, xc, dr, di, splanes, smasks
    torch.cuda.empty_cache()

    def stage_rows(q, s, m, n, dr, di, reps, into):
        """The three stage kernels at the shapes one stage-route bucket of
        ``q`` requests gives them, with that bucket's (q, m, N) scatter
        decode planes ``dr, di``."""
        a, b = ops.split_factor(s // m)
        ell = a * b
        cr, ci = randn(q, m, a, b), randn(q, m, a, b)
        fplanes = ops._fourstep_planes(a, b, dev)
        gr, gi = ref.planar(mds.rs_generator(n, m, device=dev))
        # least work: an FFT of each message shard, then the (N, m) encode
        flops = q * m * fft_flops(ell) + q * 8 * n * m * ell
        msg = torch.complex(cr, ci).reshape(q, m, ell)
        gc = torch.complex(gr, gi)
        # the card reads the shards, G, W and the f32 tables of A and B
        nbytes = F32 * (2 * q * m * ell + 2 * n * m
                        + 2 * (a * b + a + b) + 2 * q * n * ell)
        fold = encode_rows_fold(m, a, b)
        run = lambda: encode_fourstep_fused(cr, ci, gr, gi, *fplanes)
        kernel_row(
            "encode_fourstep_fused", csrc + "encode_fourstep.cu",
            "src/repro/kernels/fourstep_fft.py:187", run,
            lambda: encode_fourstep_body(cr, ci, gr, gi, *fplanes),
            None, 1e-4, nbytes, flops, reps[0], [q, m, a, b, n],
            # the FFT part alone, and the two library calls that compute
            # the same function (in natural order): the FFT, then G
            yardsticks=[("fft_ms", lambda: torch.fft.fft(msg, dim=-1)),
                        ("fft_then_cmatmul_ms", lambda: torch.matmul(
                            gc, torch.fft.fft(msg, dim=-1)))],
            into=into, encode_route=encode_route(fold))
        check_route(
            "encode_fourstep_fused", encode_kernels(fold), run,
            [q, m, a, b, n], encode_route=encode_route(fold),
            rows_per_block=(encode_rows_per_block(m, a, b) if fold
                            else None))
        del cr, ci, msg

        br, bi = randn(q, n, ell), randn(q, n, ell)
        dc, bc = torch.complex(dr, di), torch.complex(br, bi)
        # a sparse product: each request's decode matrix is zero in its
        # straggler columns, so only the responders' spectra are needed
        live = int(((dr != 0) | (di != 0)).any(dim=1).sum())
        kernel_row(
            "bcmatmul", csrc + "bcmatmul.cu",
            "src/repro/kernels/cmatmul.py:81",
            lambda: bcmatmul(dr, di, br, bi),
            lambda: bcmatmul_body(dr, di, br, bi),
            lambda: torch.bmm(dc, bc), 1e-5,
            F32 * 2 * (q * m * n + live * ell + q * m * ell),
            8 * m * live * ell, reps[1], [q, m, n, ell], live_columns=live,
            into=into)
        del br, bi, bc

        hr, hi = randn(q, m, ell), randn(q, m, ell)
        rplanes = ops._on_device(ops._recombine_planes, (s, m), dev)
        # the library call: out[q, j, l] = sum_k F[j, k] C[q, k, l] W[k, l]
        hc, wc, fc = (torch.complex(hr, hi),
                      *recombine_library_planes(rplanes))
        kernel_row(
            "recombine_twiddle_dft_batched", csrc + "recombine.cu",
            "src/repro/kernels/recombine.py:91",
            lambda: recombine_twiddle_dft_batched(hr, hi, *rplanes),
            lambda: recombine_batched_body(hr, hi, *rplanes),
            lambda: torch.einsum("qkl,kl,jk->qjl", hc, wc, fc), 1e-5,
            F32 * 2 * (2 * q * m * ell + m * ell + m * m),
            q * ell * (6 * m + fft_flops(m)), reps[1], [q, m, ell],
            into=into, windows=7,
            design=recombine_design(m))
        del hr, hi, hc

    # (b)-(d) the stage route of the 2^20-point service phase: 16 requests,
    # decode planes from the service's mask law
    q, s, m, n = 16, 1 << 20, 4, 8
    dr, di = ops.lagrange_scatter_planes(
        ops.mask_subsets(service_masks(q, n, m), m), n)
    stage_rows(q, s, m, n, dr, di, (5, 20), table)
    # (b')-(d') the same three at the widest code the host decode-matrix
    # path serves, m = 64, N = 128: one default bucket of 64 requests at
    # s = 4096 past the planes gate, its (128, 64) G and (64, 128) D planes
    # over the 48 KB a launch gets without opting in.  The decode planes
    # come from the port's LRU on evenly spread responders (the 64th roots
    # of unity): a random draw's f32 decode is too ill-conditioned to
    # compare two implementations at a fixed tolerance.
    m64_rows: list[dict] = []
    q, s, m, n = 64, 4096, 64, 128
    g64 = mds.rs_generator(n, m, device=dev).cpu().numpy()
    alt = np.arange(n) % 2 == 0
    dm64 = DecodeMatrixCache(g64).matrices(
        np.stack([np.roll(alt, i) for i in range(q)]))
    dr, di = (torch.as_tensor(np.ascontiguousarray(p), device=dev)
              for p in (dm64.real, dm64.imag))
    stage_rows(q, s, m, n, dr, di, (20, 20), m64_rows)
    del dr, di
    # the encode past its fold: m = 32 of N = 64 at A = B = 512 (a row
    # block of 16384 points, past a block's shared memory), 2 requests --
    # the row FFT, then the G apply: three launches a call -- against its
    # plain twin
    q, m, n, a, b = 2, 32, 64, 512, 512
    if encode_rows_fold(m, a, b):
        fail(f"encode_fourstep_fused ({m}, {b}) folds")
    cr, ci = randn(q, m, a, b), randn(q, m, a, b)
    fplanes = ops._fourstep_planes(a, b, dev)
    gr32, gi32 = ref.planar(mds.rs_generator(n, m, device=dev))
    msg, gc = torch.complex(cr, ci).reshape(q, m, a * b), torch.complex(
        gr32, gi32)
    run = lambda: encode_fourstep_fused(cr, ci, gr32, gi32, *fplanes)
    check_route("encode_fourstep_fused", encode_kernels(False), run,
                [q, m, a, b, n], encode_route=encode_route(False))
    emit({"phase": "kernel_check", "name": "encode_fourstep_fused",
          "shape": [q, m, a, b, n], "encode_route": encode_route(False),
          "fft_then_cmatmul_ms": time_ms(torch, lambda: torch.matmul(
              gc, torch.fft.fft(msg, dim=-1)), 3, spin_rate),
          **measure(
              "encode_fourstep_fused", run,
              lambda: encode_fourstep_body(cr, ci, gr32, gi32, *fplanes),
              None, 1e-4,
              F32 * (2 * q * m * a * b + 2 * n * m
                     + 2 * (a * b + a + b) + 2 * q * n * a * b),
              q * m * fft_flops(a * b) + q * 8 * n * m * a * b, 3)})
    del cr, ci, msg, fplanes
    torch.cuda.empty_cache()

    # the encode's fork, where both routes fit a block: the folded row
    # FFT (one block an SM past 4096 points a block) against the row FFT
    # and the G apply, each forced, each against the plain twin; the
    # gate's choice printed beside them
    for q, m, n, a, b in ((4, 16, 32, 512, 512), (4, 64, 128, 128, 128)):
        cr, ci = randn(q, m, a, b), randn(q, m, a, b)
        fplanes = ops._fourstep_planes(a, b, dev)
        gf = ref.planar(mds.rs_generator(n, m, device=dev))
        plain = encode_fourstep_body(cr, ci, *gf, *fplanes)
        fork = {}
        for folded in (True, False):
            got = _encode_on_card(cr, ci, *gf, fplanes[2], fplanes[3],
                                  folded)
            torch.cuda.synchronize()
            _, rel = compare(torch, got, plain)
            if not rel < 1e-4:
                fail(f"encode fork {[q, m, a, b, n]} folded={folded}: "
                     f"rel err {rel}")
            key = encode_route(folded).replace("-", "_")
            fork[f"{key}_max_rel_err"] = rel
            fork[f"{key}_ms"] = time_ms(
                torch, lambda: _encode_on_card(cr, ci, *gf, fplanes[2],
                                               fplanes[3], folded),
                5, spin_rate)
        emit({"phase": "encode_fold_fork", "shape": [q, m, a, b, n],
              "gate": encode_route(encode_rows_fold(m, a, b)),
              "points_a_block": m * encode_rows_per_block(m, a, b) * b,
              **fork})
        del cr, ci, fplanes, plain, got
    torch.cuda.empty_cache()

    # (e)-(h) the plan's kernels at the shapes CodedFFT.run gives them.
    # fourstep_fused: the s=4096 plan's worker, 64 requests x 8 workers.
    # The one-block kernel reads x and the L-point table (no F_A, W or F_B)
    # and writes the output; the row FFT alone on the same rows, stored in
    # natural order (fourstep_stage2's kernel), is timed beside it
    rows, a, b = 64 * 8, *ops.split_factor(4096 // 4)
    ell = a * b
    assert ops.fourstep_fusable(a, b)
    xr, xi = randn(rows, a, b), randn(rows, a, b)
    fplanes = ops._fourstep_planes(a, b, dev)
    xc = torch.complex(xr, xi).reshape(rows, ell)
    xr1, xi1 = xr.reshape(rows, 1, ell), xi.reshape(rows, 1, ell)
    run = lambda: fourstep_fused(xr, xi, *fplanes)
    kernel_row(
        "fourstep_fused", csrc + "fft_block.cuh",
        "src/repro/kernels/fourstep_fft.py:117", run,
        lambda: fourstep_body(xr, xi, *fplanes),
        lambda: torch.fft.fft(xc, dim=-1), 1e-4,
        F32 * (4 * rows * ell + 2 * ell), rows * fft_flops(ell), 50,
        [rows, a, b], windows=7,
        yardsticks=[("row_fft_ms", lambda: fourstep_stage2(xr1, xi1))])
    check_route("fourstep_fused", {"fft_block_kernel": 1}, run,
                [rows, a, b], radix_plan=list(fft_rows_plan(ell)),
                rows_per_block=fft_rows_per_block(ell))
    del xr, xi, xc, xr1, xi1

    # the two-pass pair: the s=2^20 plan's worker, 16 requests x 8 workers
    rows, a, b = 16 * 8, *ops.split_factor((1 << 20) // 4)
    ell = a * b
    assert not ops.fourstep_fusable(a, b)
    xr, xi = randn(rows, a, b), randn(rows, a, b)
    far, fai, wr, wi, fbr, fbi = ops._fourstep_planes(a, b, dev)
    t1r, t1i = fourstep_stage1(xr, xi, far, fai, wr, wi)
    xc = torch.complex(xr, xi).reshape(rows, ell)
    # the pair as one function: in, out, all three planes, the FFT's work
    pair = measure(
        "fourstep_stage1+2",
        lambda: fourstep_stage2(*fourstep_stage1(xr, xi, far, fai, wr, wi)),
        lambda: stage2_body(*stage1_body(xr, xi, far, fai, wr, wi),
                            fbr, fbi),
        lambda: torch.fft.fft(xc, dim=-1), 1e-4,
        F32 * (4 * rows * ell + 2 * (a * a + a * b + b * b)),
        rows * fft_flops(ell), 3)
    emit({"phase": "kernel_pair", "names": ["fourstep_stage1",
                                            "fourstep_stage2"],
          "shape": [rows, a, b], **pair})
    # the streaming four-step on the same rows: two column FFTs, the
    # first storing transposed, natural order (rows, B, A) out -- exactly
    # torch.fft.fft.  It reads W and the f32 tables of A and B.
    kernel_row(
        "fourstep_streaming", csrc + "fourstep.cu",
        "src/repro/kernels/fourstep_fft.py:533",
        lambda: fourstep_streaming(xr, xi, far, fai, wr, wi, fbr, fbi),
        lambda: fourstep_streaming_body(xr, xi, far, fai, wr, wi, fbr, fbi),
        lambda: torch.fft.fft(xc, dim=-1), 1e-4,
        F32 * (4 * rows * ell + 2 * (a * b + a + b)),
        rows * fft_flops(ell), 3, [rows, a, b],
        plan={"radix_plans": [list(fft_rows_plan(a)),
                              list(fft_rows_plan(b))],
              "tiles": [fft_cols_tile(a, b), fft_cols_tile(b, a)]})
    pair_info = {f"pair_{k}": v for k, v in pair.items()
                 if k in ("ms", "plain_ms", "bound_ms", "bound_by",
                          "library_ms", "max_rel_err")}
    # stage 1: B column DFTs of A points and the twiddle, per row
    kernel_row(
        "fourstep_stage1", csrc + "fourstep.cu",
        "src/repro/kernels/fourstep_fft.py:243",
        lambda: fourstep_stage1(xr, xi, far, fai, wr, wi),
        lambda: stage1_body(xr, xi, far, fai, wr, wi), None, 1e-4,
        F32 * (4 * rows * ell + 2 * (a * a + a * b)),
        rows * (b * fft_flops(a) + 6 * ell), 3, [rows, a, b], **pair_info)
    del xc
    # stage 2: A row DFTs of B points per row -- exactly torch.fft.fft
    # over the last axis of the (rows, A, B) column-pass result; the row
    # FFT of fft_rows.cuh reads the rows and a B-entry twiddle table
    t1c = torch.complex(t1r, t1i)
    kernel_row(
        "fourstep_stage2", csrc + "fourstep.cu",
        "src/repro/kernels/fourstep_fft.py:281",
        lambda: fourstep_stage2(t1r, t1i),
        lambda: stage2_body(t1r, t1i, fbr, fbi),
        lambda: torch.fft.fft(t1c, dim=-1), 1e-4,
        F32 * (4 * rows * ell + 2 * b), rows * a * fft_flops(b), 3,
        [rows, a, b], plan={"radix_plan": list(fft_rows_plan(b))},
        **pair_info)
    del xr, xi, t1r, t1i, t1c
    # the row FFT at a mixed radix (B = 384: 8, 4, 4, 3; the two-pass
    # split of L = 384^2) and at the largest prime B of the two-pass route
    # (L = 8 * 4093: one dense 4093-point pass), against the dense product
    for rows, a, b in ((16, 384, 384), (16, 8, 4093)):
        tr_, ti_ = randn(rows, a, b), randn(rows, a, b)
        fbr, fbi = ops._on_device(ops._dft_planes, (b,), dev)
        tc_ = torch.complex(tr_, ti_)
        emit({"phase": "kernel_check", "name": "fourstep_stage2",
              "shape": [rows, a, b], "radix_plan": list(fft_rows_plan(b)),
              **measure(
                  "fourstep_stage2",
                  lambda: fourstep_stage2(tr_, ti_),
                  lambda: stage2_body(tr_, ti_, fbr, fbi),
                  lambda: torch.fft.fft(tc_, dim=-1), 1e-4,
                  F32 * 4 * rows * a * b, rows * a * fft_flops(b), 3)})
        del tr_, ti_, tc_, fbr, fbi

    # the streaming four-step's column FFT at a mixed radix (A = B = 384:
    # 8, 4, 4, 3 over 8-column tiles) and at a prime A (4093: one dense
    # pass, one column a tile; then B = 4 over 256-column tiles), against
    # the dense products
    for rows, a, b in ((16, 384, 384), (16, 4093, 4)):
        xr_, xi_ = randn(rows, a, b), randn(rows, a, b)
        fplanes = ops._fourstep_planes(a, b, dev)
        xc_ = torch.complex(xr_, xi_).reshape(rows, a * b)
        emit({"phase": "kernel_check", "name": "fourstep_streaming",
              "shape": [rows, a, b],
              "radix_plans": [list(fft_rows_plan(a)),
                              list(fft_rows_plan(b))],
              "tiles": [fft_cols_tile(a, b), fft_cols_tile(b, a)],
              **measure(
                  "fourstep_streaming",
                  lambda: fourstep_streaming(xr_, xi_, *fplanes),
                  lambda: fourstep_streaming_body(xr_, xi_, *fplanes),
                  lambda: torch.fft.fft(xc_, dim=-1), 1e-4,
                  F32 * (4 * rows * a * b + 2 * (a * b + a + b)),
                  rows * fft_flops(a * b), 3)})
        del xr_, xi_, xc_, fplanes
    torch.cuda.empty_cache()

    # multistep_fused, both modes: the block mode at fourstep_fused's shape
    # (512 rows of L = 1024 in the plan (16, 16, 4)), the per-stage mode at
    # fourstep_streaming's (128 rows of L = 2^18, (64, 64, 64)).  Each row
    # gets the launches of the main-path runs in its mode (``ms_mode``).
    for rows, factors, reps in ((512, (16, 16, 4), 50),
                                (128, (64, 64, 64), 3)):
        ell = math.prod(factors)
        mode = multistep_mode(factors)
        xr, xi = randn(rows, ell), randn(rows, ell)
        mplanes = ops._on_device(ops._multistep_planes, (factors,), dev)
        stages = _parse_stage_planes(factors, mplanes)
        xc = torch.complex(xr, xi)
        # block mode reads the L-point f32 table, no plane; per stage, the
        # twiddles of every stage but the last and each factor's f32
        # table, no DFT plane
        plane_words = (2 * ell if mode == "block"
                       else sum(2 * st[2].numel() for st in stages[:-1])
                       + 2 * sum(factors))
        run = lambda: multistep_fused(xr, xi, mplanes, factors)
        kernel_row(
            "multistep_fused",
            csrc + ("fft_block.cuh" if mode == "block" else "multistep.cu"),
            "src/repro/kernels/fourstep_fft.py:374", run,
            lambda: multistep_body(xr, xi, stages),
            lambda: torch.fft.fft(xc, dim=-1), 1e-4,
            F32 * (4 * rows * ell + plane_words),
            rows * fft_flops(ell), reps, [rows, ell, *factors], windows=7,
            mode=mode)
        # block mode: the one-block kernel of fourstep_fused; per stage: a
        # column FFT for each stage but the last, then the row FFT
        check_route(
            "multistep_fused",
            {"fft_block_kernel": 1} if mode == "block"
            else {"fft_cols_kernel": len(factors) - 1,
                  "fft_rows_kernel": 1}, run,
            [rows, ell, *factors], mode=mode, windows=7,
            **({"stage_plan": multistep_stage_plan(factors, rows)}
               if mode == "per_stage" else
               {"radix_plan": list(fft_rows_plan(ell)),
                "rows_per_block": fft_rows_per_block(ell)}))
        del xr, xi, xc
    torch.cuda.empty_cache()

    # cmatmul: the s=2^20 plan's encode, G (8, 4) against the 16 requests'
    # message shards folded into 16 * 2^18 payload columns
    n, m, cols = 8, 4, 16 * ell
    br, bi = randn(m, cols), randn(m, cols)
    gc, bc = torch.complex(gr, gi), torch.complex(br, bi)
    kernel_row(
        "cmatmul", csrc + "cmatmul.cu", "src/repro/kernels/cmatmul.py:37",
        lambda: cmatmul(gr, gi, br, bi),
        lambda: cmatmul_body(gr, gi, br, bi),
        lambda: torch.matmul(gc, bc), 1e-5,
        F32 * 2 * (n * m + m * cols + n * cols), 8 * n * m * cols, 20,
        [n, m, cols])
    del br, bi, bc

    # recombine_twiddle_dft: one 2^20-point request's recombine (m = 4,
    # L = 2^18), as ops.recombine_fused gives it.  Its 24 MiB would stay
    # in the 50 MB L2 cache across back-to-back calls, where a request
    # finds them cold: each call is timed after a 128 MiB write ("ms",
    # "plain_ms", "library_ms"; back to back: "l2_warm_ms")
    s, m = 1 << 20, 4
    ell = s // m
    hr, hi = randn(m, ell), randn(m, ell)
    rplanes = ops._on_device(ops._recombine_planes, (s, m), dev)
    hc, wc, fc = torch.complex(hr, hi), *recombine_library_planes(rplanes)
    flush = torch.empty(32 << 20, dtype=torch.float32, device=dev)
    kernel_row(
        "recombine_twiddle_dft", csrc + "recombine.cu",
        "src/repro/kernels/recombine.py:43",
        lambda: recombine_twiddle_dft(hr, hi, *rplanes),
        lambda: recombine_body(hr, hi, *rplanes),
        lambda: torch.einsum("kl,kl,jk->jl", hc, wc, fc), 1e-5,
        F32 * 2 * (3 * m * ell + m * m), ell * (6 * m + fft_flops(m)), 20,
        [m, ell], flush=flush, windows=7, design=recombine_design(m))
    del hr, hi, hc, flush
    torch.cuda.empty_cache()

    # wkv: the rwkv6-3b prefill's WKV of one layer, 4 prompts of 512
    # tokens, 40 heads of 64: planar (160, 512, 64) rows, logw clamped at
    # -8 as the model does; the row prints the compiled design (value
    # columns a block, chunks a segment, blocks an SM).  Its least work
    # is the per-token recurrence, about 5 K^2 + 4 K flops a step and row
    # (o = r.S plus the bonus; S = S*w + k v^T), far below the bytes'
    # time.  o and the state are each held to 1e-5 of their own largest
    # magnitude.
    bh, t, kd = 4 * 40, 512, 64
    wr_, wk_, wv_ = randn(bh, t, kd), randn(bh, t, kd), randn(bh, t, kd)
    wlw = torch.clamp(-randn(bh, t, kd).abs(), min=-8.0)
    wu, ws0 = randn(bh, kd), randn(bh, kd, kd)
    wargs = (wr_, wk_, wv_, wlw, wu, ws0)
    got, want = wkv(*wargs), wkv_body(*wargs)
    torch.cuda.synchronize()
    wkv_rel = {name: compare(torch, [g], [w])[1]
               for name, g, w in zip(("o", "state"), got, want)}
    if not max(wkv_rel.values()) < 1e-5:
        fail(f"wkv: kernel vs plain rel err {wkv_rel} >= 1e-5")
    kernel_row(
        "wkv", csrc + "wkv.cu", "src/repro/kernels/wkv.py:84",
        lambda: wkv(*wargs), lambda: wkv_body(*wargs), None, 1e-5,
        wkv_cost(bh, t, kd)[1], wkv_cost(bh, t, kd)[0], 20, [bh, t, kd],
        windows=7,
        rel_err_o=wkv_rel["o"], rel_err_state=wkv_rel["state"],
        design=wkv_design())
    del wargs, got, want, wr_, wk_, wv_, wlw, wu, ws0
    torch.cuda.empty_cache()

    # every main-path run adds its counts here; each kernel's row gets the
    # total of the runs that launched it
    launches: dict[str, int] = {}
    # multistep_fused's launches (f32 and bf16 entries) by mode, from the
    # runs that name theirs: (name, mode) -> launches
    ms_launches: dict[tuple, int] = {}

    def counted(run, ms_mode=None):
        """Run ``run()`` with the counts set to 0 just before it, and
        return its result and the counts read just after.  ``ms_mode``:
        the multistep mode this run's ``multistep_fused`` launches ran."""
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        out = run()
        counts = _build.launch_counts()
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        if ms_mode is not None:
            for name in MULTISTEP_NAMES:
                key = (name, ms_mode)
                ms_launches[key] = ms_launches.get(key, 0) + counts.get(name,
                                                                        0)
        elif any(counts.get(name) for name in MULTISTEP_NAMES):
            fail(f"a run with no multistep mode launched it: {counts}")
        return out, counts

    def make_input(kind, shape):
        """A request batch of ``kind`` and its truth in float64/complex128:
        complex signals (c2c), real signals (r2c), half spectra of real
        signals (c2r)."""
        xt = randn(*shape)
        if kind == "r2c":
            return xt, torch.fft.rfft(xt.double(), dim=-1)
        if kind == "c2r":
            y = torch.fft.rfft(xt, dim=-1)
            return y, torch.fft.irfft(y.to(torch.complex128), n=shape[-1],
                                      dim=-1)
        x = torch.complex(xt, randn(*shape))
        return x, torch.fft.fft(x.to(torch.complex128), dim=-1)

    def rel_err(got, want) -> float:
        got = torch.as_tensor(got, device=dev).to(want.dtype)
        if got.shape != want.shape:
            return math.inf
        rel = float((got - want).abs().max() / want.abs().max())
        return rel if math.isfinite(rel) else math.inf

    # -- 4./5. the service main path, per kind ----------------------------
    # the kind's whole-bucket kernel, by decode path (masked = device)
    whole_kernel = {
        True: {"c2c": "coded_fft_bucket_masked",
               "r2c": "coded_rfft_bucket_masked",
               "c2r": "coded_irfft_bucket_masked"},
        False: {"c2c": "coded_fft_bucket", "r2c": "coded_rfft_bucket",
                "c2r": "coded_irfft_bucket"}}
    stage_kernels = {"c2c": {"encode_fourstep_fused", "bcmatmul",
                             "recombine_twiddle_dft_batched"},
                     "r2c": {"encode_fourstep_fused", "bcmatmul"},
                     "c2r": {"encode_fourstep_fused", "bcmatmul"}}
    m64_launches: dict[str, int] = {}
    ungated = ("ungated: f32 decode of ill-conditioned subsets, as in the "
               "reference")

    def drive(kind, s, n_req, rel_tol, m=4, n=8, device_decode=True,
              plan_launches=None, stage=None, autotune=False, **cfg_kw):
        """One ``submit_batch`` of ``n_req`` requests of ``kind`` (one
        bucket): exactly one launch of the kind's whole-bucket kernel for
        the decode path and nothing else where the gate admits the bucket,
        else (a c2c bucket that can stream) exactly the streaming kernel's
        launches for the decode path (four masked, three on host planes),
        else exactly the stage kernels.  A config that runs the
        ``plan.run`` executor (``cfg_kw``) launches exactly
        ``plan_launches``.  ``rel_tol=None`` (a code past
        ``LAGRANGE_MAX_M``): the service's own draws are checked for
        launches, shapes and LRU misses and their error is printed, and
        one bucket of evenly spread responders through the service's own
        staging (``stage_bucket`` with those masks) and executor is held
        to 1e-3 (tests/test_kernel_pipeline.py:113).  ``stage``: the
        stage route's kernels where they differ from the kind's usual set;
        ``autotune``: the config's warmup search (off: the phases before
        the tuned path run with an empty table)."""
        svc = FFTService(FFTServiceConfig(s=s, m=m, n_workers=n,
                                          device_decode=device_decode,
                                          autotune=autotune, **cfg_kw))
        masked = svc._device_decode()
        kernel = svc._kernel_path(s, kind)
        route = ops.bucket_route(s, m, n, kind, masked=masked)
        whole = kernel and route == "fused"
        stream = kernel and route == "streaming"
        exact = whole or stream or not kernel
        expect = (plan_launches if not kernel
                  else {whole_kernel[masked][kind]: 1} if whole
                  else ({"coded_fft_bucket_streaming_masked": 4} if masked
                        else {"coded_fft_bucket_streaming": 3}) if stream
                  else stage or stage_kernels[kind])
        svc.warmup(lengths=[s], kinds=[kind], buckets=[n_req])
        xb, want = make_input(kind, (n_req, s))
        xs = list(xb.cpu().numpy())
        t0 = time.perf_counter()
        out, counts = counted(lambda: svc.submit_batch(xs, kind=kind))
        dt = time.perf_counter() - t0
        if (exact and counts != expect) or (not exact
                                            and set(counts) != expect):
            fail(f"{kind} s={s} m={m}: expected {expect} for the one "
                 f"bucket, got {counts}")
        if m > mds.LAGRANGE_MAX_M:
            for k, v in counts.items():
                m64_launches[k] = m64_launches.get(k, 0) + v
        got = np.stack(out)
        if got.shape != tuple(want.shape) or not np.isfinite(got).all():
            fail(f"{kind} s={s} m={m}: output {got.shape}, finite "
                 f"{bool(np.isfinite(got).all())}, want {tuple(want.shape)}")
        rel = rel_err(got, want)
        if rel_tol is not None and not rel < rel_tol:
            fail(f"{kind} s={s} m={m}: service rel err {rel} >= {rel_tol}")
        if kernel and not masked and svc.stats.decode_cache_misses < 1:
            fail(f"{kind} s={s} m={m}: host path paid no LRU miss")
        checks = {"rel_err": rel, "rel_tol": rel_tol}
        if rel_tol is None:
            checks = {"rel_err_ungated": rel, "note": ungated}
            alt = np.arange(n) % 2 == 0
            spread = np.stack([np.roll(alt, i) for i in range(n_req)])
            def serve_spread():
                bucket, args = svc.stage_bucket(
                    s, kind, list(xb.cpu().numpy()), masks=spread)
                return svc.launch_bucket(s, bucket, kind, args)

            yb, scounts = counted(serve_spread)
            if set(scounts) != expect:
                fail(f"{kind} s={s} m={m} spread: launches {scounts}")
            for k, v in scounts.items():
                m64_launches[k] = m64_launches.get(k, 0) + v
            srel = rel_err(yb, want)
            if not srel < 1e-3:
                fail(f"{kind} s={s} m={m}: evenly spread responders rel "
                     f"err {srel} >= 1e-3")
            checks.update({"spread_rel_err": srel, "spread_rel_tol": 1e-3})
        # steady-state rate: three more identical calls, wall clock, split
        # into staging + launch (dispatch) and wait + fetch (sync)
        d0, s0 = svc.stats.dispatch_s, svc.stats.sync_s
        t1 = time.perf_counter()
        for _ in range(3):
            svc.submit_batch(xs, kind=kind)
        steady = (time.perf_counter() - t1) / 3
        dispatch = (svc.stats.dispatch_s - d0) / 3
        sync = (svc.stats.sync_s - s0) / 3
        trace = profile_call(torch, lambda: svc.submit_batch(xs, kind=kind),
                             track=FFT_KERNELS)
        emit({"phase": "service", "kind": kind, "s": s, "m": m,
              "n_workers": n, "requests": n_req, "autotune": autotune,
              "decode": ("plan " + svc.cfg.decode_method if not kernel
                         else "device" if masked else "host"),
              "route": ("whole_bucket" if whole else "streaming" if stream
                        else "stage" if kernel else "plan_run"),
              "launches": counts, **checks,
              "first_call_s": dt, "steady_call_s": steady,
              "steady_dispatch_s": dispatch, "steady_sync_s": sync,
              "req_per_s": n_req / steady, "profiled_call": trace,
              "stats": svc.stats.summary()})
        torch.cuda.empty_cache()

    # default config: the whole-bucket kernels; bound from the reference's
    # masked-bucket tolerance (tests/test_lagrange_decode.py:153)
    for kind in ("c2c", "r2c", "c2r"):
        drive(kind, 4096, 64, 3e-4)
    # a 2^20-point transform: 128 MiB in per c2c bucket (half that for the
    # real kinds), past the whole-bucket gates (bound from
    # tests/test_kernel_pipeline.py:113): the c2c bucket streams (the
    # masked streaming kernel, as the JAX package routes it), the real
    # kinds take the stage kernels (no streaming real kind, in the JAX
    # package either)
    for kind in ("c2c", "r2c", "c2r"):
        drive(kind, 1 << 20, 16, 1e-3)
    # past the streaming gate too (split (512, 1024): the (B, B) DFT plane
    # is over the reference's plane budget): the c2c stage kernels at m=4
    drive("c2c", 1 << 21, 4, 1e-3)
    # the plan.run executor: a pinned transform decode (decode_ifft, plain
    # torch.fft, as jnp.fft in the JAX package) behind the plan's cmatmul
    # encode and fused four-step worker; the whole-bucket tolerance
    drive("c2c", 4096, 64, 3e-4, decode_method="ifft",
          plan_launches={"cmatmul": 1, "fourstep_fused": 1})
    # the host decode-matrix path: the default config pinned to it (the
    # planes bucket kernels), and a 2^20-point c2c bucket, which streams
    # (the streaming bucket kernel on host decode planes, as the JAX
    # package routes it)
    for kind in ("c2c", "r2c", "c2r"):
        drive(kind, 4096, 64, 3e-4, device_decode=False)
    drive("c2c", 1 << 20, 16, 1e-3, device_decode=False)
    # past LAGRANGE_MAX_M: m = 64 of N = 128, which the host path serves on
    # the stage kernels (the planes kernels unroll m up to 32)
    for kind in ("c2c", "r2c", "c2r"):
        drive(kind, 4096, 64, None, m=64, n=128)

    # -- 6./7. the plans' run on their default kernel backend -------------
    plan_kind = {CodedFFT: "c2c", CodedRFFT: "r2c", CodedIRFFT: "c2r"}

    def drive_plan(cls, s, n_req, worker, rel_tol, ms_mode=None, info=None,
                   **plan_kw):
        """A batched call with per-request masks (encode on cmatmul, the
        four-step worker, the per-request solve), then one unbatched
        request (its decode on cmatmul too).  ``worker`` maps each
        four-step kernel to its launches per call; ``ms_mode``: the
        multistep mode of a worker on ``multistep_fused``; ``info``:
        plain values for the phase's line."""
        kind = plan_kind[cls]
        plan = cls(s=s, m=4, n_workers=8, **plan_kw)
        if plan.device.type != "cuda" or plan.resolved_backend != "kernel":
            fail(f"plan {cls.__name__} s={s}: runs on {plan.device}, "
                 f"backend {plan.resolved_backend}")
        shape = (n_req, s)
        x, want = make_input(kind, shape)
        masks = service_masks(n_req, 8, 4)
        plan.run(x, mask=masks)                      # warm-up: plane tables
        out = {}
        for label, xin, mk, ref, n_cmatmul in [
                ("batched", x, masks, want, 1),
                ("unbatched", x[0], masks[0], want[0], 2)]:
            t0 = time.perf_counter()
            got, counts = counted(lambda: plan.run(xin, mask=mk), ms_mode)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            expect = {"cmatmul": n_cmatmul, **worker}
            if counts != expect:
                fail(f"plan {cls.__name__} s={s} {label}: launches "
                     f"{counts}, expected {expect}")
            rel = rel_err(got, ref)
            if not rel < rel_tol:
                fail(f"plan {cls.__name__} s={s} {label}: rel err {rel} "
                     f">= {rel_tol}")
            out[label] = {"launches": counts, "rel_err": rel,
                          "first_call_s": dt}
        # steady-state rate of the batched call: three more, wall clock
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(3):
            plan.run(x, mask=masks)
        torch.cuda.synchronize()
        steady = (time.perf_counter() - t1) / 3
        trace = profile_call(torch, lambda: plan.run(x, mask=masks),
                             track=FFT_KERNELS)
        emit({"phase": "plan", "plan": cls.__name__, "s": s, "m": 4,
              "n_workers": 8, "requests": n_req, "rel_tol": rel_tol,
              "worker": sorted(worker), **(info or {}), **out,
              "steady_call_s": steady, "req_per_s": n_req / steady,
              "profiled_call": trace})
        torch.cuda.empty_cache()

    # default plans (the README quickstart's size), 64 requests: fused
    # worker (L = 1024, or L/2 = 512 for the real plans); bound from
    # tests/test_kernels.py:146
    for cls in (CodedFFT, CodedRFFT, CodedIRFFT):
        drive_plan(cls, 4096, 64, {"fourstep_fused": 1}, 5e-4)
    # 2^20-point plans, 16 requests: each shard past the fused gate, so the
    # two-pass worker runs
    for cls in (CodedFFT, CodedRFFT, CodedIRFFT):
        drive_plan(cls, 1 << 20, 16,
                   {"fourstep_stage1": 1, "fourstep_stage2": 1}, 1e-3)

    def streaming_worker(a):
        # the plug-in contract (fft along the last axis, any leading axes
        # collapsed into the kernel's batch, as make_kernel_worker_fn
        # does) on the streaming four-step
        lead, ell = tuple(a.shape[:-1]), a.shape[-1]
        xr, xi = ref.planar(a.reshape(-1, ell))
        outr, outi = ops.fourstep_planar(xr, xi, variant="streaming")
        return ref.unplanar(outr, outi).reshape(lead + (ell,))

    # the same 2^20-point CodedFFT with that worker_fn: the streaming
    # four-step in place of the two-pass pair
    drive_plan(CodedFFT, 1 << 20, 16, {"fourstep_streaming": 2}, 1e-3,
               worker_fn=streaming_worker)

    # -- 8. the single-request recombine ----------------------------------
    # one 2^20-point request's decoded sub-transforms (torch.fft of its m
    # interleaved shards) recombined by ops.recombine_fused
    from repro_torch.core.interleave import interleave
    s, m = 1 << 20, 4
    x, want = make_input("c2c", (1, s))
    c_hat = torch.fft.fft(interleave(x[0], m), dim=-1)
    got, counts = counted(lambda: ops.recombine_fused(c_hat, s))
    torch.cuda.synchronize()
    if counts != {"recombine_twiddle_dft": 1}:
        fail(f"recombine_fused: launches {counts}")
    rel = rel_err(got, want[0])
    if not rel < 1e-3:
        fail(f"recombine_fused s={s}: rel err {rel} >= 1e-3")
    emit({"phase": "recombine_fused", "s": s, "m": m, "launches": counts,
          "rel_err": rel, "rel_tol": 1e-3})
    del x, want, c_hat, got

    # -- 8b. n-D: the service's rfftn / irfftn kinds and the n-D plans ----
    nd_transforms(torch, np, rng, dev, counted, service_masks)

    # -- 8c. the fault runtime and the open-loop streaming front-end -----
    t0 = time.perf_counter()
    fault_runtime(torch, np, rng, counted)
    emit({"phase": "fault_runtime_done", "seconds": time.perf_counter() - t0})

    # -- 8d. the strategy zoo and the direct bucket executors ------------
    t0 = time.perf_counter()
    strategy_zoo(torch, np, rng, dev, counted)
    emit({"phase": "strategy_zoo_done", "seconds": time.perf_counter() - t0})

    # -- 8e. the multi-device runtime: an NCCL world of one and four gloo
    # ranks sharing the card, each in child processes --------------------
    mesh_runtime(torch, np, launches)

    # -- 8f. bf16 planes: every bf16 kernel entry beside its f32 twin, and
    # bf16 services probed from an empty autotune table -----------------
    t0 = time.perf_counter()
    fresh_autotune_cache("bf16")
    bf16_planes(torch, np, rng, dev, counted, spin_rate, table)
    emit({"phase": "bf16_planes_done", "seconds": time.perf_counter() - t0})

    # -- 9. the tuned four-step path --------------------------------------
    # (a) the default service's warmup search, from an empty cache: the
    # L = 1024 candidates (32, 32), (64, 16) and (16, 16, 4) fused, and the
    # two-pass pair, each timed; then a new process's state (memory
    # dropped, the file kept) warms a second service with no search
    tune_dir = fresh_autotune_cache("warmup")
    backend = autotune.backend_of(dev)
    shape_route = ops.fourstep_route(1024, device=dev)   # the empty table
    n0 = autotune.searches_run()
    t0 = time.perf_counter()
    _, wcounts = counted(lambda: FFTService(FFTServiceConfig(s=4096))
                         .warmup(), ms_mode="block")
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    searches = autotune.searches_run() - n0
    if searches < 1 or wcounts.get("multistep_fused", 0) < 1:
        fail(f"warmup ran {searches} searches, launches {wcounts}")
    written = json.loads(autotune.cache_path(backend).read_text())
    autotune.clear()
    n1 = autotune.searches_run()
    t0 = time.perf_counter()
    _, wcounts2 = counted(lambda: FFTService(FFTServiceConfig(s=4096))
                          .warmup(), ms_mode="block")
    torch.cuda.synchronize()
    dt2 = time.perf_counter() - t0
    if autotune.searches_run() != n1 or wcounts2.get("multistep_fused"):
        fail(f"the warm path searched: {autotune.searches_run() - n1}, "
             f"launches {wcounts2}")
    emit({"phase": "autotune_warmup", "s": 4096, "L": 1024,
          "searches": searches,
          "winners": {key: [e.get("variant"), e.get("factors")]
                      for key, e in written["entries"].items()},
          "launches": wcounts, "seconds": dt,
          "table_file": str(autotune.cache_path(backend).relative_to(ROOT)),
          "table": written, "warm_searches": 0,
          "warm_launches": wcounts2, "warm_seconds": dt2})
    measured = autotune.lookup("fourstep", backend=backend, L=1024,
                               mode="kernel")

    # (b) CodedFFT.run through recorded multistep plans: the L = 1024
    # shard in (16, 16, 4) (block mode), the L = 2^18 shard in (64, 64, 64)
    # (per stage, three launches); bounds as the plan phases above
    autotune.clear()
    for s, n_req, factors, rel_tol in ((4096, 64, (16, 16, 4), 5e-4),
                                       (1 << 20, 16, (64, 64, 64), 1e-3)):
        ell = s // 4
        autotune.record("fourstep", {"variant": "fused",
                                     "factors": list(factors),
                                     "ms": float("nan")},
                        persist=False, backend=backend, L=ell, mode="kernel")
        mode = multistep_mode(factors)
        drive_plan(CodedFFT, s, n_req,
                   {"multistep_fused": 1 if mode == "block"
                    else len(factors)}, rel_tol, ms_mode=mode,
                   info={"table": "recorded", "factors": list(factors),
                         "multistep_mode": mode})
    # (c) once under the measured table (the file the warmup wrote)
    autotune.clear()
    variant, factors = ops.fourstep_route(1024, device=dev)
    if variant != measured["variant"]:
        fail(f"measured entry {measured} routes as {variant}")
    multi = factors is not None and len(factors) > 2
    worker = ({"multistep_fused": 1} if multi
              else {"fourstep_fused": 1} if variant == "fused"
              else {"fourstep_stage1": 1, "fourstep_stage2": 1})
    drive_plan(CodedFFT, 4096, 64, worker, 5e-4,
               ms_mode=multistep_mode(factors) if multi else None,
               info={"table": "measured", "winner": measured})
    # every search candidate, the winner and the empty table's route among
    # them, timed back to back on the same rows as that run's worker (64
    # requests times N = 8) the way the kernel rows are timed: is the
    # recorded winner the fastest plan at the served batch?
    rows = 64 * 8
    xr, xi = randn(rows, 1024), randn(rows, 1024)
    at_rows = []
    for plan in [*autotune.candidate_factor_plans(1024), None]:
        v = "two_pass" if plan is None else "fused"
        at_rows.append({
            "variant": v, "factors": plan,
            "ms": time_ms(torch, lambda: ops.fourstep_planar(
                xr, xi, variant=v, factors=plan), 50, spin_rate)})
    fastest = min(at_rows, key=lambda r: r["ms"])

    def timed_route(route):
        v, f = route
        return next(r["ms"] for r in at_rows if r["variant"] == v
                    and (v == "two_pass" or tuple(r["factors"]) == f))

    emit({"phase": "autotune_at_served_rows", "rows": rows, "L": 1024,
          "candidates": at_rows, "winner": measured,
          "winner_ms": timed_route((variant, factors)),
          "shape_route": shape_route,
          "shape_route_ms": timed_route(shape_route), "fastest": fastest,
          "winner_is_fastest": (fastest["variant"], fastest["factors"])
          == (measured["variant"], measured.get("factors"))})
    del xr, xi

    # (d) a near-prime shard: s = 4 * 4099, c2c (m = 4, N = 8), 16
    # requests.  The bucket takes the stage route; its encode takes the
    # two-pass branch (one cmatmul, then the four-step on the coded rows:
    # the platform FFT for a prime 4099, where the warmup search has no
    # kernel candidate to time and records that route), as the JAX
    # package routes it; the whole-bucket bound
    drive("c2c", 4 * 4099, 16, 3e-4, autotune=True,
          stage={"cmatmul", "bcmatmul", "recombine_twiddle_dft_batched"})
    prime = autotune.lookup("fourstep", backend=backend, L=4099,
                            mode="kernel")
    if prime != {"variant": "xla"}:
        fail(f"the L=4099 search recorded {prime}, not the platform FFT")

    # -- 10. RWKV-6 generation: rwkv6-3b at full width and depth, bf16 --
    lm_rwkv6_3b(torch, rng, counted)

    # -- 11. the decoder-only transformer at full width (DENSE_CELLS):
    # gemma-2b at 512 and 8,176 tokens, qwen2.5-14b at 4 layers,
    # minicpm-2b, qwen1.5-32b and paligemma-3b whole, bf16 --
    lm_dense(torch, rng, counted)

    # -- 12. the MoE family at full width (llama4-maverick at 2 layers,
    # dbrx-132b at 10) and the hybrid recurrentgemma-9b whole, within
    # and past its window, bf16 --
    lm_moe(torch, rng, counted)
    lm_hybrid(torch, rng, counted)

    # -- 13. the encoder-decoder: whisper-medium at full width and depth
    # through prefill/decode_step; then the coded spectral mixer on the
    # plan's kernels, from an empty autotune table --
    t0 = time.perf_counter()
    lm_encdec(torch, np, rng, counted)
    fresh_autotune_cache("spectral")
    spectral_coded(torch, np, rng, counted, spin_rate)
    emit({"phase": "encdec_spectral_done",
          "seconds": time.perf_counter() - t0})

    # -- 14. the training core: gemma-2b at full width and depth, 4 steps
    # of exact AdamW; then the bit-exact restart on reduced gemma-2b --
    t0 = time.perf_counter()
    lm_train(torch, counted)
    emit({"phase": "lm_train_done", "seconds": time.perf_counter() - t0})

    # -- 15. coded and compressed gradient aggregation on gemma-2b's
    # gradients at full width (8 layers), and the sharding plan on four
    # gloo ranks --
    grad_aggregation(torch, np, counted)

    # -- 16. the launch tools: dry runs on meta, the counter on CUDA
    # against meta, make_serve_fns, fft_dryrun and the quickstart --
    launch_tools(torch, counted)

    for row in table:
        row["launches"] = (ms_launches.get((row["name"], row["mode"]), 0)
                           if row["name"] in MULTISTEP_NAMES
                           else launches.get(row["name"], 0))
        if row["launches"] < 1:
            fail(f"kernel {row['name']} was launched by no main path "
                 f"({launches})")
    # the repaired stage kernels at m = 64: launches of the m = 64 runs
    for row in m64_rows:
        row["launches"] = m64_launches.get(row["name"], 0)
        if row["launches"] < 1:
            fail(f"kernel {row['name']} at m=64 was launched by no main "
                 f"path ({m64_launches})")
    emit({"phase": "kernels_m64", "rows": m64_rows})
    emit({"kernels": table})
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    print(nvidia_smi(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
