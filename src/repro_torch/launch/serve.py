"""Serving launcher: LM generation engine or the coded FFT service.

Examples::

    # batched generation with rwkv6-3b at full size (random weights from
    # --seed), on the CUDA device
    python -m repro_torch.launch.serve --arch rwkv6-3b

    # the same family reduced, on the CPU (the kernels' plain twins)
    python -m repro_torch.launch.serve --arch rwkv6-3b --reduced --device cpu

    # the decoder-only transformer (dense: gemma-2b, minicpm-2b,
    # qwen2.5-14b, qwen1.5-32b; vlm: paligemma-3b), prompts prefilled
    # into a KV cache of --cache-len slots
    python -m repro_torch.launch.serve --arch gemma-2b --cache-len 1024
    python -m repro_torch.launch.serve --arch gemma-2b --reduced --device cpu

    # MoE (dbrx-132b, llama4-maverick-400b-a17b: capacity-routed experts;
    # their full depth outgrows one card, so serve them --reduced or cut
    # n_layers in code) and the hybrid (recurrentgemma-9b: RG-LRU and
    # local attention, whole on one card)
    python -m repro_torch.launch.serve --arch recurrentgemma-9b --cache-len 1024
    python -m repro_torch.launch.serve --arch dbrx-132b --reduced --device cpu

    # the paper's application: straggler-tolerant FFT serving
    python -m repro_torch.launch.serve --fft --s 4096 --m 4 --workers 8 --requests 20

Both modes run on CUDA and raise without a device unless ``--device``
names another.
"""

from __future__ import annotations

import argparse

import numpy as np


def _serve_lm(args) -> int:
    import torch

    from repro_torch.configs import get_config, get_reduced_config
    from repro_torch.models import build_model
    from repro_torch.serving import EngineConfig, GenerationEngine

    cfg = get_reduced_config(args.arch) if args.reduced else get_config(args.arch)
    model = build_model(cfg, device=args.device)
    params = model.init(
        torch.Generator(device=model.device).manual_seed(args.seed))
    engine = GenerationEngine(model, params, EngineConfig(
        batch_size=args.prompts, prompt_len=args.prompt_len,
        max_new_tokens=args.new_tokens, cache_len=args.cache_len,
        temperature=args.temperature, seed=args.seed))
    rng = np.random.default_rng(args.seed)
    prompts = [list(rng.integers(1, cfg.vocab_size, size=args.prompt_len // 2))
               for _ in range(args.prompts)]
    outs = engine.generate(prompts)
    for i, o in enumerate(outs):
        print(f"[serve] request {i}: generated {len(o)} tokens: {o[:16]}...")
    return 0


def _serve_fft(args) -> int:
    from repro_torch.distributed import StragglerModel
    from repro_torch.serving import FFTService, FFTServiceConfig

    svc = FFTService(FFTServiceConfig(
        s=args.s, m=args.m, n_workers=args.workers,
        straggler=StragglerModel(t0=1.0, mu=args.mu), seed=args.seed),
        device=args.device)
    rng = np.random.default_rng(args.seed)
    worst = 0.0
    for _ in range(args.requests):
        x = (rng.standard_normal(args.s)
             + 1j * rng.standard_normal(args.s)).astype(np.complex64)
        y = svc.submit(x)
        worst = max(worst, float(np.max(np.abs(y - np.fft.fft(x)))))
    stats = svc.stats.summary()
    print(f"[fft-service] {args.requests} requests, s={args.s} m={args.m} "
          f"N={args.workers}")
    print(f"[fft-service] mean latency: coded {stats['mean_coded_latency']:.3f} "
          f"vs uncoded {stats['mean_uncoded_latency']:.3f} "
          f"(speedup {stats['speedup']:.2f}x), "
          f"stragglers tolerated: {stats['stragglers_tolerated']}")
    print(f"[fft-service] worst abs error vs numpy.fft: {worst:.2e}")
    return 0


def main(argv=None) -> int:
    from repro_torch.configs import ARCH_IDS

    ap = argparse.ArgumentParser()
    ap.add_argument("--fft", action="store_true", help="run the FFT service")
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA, raising without one)")
    # LM serving
    ap.add_argument("--arch", choices=ARCH_IDS, default="rwkv6-3b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--prompts", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--cache-len", type=int, default=128)
    ap.add_argument("--temperature", type=float, default=0.0)
    # FFT service
    ap.add_argument("--s", type=int, default=4096)
    ap.add_argument("--m", type=int, default=4)
    ap.add_argument("--workers", type=int, default=8)
    ap.add_argument("--mu", type=float, default=1.0)
    ap.add_argument("--requests", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    return _serve_fft(args) if args.fft else _serve_lm(args)


if __name__ == "__main__":
    raise SystemExit(main())
