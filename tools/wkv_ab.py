#!/usr/bin/env python3
"""Time the WKV kernel of one tree of the port on a GPU.

    python3 tools/wkv_ab.py [--src DIR] [--windows 7]
    python3 tools/wkv_ab.py --sweep 16:1:128,32:2:256 [--windows 7]

Imports ``repro_torch`` from DIR (default: this checkout's ``src``), so a
parent commit unpacked elsewhere (``git archive``) is timed by the same
harness as the change.  It times ``kernels.wkv.wkv`` at the rwkv6-3b
prefill's (BH, T, K) = (160, 512, 64) (4 prompts of 512 tokens, 40 heads
of 64) and at BH = 640 and 1280 with the same T and K: a design whose
time stays flat as BH grows is bound by its per-row chain, not by the
card.  Inputs are seeded normals, logw clamped at -8 as the model does.

Each call is first held against ``wkv_body`` on the same inputs (o and
the final state each under 1e-5 of their largest magnitude), then timed
in ``--windows`` windows with ``chip_smoke.time_ms`` (CUDA events, a
spin kernel queued first).  Prints one JSON line per shape (median, min
and max ms of the windows, the twin's errors, the compiled design where
the tree reports one) and one with the card's name and power limit.  To
compare two trees, run them in turns in one machine: parent, change,
change, parent.

``--sweep VB:G:NT,...`` builds the tree's ``csrc/wkv.cu`` once per point
with ``-DWKV_VB=VB -DWKV_G=G -DWKV_NT=NT`` (value columns a block, chunks
a segment, threads a block) into ``build/wkv-sweep/<source hash>/``, prints each build's ptxas registers and
spills and the blocks an SM holds, and times each at (160, 512, 64) the
same way; ``--phases`` adds the phase clocks (``-DWKV_PHASE_CLOCKS``,
a timing build) and prints each phase's share of the blocks' cycles and
the cycles a block.  Exits 2 without a CUDA device, 1 if a run disagrees with the
twin or a build fails.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import importlib
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SHAPES = [(160, 512, 64), (640, 512, 64), (1280, 512, 64)]
TOL = 1e-5


def _inputs(torch, bh, t, kd, seed=0):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    mk = lambda *shape: torch.randn(*shape, device="cuda", generator=gen)
    r, k, v = mk(bh, t, kd), mk(bh, t, kd), mk(bh, t, kd)
    lw = torch.clamp(-mk(bh, t, kd).abs(), min=-8.0)
    return r, k, v, lw, mk(bh, kd), mk(bh, kd, kd)


def _held(torch, chip_smoke, run, plain, args):
    """The twin's relative errors on o and the state (or None if over)."""
    got, want = run(*args), plain(*args)
    torch.cuda.synchronize()
    rel = {name: chip_smoke.compare(torch, [g], [w])[1]
           for name, g, w in zip(("o", "state"), got, want)}
    return rel if max(rel.values()) < TOL else None, rel


def _sweep_lib(point, nvcc_flags, csrc: Path, out: Path, phases=False):
    """Build ``csrc/wkv.cu`` at (VB, G, NT), with the phase clocks if
    asked; returns (library, ptxas lines)."""
    from repro_torch.kernels import _build

    vb, g, nt = point
    out.mkdir(parents=True, exist_ok=True)
    tag = f"vb{vb}_g{g}_nt{nt}" + ("_phases" if phases else "")
    lib = out / f"libwkv_{tag}.so"
    cmd = [_build._nvcc(), *nvcc_flags, f"-DWKV_VB={vb}", f"-DWKV_G={g}",
           f"-DWKV_NT={nt}", *(["-DWKV_PHASE_CLOCKS"] if phases else []),
           "-I", str(csrc), "-o", str(lib), str(csrc / "wkv.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = out / f"wkv_{tag}.log"
    log.write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"wkv sweep build {tag}:\n{log.read_text()}")
    import chip_smoke

    return ctypes.CDLL(str(lib)), chip_smoke.ptxas_report(log)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--windows", type=int, default=7)
    ap.add_argument("--sweep", default="",
                    help="comma-separated VB:G:NT points to build and time")
    ap.add_argument("--phases", action="store_true",
                    help="with --sweep: build with the phase clocks and "
                         "print each phase's share of the blocks' cycles")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("wkv_ab: no CUDA device available", file=sys.stderr)
        return 2

    # the harness's timing helpers from this checkout; chip_smoke puts
    # this checkout's src first on the path, so --src goes in after it
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    src_dir = Path(args.src).resolve()
    if not (src_dir / "repro_torch" / "kernels" / "wkv.py").is_file():
        print(f"wkv_ab: no repro_torch package under {src_dir}",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(src_dir))
    from repro_torch.kernels import _build
    wkv_mod = importlib.import_module("repro_torch.kernels.wkv")

    torch.backends.cuda.matmul.allow_tf32 = False
    spin = chip_smoke.spin_cycles_per_ms(torch)
    src = str(src_dir.relative_to(ROOT) if src_dir.is_relative_to(ROOT)
              else src_dir)

    def windows(fn, reps=20):
        ts = sorted(chip_smoke.time_ms(torch, fn, reps, spin)
                    for _ in range(args.windows))
        return {"ms": ts[len(ts) // 2], "ms_min": ts[0], "ms_max": ts[-1],
                "windows": args.windows, "reps": reps}

    if args.sweep:
        csrc = Path(_build.CSRC)
        out = ROOT / "build" / "wkv-sweep" / hashlib.sha256(
            (csrc / "wkv.cu").read_bytes()).hexdigest()[:12]
        bh, t, kd = SHAPES[0]
        wargs = _inputs(torch, bh, t, kd)
        p = _build.ptr
        for spec in args.sweep.split(","):
            point = tuple(int(x) for x in spec.split(":"))
            lib, ptxas = _sweep_lib(point, _build.NVCC_FLAGS, csrc, out,
                                    args.phases)
            fn = lib.wkv_f32
            fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + [
                ctypes.c_void_p]
            fn.restype = ctypes.c_int
            design = (ctypes.c_int * 5)()
            lib.wkv_design.argtypes = [ctypes.c_void_p]
            _build.check(lib.wkv_design(ctypes.cast(design,
                                                    ctypes.c_void_p)),
                         "wkv_design")

            def run(r, k, v, lw, u, s0, fn=fn):
                o, so = torch.empty_like(r), torch.empty_like(s0)
                _build.check(fn(p(r), p(k), p(v), p(lw), p(u), p(s0), p(o),
                                p(so), r.shape[0], r.shape[1], r.shape[2],
                                _build.stream_of(r.device)), "wkv sweep")
                return o, so

            ok, rel = _held(torch, chip_smoke, run, wkv_mod.wkv_body, wargs)
            row = {"src": src, "sweep": dict(zip(("vb", "g", "nt"), point)),
                   "shape": [bh, t, kd], "design": list(design),
                   "ptxas": ptxas, "max_rel_err": rel}
            if ok is None:
                print(json.dumps(row), flush=True)
                print(f"wkv_ab: sweep {spec}: rel err {rel}",
                      file=sys.stderr)
                return 1
            if args.phases:
                cyc = (ctypes.c_ulonglong * 5)()
                read = lib.wkv_phase_cycles_read
                read.argtypes = [ctypes.c_void_p]
                _build.check(read(ctypes.cast(cyc, ctypes.c_void_p)), "read")
                run(*wargs)
                torch.cuda.synchronize()
                _build.check(read(ctypes.cast(cyc, ctypes.c_void_p)), "read")
                total = sum(cyc) or 1
                row["phase_share"] = dict(zip(
                    ("wait_issue", "A_factors", "B_scores", "C_scan",
                     "D_outputs"), (c / total for c in cyc)))
                row["phase_cycles_per_block"] = sum(cyc) / (
                    bh * ((kd + point[0] - 1) // point[0]))
            row.update(windows(lambda: run(*wargs)))
            print(json.dumps(row), flush=True)
    else:
        design = (wkv_mod.design() if hasattr(wkv_mod, "design") else None)
        for bh, t, kd in SHAPES:
            wargs = _inputs(torch, bh, t, kd)
            ok, rel = _held(torch, chip_smoke, wkv_mod.wkv,
                            wkv_mod.wkv_body, wargs)
            if ok is None:
                print(f"wkv_ab: {src} {(bh, t, kd)}: rel err {rel}",
                      file=sys.stderr)
                return 1
            print(json.dumps({"src": src, "name": "wkv",
                              "shape": [bh, t, kd], "design": design,
                              "max_rel_err": rel,
                              **windows(lambda: wkv_mod.wkv(*wargs))}),
                  flush=True)
            del wargs
            torch.cuda.empty_cache()
    print(json.dumps({"src": src, "device": torch.cuda.get_device_name(0),
                      "nvidia_smi": chip_smoke.nvidia_smi()}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
