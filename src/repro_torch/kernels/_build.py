"""Build and load the hand-written CUDA kernels, and count their launches.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared library
with a plain C interface (no PyTorch headers, so a build takes seconds),
loaded with :mod:`ctypes`.  Libraries live in a content-hashed directory
under ``build/`` at the repository root: the hash covers every source, the
shared headers and the compiler flags, so an edited kernel never loads a
stale binary.  Nothing is built at import time -- the first call of a
kernel wrapper on a CUDA tensor builds its library, and
:func:`build` compiles several libraries in parallel (one ``nvcc`` process
per source, all started together).

Flags: ``sm_90a`` only (Hopper), ``-O3``, no ``--use_fast_math`` -- the
in-kernel Lagrange decode needs accurate ``sincosf``.  ``-Xptxas=-v``
keeps each kernel's register/shared-memory report in ``<name>.log`` beside
its library.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

__all__ = ["MAX_GRID_YZ", "SMEM_PER_BLOCK_OPTIN", "SOURCES", "TABLE_DTYPES",
           "build", "build_dir", "check", "check_planes", "count_launch",
           "entry", "is_bf16", "launch_counts", "launch_name", "load",
           "log_path", "ptr", "reset_launch_counts", "stream_of"]

CSRC = Path(__file__).resolve().parent / "csrc"
# <repo>/src/repro_torch/kernels/_build.py -> <repo>/build
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build"
HEADERS = ("common.cuh", "bucket.cuh", "fft_rows.cuh", "fft_cols.cuh",
           "fft_block.cuh")
SOURCES = ("coded_bucket", "encode_fourstep", "bcmatmul", "recombine",
           "fourstep", "cmatmul", "coded_rbucket", "coded_irbucket",
           "coded_bucket_streaming", "multistep", "wkv")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

# Shared memory one block may use on the H100 (227 KB of the SM's 256 KB,
# after cudaFuncAttributeMaxDynamicSharedMemorySize): the limit of every
# fused kernel's working set, hence of the fused gates.  A constant, so
# CPU runs take the card's route decisions; the chip smoke run checks it
# against the device attribute.
SMEM_PER_BLOCK_OPTIN = 232_448
# CUDA's limit on grid y and z: the wrappers that lay a batch on either
# refuse a larger one
MAX_GRID_YZ = 65_535


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return found


def build_dir() -> Path:
    """The content-hashed directory all current libraries build into."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in sorted(HEADERS + tuple(f"{s}.cu" for s in SOURCES)):
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return BUILD_ROOT / f"kernels-{h.hexdigest()[:16]}"


def _lib_path(name: str) -> Path:
    return build_dir() / f"lib{name}.so"


def log_path(name: str) -> Path:
    """The compiler's report (``-Xptxas=-v``) for one library."""
    return build_dir() / f"{name}.log"


def build(names=SOURCES) -> dict[str, float]:
    """Compile the named libraries that are not built yet, in parallel.

    Returns ``{name: seconds}`` for the libraries compiled by this call
    (the wall time of the whole parallel build).  Raises with the
    compiler's output if any build fails.
    """
    todo = [n for n in names if not _lib_path(n).exists()]
    if not todo:
        return {}
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = {}
    for name in todo:
        tmp = out_dir / f"lib{name}.{os.getpid()}.tmp.so"
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        log_path(name).write_text(log)
        if proc.returncode != 0:
            failed.append(f"--- {name} (nvcc exit {proc.returncode})\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, _lib_path(name))
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    dt = time.perf_counter() - t0
    return {name: dt for name in todo}


# one build at a time in a process: threads that launch a kernel first
# (the measured runtime's workers, the streaming stager) share its library
_BUILD_LOCK = threading.Lock()


@functools.lru_cache(maxsize=None)
def _load(name: str) -> ctypes.CDLL:
    build((name,))
    return ctypes.CDLL(str(_lib_path(name)))


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    if name not in SOURCES:
        raise ValueError(f"unknown kernel library {name!r}")
    with _BUILD_LOCK:
        return _load(name)


def check(status: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status} at launch")


# -- launch counters -----------------------------------------------------
# Each wrapper adds one here per CUDA kernel it launches (never on the CPU
# path), so a run can prove the main path went through the kernels.  A
# lock keeps the counts exact when several threads launch at once.
_LAUNCHES: dict[str, int] = {}
_LAUNCHES_LOCK = threading.Lock()


def count_launch(name: str, k: int = 1) -> None:
    with _LAUNCHES_LOCK:
        _LAUNCHES[name] = _LAUNCHES.get(name, 0) + k


def launch_counts() -> dict[str, int]:
    with _LAUNCHES_LOCK:
        return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    with _LAUNCHES_LOCK:
        _LAUNCHES.clear()


# -- wrapper helpers -------------------------------------------------------
# the constant tables' precisions: a kernel's *_f32 entry or its *_bf16 twin
TABLE_DTYPES = (torch.float32, torch.bfloat16)


def check_planes(what: str, tables=None, **planes) -> torch.device:
    """Validate the planes a kernel wrapper passes to CUDA: one CUDA
    device, contiguous; ``planes`` (the payload, G, the decode) float32,
    ``tables`` (a dict of the DFT, twiddle, recombine, split and pack
    planes) all float32 or all bfloat16, the precision of the entry the
    wrapper launches.  Returns that device."""
    tables = tables or {}
    device = None
    for name, t in {**planes, **tables}.items():
        if t.device.type != "cuda":
            raise ValueError(f"{what}: {name} is on {t.device}, not a CUDA "
                             f"device")
        if device is None:
            device = t.device
        elif t.device != device:
            raise ValueError(f"{what}: {name} is on {t.device}, the other "
                             f"planes on {device}")
        if name in planes and t.dtype != torch.float32:
            raise TypeError(f"{what}: {name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
    dtypes = {t.dtype for t in tables.values()}
    if len(dtypes) > 1 or not dtypes <= set(TABLE_DTYPES):
        raise TypeError(f"{what}: the tables must be all float32 or all "
                        f"bfloat16, got {sorted(map(str, dtypes))}")
    return device


def is_bf16(table: torch.Tensor) -> bool:
    """Does a wrapper given ``table`` launch its kernel's bf16 entry?"""
    return table.dtype == torch.bfloat16


def entry(symbol: str, bf16: bool) -> str:
    """A kernel's C entry for its tables' precision: ``<base>_f32`` or
    ``<base>_bf16``."""
    return symbol[:-len("_f32")] + "_bf16" if bf16 else symbol


def launch_name(name: str, bf16: bool) -> str:
    """The launch counter of a wrapper's entry: its own name for the f32
    tables, ``<name>[bf16]`` for the bf16 twin."""
    return f"{name}[bf16]" if bf16 else name


def stream_of(device) -> int:
    """PyTorch's current CUDA stream on ``device``, as a raw handle."""
    return torch.cuda.current_stream(device).cuda_stream


def ptr(t) -> int:
    return t.data_ptr()
