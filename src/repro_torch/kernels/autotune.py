"""Per-shape four-step autotuner: a measured variant table with a JSON cache.

``ops.fourstep_planar(variant=None)`` reads this table for its variant
and radix plan; a miss keeps the static routes (``ops.fourstep_route``).
Like the JAX package's ``kernels/autotune.py``:

* **keys** -- ``"{kind}|k=v|..."`` with the shape params sorted; the key
  carries the port's own ``mode``: ``"kernel"`` for CUDA tensors (the
  hand-written kernels), ``"plain"`` for CPU tensors (their plain twins).
* **tables** -- one per backend, ``cuda:<device name>`` or ``cpu``, each
  in its own JSON file ``autotune-torch-<slug>.json`` (the slug is the
  backend name with every non-alphanumeric replaced by ``_``).  The
  ``torch`` prefix keeps the port off the JAX package's
  ``autotune-<backend>.json`` files in the same directory, whose keys
  would otherwise collide.
* **entries** -- ``{"variant": "fused"|"two_pass", "factors": [...],
  "ms": float}``, or ``{"variant": "xla"}`` where no kernel candidate
  exists (nothing timed).
* **search** -- :func:`tune_fourstep` times the kernel candidates (one
  warm call, then the median of ``reps`` wall-clock calls, each closed
  by ``torch.cuda.synchronize`` on the card) and records the winner.
  Searches run from ``FFTService.warmup()``, ``chip_smoke.py`` or a
  caller, never from a dispatcher: :func:`lookup` is a pure dict read
  (plus one lazy file load per backend).
* **persistence** -- the table is written atomically after each search;
  the next process loads it and skips the search.

``REPRO_AUTOTUNE_CACHE`` overrides the cache directory (default
``~/.cache/coded-fft``).
"""

from __future__ import annotations

import functools
import json
import os
import pathlib
import re
import tempfile
import time
from typing import Callable, Optional

import numpy as np
import torch

__all__ = [
    "backend_of",
    "cache_path",
    "candidate_factor_plans",
    "clear",
    "ensure_fourstep",
    "key_of",
    "load_table",
    "lookup",
    "mode_of",
    "record",
    "save_table",
    "searches_run",
    "tune_fourstep",
]

SCHEMA_VERSION = 1

# in-memory tables, keyed by backend; each maps key -> entry dict
_TABLES: dict[str, dict[str, dict]] = {}
_LOADED: set[str] = set()
_SEARCHES = 0  # lifetime search count (the warm path runs none)


@functools.lru_cache(maxsize=None)
def _cuda_backend(index: Optional[int]) -> str:
    return f"cuda:{torch.cuda.get_device_name(index)}"


def backend_of(device=None) -> str:
    """The table a device's tensors use: ``cuda:<device name>`` or
    ``cpu``.  ``None``: the card when there is one, else the CPU."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type == "cuda":
        return _cuda_backend(device.index)
    return "cpu"


def mode_of(device) -> str:
    """The key's mode for tensors on ``device``: ``"kernel"`` on CUDA,
    ``"plain"`` on the CPU."""
    return "kernel" if torch.device(device).type == "cuda" else "plain"


def cache_path(backend: Optional[str] = None) -> pathlib.Path:
    """The JSON cache file for ``backend`` (default: :func:`backend_of`)."""
    root = os.environ.get("REPRO_AUTOTUNE_CACHE")
    if not root:
        root = os.path.join(os.path.expanduser("~"), ".cache", "coded-fft")
    slug = re.sub(r"[^0-9A-Za-z]", "_", backend or backend_of())
    return pathlib.Path(root) / f"autotune-torch-{slug}.json"


def searches_run() -> int:
    """Lifetime number of measured searches (cache hits do not count)."""
    return _SEARCHES


def clear(memory_only: bool = True, backend: Optional[str] = None) -> None:
    """Drop the in-memory table (and optionally the on-disk cache)."""
    b = backend or backend_of()
    _TABLES.pop(b, None)
    _LOADED.discard(b)
    if not memory_only:
        cache_path(b).unlink(missing_ok=True)


def load_table(backend: Optional[str] = None) -> dict[str, dict]:
    """The (lazily disk-loaded) table for ``backend``.  A missing or
    corrupt file starts the table empty."""
    b = backend or backend_of()
    if b not in _LOADED:
        table: dict[str, dict] = {}
        try:
            blob = json.loads(cache_path(b).read_text())
            if blob.get("version") == SCHEMA_VERSION:
                table = {str(k): dict(v)
                         for k, v in blob.get("entries", {}).items()}
        except (OSError, ValueError, AttributeError, TypeError):
            table = {}
        mem = _TABLES.setdefault(b, {})
        mem.update({k: v for k, v in table.items() if k not in mem})
        _LOADED.add(b)
    return _TABLES.setdefault(b, {})


def save_table(backend: Optional[str] = None) -> pathlib.Path:
    """Atomically persist the in-memory table for ``backend``."""
    b = backend or backend_of()
    path = cache_path(b)
    path.parent.mkdir(parents=True, exist_ok=True)
    blob = {"version": SCHEMA_VERSION, "backend": b,
            "entries": load_table(b)}
    fd, tmp = tempfile.mkstemp(dir=str(path.parent), suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(blob, f, indent=1, sort_keys=True)
        os.replace(tmp, path)
    except OSError:
        pathlib.Path(tmp).unlink(missing_ok=True)
    return path


def key_of(kind: str, **params) -> str:
    """Canonical table key: kind plus sorted ``k=v`` shape params."""
    return "|".join([kind, *(f"{k}={params[k]}" for k in sorted(params))])


def lookup(kind: str, *, backend: Optional[str] = None,
           **params) -> Optional[dict]:
    """Pure table read: no search."""
    return load_table(backend).get(key_of(kind, **params))


def record(kind: str, entry: dict, persist: bool = True, *,
           backend: Optional[str] = None, **params) -> dict:
    """Store ``entry`` under the canonical key; persist unless told not."""
    load_table(backend)[key_of(kind, **params)] = dict(entry)
    if persist:
        save_table(backend)
    return entry


# ------------------------------------------------------------ measurement
def _time_ms(fn: Callable, device: torch.device, reps: int) -> float:
    """One warm call, then the median of ``reps`` wall-clock calls, each
    closed by a device synchronize on the card."""
    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    fn()
    sync()
    ts = []
    for _ in range(max(1, reps)):
        t0 = time.perf_counter()
        fn()
        sync()
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts) * 1e3)


# -------------------------------------------------------- four-step plans
def _balanced_split(n: int) -> tuple[int, int]:
    a = int(np.sqrt(n))
    while a > 1 and n % a != 0:
        a -= 1
    return a, n // a


def _split_to_radix(n: int, radix: int) -> Optional[list[int]]:
    """Factor ``n`` into factors <= ``radix`` by greedily peeling the
    largest divisor; None when a prime factor exceeds the radix."""
    out: list[int] = []
    while n > 1:
        f = min(n, radix)
        while f > 1 and n % f != 0:
            f -= 1
        if f == 1:
            return None
        out.append(f)
        n //= f
    return out


def candidate_factor_plans(ell: int) -> list[list[int]]:
    """Candidate radix plans for a length-``ell`` four-step: the balanced
    two-factor split, then plans whose largest dense DFT factor is capped
    at 64, 32 and 16 (the sum of the factors is the flop count per
    element; a smaller cap trades flops for more stages)."""
    plans: list[list[int]] = []
    a, b = _balanced_split(ell)
    if a > 1:
        plans.append([a, b])
    for radix in (64, 32, 16):
        p = _split_to_radix(ell, radix)
        if p and len(p) >= 2 and p not in plans:
            plans.append(p)
    return plans or [[1, ell]]


def tune_fourstep(ell: int, batch: int = 4, *, device, reps: int = 5,
                  persist: bool = True) -> dict:
    """Measure four-step variants on ``batch`` rows of length ``ell`` on
    ``device`` and record the winner.

    Candidates: ``("fused", plan)`` for each radix plan, then
    ``("two_pass", None)``; the platform FFT is never one.  A candidate
    is skipped only where ``ops.fourstep_route`` settles it before any
    launch: it refuses it (``ValueError``, the gate), or sends it to the
    platform FFT (a near-prime ``ell``, whose only plan is (1, ell)).  A
    build or launch error propagates.  The winning ``{"variant",
    "factors", "ms"}`` entry is recorded under ``fourstep|L=...|mode=...``
    in the device's table; where no kernel candidate is left, nothing is
    timed and ``{"variant": "xla"}`` is recorded, the route the
    dispatcher takes there anyway, so the warm path runs no search.
    """
    global _SEARCHES
    from repro_torch.kernels import ops  # ops imports this module

    device = torch.device(device)
    _SEARCHES += 1
    cands = [("fused", [int(f) for f in p])
             for p in candidate_factor_plans(ell)] + [("two_pass", None)]
    kernels = []
    for variant, factors in cands:
        try:
            route, _ = ops.fourstep_route(ell, variant=variant,
                                          factors=factors, device=device)
        except ValueError:
            continue
        if route != "xla":
            kernels.append((variant, factors))

    best: dict = {"variant": "xla"}
    if kernels:
        rng = np.random.default_rng(0)
        xr, xi = (torch.as_tensor(rng.standard_normal((batch, ell)),
                                  dtype=torch.float32, device=device)
                  for _ in range(2))
        for variant, factors in kernels:
            ms = _time_ms(lambda: ops.fourstep_planar(
                xr, xi, variant=variant, factors=factors), device, reps)
            if "ms" not in best or ms < best["ms"]:
                best = {"variant": variant, "ms": ms}
                if factors is not None:
                    best["factors"] = factors
    return record("fourstep", best, persist=persist,
                  backend=backend_of(device), L=ell, mode=mode_of(device))


def ensure_fourstep(ell: int, batch: int = 4, *, device, **kw) -> dict:
    """Warm path: the recorded entry, searching only on a miss."""
    device = torch.device(device)
    ent = lookup("fourstep", backend=backend_of(device), L=ell,
                 mode=mode_of(device))
    if ent is not None:
        return ent
    return tune_fourstep(ell, batch, device=device, **kw)
