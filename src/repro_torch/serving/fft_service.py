"""The straggler-tolerant FFT service, c2c slice, on the hand-written kernels.

Clients submit transform requests; the service runs them under the
(N, m) coded plan and answers as soon as the fastest ``m`` of ``N``
simulated workers respond.  Each worker's latency is a shifted-exponential
draw; the reported coded latency is the m-th order statistic.

Requests are bucketed by length ``s``, stacked, padded to a power-of-two
bucket and pushed through ONE bucket executor with a per-request
responder mask.  The executor (the device-decode path) takes the requests
and the RAW masks; on a c2c bucket it runs

* the whole-bucket kernel (``ops.coded_bucket_masked``: subset selection,
  Lagrange decode, four-step, encode, decode and recombine in one launch)
  when the bucket fits one block's shared memory
  (``ops.coded_bucket_fusable``), else
* the stage route: ``mask_subsets`` + ``lagrange_scatter_planes`` (plain
  PyTorch), then the ``encode_fourstep_fused``, ``bcmatmul`` and
  ``recombine_twiddle_dft_batched`` kernels.

``use_reference=True`` (or a complex128 dtype) runs ``CodedFFT.run`` on
the reference backend instead.  ``submit_batch`` launches every bucket
before it waits, then makes ONE device-to-host transfer for the call.

The numpy straggler draws happen in the reference service's order
(one ``default_rng(cfg.seed)``, one vectorized draw per bucket), so a
same-seed reference service sees the same masks and the same
``coded_latency``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.core import mds
from repro_torch.core.coded_fft import CodedFFT
from repro_torch.core.plan import resolve_device
from repro_torch.distributed.straggler import StragglerModel
from repro_torch.kernels import ops, ref
from repro_torch.serving.batching import bucket_size

__all__ = ["FFTService", "FFTServiceConfig", "ServiceStats"]

_NUMPY_DTYPE = {torch.complex64: np.complex64, torch.complex128: np.complex128}


@dataclasses.dataclass(frozen=True)
class FFTServiceConfig:
    s: int = 4096                 # default transform length
    m: int = 4                    # storage fraction 1/m
    n_workers: int = 8
    dtype: torch.dtype = torch.complex64
    straggler: StragglerModel = StragglerModel(t0=1.0, mu=1.0)
    seed: int = 0
    use_reference: bool = False   # escape hatch: CodedFFT.run, reference
    #                               backend
    max_batch: int = 64           # bucket cap per length
    # -- the options below are served by later slices of the port; a
    #    non-default value raises NotImplementedError at construction
    device_decode: bool = True    # False = host decode-matrix cache
    precision: str = "f32"        # "bf16" plane precision
    faults: Optional[object] = None
    health: bool = False
    verify: str = "off"
    measured: bool = False
    strategy: str = "mds"


# config values this slice does not serve -> the ROADMAP item serving them
_LATER = {
    "device_decode": (True, "the host decode-matrix path "
                      "(coded_fft_bucket + serving/decode_cache.py)"),
    "precision": ("f32", "bf16 planes (kernels/autotune.py + the bf16 probe)"),
    "faults": (None, "the fault runtime"),
    "health": (False, "the fault runtime"),
    "verify": ("off", "the fault runtime"),
    "measured": (False, "the fault runtime"),
    "strategy": ("mds", "the strategy zoo"),
}


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not served by the PyTorch port yet -- see ROADMAP.md, "
        f"{item}")


@dataclasses.dataclass
class ServiceStats:
    requests: int = 0
    batches: int = 0               # bucket executor invocations
    coded_latency: float = 0.0     # sum of m-th order statistics
    uncoded_latency: float = 0.0   # sum of "wait for everyone" latencies
    stragglers_tolerated: int = 0
    dispatch_s: float = 0.0        # wall time staging + launching buckets
    sync_s: float = 0.0            # wall time blocked on device results
    host_transfers: int = 0        # device->host fetches (1 per submit_batch)

    def summary(self) -> dict:
        n = max(self.requests, 1)
        return {
            "requests": self.requests,
            "batches": self.batches,
            "mean_coded_latency": self.coded_latency / n,
            "mean_uncoded_latency": self.uncoded_latency / n,
            "speedup": (self.uncoded_latency / self.coded_latency
                        if self.coded_latency > 0 else float("nan")),
            "stragglers_tolerated": self.stragglers_tolerated,
            "dispatch_s": self.dispatch_s,
            "sync_s": self.sync_s,
            "host_transfers": self.host_transfers,
        }


class FFTService:
    """Batched straggler-tolerant FFT front end (c2c kind).

    Requests of any length with ``m | s`` are accepted; each length gets
    its own plan and bucket executors.  ``device=None`` runs on CUDA and
    raises without a GPU; ``device="cpu"`` runs the kernels' plain
    PyTorch versions (the tests' mode) with the same route decisions.
    """

    KINDS = ("c2c",)

    def __init__(self, cfg: FFTServiceConfig, device=None, *, mesh=None,
                 pool=None):
        for name, (default, item) in _LATER.items():
            if getattr(cfg, name) != default:
                raise _not_ported(f"{name}={getattr(cfg, name)!r}", item)
        if cfg.m > mds.LAGRANGE_MAX_M:
            raise _not_ported(
                f"m={cfg.m} > LAGRANGE_MAX_M={mds.LAGRANGE_MAX_M}",
                "the host decode-matrix path (coded_fft_bucket + "
                "serving/decode_cache.py)")
        if mesh is not None:
            raise _not_ported("a mesh", "the multi-device runtime")
        if pool is not None:
            raise _not_ported("an elastic worker pool", "the fault runtime")
        if cfg.dtype not in _NUMPY_DTYPE:
            raise ValueError(f"dtype must be complex64 or complex128, got "
                             f"{cfg.dtype}")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.rng = np.random.default_rng(cfg.seed)
        self.stats = ServiceStats()
        self._plans: dict[int, CodedFFT] = {}
        self._runners: dict[tuple, object] = {}
        self._gplanes: Optional[tuple[torch.Tensor, torch.Tensor]] = None
        self.plan = self._plan_for(cfg.s)

    # -- plans, generator state and executors ----------------------------
    def _plan_for(self, s: int) -> CodedFFT:
        if s not in self._plans:
            cfg = self.cfg
            self._plans[s] = CodedFFT(
                s=s, m=cfg.m, n_workers=cfg.n_workers, dtype=cfg.dtype,
                backend="reference" if cfg.use_reference else "kernel",
                device=self.device)
        return self._plans[s]

    def generator_planes(self) -> tuple[torch.Tensor, torch.Tensor]:
        """The (N, m) generator as f32 planes on the service's device --
        the code's only state, shared by every bucket length."""
        if self._gplanes is None:
            self._gplanes = ref.planar(self.plan.generator)
        return self._gplanes

    def load_generator(self, gr: torch.Tensor, gi: torch.Tensor) -> None:
        """Replace the kernel path's generator planes (e.g. with another
        implementation's, via ``repro_torch.convert``).  Drops the built
        executors, which captured the old planes."""
        want = (self.cfg.n_workers, self.cfg.m)
        if tuple(gr.shape) != want or tuple(gi.shape) != want:
            raise ValueError(f"generator planes must be {want}, got "
                             f"{tuple(gr.shape)} / {tuple(gi.shape)}")
        self._gplanes = (gr.to(self.device, torch.float32).contiguous(),
                         gi.to(self.device, torch.float32).contiguous())
        self._runners.clear()

    def _kernel_path(self, s: int) -> bool:
        """Does this length run the bucket kernels (else ``plan.run``)?"""
        return self._plan_for(s).resolved_backend == "kernel"

    def _runner_for(self, s: int, bucket: int):
        key = (s, bucket, self._kernel_path(s))
        if key not in self._runners:
            if key[2]:
                self._runners[key] = self._make_masked_runner(s, bucket)
            else:
                plan = self._plan_for(s)
                self._runners[key] = lambda xb, masks: plan.run(
                    xb, mask=masks)
        return self._runners[key]

    def _make_masked_runner(self, s: int, bucket: int):
        """The device-decode bucket executor: ``(requests, raw masks) ->
        spectra``, on the whole-bucket kernel when the bucket fits one
        block's shared memory, else on the stage kernels."""
        m, n = self.cfg.m, self.cfg.n_workers
        gr, gi = self.generator_planes()
        whole = ops.coded_bucket_fusable(s, m, n)
        ell = s // m

        def fn(xb: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
            xr, xi = ref.planar(xb)
            if whole:
                yr, yi = ops.coded_bucket_masked(xr, xi, masks, gr, gi, s)
            else:
                subsets = ops.mask_subsets(masks, m)
                dr, di = ops.lagrange_scatter_planes(subsets, n)
                # interleave on planes: c_i[j] = x[i + j*m]
                cr = xr.reshape(bucket, ell, m).transpose(1, 2)
                ci = xi.reshape(bucket, ell, m).transpose(1, 2)
                br, bi = ops.encode_worker(cr, ci, gr, gi)
                hr, hi = ops.decode_apply(dr, di, br, bi)
                yr, yi = ops.recombine_planar(hr, hi, s)
            return ref.unplanar(yr, yi)

        return fn

    # -- straggler simulation --------------------------------------------
    def _simulate_arrivals(self, n_requests: int
                           ) -> tuple[np.ndarray, np.ndarray]:
        """Per-request worker latencies + availability masks at decode
        time: ONE vectorized draw per bucket, the mask admitting the
        fastest ``m`` (the m-th order statistic and everything before).
        c2c shards ship the full payload (``payload_scale=1``)."""
        cfg = self.cfg
        lat = cfg.straggler.sample(
            (n_requests, cfg.n_workers), 1.0 / cfg.m, self.rng)
        t_done = np.sort(lat, axis=-1)[:, cfg.m - 1]
        return lat, lat <= t_done[:, None]

    def _account(self, lat: np.ndarray, mask: np.ndarray) -> None:
        lat_sorted = np.sort(lat, axis=-1)
        self.stats.requests += lat.shape[0]
        self.stats.coded_latency += float(lat_sorted[:, self.cfg.m - 1].sum())
        self.stats.stragglers_tolerated += int((~mask).sum())
        self.stats.uncoded_latency += float(lat_sorted[:, -1].sum())

    # -- staging seam ----------------------------------------------------
    def bucket_key(self, x, kind: str) -> int:
        """The bucket length one request lands in."""
        if kind not in self.KINDS:
            raise _not_ported(f"request kind {kind!r}",
                              "the real kinds (r2c/c2r) and n-D")
        return int(x.shape[-1])

    def _bucket_buffer(self, s: int, bucket: int) -> np.ndarray:
        return np.zeros((bucket, s), dtype=_NUMPY_DTYPE[self.cfg.dtype])

    def stage_bucket(self, s: int, kind: str, reqs: Sequence) -> tuple:
        """Host-side staging for one bucket of same-length requests: the
        straggler draw, the pack into the padded bucket buffer and the
        host->device copy.  Returns ``(bucket, args)``."""
        cfg = self.cfg
        n_live = len(reqs)
        bucket = bucket_size(n_live, cfg.max_batch)
        self.stats.batches += 1
        xb = self._bucket_buffer(s, bucket)
        for row, x in enumerate(reqs):
            xb[row] = (x.cpu().numpy() if isinstance(x, torch.Tensor)
                       else np.asarray(x))
        lat, mask = self._simulate_arrivals(n_live)
        self._account(lat, mask)
        # padded rows: every worker "responds" so decode stays well-posed
        masks = np.ones((bucket, cfg.n_workers), bool)
        masks[:n_live] = mask
        return bucket, (torch.from_numpy(xb).to(self.device),
                        torch.from_numpy(masks).to(self.device))

    def launch_bucket(self, s: int, bucket: int, kind: str,
                      args: tuple) -> torch.Tensor:
        """Launch one staged bucket; returns the UNSYNCED device result."""
        return self._runner_for(s, bucket)(*args)

    # -- public API ------------------------------------------------------
    def submit(self, x) -> np.ndarray:
        """One request: returns F{x}, never waiting for stragglers."""
        return self.submit_batch([x])[0]

    def submit_batch(self, xs: Sequence,
                     kind: Union[str, Sequence[str]] = "c2c"
                     ) -> list[np.ndarray]:
        """Serve a batch of requests, bucketed by length.

        Every bucket is staged and launched before any wait; then ONE
        device->host transfer fetches all results, returned in submission
        order as host arrays.
        """
        kinds = [kind] * len(xs) if isinstance(kind, str) else list(kind)
        if len(kinds) != len(xs):
            raise ValueError(f"per-request kinds: got {len(kinds)} kinds "
                             f"for {len(xs)} requests")
        by_bucket: dict[int, list[int]] = {}
        for i, (x, k) in enumerate(zip(xs, kinds)):
            by_bucket.setdefault(self.bucket_key(x, k), []).append(i)

        t0 = time.perf_counter()
        pending: list[tuple[list[int], torch.Tensor]] = []
        for s, idxs in by_bucket.items():
            for start in range(0, len(idxs), self.cfg.max_batch):
                chunk = idxs[start:start + self.cfg.max_batch]
                bucket, args = self.stage_bucket(s, "c2c",
                                                 [xs[i] for i in chunk])
                pending.append((chunk, self.launch_bucket(s, bucket, "c2c",
                                                          args)))
        self.stats.dispatch_s += time.perf_counter() - t0

        t0 = time.perf_counter()
        flat = torch.cat([out.reshape(-1) for _, out in pending]).cpu()
        self.stats.host_transfers += 1
        self.stats.sync_s += time.perf_counter() - t0
        results: list[Optional[np.ndarray]] = [None] * len(xs)
        offset = 0
        for chunk, out in pending:
            rows = flat[offset:offset + out.numel()].reshape(out.shape)
            offset += out.numel()
            for row, i in enumerate(chunk):
                results[i] = rows[row].numpy()
        return results  # type: ignore[return-value]

    def warmup(self, lengths: Optional[Sequence[int]] = None,
               buckets: Optional[Sequence[int]] = None) -> int:
        """Run every bucket executor once (default: the config length at
        every power-of-two bucket up to ``max_batch``) so kernel libraries
        and plane tables are built before traffic arrives.  Returns the
        number of executors run."""
        cfg = self.cfg
        lengths = [cfg.s] if lengths is None else list(lengths)
        if buckets is None:
            buckets, b = [], 1
            while b < cfg.max_batch:
                buckets.append(b)
                b *= 2
            buckets.append(cfg.max_batch)
        count = 0
        for s in lengths:
            for b in sorted(set(buckets)):
                xb = torch.from_numpy(self._bucket_buffer(s, b)).to(
                    self.device)
                masks = torch.ones((b, cfg.n_workers), dtype=torch.bool,
                                   device=self.device)
                self._runner_for(s, b)(xb, masks)
                count += 1
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return count
