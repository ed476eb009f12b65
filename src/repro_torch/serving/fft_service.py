"""The straggler-tolerant FFT service on the hand-written kernels.

Clients submit transform requests; the service runs them under the
(N, m) coded plan and answers as soon as the fastest ``m`` of ``N``
simulated workers respond.  Each worker's latency is a shifted-exponential
draw; the reported coded latency is the m-th order statistic.

Requests are bucketed by ``(s, kind)``, stacked, padded to a power-of-two
bucket and pushed through ONE bucket executor with a per-request
responder mask.  ``kind`` is ``"c2c"`` (complex forward), ``"r2c"`` (real
input -> half spectrum), ``"c2r"`` (half spectrum -> real output), or the
n-D real pair ``"rfftn"`` / ``"irfftn"``; ``s`` is the time-domain
extent, so a c2r request of ``h`` bins lands in ``s = 2*(h-1)``, and an
n-D request's ``s`` is its time-domain shape tuple.  On the device-decode
path (the default, for
``m <= mds.LAGRANGE_MAX_M``) the executor takes the requests and the RAW
masks; on a c2c bucket it runs

* the whole-bucket kernel (``ops.coded_bucket_masked``: subset selection,
  Lagrange decode, four-step, encode, decode and recombine in one launch)
  when the bucket fits one block's shared memory
  (``ops.coded_bucket_fusable``), else
* the masked streaming bucket kernel (the same function in four
  launches, the decode first) where ``ops.coded_bucket_streamable``
  admits the bucket, as the reference routes it, else
* the stage route: ``mask_subsets`` + ``lagrange_scatter_planes`` (plain
  PyTorch), then the ``encode_fourstep_fused``, ``bcmatmul`` and
  ``recombine_twiddle_dft_batched`` kernels.

The real kinds carry half-length packed payloads and run their own
whole-bucket kernel (``ops.coded_rbucket_masked``,
``ops.coded_irbucket_masked``) under its gate, else the stage route:
plain-PyTorch pack/split or message/unpack glue around the same
``encode_fourstep_fused`` and ``bcmatmul`` kernels.

The host decode-matrix path serves ``device_decode=False`` and codes
wider than the closed-form Lagrange decode serves (``m >
LAGRANGE_MAX_M``, up to the stage kernels' bounds): each request's (m,
N) scatter decode matrix comes from a complex128 host LRU
(``serving.decode_cache``, one per service, shared by every ``(s,
kind)``), and the bucket ships as the requests plus ONE (2, q, m, N) f32
plane stack.  The executor runs the kind's planes whole-bucket kernel
(``ops.coded_bucket``, ``ops.coded_rbucket``, ``ops.coded_irbucket``)
under its gate; a c2c bucket past it that ``ops.coded_bucket_streamable``
admits runs the streaming bucket kernel, as the reference routes it;
anything else takes the same stage route with the host planes as its
decode.

``precision="bf16"`` runs the whole-bucket and streaming kernels on
bfloat16 DFT, twiddle and recombine planes (f32 payload, G, decode and
accumulation) for each ``(s, m, kind)`` whose probe keeps the error
within ``ops.BF16_RTOL``; the verdict lives in the device's autotune
table (``_precision_for``).  The stage route, the n-D kinds, the
strategies, a mesh and ``plan.run`` stay f32, as in the reference.

The n-D kinds always run the ``plan.run`` executor of their plan
(``CodedRFFTN`` / ``CodedIRFFTN``, factors from ``plan_factors`` with
``even_last_shard=True``), as the reference routes them: the ``cmatmul``
encode, the four-step kernels swept over each shard axis, and the
plan's decode (``cmatmul`` for a bucket of one, the per-request solve
otherwise).

The stage kernels hold the code's whole (N, m) G and (m, N) D in one
block's shared memory, and the recombine unrolls m up to 64: a length
whose bucket would take the stage route with a code past those bounds is
refused (``ops.check_stage_code``) when the service is built (for
``cfg.s``) or in ``bucket_key`` (any other length), before any straggler
draw.  Lengths whose buckets fuse or stream still serve.

``strategy=`` picks the plan serving the c2c buckets from the strategy
registry (``core.strategies``): ``"partial"`` (r sequentially-useful
fragments per worker, per-fragment masks) and ``"comm_efficient"`` (a
1/q folded payload at threshold m*q) run ``plan.run`` on the reference
backend -- ``torch.fft`` and the batched ``torch.linalg.solve`` -- as
the reference runs them on its jnp executor, with the draws, the wire
charge and the fault path's deadline machine at the plan's own
threshold; the other kinds, ``verify``, ``measured``, ``worker_fn`` and
the ``"repetition"`` baseline are refused with the reference's errors.

``use_reference=True`` (or a complex128 dtype) runs ``plan.run`` on the
reference backend instead; a ``worker_fn`` plug-in (c2c only) or a
pinned ``decode_method`` runs ``plan.run(..., method=decode_method)`` on
the plans' own kernel backend (the ``cmatmul`` encode, the four-step
worker or the plug-in, the chosen decode), as the reference routes them.
``submit_batch`` launches every bucket before it waits, then makes ONE
device-to-host transfer for the call.

``mesh=`` (a ``torch.distributed`` ``DeviceMesh`` whose ``axis``
dimension carries the workers) serves every bucket of every kind through
``DistributedCodedPlan.run`` on the bucket's plan (kernel backend unless
``use_reference``): each rank encodes and transforms its own coded rows,
one all-gather fans them in, and every rank decodes.  Each rank calls
``submit_batch`` with the same requests, and a same-seed service on every
rank draws the same masks, so every rank returns the same outputs.  The
fault-tolerant path does not compose with a mesh, as in the reference.

The numpy straggler draws happen in the reference service's order
(one ``default_rng(cfg.seed)``, one vectorized draw per bucket), so a
same-seed reference service sees the same masks and the same
``coded_latency``; real-kind shards ship half the c2c payload, so their
draws charge the wire share at ``payload_scale=0.5``.

The fault-tolerant path (opt-in: ``faults``, ``health``, ``verify``,
``measured`` or an ``ElasticWorkerPool``) derives each round's masks at
launch time from a learned DEADLINE (``WorkerHealthTracker``) with capped
retry and re-dispatch rounds, in the reference's draw order (the
straggler times, the injected kills and delays, then a fresh draw per
re-dispatch round).  With ``verify="off"`` and no live corruption it
serves the bucket through the same bucket executor, fed the deadline
masks; otherwise (the instrumented path) a kernel-backend plan computes
real worker rows -- the ``cmatmul`` encode and the four-step worker --,
the injector corrupts them, and each request is verified on the host
(complex128 syndromes) and decoded by the plan (``cmatmul``).
``measured=True`` runs c2c buckets on the thread-per-worker
``MeasuredWorkerRuntime``.  A request that cannot be served gets a typed
:class:`ServiceError` (``on_failure="raise"``) or a
:class:`DegradedResult` slot (``"degrade"``).  Plans, generator planes,
decode caches and executors are keyed by the live code size N, which an
elastic pool can grow.
"""

from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.core import mds
from repro_torch.core.coded_fft import CodedFFT, plan_factors
from repro_torch.core.fault_tolerance import detect_errors, robust_decode
from repro_torch.core.plan import resolve_device
from repro_torch.core.rfft import CodedIRFFT, CodedRFFT
from repro_torch.core.rfftn import CodedIRFFTN, CodedRFFTN
from repro_torch.core.strategies import REGISTRY, make_strategy
from repro_torch.distributed.coded_runtime import DistributedCodedPlan
from repro_torch.distributed.elastic import ElasticWorkerPool
from repro_torch.distributed.faults import (
    FaultInjector,
    FaultPlan,
    RoundFaults,
)
from repro_torch.distributed.health import WorkerHealthTracker
from repro_torch.distributed.straggler import StragglerModel
from repro_torch.distributed.worker_runtime import MeasuredWorkerRuntime
from repro_torch.kernels import autotune, ops, ref
from repro_torch.serving.batching import LatencyHistogram, bucket_size
from repro_torch.serving.decode_cache import DecodeMatrixCache

__all__ = ["DegradedResult", "FAILURE_REASONS", "FFTService",
           "FFTServiceConfig", "ServiceError", "ServiceStats"]

_NUMPY_DTYPE = {torch.complex64: np.complex64, torch.complex128: np.complex128}
_PLAN_CLASS = {"c2c": CodedFFT, "r2c": CodedRFFT, "c2r": CodedIRFFT,
               "rfftn": CodedRFFTN, "irfftn": CodedIRFFTN}
# per kind: the whole-bucket masked and planes entry points
_WHOLE = {
    "c2c": (ops.coded_bucket_masked, ops.coded_bucket),
    "r2c": (ops.coded_rbucket_masked, ops.coded_rbucket),
    "c2r": (ops.coded_irbucket_masked, ops.coded_irbucket),
}

# machine-readable per-request failure reasons
FAILURE_REASONS = ("insufficient_workers", "retries_exhausted",
                   "corrupt_uncorrectable")


class ServiceError(RuntimeError):
    """Typed per-request failure from the fault-tolerant service path.

    ``reason`` is one of :data:`FAILURE_REASONS`:

    * ``insufficient_workers`` -- fewer than ``m`` live workers exist (or
      none are healthy enough to re-dispatch to), so the MDS threshold is
      unreachable no matter how long the master waits.
    * ``retries_exhausted`` -- ``m`` responses never arrived inside the
      capped retry windows (``max_retries`` x ``retry_backoff``).
    * ``corrupt_uncorrectable`` -- the Byzantine syndrome check failed and
      correction was impossible (``verify="detect"``, or more than
      ``floor((k - m)/2)`` corrupt responders under ``verify="correct"``).

    Surfaces as a raised exception from ``submit_batch``
    (``on_failure="raise"``), a :class:`DegradedResult` slot
    (``on_failure="degrade"``), and a per-request Future exception on the
    streaming path -- never as a dead scheduler thread.
    """

    def __init__(self, reason: str, detail: str = ""):
        if reason not in FAILURE_REASONS:
            raise ValueError(f"unknown failure reason {reason!r}")
        super().__init__(f"request failed: {reason}"
                         + (f" ({detail})" if detail else ""))
        self.reason = reason
        self.detail = detail


@dataclasses.dataclass(frozen=True)
class DegradedResult:
    """Graceful-degradation slot value (``on_failure="degrade"``).

    Takes the place of the transform result for a request the fault path
    could not serve; ``reason``/``detail`` mirror :class:`ServiceError`.
    """

    reason: str
    detail: str = ""

    @property
    def ok(self) -> bool:
        return False


class _Launched:
    """A launched robust bucket: its rows on the device + per-row errors."""

    __slots__ = ("out", "errors")

    def __init__(self, out: torch.Tensor, errors: list):
        self.out = out          # (bucket, *output_shape), not synced
        self.errors = errors    # per-bucket-row Optional[ServiceError]


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
    device_decode: bool = True    # decode matrices from the raw masks on
    #                               the device; False, or m >
    #                               LAGRANGE_MAX_M, takes the host LRU
    decode_cache_size: int = 512  # LRU size of per-mask decode matrices
    #                               (the host decode-matrix path)
    worker_fn: Optional[object] = None  # c2c worker plug-in (fft along
    #                               the last axis, torch in and out):
    #                               runs plan.run
    decode_method: str = "auto"   # "solve" | "ifft" pins the plan's MDS
    #                               decode: runs plan.run
    autotune: bool = True         # time the four-step variants and radix
    #                               plans at warmup() and persist the
    #                               winners to the device's JSON table
    #                               (kernels/autotune.py); dispatch routes
    #                               by shape on a miss
    autotune_reps: int = 3        # timing repetitions per candidate
    # -- fault-tolerant runtime (opt-in) ----------------------------------
    faults: Optional[FaultPlan] = None  # seeded kill/delay/corrupt schedule;
    #                               None leaves every code path the
    #                               fault-free one
    health: bool = False          # track per-worker EWMAs and derive each
    #                               round's availability mask from a DEADLINE
    #                               (m-th-fastest estimate + slack) instead of
    #                               a straggler draw's m-th order statistic
    deadline_slack: float = 0.5   # deadline = (1 + slack) * m-th-fastest
    max_retries: int = 2          # re-dispatch rounds for missing shards
    retry_backoff: float = 2.0    # wait-window multiplier per retry
    verify: str = "off"           # Byzantine check on surplus responses when
    #                               k > m arrive: "off" | "detect" | "correct"
    #                               (detect k-m, correct floor((k-m)/2))
    verify_quorum: int = 2        # measured path only: extra rows beyond m
    #                               the master waits for when verify is on
    on_failure: str = "raise"     # "raise" ServiceError from submit_batch, or
    #                               "degrade" to a DegradedResult slot
    measured: bool = False        # run c2c buckets on the thread-per-worker
    #                               MeasuredWorkerRuntime (wall-clock
    #                               deadlines and retries, rows from the
    #                               service's device)
    require_all: bool = False     # measured path waits for ALL live workers
    #                               (the uncoded baseline)
    # -- computation strategy --------------------------------------------
    strategy: str = "mds"         # registered strategy serving the c2c
    #                               buckets: "mds" (the paper's code),
    #                               "partial" (Wang 1804.09791: r fragments
    #                               per worker, decode from any m*r),
    #                               "comm_efficient" (Jeong 1805.09891:
    #                               1/q payload at threshold m*q), or
    #                               "repetition" (bench-only, refused).
    #                               Non-"mds" strategies are c2c-only and
    #                               run the plan.run executor on torch
    strategy_param: Optional[int] = None  # the strategy's own knob (r for
    #                               partial, q for comm_efficient); None
    #                               means the registry entry's default
    precision: str = "f32"        # kernel plane precision: "bf16" casts the
    #                               whole-bucket kernels' DFT, twiddle and
    #                               recombine planes to bfloat16 (f32
    #                               payload and accumulation) where a
    #                               per-shape probe keeps the error within
    #                               ops.BF16_RTOL; any other value is f32


@dataclasses.dataclass
class ServiceStats:
    requests: int = 0
    batches: int = 0               # bucket executor invocations
    coded_latency: float = 0.0     # sum of m-th order statistics
    uncoded_latency: float = 0.0   # sum of "wait for everyone" latencies
    stragglers_tolerated: int = 0
    dispatch_s: float = 0.0        # wall time staging + launching buckets
    sync_s: float = 0.0            # wall time blocked on device results
    host_transfers: int = 0        # device->host fetches (1 per submit_batch
    #                                call; 1 per bucket on the streaming path)
    decode_cache_hits: int = 0     # host decode-matrix LRU hits
    decode_cache_misses: int = 0   # ... and misses (host inversions paid)
    # -- open-loop streaming observables (serving/streaming.py) -----------
    queue_peak: int = 0            # high-water mark of undispatched requests
    rejected: int = 0              # admission-control rejections (both
    #                                "queue_full" and "closed" reasons)
    cancelled: int = 0             # futures the caller cancelled before
    #                                resolution (the bucket still computed)
    fill_dispatches: int = 0       # buckets dispatched because they filled
    deadline_dispatches: int = 0   # ... because the earliest deadline
    #                                across bucket heads expired (EDF)
    drain_dispatches: int = 0      # ... flushed by drain()/close()
    staging_overlap_s: float = 0.0  # host staging wall time hidden behind
    #                                 a downstream bucket's device compute
    # -- fault-tolerant runtime observables -------------------------------
    retries: int = 0               # retry rounds performed (window extensions)
    redispatched_shards: int = 0   # shard computations re-dispatched to
    #                                healthy workers after a missed deadline
    degraded: int = 0              # requests that failed with a typed reason
    detected: int = 0              # corrupt workers caught by the syndrome
    #                                check (verify="detect"/"correct")
    corrected: int = 0             # ... of those, corrected (verify="correct")
    latency: LatencyHistogram = dataclasses.field(
        default_factory=LatencyHistogram)  # per-request arrival->result
    tier_latency: dict = dataclasses.field(default_factory=dict)
    #                              # per-SLO-tier LatencyHistogram, keyed by
    #                                tier name (streaming front-end only)

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
            "decode_cache_hits": self.decode_cache_hits,
            "decode_cache_misses": self.decode_cache_misses,
            "dispatch_s": self.dispatch_s,
            "sync_s": self.sync_s,
            "host_transfers": self.host_transfers,
            "queue_peak": self.queue_peak,
            "rejected": self.rejected,
            "cancelled": self.cancelled,
            "fill_dispatches": self.fill_dispatches,
            "deadline_dispatches": self.deadline_dispatches,
            "drain_dispatches": self.drain_dispatches,
            "staging_overlap_s": self.staging_overlap_s,
            "retries": self.retries,
            "redispatched_shards": self.redispatched_shards,
            "degraded": self.degraded,
            "detected": self.detected,
            "corrected": self.corrected,
            "latency": self.latency.summary(),
            "tiers": {name: hist.summary()
                      for name, hist in sorted(self.tier_latency.items())},
        }


class FFTService:
    """Batched straggler-tolerant FFT front end (c2c, r2c, c2r, rfftn and
    irfftn kinds).

    Requests of any length with ``m | s`` (``2m | s`` for the real kinds,
    along the last axis's shard for the n-D kinds) are accepted; each
    ``(s, kind)`` gets its own plan and bucket executors.
    ``device=None`` runs on CUDA and raises without a GPU;
    ``device="cpu"`` runs the kernels' plain PyTorch versions (the tests'
    mode) with the same route decisions.  ``pool``: an
    ``ElasticWorkerPool`` with the config's ``m`` whose membership the
    fault-tolerant path reads each round (its capacity is the live N).
    ``close()`` stops the measured runtime's worker threads.
    ``cfg.strategy`` other than ``"mds"`` serves c2c only, through the
    strategy's plan on the ``plan.run`` executor.  ``mesh``: a
    ``DeviceMesh`` (device type that of ``device``) whose ``axis``
    dimension runs the workers through ``DistributedCodedPlan``; every
    rank builds the same service and submits the same requests.
    """

    KINDS = ("c2c", "r2c", "c2r", "rfftn", "irfftn")
    # half-payload kinds: workers ship pair-packed shards with a halved
    # (last) axis, so their wire time is charged at payload_scale=0.5
    REAL_KINDS = ("r2c", "c2r", "rfftn", "irfftn")
    # n-D kinds bucket by the time-domain shape tuple and run the plan.run
    # executor (the bucket kernels are 1-D layouts)
    ND_KINDS = ("rfftn", "irfftn")

    def __init__(self, cfg: FFTServiceConfig, device=None, *, mesh=None,
                 axis: str = "workers",
                 pool: Optional[ElasticWorkerPool] = None):
        if cfg.verify not in ("off", "detect", "correct"):
            raise ValueError(
                f'verify must be "off"|"detect"|"correct", got {cfg.verify!r}')
        if cfg.on_failure not in ("raise", "degrade"):
            raise ValueError(
                f'on_failure must be "raise"|"degrade", got {cfg.on_failure!r}')
        if cfg.strategy not in REGISTRY:
            raise ValueError(
                f"unknown strategy {cfg.strategy!r}; "
                f"registered: {sorted(REGISTRY)}")
        if cfg.strategy != "mds":
            # the Byzantine verifier and the measured runtime speak the
            # (N, m) MDS row code; the worker plug-in contract is the MDS
            # c2c worker
            if cfg.verify != "off" or cfg.measured:
                raise ValueError(
                    f"strategy {cfg.strategy!r} does not compose with "
                    f"verify/measured (MDS-row machinery)")
            if cfg.worker_fn is not None:
                raise ValueError(
                    f"worker_fn plug-ins apply to the mds strategy only, "
                    f"got strategy {cfg.strategy!r}")
            if cfg.strategy == "repetition":
                # its replication decode is host-side block assembly, not
                # the masked-subset protocol the bucket executors speak
                raise ValueError(
                    "the repetition baseline is bench-only; the service "
                    "serves subset-decodable strategies")
        if mesh is not None and not REGISTRY[cfg.strategy].mesh_ok:
            raise ValueError(
                f"strategy {cfg.strategy!r} does not compose with a mesh")
        if pool is not None and pool.m != cfg.m:
            raise ValueError(
                f"pool threshold m={pool.m} must match cfg.m={cfg.m}")
        if cfg.dtype not in _NUMPY_DTYPE:
            raise ValueError(f"dtype must be complex64 or complex128, got "
                             f"{cfg.dtype}")
        if cfg.decode_method not in ("auto", "solve", "ifft"):
            raise ValueError(f"unknown decode_method {cfg.decode_method!r}")
        self.cfg = cfg
        self.mesh = mesh
        self.axis = axis
        self.pool = pool
        self.device = resolve_device(device)
        self.rng = np.random.default_rng(cfg.seed)
        self.stats = ServiceStats()
        # plans, generator planes, decode-matrix LRUs and executors are
        # keyed by the live code size N: an elastic pool can GROW it, and
        # each N is a distinct roots-of-unity code
        self._plans: dict[tuple, object] = {}
        # the mesh runtimes over those plans, keyed by (s, m, kind, N)
        self._runtimes: dict[tuple, DistributedCodedPlan] = {}
        # the instrumented (verify / measured) path's kernel-backend plans
        self._kplans: dict[tuple, object] = {}
        self._runners: dict[tuple, object] = {}
        self._gplanes: dict[int, tuple[torch.Tensor, torch.Tensor]] = {}
        self._decode_caches: dict[int, DecodeMatrixCache] = {}
        # -- fault-tolerant runtime state ---------------------------------
        self._robust = (cfg.faults is not None or cfg.health
                        or cfg.verify != "off" or cfg.measured
                        or pool is not None)
        self.injector = (FaultInjector(cfg.faults)
                         if cfg.faults is not None else None)
        self.health = (WorkerHealthTracker(
            self._n_workers(), slack_frac=cfg.deadline_slack)
            if self._robust else None)
        self._measured: dict[tuple, MeasuredWorkerRuntime] = {}
        self._round = 0                # monotone fault/health round counter
        if self._robust and mesh is not None:
            raise ValueError("the fault-tolerant service path is host-"
                             "orchestrated; it does not compose with a mesh")
        self.plan = self._plan_for(cfg.s)
        self.runtime = (self._runtime_for(cfg.s) if mesh is not None
                        else None)
        self._check_servable(cfg.s, "c2c")

    def _n_workers(self) -> int:
        """Current code size N: the pool's capacity when elastic, else the
        config's."""
        return self.pool.capacity if self.pool is not None \
            else self.cfg.n_workers

    def close(self, wait: bool = False) -> None:
        """Stop the measured runtimes' worker threads (a no-op for a
        service that built none); ``wait=True`` also waits for rows still
        computing."""
        for rt in self._measured.values():
            rt.close(wait=wait)
        self._measured.clear()

    def _route(self, s: int, kind: str) -> str:
        """The kernel path's ``ops.bucket_route`` for ``(s, kind)``
        buckets at the live N on this service's decode path."""
        return ops.bucket_route(s, self.cfg.m, self._n_workers(), kind,
                                masked=self._device_decode())

    def _check_servable(self, s, kind: str) -> None:
        """Refuse, before any draw or staging, an ``(s, kind)`` bucket that
        would take the stage route with a code the stage kernels cannot
        carry (``ops.check_stage_code``); the recombine kernel serves the
        c2c kind only.  An n-D bucket's kernel-backend plan holds the (N,
        m) code in ``mds_apply``, so its code is checked the same way.  The
        code is the live one: an elastic pool's growth is checked before
        that bucket's draw."""
        cfg = self.cfg
        n = self._n_workers()
        if cfg.strategy != "mds":
            return      # the strategy plans hold no kernel-bounded code
        if kind in self.ND_KINDS:
            if (not cfg.use_reference
                    and ops.kernel_backend_supported(cfg.dtype)):
                ops.check_stage_code(
                    n, cfg.m,
                    f"the mds_apply of shape {tuple(s)} {kind} plans")
            return
        if self._kernel_path(s, kind) and self._route(s, kind) == "stage":
            ops.check_stage_code(
                n, self.cfg.m,
                f"the stage route of s={s} {kind} buckets",
                recombine=kind == "c2c")

    # -- plans, generator state and executors ----------------------------
    def _plan_for(self, s, kind: str = "c2c"):
        """The plan serving ``(s, kind)`` buckets: ``CodedFFT``,
        ``CodedRFFT``, ``CodedIRFFT``, or for the n-D kinds (``s`` the
        shape tuple) ``CodedRFFTN`` / ``CodedIRFFTN`` with the factors of
        ``plan_factors(s, m, even_last_shard=True)``, all on the same (N,
        m) code.  A real kind's plan raises its ``2m | s`` error here, and
        so does a non-c2c request on a ``worker_fn`` service.

        On the bucket-kernel path the plan only holds the code and checks
        the length -- the bucket kernels compute -- so it is built on the
        reference backend, free of the plan kernels' bounds; the
        ``plan.run`` executor's plan takes the kernel backend unless
        ``use_reference``.  Keyed by ``(s, kind, N)`` at the live N."""
        n = self._n_workers()
        key = (s, kind, n)
        if key not in self._plans:
            cfg = self.cfg
            if cfg.strategy != "mds":
                self._plans[key] = self._strategy_plan(s, kind, n)
                return self._plans[key]
            if cfg.worker_fn is not None and kind != "c2c":
                raise ValueError(
                    f"worker_fn plug-ins only apply to c2c buckets; got a "
                    f"{kind!r} request on a worker_fn service")
            if kind in self.ND_KINDS:
                shape = tuple(int(d) for d in s)
                kwargs = {"shape": shape, "factors": plan_factors(
                    shape, cfg.m, even_last_shard=True)}
            else:
                kwargs = {"s": s, "m": cfg.m}
                if kind == "c2c":
                    kwargs["worker_fn"] = cfg.worker_fn
            self._plans[key] = _PLAN_CLASS[kind](
                n_workers=n, dtype=cfg.dtype,
                backend=("reference" if cfg.use_reference
                         or self._kernel_path(s, kind) else "kernel"),
                device=self.device, **kwargs)
        return self._plans[key]

    def _runtime_for(self, s, kind: str = "c2c") -> DistributedCodedPlan:
        """The mesh runtime over the ``(s, kind)`` bucket's plan at the
        live N."""
        key = (s, self.cfg.m, kind, self._n_workers())
        if key not in self._runtimes:
            self._runtimes[key] = DistributedCodedPlan(
                self._plan_for(s, kind), self.mesh, self.axis)
        return self._runtimes[key]

    def _strategy_plan(self, s, kind: str, n: int):
        """A non-``mds`` strategy's plan from the registry: c2c only (the
        real and n-D pipelines are built on the (N, m) MDS row code),
        where the entry is applicable, always on the reference backend
        (``torch.fft`` and the batched solve), as the reference builds it
        (``StrategyEntry.kernel_ok``)."""
        cfg = self.cfg
        if kind != "c2c":
            raise ValueError(
                f"strategy {cfg.strategy!r} serves c2c buckets only; got a "
                f"{kind!r} request")
        if not REGISTRY[cfg.strategy].applicable(s, cfg.m, n,
                                                 cfg.strategy_param):
            raise ValueError(
                f"strategy {cfg.strategy!r} is not applicable at (s={s}, "
                f"m={cfg.m}, N={n}, param={cfg.strategy_param})")
        return make_strategy(cfg.strategy, s, cfg.m, n, dtype=cfg.dtype,
                             backend="reference", param=cfg.strategy_param,
                             device=self.device)

    def _instrumented_plan(self, s, kind: str):
        """The plan the instrumented path (verify, measured) computes real
        worker rows with.  A bucket-kernel bucket's ``_plan_for`` plan is
        on the reference backend (it only holds the code), so this is a
        kernel-backend plan of its own -- its ``encode`` runs ``cmatmul``,
        its ``worker_compute`` the four-step kernels, its one-request
        ``decode`` ``cmatmul`` -- cached by ``(s, kind, N)``.  Any other
        bucket's plan (``plan.run`` executor) already computes as the
        service does, and serves as it is."""
        if not self._kernel_path(s, kind):
            return self._plan_for(s, kind)
        cfg = self.cfg
        n = self._n_workers()
        key = (s, kind, n)
        if key not in self._kplans:
            self._kplans[key] = _PLAN_CLASS[kind](
                s=s, m=cfg.m, n_workers=n, dtype=cfg.dtype,
                backend="kernel", device=self.device)
        return self._kplans[key]

    def generator_planes(self) -> tuple[torch.Tensor, torch.Tensor]:
        """The live (N, m) generator as f32 planes on the service's
        device -- the code's only state, shared by every bucket length."""
        n = self._n_workers()
        if n not in self._gplanes:
            self._gplanes[n] = ref.planar(self._plan_for(self.cfg.s).generator)
        return self._gplanes[n]

    def load_generator(self, gr: torch.Tensor, gi: torch.Tensor) -> None:
        """Replace the kernel path's generator planes at the live N (e.g.
        with another implementation's, via ``repro_torch.convert``).
        Drops the built executors, which captured the old planes, and
        that N's decode-matrix LRU, which inverted them."""
        n = self._n_workers()
        want = (n, self.cfg.m)
        if tuple(gr.shape) != want or tuple(gi.shape) != want:
            raise ValueError(f"generator planes must be {want}, got "
                             f"{tuple(gr.shape)} / {tuple(gi.shape)}")
        self._gplanes[n] = (gr.to(self.device, torch.float32).contiguous(),
                            gi.to(self.device, torch.float32).contiguous())
        self._runners.clear()
        self._decode_caches.pop(n, None)

    def _decode_cache_for(self) -> DecodeMatrixCache:
        """The host decode-matrix LRU over the generator planes: one per
        live (N, m) code, shared by every ``(s, kind)``."""
        n = self._n_workers()
        if n not in self._decode_caches:
            gr, gi = self.generator_planes()
            g = gr.cpu().numpy() + 1j * gi.cpu().numpy()
            self._decode_caches[n] = DecodeMatrixCache(
                g.astype(np.complex64), maxsize=self.cfg.decode_cache_size)
        return self._decode_caches[n]

    def _kernel_path(self, s, kind: str = "c2c") -> bool:
        """Does this bucket run the bucket kernels (else ``plan.run``, or
        the mesh runtime)?  Not under a mesh, for an n-D kind (the bucket
        kernels are 1-D layouts), a non-``mds`` strategy (the bucket
        kernels are (N, m) MDS layouts), a reference or complex128
        service, a ``worker_fn`` plug-in or a pinned ``decode_method``
        (the reference's rule)."""
        cfg = self.cfg
        return (kind not in self.ND_KINDS and cfg.strategy == "mds"
                and self.mesh is None
                and not cfg.use_reference and cfg.worker_fn is None
                and cfg.decode_method == "auto"
                and ops.kernel_backend_supported(cfg.dtype))

    def _device_decode(self) -> bool:
        """Are decode matrices built on the device from the raw masks?
        True for ``m <= mds.LAGRANGE_MAX_M`` unless the config pins
        ``device_decode=False``; past that bound f32 planes cannot carry
        the subset inverse's conditioning, and the host LRU decodes."""
        return self.cfg.device_decode and self.cfg.m <= mds.LAGRANGE_MAX_M

    def _precision_for(self, s, kind: str) -> str:
        """The resolved plane precision of one ``(s, m, kind)`` bucket
        family on the kernel path.

        ``cfg.precision="bf16"`` is a request: the first bucket of each
        ``(s, m, kind)`` probes the bf16 whole-bucket kernel against its
        f32 run (:meth:`_probe_bf16`) and records the verdict ``{"ok":
        err <= ops.BF16_RTOL}`` in the device's autotune table under
        ``bf16|k=<kind>|m=<m>|mode=<mode>|s=<s>``, where it persists; a
        recorded verdict is read, never probed again.  Two differences
        from the reference, on purpose: a probe that raises (a bf16
        kernel that fails to build or launch) propagates instead of
        recording ``ok=False``, and a bucket on the stage route, which
        carries no planes, resolves to ``"f32"`` with no probe and no
        verdict.
        """
        cfg = self.cfg
        if (cfg.precision != "bf16" or not self._kernel_path(s, kind)
                or self._route(s, kind) == "stage"):
            return "f32"
        key = dict(backend=autotune.backend_of(self.device), s=s, m=cfg.m,
                   k=kind, mode=autotune.mode_of(self.device))
        ent = autotune.lookup("bf16", **key)
        if ent is None:
            ent = autotune.record(
                "bf16", {"ok": bool(self._probe_bf16(s, kind))}, **key)
        return "bf16" if ent.get("ok") else "f32"

    def _probe_bf16(self, s: int, kind: str) -> bool:
        """Does the bf16 whole-bucket kernel stay inside the f32 error
        budget at this ``(s, m, kind)``?  One masked bucket of two
        requests (seeded normal data, every worker responding) at f32 and
        at bf16, the reference's probe: max abs difference over the f32
        run's largest magnitude, against ``ops.BF16_RTOL``."""
        gr, gi = self.generator_planes()
        n = gr.shape[0]
        rng = np.random.default_rng(0)
        q = 2
        dev = self.device
        masks = torch.ones((q, n), dtype=torch.bool, device=dev)

        def normal(*shape):
            return torch.as_tensor(
                rng.standard_normal(shape).astype(np.float32), device=dev)

        if kind == "r2c":
            xb = normal(q, s)
            run = lambda p: ops.coded_rbucket_masked(xb, masks, gr, gi, s,
                                                     precision=p)
        elif kind == "c2r":
            yr, yi = normal(q, s // 2 + 1), normal(q, s // 2 + 1)
            run = lambda p: ops.coded_irbucket_masked(yr, yi, masks, gr, gi,
                                                      s, precision=p)
        else:
            xr, xi = normal(q, s), normal(q, s)
            run = lambda p: ops.coded_bucket_masked(xr, xi, masks, gr, gi, s,
                                                    precision=p)
        want, got = run("f32"), run("bf16")
        want = want if isinstance(want, tuple) else (want,)
        got = got if isinstance(got, tuple) else (got,)
        scale = max(float(w.abs().max()) for w in want) or 1.0
        err = max(float((g - w).abs().max())
                  for g, w in zip(got, want)) / scale
        return err <= ops.BF16_RTOL

    def _runner_for(self, s, bucket: int, kind: str = "c2c"):
        kernel = self._kernel_path(s, kind)
        masked = kernel and self._device_decode()
        prec = self._precision_for(s, kind) if kernel else "f32"
        key = (s, kind, bucket, kernel, masked, prec, self._n_workers())
        if key not in self._runners:
            if kernel:
                self._runners[key] = self._make_kernel_runner(
                    s, bucket, kind, masked=masked, precision=prec)
            else:
                plan = self._plan_for(s, kind)
                run = (self._runtime_for(s, kind).run if self.mesh is not None
                       else plan.run)
                method = self.cfg.decode_method
                if getattr(plan, "fragments", 1) > 1:
                    # partial-work strategy: per-fragment (bucket, N, r)
                    self._runners[key] = lambda xb, masks: run(
                        xb, fragment_mask=masks, method=method)
                else:
                    self._runners[key] = lambda xb, masks: run(
                        xb, mask=masks, method=method)
        return self._runners[key]

    def _make_kernel_runner(self, s: int, bucket: int, kind: str, *,
                            masked: bool, precision: str):
        """A kernel-path bucket executor: ``(requests, decode) ->
        outputs``.

        ``masked=True`` (the device-decode path): ``decode`` is the raw
        (q, N) responder masks, decoded inside the whole-bucket kernel or,
        on the stage route, by ``mask_subsets`` and
        ``lagrange_scatter_planes``.  ``masked=False`` (the host
        decode-matrix path): ``decode`` is the (2, q, m, N) f32 stack of
        host-built scatter decode planes.  Either runs the kind's
        whole-bucket kernel when the bucket fits its gate (a c2c bucket
        past it streams, ``ops.coded_bucket`` and
        ``ops.coded_bucket_masked`` routing it), at the resolved
        ``precision`` (:meth:`_precision_for`), else the stage kernels.
        """
        m, n = self.cfg.m, self._n_workers()
        gr, gi = self.generator_planes()
        whole = self._route(s, kind) != "stage"
        whole_op = _WHOLE[kind][0 if masked else 1]

        def whole_fn(*args):
            return whole_op(*args, precision=precision)

        def decode_args(dec):
            # the whole-bucket kernel's decode arguments
            return (dec,) if masked else (dec[0], dec[1])

        def scatter_planes(dec):
            # the stage route's (q, m, N) scatter decode planes
            if masked:
                return ops.lagrange_scatter_planes(
                    ops.mask_subsets(dec, m), n)
            return dec[0], dec[1]

        if kind == "r2c":
            def fn(xb: torch.Tensor, dec: torch.Tensor) -> torch.Tensor:
                if whole:
                    yr, yi = whole_fn(xb, *decode_args(dec), gr, gi, s)
                else:
                    dr, di = scatter_planes(dec)
                    zr, zi = ops.pack_real_planes(xb, m)
                    br, bi = ops.encode_worker(zr, zi, gr, gi)
                    hr, hi = ops.decode_apply(dr, di, br, bi)
                    yr, yi = ops.rfft_postdecode_planar(hr, hi, s)
                return ref.unplanar(yr, yi)

            return fn

        if kind == "c2r":
            n2 = s // m // 2
            gi_conj = -gi

            def fn(yb: torch.Tensor, dec: torch.Tensor) -> torch.Tensor:
                yr, yi = ref.planar(yb)
                if whole:
                    return whole_fn(yr, yi, *decode_args(dec), gr, gi, s)
                dr, di = scatter_planes(dec)
                zr, zi = ops.irfft_message_planar(yr, yi, s, m)
                # the ifft worker through the forward kernel: conj in and
                # out
                br, bi = ops.encode_worker(zr, -zi, gr, gi_conj)
                br, bi = br / n2, -bi / n2
                hr, hi = ops.decode_apply(dr, di, br, bi)
                return ops.irfft_unpack_planar(hr, hi)

            return fn

        ell = s // m

        def fn(xb: torch.Tensor, dec: torch.Tensor) -> torch.Tensor:
            xr, xi = ref.planar(xb)
            if whole:
                yr, yi = whole_fn(xr, xi, *decode_args(dec), gr, gi, s)
            else:
                dr, di = scatter_planes(dec)
                # interleave on planes: c_i[j] = x[i + j*m]
                cr = xr.reshape(bucket, ell, m).transpose(1, 2)
                ci = xi.reshape(bucket, ell, m).transpose(1, 2)
                br, bi = ops.encode_worker(cr, ci, gr, gi)
                hr, hi = ops.decode_apply(dr, di, br, bi)
                yr, yi = ops.recombine_planar(hr, hi, s)
            return ref.unplanar(yr, yi)

        return fn

    # -- straggler simulation --------------------------------------------
    def _wire_scale(self, kind: str) -> float:
        """Per-shard wire payload relative to the c2c MDS shard: the real
        kinds ship half of it (pair packing); a strategy charges its own
        ``payload_scale`` (1/q for comm_efficient, 1 for partial)."""
        base = 0.5 if kind in self.REAL_KINDS else 1.0
        return base * float(getattr(self.plan, "payload_scale", 1.0))

    def _fragment_times(self, lat: np.ndarray) -> np.ndarray:
        """Partial strategy: fragment f of worker w lands at ``lat *
        fractions[f]``: ``(..., N)`` -> ``(..., N, r)``."""
        return lat[..., None] * np.asarray(self.plan.fragment_fractions)

    def _simulate_arrivals(self, n_requests: int, kind: str = "c2c"
                           ) -> tuple[np.ndarray, np.ndarray]:
        """Per-request worker latencies + availability masks at decode
        time: ONE vectorized draw per bucket, the mask admitting the
        fastest ``k`` (the plan's recovery threshold: ``m``, or ``m*q``
        for comm_efficient) -- the k-th order statistic and everything
        before.  The partial strategy's mask is per FRAGMENT, ``(n, N,
        r)``, admitting fragments until ``m*r`` have arrived.  The wire
        share is charged at the kind's payload (:meth:`_wire_scale`)."""
        cfg = self.cfg
        plan = self.plan
        lat = cfg.straggler.sample(
            (n_requests, cfg.n_workers), 1.0 / cfg.m, self.rng,
            payload_scale=self._wire_scale(kind))
        if getattr(plan, "fragments", 1) > 1:
            ft = self._fragment_times(lat)
            need = plan.fragments_needed
            t_done = np.sort(ft.reshape(n_requests, -1), -1)[:, need - 1]
            return lat, ft <= t_done[:, None, None]
        k = plan.recovery_threshold
        t_done = np.sort(lat, axis=-1)[:, k - 1]
        return lat, lat <= t_done[:, None]

    def _account(self, lat: np.ndarray, mask: np.ndarray) -> None:
        plan = self.plan
        lat_sorted = np.sort(lat, axis=-1)
        self.stats.requests += lat.shape[0]
        if mask.ndim == 3:
            # partial strategy: the coded latency is the fragment-coverage
            # time; a tolerated straggler is a worker whose LAST fragment
            # the master did not wait for
            need = plan.fragments_needed
            t_cov = np.sort(self._fragment_times(lat).reshape(
                lat.shape[0], -1), -1)[:, need - 1]
            self.stats.coded_latency += float(t_cov.sum())
            self.stats.stragglers_tolerated += int((~mask[..., -1]).sum())
        else:
            k = plan.recovery_threshold
            self.stats.coded_latency += float(lat_sorted[:, k - 1].sum())
            self.stats.stragglers_tolerated += int((~mask).sum())
        self.stats.uncoded_latency += float(lat_sorted[:, -1].sum())

    # -- fault-tolerant bucket path (opt-in) -------------------------------
    def _fault_arrivals(self, n_live: int, kind: str):
        """The deadline/retry state machine for one robust bucket.

        Ground truth is still a per-(request, worker) completion-time draw
        (plus injected kill=inf / delay=+d), but the MASK is no longer "the
        m fastest of the draw": the master only admits workers whose time
        beats the LEARNED deadline (m-th-fastest health estimate + slack).
        Requests below the threshold go through capped retry rounds --
        late originals count, missing shards are re-dispatched to healthy
        workers with fresh draws, the window backs off geometrically --
        and requests that still miss get a typed ServiceError.  The draws
        are the reference's, in its order.

        Strategy-generic: the worker-count threshold and the wire payload
        come from the configured plan (``m`` for mds, ``m*q`` for
        comm_efficient), and the partial strategy's masks are per
        FRAGMENT, ``(n_live, N, r)``: the deadline gates each fragment
        (:meth:`WorkerHealthTracker.fragment_mask_from_times`), ``met``
        counts fragments against the ``m*r`` coverage condition, and a
        re-dispatched shard lands all r fragments at once.

        Returns ``(masks, errors, t_comp, lat, round_faults, round_idx)``.
        """
        cfg = self.cfg
        n = self._n_workers()
        plan = self.plan
        need = plan.recovery_threshold
        nf = getattr(plan, "fragments", 1)
        frac = (np.asarray(plan.fragment_fractions, np.float64)
                if nf > 1 else None)
        # fragments needed for decode; in worker units it is `need`
        need_units = getattr(plan, "fragments_needed", need)
        if self.health.n_workers < n:
            self.health.grow(n)       # elastic capacity growth keeps history
        round_idx = self._round
        self._round += 1
        rf = (self.injector.faults_for(round_idx)
              if self.injector is not None else RoundFaults())
        alive = (self.pool.mask() if self.pool is not None
                 else np.ones(n, bool))
        scale = self._wire_scale(kind)
        lat = cfg.straggler.sample((n_live, n), 1.0 / cfg.m, self.rng,
                                   payload_scale=scale)
        if self.injector is not None:
            lat = self.injector.perturb_latencies(lat, round_idx)
        lat = np.where(alive[None, :], lat, np.inf)
        errors: list = [None] * n_live
        masks = np.zeros((n_live, n) + ((nf,) if nf > 1 else ()), bool)
        t_comp = np.full(n_live, np.inf)

        def admit(times, window):
            """Per-worker (or per-fragment) arrivals inside ``window``."""
            if nf > 1:
                return (self.health.fragment_mask_from_times(
                    times, window, frac) & alive[..., :, None])
            return self.health.mask_from_times(times, window) & alive

        def coverage_time(lat_rows):
            """Per-request completion: the need-th worker (need_units-th
            fragment for partial) order statistic."""
            if nf > 1:
                ft = np.sort(self._fragment_times(lat_rows).reshape(
                    lat_rows.shape[0], -1), axis=1)
                return ft[:, need_units - 1]
            return np.sort(lat_rows, axis=1)[:, need - 1]

        if int(alive.sum()) < need:
            err = ServiceError(
                "insufficient_workers",
                f"{int(alive.sum())} live workers < threshold {need}")
            errors = [err] * n_live
            self.stats.degraded += n_live
            masks[:] = True   # padding decode stays well-posed; never surfaced
            return masks, errors, t_comp, lat, rf, round_idx

        if self.health.rounds == 0:
            # cold start: no learned estimates yet -- bootstrap from this
            # round's own threshold-order statistics
            kth = coverage_time(lat)
            kth = kth[np.isfinite(kth)]
            deadline = (float(kth.max()) * (1.0 + cfg.deadline_slack)
                        if kth.size else float("inf"))
        else:
            deadline = self.health.deadline(need, alive=alive)
        masks = admit(lat, deadline)
        met = masks.reshape(n_live, -1).sum(axis=1) >= need_units
        t_comp[met] = coverage_time(lat)[met]

        killed = np.zeros(n, bool)
        for w in rf.killed:
            if w < n:
                killed[w] = True
        healthy = alive & ~killed & ~self.health.byzantine[:n]
        window = deadline
        for _ in range(cfg.max_retries):
            if met.all():
                break
            prev = window
            window *= cfg.retry_backoff
            self.stats.retries += 1
            for i in np.flatnonzero(~met):
                # late originals land inside the extended window (for
                # partial: the late worker's finished fragment PREFIX)
                masks[i] |= admit(lat[i], window)
                done = masks[i] if nf == 1 else masks[i].all(axis=-1)
                missing = np.flatnonzero(alive & ~done)
                if missing.size and healthy.any():
                    # re-dispatch the missing shard rows to healthy workers:
                    # fresh work issued when the previous window closed,
                    # racing the extension (a shard row is data, not a
                    # worker identity -- any healthy thread recomputes it)
                    redraw = cfg.straggler.sample(
                        missing.size, 1.0 / cfg.m, self.rng,
                        payload_scale=scale)
                    # (a re-dispatched shard lands all r fragments at once)
                    masks[i][missing[prev + redraw <= window]] = True
                    self.stats.redispatched_shards += int(missing.size)
                if int(masks[i].sum()) >= need_units:
                    met[i] = True
                    t_comp[i] = window   # conservative: met at window close
        for i in np.flatnonzero(~met):
            if not healthy.any():
                reason = "insufficient_workers"
                detail = "no healthy workers to re-dispatch to"
            else:
                unit = "fragments" if nf > 1 else "shards"
                detail = (f"{int(masks[i].sum())}/{need_units} {unit} after "
                          f"{cfg.max_retries} retries")
                reason = "retries_exhausted"
            errors[i] = ServiceError(reason, detail)
            self.stats.degraded += 1
            masks[i] = True
        # feed the tracker: per-worker mean measured time this round
        col = np.where(np.isfinite(lat), lat, np.nan)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", category=RuntimeWarning)
            col_mean = np.nanmean(col, axis=0)
        self.health.observe_round(np.where(np.isnan(col_mean), np.inf,
                                           col_mean))
        return masks, errors, t_comp, lat, rf, round_idx

    def _account_robust(self, t_comp: np.ndarray, lat: np.ndarray,
                        masks: np.ndarray, errors: list) -> None:
        self.stats.requests += int(t_comp.shape[0])
        finite = lat[np.isfinite(lat)]
        cap = float(finite.max()) if finite.size else 0.0
        coded = np.where(np.isfinite(t_comp), t_comp, cap)
        self.stats.coded_latency += float(coded.sum())
        unc = np.where(np.isfinite(lat), lat, cap).max(axis=1)
        self.stats.uncoded_latency += float(unc.sum())
        ok = np.array([e is None for e in errors], bool)
        if ok.any():
            self.stats.stragglers_tolerated += int((~masks[ok]).sum())

    def _robust_launch(self, s, bucket: int, kind: str, xb: np.ndarray,
                       n_live: int) -> _Launched:
        """Launch one staged bucket through the fault-tolerant path."""
        cfg = self.cfg
        n = self._n_workers()
        if cfg.measured:
            if kind != "c2c":
                raise ValueError(
                    "measured=True serves c2c buckets only "
                    "(MeasuredWorkerRuntime is a 1-D c2c runtime)")
            return self._measured_launch(s, bucket, xb, n_live)
        masks, errors, t_comp, lat, rf, round_idx = \
            self._fault_arrivals(n_live, kind)
        self._account_robust(t_comp, lat, masks, errors)
        # the bucket's plan raises its length and strategy errors here,
        # after the draws, as the reference's executor lookup does
        full = self._full_masks(s, kind, bucket)
        full[:n_live] = masks
        errors = errors + [None] * (bucket - n_live)
        live_corrupt = [w for w in sorted(rf.corrupt) if w < n]
        if cfg.verify == "off" and not live_corrupt:
            # fault-free data path: the bucket executor (on the kernel path
            # the masked whole-bucket or streaming kernel) fed the
            # deadline-derived masks
            out = self._runner_for(s, bucket, kind)(
                *self._bucket_args(s, kind, xb, full))
            return _Launched(out, errors)
        # instrumented path: corruption must land in real worker rows and
        # verification must see them
        rows, errors = self._verify_execute(s, kind, xb, full, errors,
                                            round_idx, rf, n_live)
        return _Launched(rows, errors)

    def _verify_execute(self, s, kind: str, xb: np.ndarray,
                        masks: np.ndarray, errors: list, round_idx: int,
                        rf: RoundFaults, n_live: int
                        ) -> tuple[torch.Tensor, list]:
        """Instrumented bucket execution: real worker rows from the
        kernel-backend plan, injected corruption, per-request Byzantine
        verification + decode."""
        plan = self._instrumented_plan(s, kind)
        b = plan.worker_compute(plan.encode(
            torch.as_tensor(xb, device=self.device)))
        live_corrupt = [w for w in sorted(rf.corrupt) if w < plan.n_workers]
        if live_corrupt and self.injector is not None:
            # the reference corrupts complex128 host rows: so does this
            bh = b.cpu().numpy().astype(np.complex128)
            b = torch.as_tensor(self.injector.corrupt_array(
                bh, live_corrupt, round_idx, worker_axis=1),
                device=self.device)
        return self._decode_collected(s, kind, b, masks, errors, n_live)

    def _decode_collected(self, s, kind: str, b: torch.Tensor,
                          masks: np.ndarray, errors: list, n_live: int
                          ) -> tuple[torch.Tensor, list]:
        """Per-request decode of collected worker rows ``(bucket, N, ...)``,
        with the configured Byzantine check on surplus responses.

        ``verify="detect"``: k > m responses run the generalized-RS
        syndrome check (catches up to k - m liars); a hit fails the request
        (detection cannot say WHO lied with that budget).
        ``verify="correct"``: Prony error location corrects up to
        floor((k - m)/2) corrupt rows, flags the offenders into the health
        tracker (excluded from future re-dispatch), and decodes from clean
        rows.  The syndromes run in complex128 on the host; every decode
        is the instrumented plan's one-request ``decode`` on the device.
        Returns the bucket's rows on the device (zeros under an error).
        """
        cfg = self.cfg
        plan = self._instrumented_plan(s, kind)
        m, n = plan.m, plan.n_workers
        bucket = b.shape[0]
        nodes_all = mds.rs_nodes(n, torch.complex128).numpy()
        zero = torch.as_tensor(self._zero_row(s, kind), device=self.device)
        rows: list = [zero] * bucket
        host_rows = None             # the bucket's rows on the host, once
        for i in range(min(bucket, n_live)):   # padding rows never decode
            if errors[i] is not None:
                continue
            recv = np.flatnonzero(masks[i])
            k = int(recv.size)
            bi = b[i].to(plan.dtype)
            if cfg.verify != "off" and k > m:
                if host_rows is None:
                    host_rows = b.cpu().numpy().astype(np.complex128)
                host = host_rows[i]
                if cfg.verify == "detect":
                    if detect_errors(nodes_all[recv],
                                     host[recv].reshape(k, -1), m):
                        self.stats.detected += 1
                        self.stats.degraded += 1
                        errors[i] = ServiceError(
                            "corrupt_uncorrectable",
                            f"syndrome check failed over {k} responses "
                            f'(verify="detect" cannot correct)')
                        continue
                    y = plan.decode(bi, subset=torch.as_tensor(
                        recv[:m], device=self.device))
                else:
                    res = robust_decode(plan, host, recv)
                    if not res.ok:
                        self.stats.detected += 1
                        self.stats.degraded += 1
                        errors[i] = ServiceError(
                            "corrupt_uncorrectable",
                            f"more than {(k - m) // 2} corrupt rows among "
                            f"{k} responses")
                        continue
                    if res.n_errors_corrected:
                        self.stats.detected += res.n_errors_corrected
                        self.stats.corrected += res.n_errors_corrected
                        for w in np.asarray(
                                res.error_worker_indices).tolist():
                            self.health.flag_byzantine(int(w))
                    y = torch.as_tensor(res.output, device=self.device)
            elif getattr(plan, "fragments", 1) > 1:
                y = plan.decode(bi, fragment_mask=torch.as_tensor(
                    masks[i], device=self.device))
            else:
                y = plan.decode(bi, mask=torch.as_tensor(
                    masks[i], device=self.device))
            rows[i] = y.to(zero.dtype)
        return torch.stack(rows), errors

    def _zero_row(self, s, kind: str) -> np.ndarray:
        """All-zeros result row (the slot value under a per-row error)."""
        plan = self._plan_for(s, kind)
        cdt = _NUMPY_DTYPE[self.cfg.dtype]
        dt = np.finfo(cdt).dtype if kind in ("c2r", "irfftn") else cdt
        return np.zeros(tuple(plan.output_shape), dt)

    def _measured_for(self, s: int) -> MeasuredWorkerRuntime:
        cfg = self.cfg
        key = (s, self._n_workers())
        if key not in self._measured:
            self._measured[key] = MeasuredWorkerRuntime(
                self._instrumented_plan(s, "c2c"), self.health,
                injector=self.injector, max_retries=cfg.max_retries,
                retry_backoff=cfg.retry_backoff,
                require_all=cfg.require_all,
                threshold_extra=(0 if cfg.verify == "off"
                                 else cfg.verify_quorum))
        return self._measured[key]

    def _measured_launch(self, s: int, bucket: int, xb: np.ndarray,
                         n_live: int) -> _Launched:
        """Run one bucket on the thread-per-worker measured runtime."""
        n = self._n_workers()
        rt = self._measured_for(s)
        round_idx = self._round
        self._round += 1
        alive = self.pool.mask() if self.pool is not None else None
        res = rt.round(xb, round_idx, alive)
        self.stats.retries += res.retries
        self.stats.redispatched_shards += res.redispatched
        self.stats.requests += n_live
        t_last = res.t_last if np.isfinite(res.t_last) else 0.0
        self.stats.uncoded_latency += t_last * n_live
        errors: list = [None] * bucket
        if not res.ok:
            err = ServiceError(res.reason, f"measured round {round_idx}")
            for i in range(n_live):
                errors[i] = err
            self.stats.degraded += n_live
            self.stats.coded_latency += t_last * n_live
            zero = torch.as_tensor(self._zero_row(s, "c2c"),
                                   device=self.device)
            return _Launched(zero.expand((bucket,) + tuple(zero.shape))
                             .contiguous(), errors)
        self.stats.coded_latency += float(res.t_met) * n_live
        alive_arr = np.ones(n, bool) if alive is None else alive
        self.stats.stragglers_tolerated += \
            int((alive_arr & ~res.mask).sum()) * n_live
        masks = np.ones((bucket, n), bool)
        masks[:n_live] = res.mask[None, :]
        # corruption was already injected by the worker threads inside
        # res.b, so the shared decode/verify step runs as-is
        return _Launched(*self._decode_collected(s, "c2c", res.b, masks,
                                                 errors, n_live))

    def fetch_bucket(self, out) -> tuple[np.ndarray, Optional[list]]:
        """Host rows + per-row errors for one launched bucket.

        The streaming syncer calls this instead of a bare ``.cpu()`` so
        the robust path's per-row :class:`ServiceError` objects never go
        through a device transfer.  The copy runs on the caller's current
        stream."""
        if isinstance(out, _Launched):
            return out.out.cpu().numpy(), out.errors
        return out.cpu().numpy(), None

    # -- staging seam ----------------------------------------------------
    def _check_kind(self, kind: str) -> None:
        """Refuse an unknown kind with the reference's error."""
        if kind not in self.KINDS:
            raise ValueError(f"unknown bucket kind {kind!r}")

    def bucket_key(self, x, kind: str):
        """The time-domain extent ``s`` one request lands in: a length for
        the 1-D kinds (a c2r request of ``h`` bins maps to ``s =
        2*(h-1)``), the time-domain shape tuple for the n-D kinds (an
        irfftn request's last axis likewise).  Validates the kind, the
        half-spectrum width and that the code serves the bucket's route,
        before any straggler draw.  The length itself (``m | s``, ``2m |
        s`` for the real kinds, the n-D factors) is checked where the
        reference checks it: by the bucket's plan in :meth:`stage_bucket`,
        after the draws of every bucket staged before it and of its
        own."""
        self._check_kind(kind)
        n_last = int(x.shape[-1])
        if kind in ("c2r", "irfftn") and n_last < 2:
            raise ValueError(
                f"{kind} requests need >= 2 half-spectrum bins "
                f"(s = 2*(bins-1) > 0), got {n_last}")
        time_last = 2 * (n_last - 1) if kind in ("c2r", "irfftn") else n_last
        s = (tuple(int(d) for d in x.shape[:-1]) + (time_last,)
             if kind in self.ND_KINDS else time_last)
        self._check_servable(s, kind)
        return s

    def _bucket_buffer(self, s, bucket: int,
                       kind: str = "c2c") -> np.ndarray:
        """The staging buffer of one bucket in the kind's ingress dtype:
        a real plane for r2c and rfftn, ``s//2 + 1`` complex bins (along
        the last axis) for c2r and irfftn."""
        cdt = _NUMPY_DTYPE[self.cfg.dtype]
        if kind == "rfftn":
            return np.zeros((bucket,) + tuple(s), dtype=np.finfo(cdt).dtype)
        if kind == "irfftn":
            return np.zeros((bucket,) + tuple(s[:-1]) + (s[-1] // 2 + 1,),
                            dtype=cdt)
        if kind == "r2c":
            return np.zeros((bucket, s), dtype=np.finfo(cdt).dtype)
        if kind == "c2r":
            return np.zeros((bucket, s // 2 + 1), dtype=cdt)
        return np.zeros((bucket, s), dtype=cdt)

    def _mask_tail(self) -> tuple[int, ...]:
        """Trailing mask axes after the worker axis: ``(r,)`` for the
        partial strategy's per-fragment masks, else none."""
        nf = getattr(self.plan, "fragments", 1)
        return (nf,) if nf > 1 else ()

    def _full_masks(self, s, kind: str, bucket: int) -> np.ndarray:
        """All-responders mask block for one bucket: ``(bucket, N)``, or
        ``(bucket, N, r)`` per fragment for the partial strategy.  Builds
        the bucket's plan first, so its length and strategy errors raise
        here, where the reference raises them."""
        self._plan_for(s, kind)
        return np.ones((bucket, self._n_workers()) + self._mask_tail(), bool)

    def _bucket_args(self, s, kind: str, xb: np.ndarray,
                     masks: np.ndarray) -> tuple:
        """Device arguments of one bucket: the requests, then the raw
        (q, N) masks -- or, on the host decode-matrix path, the (2, q, m,
        N) f32 scatter decode planes from the host LRU.  One host->device
        copy each.  Adds the LRU's hit and miss deltas to the stats."""
        xt = torch.from_numpy(xb).to(self.device)
        if self._kernel_path(s, kind) and not self._device_decode():
            cache = self._decode_cache_for()
            h0, m0 = cache.hits, cache.misses
            dmats = cache.matrices(masks)
            dplanes = np.stack([dmats.real, dmats.imag])
            self.stats.decode_cache_hits += cache.hits - h0
            self.stats.decode_cache_misses += cache.misses - m0
            return xt, torch.from_numpy(dplanes).to(self.device)
        return xt, torch.from_numpy(masks).to(self.device)

    def stage_bucket(self, s, kind: str, reqs: Sequence,
                     masks: Optional[np.ndarray] = None) -> tuple:
        """Host-side staging for one bucket of same-``(s, kind)``
        requests: the straggler draw, the pack into the padded bucket
        buffer, the decode planes on the host decode-matrix path, and the
        host->device copies.  Returns ``(bucket, args)``.

        ``masks`` (``(len(reqs), N)`` bool, ``(len(reqs), N, r)`` under the
        partial strategy) stages the bucket with those
        responders instead of a straggler draw, and accounts no latency:
        the seam a check uses to serve a bucket with chosen responders
        (the non-robust path only).

        On the fault-tolerant path the masks are derived at LAUNCH time --
        the deadline/retry state machine mutates health and round state,
        which the launch step owns -- so this returns ``(bucket, (xb,
        n_live))`` with the packed host buffer.
        """
        cfg = self.cfg
        self._check_servable(s, kind)
        n_live = len(reqs)
        n = self._n_workers()
        bucket = bucket_size(n_live, cfg.max_batch)
        if masks is not None:
            if self._robust:
                raise ValueError("masks= stages a bucket on the non-robust "
                                 "path only; the fault-tolerant path "
                                 "derives its masks at launch")
            masks = np.asarray(masks, bool)
            want = (n_live, n) + self._mask_tail()
            if masks.shape != want:
                raise ValueError(f"masks must be {want}, got {masks.shape}")
        self.stats.batches += 1
        xb = self._bucket_buffer(s, bucket, kind)
        real_in = kind in ("r2c", "rfftn")
        for row, x in enumerate(reqs):
            x = (x.cpu().numpy() if isinstance(x, torch.Tensor)
                 else np.asarray(x))
            xb[row] = x.real if real_in and np.iscomplexobj(x) else x
        if self._robust:
            return bucket, (xb, n_live)
        if masks is None:
            lat, masks = self._simulate_arrivals(n_live, kind)
            self._account(lat, masks)
        # the bucket's plan raises its length errors (``m | s``, ``2m | s``,
        # the n-D factors) and a strategy's errors (c2c only, applicable)
        # here, after the draw and before the decode planes, as the
        # reference's; padded rows: every worker "responds" so decode
        # stays well-posed
        full = self._full_masks(s, kind, bucket)
        full[:n_live] = masks
        return bucket, self._bucket_args(s, kind, xb, full)

    def launch_bucket(self, s, bucket: int, kind: str, args: tuple):
        """Launch one staged bucket; returns the UNSYNCED device result.

        On the fault-tolerant path the return value is a ``_Launched``
        (device rows + per-row errors); fetch it with
        :meth:`fetch_bucket`."""
        if self._robust:
            xb, n_live = args
            return self._robust_launch(s, bucket, kind, xb, n_live)
        return self._runner_for(s, bucket, kind)(*args)

    # -- public API ------------------------------------------------------
    def submit(self, x) -> np.ndarray:
        """One request: returns F{x}, never waiting for stragglers."""
        return self.submit_batch([x])[0]

    def submit_rfft(self, x) -> np.ndarray:
        """One REAL request: returns the half spectrum ``rfft(x)``
        (``s//2 + 1`` bins) from half-payload worker shards."""
        return self.submit_batch([x], kind="r2c")[0]

    def submit_irfft(self, y) -> np.ndarray:
        """One half-spectrum request: returns the real ``irfft(y)`` of
        length ``2*(len(y) - 1)``."""
        return self.submit_batch([y], kind="c2r")[0]

    def submit_rfftn(self, t) -> np.ndarray:
        """One n-D REAL request: returns ``numpy.fft.rfftn(t)``, the half
        spectrum over the last axis (``t.shape[:-1] + (last//2 + 1,)``),
        from half-payload worker shards.  The last axis's shard must be
        even once ``plan_factors`` has split ``m`` across the axes (the
        ``2m | s`` ValueError otherwise)."""
        return self.submit_batch([t], kind="rfftn")[0]

    def submit_irfftn(self, y) -> np.ndarray:
        """One n-D half-spectrum request: returns the real
        ``numpy.fft.irfftn(y)`` of shape
        ``y.shape[:-1] + (2*(y.shape[-1] - 1),)``."""
        return self.submit_batch([y], kind="irfftn")[0]

    def submit_batch(self, xs: Sequence,
                     kind: Union[str, Sequence[str]] = "c2c"
                     ) -> list[np.ndarray]:
        """Serve a batch of requests, bucketed by ``(s, kind)``: ``s`` the
        time-domain length of a 1-D request, the time-domain shape tuple
        of an n-D one.

        ``kind`` is one kind for the whole call or one per request
        (mixed traffic).  Every bucket is staged and launched before any
        wait; then ONE device->host transfer fetches all results --
        complex and real alike, packed into one real buffer -- returned
        in submission order as host arrays.  On the fault-tolerant path a
        request that failed raises its :class:`ServiceError`
        (``on_failure="raise"``) or holds a :class:`DegradedResult`
        (``"degrade"``).
        """
        kinds = [kind] * len(xs) if isinstance(kind, str) else list(kind)
        if len(kinds) != len(xs):
            raise ValueError(f"per-request kinds: got {len(kinds)} kinds "
                             f"for {len(xs)} requests")
        by_bucket: dict[tuple[int, str], list[int]] = {}
        for i, (x, k) in enumerate(zip(xs, kinds)):
            by_bucket.setdefault((self.bucket_key(x, k), k), []).append(i)

        t0 = time.perf_counter()
        pending: list[tuple[list[int], object]] = []
        for (s, k), idxs in by_bucket.items():
            for start in range(0, len(idxs), self.cfg.max_batch):
                chunk = idxs[start:start + self.cfg.max_batch]
                bucket, args = self.stage_bucket(s, k,
                                                 [xs[i] for i in chunk])
                pending.append((chunk, self.launch_bucket(s, bucket, k,
                                                          args)))
        self.stats.dispatch_s += time.perf_counter() - t0

        # ONE transfer for outputs of two dtypes: complex buckets travel
        # as their real (re, im) pairs beside the real c2r rows.  An empty
        # batch fetches nothing and counts its one transfer, as the
        # reference's does
        t0 = time.perf_counter()
        rdt = self.cfg.dtype.to_real()
        outs = [out.out if isinstance(out, _Launched) else out
                for _, out in pending]
        if pending:
            flat = torch.cat([
                (torch.view_as_real(out) if out.is_complex() else out)
                .reshape(-1).to(rdt) for out in outs]).cpu().numpy()
        self.stats.host_transfers += 1
        self.stats.sync_s += time.perf_counter() - t0
        cdt = _NUMPY_DTYPE[self.cfg.dtype]
        results: list = [None] * len(xs)
        offset = 0
        for (chunk, launched), out in zip(pending, outs):
            width = 2 if out.is_complex() else 1
            seg = flat[offset:offset + width * out.numel()]
            offset += width * out.numel()
            rows = (seg.view(cdt) if out.is_complex() else seg).reshape(
                tuple(out.shape))
            errors = (launched.errors if isinstance(launched, _Launched)
                      else None)
            for row, i in enumerate(chunk):
                err = errors[row] if errors is not None else None
                if err is not None:
                    if self.cfg.on_failure == "raise":
                        raise err
                    results[i] = DegradedResult(err.reason, err.detail)
                else:
                    results[i] = rows[row]
        return results

    def warmup(self, lengths: Optional[Sequence[int]] = None,
               kinds: Sequence[str] = ("c2c",),
               buckets: Optional[Sequence[int]] = None) -> int:
        """Run every bucket executor once (default: the config length, the
        c2c kind, every power-of-two bucket up to ``max_batch``) so kernel
        libraries and plane tables are built before traffic arrives.
        ``lengths`` are time-domain lengths for every kind.  On the host
        decode-matrix path this also primes the all-alive mask's LRU entry
        (and counts it, as a same-seed reference service does).  Returns
        the number of executors run.

        With ``cfg.autotune`` (the default) this is also when the
        four-step search runs, before any executor: per warmed ``(s,
        kind)`` on the kernel path, ``autotune.ensure_fourstep`` times the
        variants and radix plans at the shard length (s/m for c2c, s/m/2
        for the real kinds) on the service's device and persists the
        winner; the plans' workers and the stage route's two-pass encode
        read it, and the next process skips the search.  The search runs
        on the rows the largest warmed bucket gives those workers
        (bucket times n_workers), where the JAX package times 4 rows.

        ``lengths`` entries pair as the reference's do: a scalar with the
        1-D kinds (and with an unknown kind, which then raises), a shape
        tuple with the n-D kinds; other pairs are skipped.  The n-D kinds
        run no four-step search, as in the reference.  Every pair is
        validated -- the kind, then the bucket's plan (``m | s``, ``2m |
        s``, the n-D factors) and the code's route -- before any search,
        staging or launch."""
        cfg = self.cfg
        lengths = [cfg.s] if lengths is None else list(lengths)
        if buckets is None:
            buckets, b = [], 1
            while b < cfg.max_batch:
                buckets.append(b)
                b *= 2
            buckets.append(cfg.max_batch)
        pairs = []
        for s in lengths:
            nd = isinstance(s, (tuple, list))
            s = tuple(int(d) for d in s) if nd else int(s)
            for k in kinds:
                if nd != (k in self.ND_KINDS):
                    continue        # scalar<->1-D, tuple<->n-D only
                self._check_kind(k)
                self._plan_for(s, k)
                self._check_servable(s, k)
                pairs.append((s, k))
        if cfg.autotune:
            for s, k in pairs:
                if self._kernel_path(s, k):
                    ell = s // cfg.m if k == "c2c" else s // cfg.m // 2
                    autotune.ensure_fourstep(
                        ell, max(buckets) * self._n_workers(),
                        device=self.device, reps=cfg.autotune_reps)
        count = 0
        for s, k in pairs:
            for b in sorted(set(buckets)):
                args = self._bucket_args(
                    s, k, self._bucket_buffer(s, b, k),
                    self._full_masks(s, k, b))
                self._runner_for(s, b, k)(*args)
                count += 1
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return count
