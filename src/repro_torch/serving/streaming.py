"""Open-loop streaming front-end for the FFT service.

``FFTService.submit_batch`` is closed-loop: the caller hands over a
complete request list and blocks on one device fetch, so its throughput
number says nothing about latency under CONTINUOUS arrivals.
:class:`StreamingFFTService` turns the batched scheduler into a
continuously-batching service with an SLO story:

* **Async request queue** -- :meth:`submit` is non-blocking: it enqueues
  the request and returns a ``concurrent.futures.Future`` that resolves
  to the transform (with its measured ``latency_s`` attached).
* **Multi-tier EDF bucket formation** -- every request belongs to a
  named SLO tier (``StreamConfig.tiers``, e.g. ``interactive=2ms``,
  ``standard=10ms``, ``batch=100ms``) whose slack sets its deadline.
  Requests accumulate per ``(s, m, kind)`` bucket in
  earliest-deadline-first order; buckets dispatch when they FILL
  (``max_batch``) *or* when the earliest deadline across ALL bucket
  heads expires -- the scheduler scans a deadline-ordered heap of
  bucket heads, never dict insertion order, so a late-created bucket
  with an urgent head is served first.
* **Adaptive slack** -- an EWMA of the measured per-bucket-shape
  compute time (stage + launch + sync) is subtracted from each tier's
  nominal slack, so a tier's deadline budget covers QUEUEING only,
  not compute the scheduler can already predict.  Shrinks under load,
  grows back as the shape gets faster (``StreamConfig.adaptive``).
* **Admission control / backpressure** -- the undispatched queue is
  bounded (``max_queue``); over capacity, :meth:`submit` raises a typed
  :class:`AdmissionError` with a machine-readable ``reason`` instead of
  letting queueing delay grow without bound (reject early, don't
  collapse late).  Both reject reasons count into ``stats.rejected``.
* **Double-buffered host->device staging** -- a dedicated staging
  thread packs bucket k+1's numpy buffers and launches its (async)
  device call while the sync thread is still blocked fetching bucket k.
  ``ServiceStats.staging_overlap_s`` measures exactly the staging
  sub-interval that ran while a downstream bucket was in flight
  (explicit in-flight counter under the scheduler lock -- no unlocked
  queue-internals peeking).

On a CUDA service the overlap needs streams, since every call sits on the
default stream otherwise: bucket k+1's pageable host->device copy would
queue behind bucket k's kernels, and the syncer's copy back would wait on
bucket k+1's launch.  So the stager makes its copies on a copy stream of
its own, launches each bucket on the next of two launch streams (after
an event of its copies) and records an event after the launch; the
syncer waits on that bucket's event alone and copies on a stream of its
own.  ``record_stream`` tells the caching allocator about every tensor
that crosses streams.

The pipeline is three threads around two depth-bounded queues::

    callers --submit()--> per-(s, kind) EDF heaps   [admission bound]
        | scheduler: fill-or-earliest-deadline bucket formation
        v
    stage_q  (depth scfg.stage_depth)
        | stager: straggler sim + numpy pack + H2D + async launch
        v
    sync_q   (depth 1  ==  double buffer: bucket k+1 stages/computes
        |                   while bucket k is being fetched)
        v syncer: fetch_bucket -> resolve futures -> latency histograms
                  (one histogram per tier + the global one)

Every ``FFTService`` internal (plan/runner caches, the staging numpy
work, ``stats.batches`` accounting) is touched ONLY by the staging
thread, so the service object itself never needs locks.  The bucket
executors are untouched: the streaming path launches the SAME bucket
executors as ``submit_batch``, and fetches each bucket with one
transfer.

Scheduler invariants:

* **EDF order** -- among dispatchable buckets the one with the
  earliest head deadline goes first, and rows inside a bucket are
  deadline-ordered, never FIFO.
* **Flush scoping** -- :meth:`flush` drains exactly the requests
  pending at flush time (a generation counter); requests submitted
  after ``flush()`` returns ride the normal fill/deadline rules.
* **Cancellation safety** -- a caller cancelling a pending future can
  never kill a pipeline thread: resolution claims the future with
  ``set_running_or_notify_cancel()`` and counts losses in
  ``stats.cancelled``.

``fill_only=True`` + ``pipelined=False`` reproduce the naive baseline
the open-loop benchmark races against: dispatch only full buckets, and
stage synchronously on the scheduler thread.
"""

from __future__ import annotations

import dataclasses
import heapq
import threading
import time
from concurrent.futures import Future
from queue import Queue
from typing import Mapping, Optional

import numpy as np
import torch

from repro_torch.serving.batching import LatencyHistogram
from repro_torch.serving.fft_service import FFTService, _Launched

__all__ = ["AdmissionError", "StreamConfig", "StreamingFFTService"]


def _tensors(obj) -> list:
    """The device tensors of a staged bucket's args or a launched bucket,
    for ``record_stream`` where they cross streams."""
    if isinstance(obj, _Launched):
        obj = obj.out
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, (tuple, list)):
        return [t for t in obj if isinstance(t, torch.Tensor)]
    return []


class AdmissionError(RuntimeError):
    """Typed rejection from admission control.

    ``reason`` is machine-readable: ``"queue_full"`` (the undispatched
    queue is at ``max_queue``) or ``"closed"`` (submit after close).
    Every rejection -- both reasons -- increments ``stats.rejected``.
    """

    def __init__(self, reason: str, detail: str = ""):
        super().__init__(f"request rejected: {reason}"
                         + (f" ({detail})" if detail else ""))
        self.reason = reason


@dataclasses.dataclass(frozen=True)
class StreamConfig:
    slack_s: float = 0.010      # nominal slack of the DEFAULT tier (and
    #                             of any tier left unset in ``tiers``);
    #                             per-request override via
    #                             submit(..., slack_s=...)
    tiers: Optional[Mapping[str, float]] = None
    #                           # named SLO tiers -> nominal slack seconds.
    #                             None = {"interactive": 2ms,
    #                             "standard": slack_s, "batch": 100ms}
    default_tier: str = "standard"   # tier used when submit() names none
    adaptive: bool = True       # subtract the EWMA-predicted compute time
    #                             of the request's (s, kind) shape from the
    #                             tier slack, so the deadline budget covers
    #                             queueing only
    ewma_alpha: float = 0.25    # EWMA weight of the newest compute sample
    min_slack_frac: float = 0.1  # floor of the effective slack as a
    #                              fraction of the nominal tier slack
    max_queue: int = 1024       # admission bound on undispatched requests
    stage_depth: int = 2        # bucket plans buffered ahead of the stager
    fill_only: bool = False     # naive baseline: dispatch only on full
    #                             buckets (plus the drain flush)
    pipelined: bool = True      # False = naive baseline: stage + launch +
    #                             sync inline on the scheduler thread

    def resolved_tiers(self) -> dict[str, float]:
        """The tier table with defaults filled in (name -> slack seconds)."""
        if self.tiers is not None:
            return {str(k): float(v) for k, v in self.tiers.items()}
        return {"interactive": 0.002, "standard": self.slack_s,
                "batch": 0.100}


@dataclasses.dataclass
class _Request:
    x: object                   # the (host) request payload
    kind: str
    tier: str
    arrival: float              # perf_counter at submit
    deadline: float             # arrival + effective slack
    seq: int                    # submit order; EDF tie-break
    gen: int                    # flush generation at submit time
    future: Future

    def entry(self) -> tuple:
        """The per-bucket heap entry (EDF order, seq tie-break)."""
        return (self.deadline, self.seq, self)


@dataclasses.dataclass
class _BucketPlan:
    s: object                   # scalar length or n-D shape tuple
    kind: str
    reqs: list
    reason: str                 # "fill" | "deadline" | "drain"
    stage_s: float = 0.0        # filled by the stager; the syncer adds its
    #                             sync share and feeds the compute EWMA


class StreamingFFTService:
    """Multi-tier EDF continuous batching over one :class:`FFTService`.

    The wrapped service's ``stats`` object is extended in place (queue
    peak, dispatch reasons, staging overlap, cancellations, the global
    AND per-tier latency histograms), so one ``ServiceStats.summary()``
    tells the whole story.

    Warm up the wrapped service (``service.warmup()``) BEFORE offering
    traffic: the streaming scheduler dispatches every power-of-two
    bucket size up to ``max_batch``, and a cold compile inside a latency
    window is exactly the stall the front-end exists to avoid.
    """

    def __init__(self, service: FFTService,
                 scfg: StreamConfig = StreamConfig()):
        self.service = service
        self.scfg = scfg
        self.tiers = scfg.resolved_tiers()
        if scfg.default_tier not in self.tiers:
            raise ValueError(
                f"default_tier {scfg.default_tier!r} not in tiers "
                f"{sorted(self.tiers)}")
        self.stats = service.stats       # extended in place
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        # per-(s, kind) EDF heaps of (deadline, seq, request)
        self._pending: dict[tuple, list[tuple]] = {}
        # deadline-ordered heap of bucket HEADS: (deadline, seq, key).
        # Lazy invalidation: every time a request becomes the head of its
        # bucket an entry is pushed, so the true head of every pending
        # bucket always has an exact entry; stale entries are discarded
        # when they surface.
        self._heads: list[tuple] = []
        self._seq = 0                    # submit counter (EDF tie-break)
        self._gen = 0                    # flush generation counter
        self._flush_upto: Optional[int] = None   # drain gens <= this
        self._depth = 0                  # undispatched requests
        self._outstanding = 0            # submitted, not yet resolved
        self._closed = False
        # compute-time EWMA per (s, kind): stage + launch + sync seconds
        self._ewma: dict[tuple, float] = {}
        # launched-but-not-yet-fetched buckets, and the "busy clock" that
        # integrates the wall time with at least one bucket in flight --
        # the overlap accounting reads this under the lock instead of
        # racing on Queue.unfinished_tasks
        self._inflight = 0
        self._busy_total = 0.0
        self._busy_since: Optional[float] = None
        self._stage_q: Queue = Queue(maxsize=max(1, scfg.stage_depth))
        self._sync_q: Queue = Queue(maxsize=1)
        # CUDA: the stager's copy stream, two launch streams taken in
        # turns, and the syncer's stream (None on another device)
        dev = service.device
        cuda = dev.type == "cuda"
        self._copy_stream = torch.cuda.Stream(dev) if cuda else None
        self._launch_streams = ([torch.cuda.Stream(dev) for _ in range(2)]
                                if cuda else [])
        self._sync_stream = torch.cuda.Stream(dev) if cuda else None
        self._n_launched = 0
        self._threads = [threading.Thread(
            target=self._scheduler, name="stream-scheduler", daemon=True)]
        if scfg.pipelined:
            self._threads.append(threading.Thread(
                target=self._stager, name="stream-stager", daemon=True))
            self._threads.append(threading.Thread(
                target=self._syncer, name="stream-syncer", daemon=True))
        for t in self._threads:
            t.start()

    # -- client surface -------------------------------------------------
    def submit(self, x, kind: str = "c2c", tier: Optional[str] = None,
               slack_s: Optional[float] = None) -> Future:
        """Enqueue one request; returns a Future resolving to the result.

        Non-blocking.  ``tier`` names an SLO class from
        ``StreamConfig.tiers`` (default ``scfg.default_tier``) whose
        slack -- shrunk by the predicted compute time of this request's
        bucket shape when ``scfg.adaptive`` -- sets the deadline;
        ``slack_s`` overrides the nominal slack outright (the tier still
        labels the latency accounting).  Raises :class:`AdmissionError`
        when the service is over capacity (``reason="queue_full"``) or
        closed.  The resolved future carries ``latency_s`` --
        arrival-to-result wall time -- as an attribute.
        """
        x = np.asarray(x)
        s = self.service.bucket_key(x, kind)      # validates kind/shape
        tier = self.scfg.default_tier if tier is None else tier
        if tier not in self.tiers:
            raise ValueError(
                f"unknown tier {tier!r}; configured: {sorted(self.tiers)}")
        base = self.tiers[tier] if slack_s is None else float(slack_s)
        now = time.perf_counter()
        with self._cv:
            if self._closed:
                self.stats.rejected += 1
                raise AdmissionError("closed")
            if self._depth >= self.scfg.max_queue:
                self.stats.rejected += 1
                raise AdmissionError(
                    "queue_full", f"max_queue={self.scfg.max_queue}")
            slack = self._effective_slack_locked((s, kind), base)
            self._seq += 1
            req = _Request(x, kind, tier, now, now + slack,
                           self._seq, self._gen, Future())
            heap = self._pending.setdefault((s, kind), [])
            heapq.heappush(heap, req.entry())
            if heap[0][2] is req:        # new bucket head -> index it
                heapq.heappush(self._heads,
                               (req.deadline, req.seq, (s, kind)))
            self._depth += 1
            self._outstanding += 1
            self.stats.queue_peak = max(self.stats.queue_peak, self._depth)
            self._cv.notify_all()
        return req.future

    def _effective_slack_locked(self, key: tuple, base: float) -> float:
        """The tier slack minus the EWMA-predicted compute time of this
        bucket shape (floored at ``min_slack_frac`` of nominal), so the
        remaining budget is pure queueing headroom."""
        if not self.scfg.adaptive:
            return base
        predicted = self._ewma.get(key)
        if predicted is None:
            return base
        return max(base - predicted, base * self.scfg.min_slack_frac)

    def _record_compute_locked(self, key: tuple, seconds: float) -> None:
        prev = self._ewma.get(key)
        a = self.scfg.ewma_alpha
        self._ewma[key] = (seconds if prev is None
                           else a * seconds + (1.0 - a) * prev)

    @property
    def compute_ewma(self) -> dict[tuple, float]:
        """Predicted compute seconds per (s, kind) bucket shape (a copy)."""
        with self._lock:
            return dict(self._ewma)

    @property
    def queue_depth(self) -> int:
        """Undispatched requests right now (the admission-bounded gauge)."""
        with self._lock:
            return self._depth

    def flush(self) -> None:
        """Dispatch every CURRENTLY pending partial bucket (reason
        ``"drain"``), without waiting for fills or deadlines.  Scoped by
        a generation counter: requests submitted after ``flush()``
        returns are NOT swept into drain buckets."""
        with self._cv:
            self._flush_upto = self._gen
            self._gen += 1
            self._cv.notify_all()

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Flush, then block until every submitted request has resolved.

        Returns False if ``timeout`` elapsed first.
        """
        with self._cv:
            self._flush_upto = self._gen
            self._gen += 1
            self._cv.notify_all()
            return self._cv.wait_for(
                lambda: self._outstanding == 0, timeout)

    def close(self) -> None:
        """Drain outstanding work and stop the pipeline threads."""
        with self._cv:
            if self._closed:
                return
            self._closed = True
            self._cv.notify_all()
        for t in self._threads:
            t.join()

    def __enter__(self) -> "StreamingFFTService":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- scheduler: fill-or-earliest-deadline bucket formation ----------
    def _scheduler(self) -> None:
        cap = self.service.cfg.max_batch
        while True:
            with self._cv:
                plan = None
                while True:
                    plan = self._pop_ready_locked(cap)
                    if plan is not None or (self._closed
                                            and not self._pending):
                        break
                    self._cv.wait(self._timeout_locked())
            if plan is None:
                break                        # closed and fully dispatched
            with self._lock:
                field = f"{plan.reason}_dispatches"
                setattr(self.stats, field,
                        getattr(self.stats, field) + 1)
            if self.scfg.pipelined:
                self._stage_q.put(plan)      # backpressure: bounded depth
            else:
                self._stage_and_sync(plan)   # naive serial baseline
        self._stage_q.put(None)              # sentinel for the stager

    def _head_key_locked(self) -> Optional[tuple]:
        """The pending bucket with the EARLIEST head deadline, via the
        lazy heap (stale entries discarded as they surface)."""
        while self._heads:
            deadline, seq, key = self._heads[0]
            heap = self._pending.get(key)
            if heap is not None and heap[0][:2] == (deadline, seq):
                return key
            heapq.heappop(self._heads)       # dispatched or superseded
        return None

    def _pop_ready_locked(self, cap: int) -> Optional[_BucketPlan]:
        """The EDF-ordered dispatch decision under the fill-or-deadline
        rule: fill first (a full bucket never waits), then drain when a
        flush/close is armed, then the earliest expired head."""
        now = time.perf_counter()
        choice = reason = None
        full = [key for key, heap in self._pending.items()
                if len(heap) >= cap]
        if full:
            # ties between simultaneously-full buckets break EDF too
            choice = min(full, key=lambda k: self._pending[k][0][0])
            reason = "fill"
        elif self._closed or self._flush_upto is not None:
            elig = [key for key, heap in self._pending.items()
                    if any(self._drains_locked(e[2]) for e in heap)]
            if elig:
                choice = min(elig, key=lambda k: self._pending[k][0][0])
                reason = "drain"
            elif self._flush_upto is not None and not self._closed:
                self._flush_upto = None      # drain scope finished; disarm
        if choice is None and not self.scfg.fill_only:
            key = self._head_key_locked()
            if key is not None and self._pending[key][0][0] <= now:
                choice, reason = key, "deadline"
        if choice is None:
            return None
        heap = self._pending[choice]
        if reason == "drain":
            # take only the requests inside the drain scope, EDF order
            keep, take = [], []
            while heap and len(take) < cap:
                entry = heapq.heappop(heap)
                (take if self._drains_locked(entry[2]) else keep).append(
                    entry)
            for entry in keep:
                heapq.heappush(heap, entry)
        else:
            take = [heapq.heappop(heap) for _ in range(min(cap, len(heap)))]
        if heap:
            # re-index the new bucket head in the deadline heap
            heapq.heappush(self._heads, (heap[0][0], heap[0][1], choice))
        else:
            del self._pending[choice]
        self._depth -= len(take)
        return _BucketPlan(choice[0], choice[1],
                           [entry[2] for entry in take], reason)

    def _drains_locked(self, req: _Request) -> bool:
        """Is this request inside the current drain scope?  close()
        drains everything; flush() only the generations it snapshotted."""
        if self._closed:
            return True
        return self._flush_upto is not None and req.gen <= self._flush_upto

    def _timeout_locked(self) -> Optional[float]:
        """Sleep until the earliest head deadline (None = wait for a fill
        notification -- the fill_only baseline never sets an alarm)."""
        if self.scfg.fill_only or not self._pending:
            return None
        key = self._head_key_locked()
        if key is None:                      # unreachable: pending != {}
            return None
        return max(self._pending[key][0][0] - time.perf_counter(), 0.0)

    # -- in-flight accounting (the staging-overlap clock) ---------------
    def _busy_clock_locked(self, now: float) -> float:
        """Total wall seconds, so far, with >= 1 launched-but-unfetched
        bucket; differences of this clock measure exactly the overlapped
        sub-interval of any window."""
        busy = self._busy_total
        if self._busy_since is not None:
            busy += now - self._busy_since
        return busy

    def _inflight_inc_locked(self, now: float) -> None:
        self._inflight += 1
        if self._inflight == 1:
            self._busy_since = now

    def _inflight_dec_locked(self, now: float) -> None:
        self._inflight -= 1
        if self._inflight == 0:
            self._busy_total += now - self._busy_since
            self._busy_since = None

    # -- stager: numpy pack + H2D + async launch ------------------------
    def _stager(self) -> None:
        while True:
            plan = self._stage_q.get()
            if plan is None:
                break
            t0 = time.perf_counter()
            with self._lock:
                busy0 = self._busy_clock_locked(t0)
            try:
                out, done = self._stage_and_launch(plan)
            except Exception as e:                # noqa: BLE001
                self._resolve(plan, error=e)
                continue
            t1 = time.perf_counter()
            dt = t1 - t0
            plan.stage_s = dt
            with self._lock:
                # the sub-interval of [t0, t1] during which a downstream
                # bucket was between launch and fetch-completion: the
                # double-buffer win, measured -- not inferred from a
                # point sample of queue internals
                overlap = min(self._busy_clock_locked(t1) - busy0, dt)
                self.stats.dispatch_s += dt
                self.stats.staging_overlap_s += max(overlap, 0.0)
                self._inflight_inc_locked(t1)
            self._sync_q.put((plan, out, done))
        self._sync_q.put(None)                    # sentinel for the syncer

    def _stage_and_launch(self, plan: _BucketPlan):
        """Stage and launch one bucket: ``(out, done)``, ``done`` the CUDA
        event recorded after its launch (None off CUDA).  On CUDA the
        staging copies run on the copy stream and the launch on the next
        launch stream, which first waits for those copies."""
        svc = self.service
        reqs = [r.x for r in plan.reqs]
        if self._copy_stream is None:
            bucket, args = svc.stage_bucket(plan.s, plan.kind, reqs)
            return svc.launch_bucket(plan.s, bucket, plan.kind, args), None
        with torch.cuda.stream(self._copy_stream):
            bucket, args = svc.stage_bucket(plan.s, plan.kind, reqs)
        copied = torch.cuda.Event()
        copied.record(self._copy_stream)
        stream = self._launch_streams[self._n_launched % 2]
        self._n_launched += 1
        stream.wait_event(copied)
        for t in _tensors(args):
            t.record_stream(stream)
        with torch.cuda.stream(stream):
            out = svc.launch_bucket(plan.s, bucket, plan.kind, args)
        done = torch.cuda.Event()
        done.record(stream)
        return out, done

    def _fetch(self, out, done):
        """``fetch_bucket`` of one launched bucket: on CUDA on the
        syncer's stream, after that bucket's launch event alone."""
        if done is None:
            return self.service.fetch_bucket(out)
        self._sync_stream.wait_event(done)
        for t in _tensors(out):
            t.record_stream(self._sync_stream)
        with torch.cuda.stream(self._sync_stream):
            return self.service.fetch_bucket(out)

    # -- syncer: one device->host fetch per bucket ----------------------
    def _syncer(self) -> None:
        while True:
            item = self._sync_q.get()
            if item is None:
                self._sync_q.task_done()
                break
            plan, out, done = item
            t0 = time.perf_counter()
            try:
                # fetch_bucket (not a bare .cpu()): the fault-tolerant
                # path returns host rows plus per-row ServiceErrors, which
                # must become per-request Future exceptions
                rows, row_errors = self._fetch(out, done)
            except Exception as e:                # noqa: BLE001
                self._sync_q.task_done()
                with self._lock:
                    self._inflight_dec_locked(time.perf_counter())
                self._resolve(plan, error=e)
                continue
            t1 = time.perf_counter()
            dt = t1 - t0
            self._sync_q.task_done()
            with self._lock:
                self._inflight_dec_locked(t1)
                self.stats.sync_s += dt
                self.stats.host_transfers += 1
                self._record_compute_locked(
                    (plan.s, plan.kind), plan.stage_s + dt)
            self._resolve(plan, rows=rows, row_errors=row_errors)

    def _stage_and_sync(self, plan: _BucketPlan) -> None:
        """The unpipelined baseline: stage, launch, and block, serially
        on the scheduler thread (no staging/compute overlap)."""
        t0 = time.perf_counter()
        try:
            out, done = self._stage_and_launch(plan)
        except Exception as e:                    # noqa: BLE001
            self._resolve(plan, error=e)
            return
        t1 = time.perf_counter()
        rows, row_errors = self._fetch(out, done)
        t2 = time.perf_counter()
        with self._lock:
            self.stats.dispatch_s += t1 - t0
            self.stats.sync_s += t2 - t1
            self.stats.host_transfers += 1
            self._record_compute_locked((plan.s, plan.kind), t2 - t0)
        self._resolve(plan, rows=rows, row_errors=row_errors)

    def _resolve(self, plan: _BucketPlan, rows=None,
                 error: Optional[Exception] = None,
                 row_errors: Optional[list] = None) -> None:
        now = time.perf_counter()
        with self._cv:
            for req in plan.reqs:
                self.stats.latency.record(now - req.arrival)
                self.stats.tier_latency.setdefault(
                    req.tier, LatencyHistogram()).record(now - req.arrival)
            self._outstanding -= len(plan.reqs)
            self._cv.notify_all()
        # futures resolve OUTSIDE the lock: done-callbacks may re-enter
        # submit()
        cancelled = 0
        for row, req in enumerate(plan.reqs):
            req.future.latency_s = now - req.arrival
            # claim the future first: a caller's .cancel() on a pending
            # future would otherwise make set_result/set_exception raise
            # InvalidStateError and kill this pipeline thread
            if not req.future.set_running_or_notify_cancel():
                cancelled += 1
                continue
            # a bucket-wide error beats per-row errors; a per-row
            # ServiceError (fault path) fails ONLY its own request --
            # the rest of the bucket resolves normally
            err = error if error is not None else (
                row_errors[row] if row_errors is not None else None)
            if err is not None:
                req.future.set_exception(err)
            else:
                req.future.set_result(rows[row])
        if cancelled:
            with self._lock:
                self.stats.cancelled += cancelled
