"""Measured thread-pool worker runtime: real deadlines, retries, re-dispatch.

The service's robust path *simulates* worker timing; this module runs the
paper's master/worker protocol against actual wall-clock time.  Each
worker is a thread computing its coded shard ``b_k = fft(G[k] @ c)`` for
the whole bucket; the master

1. dispatches all live workers and waits until ``threshold`` rows have
   ARRIVED or the deadline expires -- the deadline comes from the shared
   :class:`~repro_torch.distributed.health.WorkerHealthTracker`
   (m-th-fastest EWMA estimate + slack), so the wait budget is learned
   from measured rounds, never assumed;
2. on a miss, re-dispatches the missing shard rows to the pool (any
   healthy thread computes a row -- the row is data, not an identity) and
   extends the window by ``retry_backoff``, up to ``max_retries`` times;
3. gives up with a typed reason: ``insufficient_workers`` when no healthy
   worker exists to re-dispatch to, ``retries_exhausted`` when the capped
   windows close without ``m`` rows.

``require_all=True`` is the UNCODED baseline: the master needs every row
(an uncoded partition has no slack), so one killed or delayed worker
stalls the round into the retry machinery.

Fault injection rides the :class:`~repro_torch.distributed.faults
.FaultInjector` hook of the simulated path: killed workers never respond,
delayed workers sleep before responding, corrupt workers respond on time
with seeded garbage (caught downstream by ``verify="correct"``).

Where the JAX package computes each row in numpy on the host, a worker
here computes its row on the plan's device with the plan's own stages:
on the kernel backend the row's generator product is one ``cmatmul`` of
its (1, m) generator row and the shard FFT the plan's four-step worker
(``fourstep_fused`` where the shard fuses); on
the reference backend (complex128, or a CPU run's plain versions) the
same product and ``torch.fft``.  On a CUDA device every worker thread
owns a CUDA stream and synchronizes it before it records its arrival, so
a deadline measures that worker's compute, not the queue of another's.

The runtime covers 1-D c2c plans; the simulated robust path in
``serving/fft_service.py`` covers every kind.
"""

from __future__ import annotations

import contextlib
import queue as queue_mod
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch

from repro_torch.distributed.faults import FaultInjector, RoundFaults
from repro_torch.distributed.health import WorkerHealthTracker
from repro_torch.kernels import ops, ref
from repro_torch.kernels.cmatmul import cmatmul

__all__ = ["MeasuredRound", "MeasuredWorkerRuntime"]


class MeasuredRound:
    """One completed measured round (a plain result record)."""

    def __init__(self, b: torch.Tensor, mask: np.ndarray,
                 reason: Optional[str], *, t_met: float, t_last: float,
                 retries: int, redispatched: int, times: np.ndarray):
        self.b = b                    # (q, N, ell) on the plan's device,
        #                               the plan's dtype; missing rows 0
        self.mask = mask              # (N,) bool: rows that arrived in time
        self.reason = reason          # None | insufficient_workers |
        #                               retries_exhausted
        self.t_met = t_met            # seconds until threshold met (inf if not)
        self.t_last = t_last          # seconds until last arrival seen
        self.retries = retries
        self.redispatched = redispatched
        self.times = times            # (N,) per-worker arrival seconds (inf
        #                               = no response)

    @property
    def ok(self) -> bool:
        return self.reason is None


class MeasuredWorkerRuntime:
    """Thread-per-worker execution of one 1-D coded FFT plan.

    ``plan`` must be a c2c :class:`~repro_torch.core.coded_fft.CodedFFT`
    (worker body = fft along the last axis).  ``health`` is shared with
    the owning service so deadlines learn across rounds.
    ``min_deadline_s`` floors the wait budget against scheduler jitter at
    sub-millisecond compute.
    """

    def __init__(self, plan, health: WorkerHealthTracker, *,
                 injector: Optional[FaultInjector] = None,
                 max_retries: int = 2, retry_backoff: float = 2.0,
                 require_all: bool = False, min_deadline_s: float = 2e-3,
                 threshold_extra: int = 0):
        self.plan = plan
        self.health = health
        self.injector = injector
        self.max_retries = int(max_retries)
        self.retry_backoff = float(retry_backoff)
        self.require_all = bool(require_all)
        self.min_deadline_s = float(min_deadline_s)
        # surplus responses to wait for beyond m: the Byzantine verifier
        # needs k > m rows (k = m + q detects q liars, corrects q//2)
        self.threshold_extra = int(threshold_extra)
        self.device = plan.device
        self._kernel = plan.resolved_backend == "kernel"
        # one stream per worker slot: a worker's arrival waits on its own
        # compute only
        self._streams = ([torch.cuda.Stream(self.device)
                          for _ in range(plan.n_workers)]
                         if self.device.type == "cuda" else None)
        self.pool = ThreadPoolExecutor(
            max_workers=plan.n_workers, thread_name_prefix="coded-worker")

    def close(self, wait: bool = False) -> None:
        """Stop the worker threads; ``wait=True`` also waits for the rows
        still computing (late originals, re-dispatches) to finish."""
        self.pool.shutdown(wait=wait, cancel_futures=True)

    def __enter__(self) -> "MeasuredWorkerRuntime":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------------
    def _on_stream(self, row: int):
        """The context a row computes in: its slot's stream on CUDA."""
        if self._streams is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self._streams[row])

    def _row_fn(self, xb):
        """``(compute_row, (q, ell))``: ``compute_row(row)`` gives that
        shard row's ``(q, ell)`` transform on the plan's device, on the
        calling thread's current stream, synchronized before it returns.
        On CUDA each row's stream first waits for the bucket's message.

        On the kernel backend the message and the generator are split
        into f32 planes once a round; a row is then one ``cmatmul`` of
        its (1, m) generator row and one ``fourstep_planar`` call (the
        plan's worker, planes in and out)."""
        plan = self.plan
        x = torch.as_tensor(xb, device=self.device)
        c = plan.message(x)                                  # (q, m, ell)
        q, m, ell = c.shape
        # (m, q*ell): the bucket folded into the payload columns
        folded = c.transpose(0, 1).reshape(m, q * ell).contiguous()
        if self._kernel:
            operands = (*ref.planar(plan.generator), *ref.planar(folded))
        else:
            operands = (plan.generator.to(folded.dtype), folded)
        ready = None
        if self._streams is not None:
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(self.device))

        def compute_row(row: int) -> torch.Tensor:
            if ready is not None:
                stream = self._streams[row]
                stream.wait_event(ready)
                for t in operands:
                    t.record_stream(stream)
            if self._kernel:
                gr, gi, cr, ci = operands
                ar, ai = cmatmul(gr[row:row + 1], gi[row:row + 1], cr, ci)
                outr, outi = ops.fourstep_planar(ar.reshape(q, ell),
                                                 ai.reshape(q, ell))
                b_k = ref.unplanar(outr, outi)
            else:
                gen, flat = operands
                b_k = plan.worker_compute((gen[row:row + 1] @ flat)
                                          .reshape(q, ell))
            if self._streams is not None:
                self._streams[row].synchronize()
            return b_k

        return compute_row, (q, ell)

    def round(self, xb, round_idx: int,
              alive: Optional[np.ndarray] = None) -> MeasuredRound:
        """Run one bucket ``xb`` (``(q, s)`` complex) as a measured round."""
        plan = self.plan
        n, m = plan.n_workers, plan.m
        alive = (np.ones(n, bool) if alive is None
                 else np.asarray(alive, bool).copy())
        rf = (self.injector.faults_for(round_idx)
              if self.injector is not None else RoundFaults())
        delay_map = rf.delay_map
        compute_row, (q, ell) = self._row_fn(xb)
        threshold = (int(alive.sum()) if self.require_all
                     else min(m + self.threshold_extra, int(alive.sum())))
        resq: queue_mod.Queue = queue_mod.Queue()
        t_start = time.perf_counter()

        def worker(k: int) -> None:
            if k in rf.killed:
                return  # dead: never responds this round
            try:
                with self._on_stream(k):
                    b_k = compute_row(k)
                if k in rf.corrupt and self.injector is not None:
                    bad = self.injector.corrupt_payload(b_k.cpu().numpy(),
                                                        k, round_idx)
                    b_k = torch.as_tensor(bad, device=self.device)
            except Exception as err:              # noqa: BLE001
                resq.put((k, err, 0.0))           # re-raised by the master
                return
            d = delay_map.get(k)
            if d:
                time.sleep(d)
            resq.put((k, b_k, time.perf_counter() - t_start))

        def redispatch(row: int) -> None:
            # a healthy thread recomputes the missing shard row: no fault
            # applies (the faulty worker is not the one computing it)
            try:
                with self._on_stream(row):
                    b_k = compute_row(row)
            except Exception as err:              # noqa: BLE001
                resq.put((row, err, 0.0))
                return
            resq.put((row, b_k, time.perf_counter() - t_start))

        for k in np.flatnonzero(alive):
            self.pool.submit(worker, int(k))

        got: dict[int, torch.Tensor] = {}
        times = np.full(n, np.inf)
        t_met = np.inf
        # wait budget for the k-th-fastest response we actually need:
        # m for the coded path, m + quorum under verify, ALL alive rows
        # for the uncoded require_all baseline
        deadline = self.health.deadline(max(threshold, 1), alive=alive)
        if not np.isfinite(deadline):
            # too many never-responders for an m-th-fastest deadline:
            # budget off the slowest worker that HAS responded (retries
            # still extend from there), or the floor when nobody has
            est = self.health.estimates()[:n]
            fin = est[np.isfinite(est) & alive]
            deadline = (float(fin.max()) * (1.0 + self.health.slack_frac)
                        if fin.size else 0.0)
        window = max(deadline, self.min_deadline_s)
        retries = redispatched = 0
        healthy = alive & ~np.isin(np.arange(n), sorted(rf.killed))
        if self.health.byzantine.any():
            healthy &= ~self.health.byzantine
        reason: Optional[str] = None

        if int(alive.sum()) < m:
            reason = "insufficient_workers"
        else:
            while True:
                self._collect(resq, got, times, window, t_start, threshold)
                if len(got) >= threshold:
                    break
                if retries >= self.max_retries:
                    reason = "retries_exhausted"
                    break
                if not healthy.any():
                    reason = "insufficient_workers"
                    break
                missing = [k for k in np.flatnonzero(alive) if k not in got]
                for row in missing:
                    self.pool.submit(redispatch, int(row))
                redispatched += len(missing)
                retries += 1
                window *= self.retry_backoff
            if len(got) >= threshold:
                t_met = float(np.sort(times[np.isfinite(times)])[threshold - 1])

        b = torch.zeros((q, n, ell), dtype=plan.dtype, device=self.device)
        mask = np.zeros(n, bool)
        main = (torch.cuda.current_stream(self.device)
                if self._streams is not None else None)
        for k, row in got.items():
            b[:, k] = row
            if main is not None:
                # made on its slot's stream, read on this one
                row.record_stream(main)
            mask[k] = True
        finite = times[np.isfinite(times)]
        t_last = float(finite.max()) if finite.size else np.inf
        self.health.observe_round(np.where(np.isfinite(times), times, np.nan))
        return MeasuredRound(b, mask, reason, t_met=t_met, t_last=t_last,
                             retries=retries, redispatched=redispatched,
                             times=times)

    @staticmethod
    def _collect(resq: queue_mod.Queue, got: dict, times: np.ndarray,
                 window: float, t_start: float, threshold: int) -> None:
        """Drain arrivals until ``threshold`` rows are in or the window
        closes (first arrival per row wins: an original beating its
        re-dispatched copy is kept).  A worker whose compute raised hands
        its exception over, and it is raised here: a failed kernel fails
        the round instead of passing for a straggler."""
        while len(got) < threshold:
            remaining = window - (time.perf_counter() - t_start)
            if remaining <= 0:
                # non-blocking final sweep: arrivals already queued count
                try:
                    while True:
                        k, row, t = resq.get_nowait()
                        if isinstance(row, BaseException):
                            raise row
                        if k not in got and t <= window:
                            got[k] = row
                            times[k] = t
                except queue_mod.Empty:
                    return
                continue
            try:
                k, row, t = resq.get(timeout=remaining)
            except queue_mod.Empty:
                continue
            if isinstance(row, BaseException):
                raise row
            if k not in got:
                got[k] = row
                times[k] = t
