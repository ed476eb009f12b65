"""SPMD execution of any MDS coded plan over a ``torch.distributed`` mesh.

The paper's master/worker topology mapped onto processes, one rank a
device (the JAX package runs one ``shard_map`` over P devices; the port
runs P processes, each calling the runtime with the same arguments):

* **encode** -- each rank holds the (replicated) message shards and
  computes only ITS ``n_local = N / P`` coded shards, rows
  ``rank * n_local + arange(n_local)`` of the generator (no collective).
  On a kernel-backend plan this is one ``ops.mds_apply`` (the ``cmatmul``
  kernel) of those rows on the batch-folded message, in the layout of the
  plan's own kernel encode; on a reference-backend plan the plain product.
  The message is produced by ``plan.message`` (interleave), so the runtime
  works for every :class:`repro_torch.core.plan.MDSPlan` -- 1-D, n-D,
  real, multi-input -- and the strategy plans that allow a mesh.
* **worker compute** -- ``plan.worker_compute`` on the rank's own shards
  (the four-step kernels on the kernel backend), then the straggler mask:
  rows a request's mask has off are overwritten with ``masked_fill`` (NaN
  in tests, to prove decode never reads them).
* **decode** -- one ``all_gather_into_tensor`` on the axis's group is the
  paper's fan-in to the master (exactly the coded symbols, Remark 5's
  cut-set optimum); then every rank runs the same masked decode: a
  single request through ``mds.decode_auto``, a batch through
  per-request Lagrange decode matrices (their scatter form contracted by
  ``ops.decode_apply``, the ``bcmatmul`` kernel, on the kernel backend),
  and ``plan.postdecode``.

:meth:`DistributedCodedPlan.run_sharded` is the 1-D pipeline whose one
collective is an all-to-all: each rank receives only its output columns.
Each call records its collectives in ``last_collectives`` (kind, group
size, symbols each rank sends and receives), the port's counterpart of
the JAX package's compiled-program inspection.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.core import mds
from repro_torch.core.coded_fft import CodedFFT
from repro_torch.core.plan import batch_shape
from repro_torch.core.recombine import dft_matrix
from repro_torch.distributed.faults import FaultInjector, FaultPlan
from repro_torch.kernels import ops, ref

__all__ = ["DistributedCodedPlan", "DistributedCodedFFT"]


@dataclasses.dataclass(frozen=True)
class DistributedCodedPlan:
    """Run any ``MDSPlan`` across a mesh axis with straggler masking.

    ``masked_fill`` is the value written into masked-out workers' result
    rows before they leave the rank; the decode provably ignores those
    rows, which tests assert by setting it to NaN.  The mesh's device type
    must be that of the plan's device.  Every rank of the mesh calls each
    method with the same arguments.
    """

    plan: object  # any repro_torch.core.plan.MDSPlan
    mesh: DeviceMesh
    axis: str = "workers"
    masked_fill: float = 0.0
    # the collectives of the last call: dicts of kind, group_size,
    # send_symbols and recv_symbols (complex symbols a rank moves)
    last_collectives: list = dataclasses.field(
        default_factory=list, init=False, compare=False, repr=False)

    def __post_init__(self):
        names = tuple(self.mesh.mesh_dim_names or ())
        if self.axis not in names:
            raise ValueError(f"mesh has no axis {self.axis!r}: {names}")
        if self.mesh.device_type != self.plan.device.type:
            raise ValueError(
                f"mesh device type {self.mesh.device_type!r} does not match "
                f"the plan's device {self.plan.device}")
        size = self.axis_size
        if self.plan.n_workers % size != 0:
            raise ValueError(
                f"N={self.plan.n_workers} must be a multiple of axis "
                f"size {size}")

    @property
    def axis_size(self) -> int:
        return self.mesh.size(self.mesh.mesh_dim_names.index(self.axis))

    @property
    def n_local(self) -> int:
        return self.plan.n_workers // self.axis_size

    def _local_rows(self) -> torch.Tensor:
        """This rank's coded rows: ``rank * n_local + arange(n_local)``."""
        idx = self.mesh.get_local_rank(self.axis)
        return idx * self.n_local + torch.arange(self.n_local,
                                                 device=self.plan.device)

    def _record(self, kind: str, send: int, recv: int) -> None:
        object.__setattr__(self, "last_collectives", [{
            "kind": kind, "group_size": self.axis_size,
            "send_symbols": int(send), "recv_symbols": int(recv)}])

    # ------------------------------------------------------------------
    def run(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
            *, fragment_mask: Optional[torch.Tensor] = None,
            method: str = "auto",
            faults: Optional[object] = None, round_idx: int = 0
            ) -> torch.Tensor:
        """End-to-end coded transform of ``x`` under the mesh.

        ``x``: ``(*B, *input_shape)``; ``mask``: bool ``(*B, N)`` or shared
        ``(N,)`` worker availability.  Default: all up.  Returns
        ``(*B, *output_shape)``, the same on every rank.

        ``fragment_mask`` (plans with ``fragments > 1``): bool ``(*B, N,
        F)`` / ``(N, F)`` per-fragment availability -- a slow-but-alive
        worker contributes its finished prefix.  Combines with ``mask``.

        The strategy hooks (all optional, the base MDS plans use none):
        ``worker_encode_tensor`` ``(N, F, W)`` replaces per-worker
        generator rows, ``stored_shard_shape`` sizes the per-rank buffer
        when a plan ships less than it stores, ``worker_compute_rows`` is
        the worker-index-aware compute (the comm-efficient fold), and
        ``decode_generator`` is the (possibly wider) system the master
        solves -- the gathered ``(N, F)`` results flatten to its ``N*F``
        rows in ``f*N + w`` order.

        ``faults``: a :class:`~repro_torch.distributed.faults.FaultPlan` or
        ``FaultInjector`` projected onto ``round_idx``.  Kills fold into
        the availability mask (a dead worker IS a masked worker); corrupt
        workers keep their mask bit but their rows are warped to ``b *
        (-3.7) + 11.3`` before leaving the worker stage, so an unmasked
        decode that reads them yields visibly wrong output.  Delays are a
        no-op: the all-gather already waits for every participant.
        """
        plan = self.plan
        dev = plan.device
        n = plan.n_workers
        nf = getattr(plan, "fragments", 1)
        out_shard = tuple(plan.worker_shard_shape)
        stored = tuple(getattr(plan, "stored_shard_shape", out_shard))
        # what one decoded row / shipped fragment carries
        post_shard = out_shard[1:] if nf > 1 else out_shard
        payload = math.prod(post_shard)
        enc_t = getattr(plan, "worker_encode_tensor", None)
        if enc_t is None:
            enc_t = plan.generator[:, None, :]                # (N, 1, m)
        width = enc_t.shape[2]
        dec_g = plan.decode_generator
        k = dec_g.shape[1]
        n_rows = n * nf
        wc_rows = getattr(plan, "worker_compute_rows", None)
        kernel = plan.resolved_backend == "kernel"

        x = torch.as_tensor(x, device=dev)
        batch = batch_shape(x, len(plan.input_shape), "plan input")
        mask = (torch.ones(batch + (n,), dtype=torch.bool, device=dev)
                if mask is None
                else torch.as_tensor(mask, device=dev).bool())
        corrupt = None
        if faults is not None:
            injector = (FaultInjector(faults)
                        if isinstance(faults, FaultPlan) else faults)
            rf = injector.faults_for(round_idx)
            if rf.killed:
                dead = torch.tensor([w in rf.killed for w in range(n)],
                                    device=dev)
                mask = mask & ~dead
            if rf.corrupt:
                corrupt = torch.as_tensor(
                    np.asarray(injector.corrupt_flags(n, round_idx)),
                    device=dev)

        # (B, W, payload) flat message symbols
        c = plan.message(x).reshape((-1, width, math.prod(stored) // nf))
        nb, p_in = c.shape[0], c.shape[2]
        wmask = mask.broadcast_to(batch + (n,)).reshape(nb, n)
        if fragment_mask is None:
            fmask = wmask[:, :, None].expand(nb, n, nf)
        else:
            fmask = torch.as_tensor(fragment_mask, device=dev).bool() \
                .broadcast_to(batch + (n, nf)).reshape(nb, n, nf) \
                & wmask[:, :, None]

        # -- worker stage: this rank's coded rows only -------------------
        rows = self._local_rows()
        nl = self.n_local
        g_rows = enc_t[rows]                                # (nl, F, W)
        if kernel:
            # the plan's kernel encode layout: batch folded into columns
            folded = c.transpose(0, 1).reshape(width, nb * p_in)
            a = ops.mds_apply(g_rows.reshape(nl * nf, width), folded)
            a = a.reshape(nl, nf, nb, p_in).transpose(1, 2)
        else:
            a = torch.einsum("nfw,bwp->nbfp", g_rows.to(c.dtype), c)
        a = a.reshape((nl, nb) + stored)
        if wc_rows is not None:
            # worker-index-aware compute: its row axis sits at -2
            b = wc_rows(a.movedim(0, -2), rows).movedim(-2, 0)
        else:
            b = plan.worker_compute(a)
        b = b.reshape(nl, nb, nf, payload)
        if corrupt is not None:
            bad = corrupt[rows][:, None, None, None]
            b = torch.where(bad, b * (-3.7) + 11.3, b)
        alive = fmask[:, rows].transpose(0, 1)[..., None]   # (nl, nb, F, 1)
        b = torch.where(alive, b, torch.full((), self.masked_fill,
                                             dtype=b.dtype, device=dev))

        # -- the fan-in: one all-gather, worker axis leading -------------
        b_all = torch.empty((n, nb, nf, payload), dtype=b.dtype, device=dev)
        dist.all_gather_into_tensor(
            torch.view_as_real(b_all), torch.view_as_real(b.contiguous()),
            group=self.mesh.get_group(self.axis))
        self._record("all_gather", b.numel(), b_all.numel())

        # -- the master's decode, replicated on every rank ---------------
        b_all = b_all.permute(1, 2, 0, 3).reshape(nb, n_rows, payload)
        rmask = fmask.transpose(1, 2).reshape(nb, n_rows)
        if nb == 1:
            subset = mds.first_available(rmask[0], k)
            c_hat = mds.decode_auto(dec_g, b_all[0], subset,
                                    method=method)[None]
        elif method == "auto" and k <= mds.LAGRANGE_MAX_M:
            # per-request decode matrices from the closed-form Lagrange
            # inversion, built in complex128 (built in f32 they lose 1e-2
            # on a partial plan's fragment draws at k = 8 of 16 nodes,
            # 4e-5 so); straggler rows are never read: on the kernel
            # backend the scatter form's zero columns, which bcmatmul
            # skips, else gathered out
            if kernel:
                dmat = mds.lagrange_decode_matrices(rmask, k,
                                                    torch.complex128)
                hr, hi = ops.decode_apply(*ref.planar(dmat),
                                          *ref.planar(b_all))
                c_hat = ref.unplanar(hr, hi)
            else:
                subsets = mds.first_available(rmask, k)
                inv = mds.lagrange_inverse(subsets, n_rows, torch.complex128)
                c_hat = inv.to(b_all.dtype) @ torch.take_along_dim(
                    b_all, subsets[:, :, None], dim=1)
        else:
            # batched, pinned method: "auto" resolves to the solve
            subsets = mds.first_available(rmask, k)
            if method == "ifft":
                c_hat = mds.decode_ifft_batched(b_all, subsets, n_rows)
            else:
                c_hat = torch.linalg.solve(
                    dec_g[subsets].to(b_all.dtype),
                    torch.take_along_dim(b_all, subsets[:, :, None], dim=1))
        out = plan.postdecode(c_hat.reshape((nb, k) + post_shard))
        if not batch:
            return out[0]
        return out.reshape(batch + tuple(plan.output_shape))

    # ------------------------------------------------------------------
    def run_sharded(self, x: torch.Tensor,
                    mask: Optional[torch.Tensor] = None,
                    *, method: str = "auto") -> DTensor:
        """The 1-D pipeline with a column-sharded output.

        ``run`` realizes the paper's master literally: every rank gathers
        all N coded results (N/m x s symbols) and decodes everything.  No
        consumer needs X replicated, so here each rank receives only its
        OUTPUT COLUMNS of every worker's result through one all-to-all --
        N*(s/m)/P symbols instead of the gather's N*(s/m), P times less
        wire -- decodes its (m, L/P) column block and recombines it
        locally (twiddles on the rank's absolute columns).

        Specific to the 1-D :class:`CodedFFT` layout; other plans raise.
        Returns the output matrix ``Xmat`` ``(m, s/m)`` as a DTensor
        sharded by columns over the axis (``Shard(1)``);
        ``X = Xmat.reshape(s)``, since ``Xmat[j, i] = X[j*(s/m) + i]``.
        """
        plan = self.plan
        if not isinstance(plan, CodedFFT):
            raise NotImplementedError(
                "run_sharded implements the 1-D Cooley-Tukey output layout; "
                f"got {type(plan).__name__} -- use run()")
        p_sz = self.axis_size
        ell = plan.shard_len
        if ell % p_sz != 0:
            raise ValueError(f"s/m={ell} must divide over {p_sz} devices")
        dev = plan.device
        mask = (torch.ones(plan.n_workers, dtype=torch.bool, device=dev)
                if mask is None
                else torch.as_tensor(mask, device=dev).bool())
        cols = ell // p_sz
        rows = self._local_rows()
        nl = self.n_local

        # fused interleave + encode: c[i, l] = x[i + l*m] is the transposed
        # view of x.reshape(L, m), so the coded shards are one product
        xr = torch.as_tensor(x, device=dev).to(plan.dtype).reshape(ell, plan.m)
        g_rows = plan.generator[rows]                       # (nl, m)
        if plan.resolved_backend == "kernel":
            a_local = ops.mds_apply(g_rows, xr.transpose(0, 1))
        else:
            a_local = torch.einsum("lm,nm->nl", xr, g_rows.to(plan.dtype))
        b_local = plan.resolved_worker_fn(a_local)          # (nl, L)
        b_local = torch.where(
            mask[rows][:, None], b_local,
            torch.full((), self.masked_fill, dtype=b_local.dtype,
                       device=dev))
        # row shards -> column shards: THE one collective of this path
        send = b_local.reshape(nl, p_sz, cols).transpose(0, 1).contiguous()
        recv = torch.empty_like(send)                       # (P, nl, L/P)
        dist.all_to_all_single(torch.view_as_real(recv),
                               torch.view_as_real(send),
                               group=self.mesh.get_group(self.axis))
        self._record("all_to_all", send.numel(), recv.numel())
        b_cols = recv.reshape(plan.n_workers, cols)
        subset = mds.first_available(mask, plan.m)
        c_cols = mds.decode_auto(plan.generator, b_cols, subset,
                                 method=method)             # (m, L/P)
        # the recombine on this rank's absolute columns
        idx = self.mesh.get_local_rank(self.axis)
        col = idx * cols + torch.arange(cols, device=dev, dtype=torch.int64)
        ki = (torch.arange(plan.m, device=dev)[:, None] * col) % plan.s
        ang = (-2.0 * np.pi / plan.s) * ki.to(torch.float64)
        w = torch.polar(torch.ones_like(ang), ang).to(c_cols.dtype)
        out = dft_matrix(plan.m, c_cols.dtype, device=dev) @ (c_cols * w)
        placements = [Replicate()] * self.mesh.ndim
        placements[self.mesh.mesh_dim_names.index(self.axis)] = Shard(1)
        return DTensor.from_local(out, self.mesh, placements,
                                  run_check=False)


# The 1-D name; the class is generic over plans, so this is a pure alias.
DistributedCodedFFT = DistributedCodedPlan
