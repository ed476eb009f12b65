"""The RWKV-6 WKV recurrence, chunked and factorised: plain body and kernel.

Per (batch, head) row, with the state S (K, V = K), the log decay
``logw <= 0`` and the bonus u:

    o_t = r_t . (diag(u) k_t v_t^T + S_{t-1})
    S_t = diag(exp(logw_t)) S_{t-1} + k_t v_t^T

computed chunk by chunk (``CT = 8`` steps) in the mid-chunk re-centred
factorisation of the JAX package's ``kernels/wkv.py``: each decay factor's
exponent stays within (CT/2 + 1) * 8 because the model clamps
``logw >= -8``, and the intra-chunk scores take the strict lower triangle
by selection.  :func:`wkv_body` is the plain twin; :func:`wkv` the wrapper
of ``csrc/wkv.cu``, one launch, counted under ``"wkv"``.

The kernel splits the value axis: one block per (row, slice of
``VALUE_BLOCK`` value columns), no block depending on another, each
walking the row in segments of ``SEGMENT_CHUNKS`` chunks -- the decay
factors and the masked scores of a whole segment first, then a state scan
held in registers, then every output of the segment at once.  The two
constants mirror the ``.cu``'s compile-time ``WKV_VB`` and ``WKV_G``.  It
forms each decay factor as a product of two exponentials (``e^{pm1}``
times ``e^{-c}``, ``e^{c}`` or ``e^{p_end}`` times ``e^{-p}``, all within
``e^{+-64}`` under the clamp), so it holds the twin's results for
``logw >= -8``, the model's clamp.

Layout, as the TPU kernel's: r, k, v, logw (BH, T, K) f32 planar (batch
and heads flattened b-major), u (BH, K), state (BH, K, K).  T must be a
multiple of 8: the caller pads, with zeros in logw as well, so padded
steps leave the state unchanged.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build

__all__ = ["CT", "MAX_K", "SEGMENT_CHUNKS", "VALUE_BLOCK", "design", "wkv",
           "wkv_body"]

CT = 8       # time chunk
MAX_K = 64   # the kernel's head-size bound (the model's 64)
VALUE_BLOCK = 32     # value columns a block (csrc/wkv.cu's WKV_VB)
SEGMENT_CHUNKS = 2   # chunks a segment (csrc/wkv.cu's WKV_G)


def wkv_body(r, k, v, logw, u, state):
    """The chunked factorised WKV in PyTorch ops.  Returns (o, state)."""
    bh, t, kd = r.shape
    rows = torch.arange(CT, device=r.device)
    below = rows[:, None] > rows[None, :]
    s = state
    outs = []
    for t0 in range(0, t, CT):
        rc, kc, vc, lw = (x[:, t0:t0 + CT] for x in (r, k, v, logw))
        p = torch.cumsum(lw, dim=1)                   # (BH, CT, K)
        pm1 = F.pad(p[:, :-1], (0, 0, 1, 0))          # exclusive cumsum
        c = p[:, CT // 2:CT // 2 + 1]                 # re-centring
        o_inter = (rc * torch.exp(pm1)) @ s
        scores = (rc * torch.exp(pm1 - c)) @ (kc * torch.exp(c - p)).mT
        scores = torch.where(below, scores, 0.0)      # select, not multiply
        coef = (rc * kc * u[:, None]).sum(-1, keepdim=True)
        outs.append(o_inter + scores @ vc + coef * vc)
        pe = p[:, -1:]
        s = s * torch.exp(pe).mT + (kc * torch.exp(pe - p)).mT @ vc
    return torch.cat(outs, dim=1), s


@functools.lru_cache(maxsize=None)
def _lib():
    fn = _build.load("wkv").wkv_f32
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp] * 8 + [i32, i32, i32, vp]
    fn.restype = ctypes.c_int
    return fn


def design() -> dict:
    """The compiled kernel's design on the current CUDA device: value
    columns a block, chunks a segment, threads, shared bytes a block and
    the blocks an SM holds (the occupancy calculator)."""
    lib = _build.load("wkv")
    out = (ctypes.c_int * 5)()
    lib.wkv_design.argtypes = [ctypes.c_void_p]
    lib.wkv_design.restype = ctypes.c_int
    _build.check(lib.wkv_design(ctypes.cast(out, ctypes.c_void_p)),
                 "wkv_design")
    return dict(zip(("value_block", "segment_chunks", "threads",
                     "smem_bytes", "blocks_per_sm"), out))


def _check(r, k, v, logw, u, state):
    """Shapes, dtypes and T % 8 of the wrapper's contract, or raise."""
    if r.dim() != 3 or any(x.shape != r.shape for x in (k, v, logw)):
        raise ValueError("wkv: r, k, v and logw must share one (BH, T, K) "
                         f"shape, got {[tuple(x.shape) for x in (r, k, v, logw)]}")
    bh, t, kd = r.shape
    if tuple(u.shape) != (bh, kd) or tuple(state.shape) != (bh, kd, kd):
        raise ValueError(f"wkv: u {tuple(u.shape)} and state "
                         f"{tuple(state.shape)} do not fit (BH, T, K) = "
                         f"{(bh, t, kd)}")
    if t == 0 or t % CT:
        raise ValueError(f"wkv: T={t} is not a positive multiple of {CT}; "
                         f"pad upstream (zeros in logw too)")
    for name, x in (("r", r), ("k", k), ("v", v), ("logw", logw), ("u", u),
                    ("state", state)):
        if x.dtype != torch.float32:
            raise TypeError(f"wkv: {name} must be float32, got {x.dtype}")


def wkv(r, k, v, logw, u, state):
    """The WKV over (BH, T, K) planar rows.  Returns (o, final_state).

    CPU tensors run :func:`wkv_body`; CUDA tensors launch the kernel (one
    launch, K <= ``MAX_K``) or raise.
    """
    _check(r, k, v, logw, u, state)
    if r.device.type == "cpu":
        return wkv_body(r, k, v, logw, u, state)
    dev = _build.check_planes("wkv", r=r, k=k, v=v, logw=logw, u=u,
                              state=state)
    bh, t, kd = r.shape
    if kd > MAX_K:
        raise NotImplementedError(
            f"wkv: K={kd} > {MAX_K}, the kernel's head-size bound")
    o = torch.empty_like(r)
    s_out = torch.empty_like(state)
    p = _build.ptr
    _build.check(_lib()(p(r), p(k), p(v), p(logw), p(u), p(state), p(o),
                        p(s_out), bh, t, kd, _build.stream_of(dev)), "wkv")
    _build.count_launch("wkv")
    return o, s_out
