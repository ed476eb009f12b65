"""int8 error-feedback gradient compression for the data-parallel all-reduce.

Each replica (1) adds its residual from the previous step, (2)
block-quantizes to int8 (blocks of 256, one f32 amax scale a block:
1024 / 260 = 3.94x fewer bytes than f32 on the wire, 1.97x than bf16),
(3) exchanges the int8 code and the scales, (4) dequantizes, and (5)
keeps the quantization error as the next residual: error feedback keeps
the *accumulated* bias bounded, so convergence matches uncompressed SGD
up to higher-order terms (Karimireddy et al. 2019).

``compress``/``decompress`` follow the JAX package's operation for
operation (an f32 add, zero padding to whole blocks, amax / 127, a safe
divide, round half to even, a clip to +-127), so the codes are its codes
bit for bit.  :func:`compressed_psum` is the all-reduce over a
``torch.distributed`` group.  The reference all-reduces the f32 product
``q * scale`` (its int32 sum of ``q`` is computed and dropped); the port
sends what the scheme promises, the int8 code and the f32 scales, as
one all-gather each, and every rank dequantizes and sums the ranks in
rank order, so the mean is bit-equal on every rank and equals the
reference's up to the order of the sum.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

__all__ = ["CompressedGrad", "compress", "decompress", "init_residual",
           "compressed_psum", "compression_ratio", "last_collectives"]

_BLOCK = 256
F32 = torch.float32

# the collectives of the last compressed_psum call in this process: kind,
# group size, bytes each rank sends and receives
last_collectives: list[dict] = []


class CompressedGrad(NamedTuple):
    q: torch.Tensor       # int8 (nblocks, _BLOCK)
    scale: torch.Tensor   # f32 (nblocks, 1)


def _blocks(flat: torch.Tensor) -> torch.Tensor:
    pad = (-flat.shape[0]) % _BLOCK
    return torch.nn.functional.pad(flat, (0, pad)).reshape(-1, _BLOCK)


def compress(g: torch.Tensor, residual: torch.Tensor
             ) -> tuple[CompressedGrad, torch.Tensor]:
    """Quantize ``g + residual`` to int8 blocks; return code + new residual."""
    x = g.to(F32) + residual
    blocks = _blocks(x.reshape(-1))
    amax = blocks.abs().amax(dim=-1, keepdim=True)
    # divided by a tensor: CUDA turns a division by a Python scalar into
    # a product with its reciprocal, one rounding off the reference's
    scale = amax / amax.new_tensor(127.0)
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round(blocks / safe), -127, 127).to(torch.int8)
    deq = (q.to(F32) * scale).reshape(-1)[: x.numel()].reshape(x.shape)
    return CompressedGrad(q=q, scale=scale), x - deq


def decompress(code: CompressedGrad, shape: tuple[int, ...]) -> torch.Tensor:
    n = math.prod(shape)
    flat = (code.q.to(F32) * code.scale).reshape(-1)[:n]
    return flat.reshape(shape)


def init_residual(g: torch.Tensor) -> torch.Tensor:
    return torch.zeros(g.shape, dtype=F32, device=g.device)


def compressed_psum(g: torch.Tensor, residual: torch.Tensor,
                    group: Optional[object] = None, *, mesh=None,
                    axis: Optional[str] = None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Error-feedback int8 all-reduce mean of ``g`` over ``group`` (the
    default group when None), or over the ``DeviceMesh`` dimension
    ``axis`` of ``mesh``; every rank of the group calls it.  Returns
    (the mean in f32, this rank's new residual).

    One ``all_gather`` of the int8 code and one of the f32 scales; then
    sum_r scale_r * q_r over the ranks in rank order, over the group's
    size -- the same value on every rank."""
    if mesh is not None:
        group = mesh.get_group(axis)
    code, new_residual = compress(g, residual)
    world = dist.get_world_size(group)
    qs = [torch.empty_like(code.q) for _ in range(world)]
    scales = [torch.empty_like(code.scale) for _ in range(world)]
    dist.all_gather(qs, code.q, group=group)
    dist.all_gather(scales, code.scale, group=group)
    total = None
    for q, scale in zip(qs, scales):
        term = q.to(F32) * scale
        total = term if total is None else total.add_(term)
    mean = total / total.new_tensor(float(world))
    last_collectives[:] = [
        {"kind": "all_gather", "group_size": world, "dtype": "int8",
         "send_bytes": code.q.numel(), "recv_bytes": world * code.q.numel()},
        {"kind": "all_gather", "group_size": world, "dtype": "float32",
         "send_bytes": 4 * code.scale.numel(),
         "recv_bytes": 4 * world * code.scale.numel()}]
    return mean.reshape(-1)[: g.numel()].reshape(g.shape), new_residual


def compression_ratio(shape: tuple[int, ...], dtype=torch.float32) -> float:
    """Wire-bytes ratio of uncompressed vs int8-block compressed: 1024 / 260
    = 3.94 for f32 (a whole number of blocks), 1.97 for bf16."""
    n = math.prod(shape)
    nblocks = (n + _BLOCK - 1) // _BLOCK
    raw = n * dtype.itemsize
    comp = nblocks * _BLOCK * 1 + nblocks * 4
    return raw / comp
