"""Coded and compressed gradient aggregation on the card (marker ``gpu``,
skipped without a CUDA device; no JAX import, so the file runs where
only torch is installed).

Reduced gemma-2b's gradients (f32 weights, a seeded 4 x 24 batch split
into 4 partitions of one row, taken on the CPU) go through the same
operations on the card and on the CPU, which
``tests/test_torch_grad_aggregation.py`` holds against the JAX package:

* ``CyclicGradientCode(4, 1)``: every worker's message and the decode
  from every 3-of-4 subset, bit-equal (each is f32 products by rounded
  weights and f32 sums in a fixed order, IEEE-exact on both devices);
* ``compress``/``decompress`` of every leaf with a seeded residual: the
  int8 codes, the scales, the new residuals and the decompressed values
  bit-equal (amax, a correctly rounded division, round half to even).
"""

import itertools

import numpy as np
import pytest
import torch

from repro_torch.configs import ShapeConfig, get_reduced_config
from repro_torch.data import make_pipeline
from repro_torch.models import build_model
from repro_torch.optim import CyclicGradientCode, compress, decompress
from repro_torch.optim.grad_utils import accumulate_grads


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture
def partition_grads():
    """4 partition gradients of reduced gemma-2b on the CPU."""
    cfg = get_reduced_config("gemma-2b")
    model = build_model(cfg, dtype=torch.float32, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    params.requires_grad_(True)
    batch = make_pipeline(cfg, ShapeConfig("t", 24, 4, "train"), seed=0,
                          device="cpu").batch(0)
    out = []
    for j in range(4):
        part = {k: v[j:j + 1] for k, v in batch.items()}
        out.append(accumulate_grads(model.loss, params, part, 1)[2])
    return out


def _on(tree, dev):
    return {k: v.detach().to(dev) for k, v in tree.items()}


@pytest.mark.gpu
def test_gpu_coded_encode_decode_matches_cpu(cuda, partition_grads):
    code = CyclicGradientCode(4, 1)
    parts = {dev: [_on(g, dev) for g in partition_grads]
             for dev in ("cpu", cuda)}
    msgs = {dev: [code.encode_worker_grad(k, parts[dev]) for k in range(4)]
            for dev in parts}
    for k in range(4):
        for name, m in msgs["cpu"][k].items():
            assert torch.equal(msgs[cuda][k][name].cpu(), m), (k, name)
    for subset in itertools.combinations(range(4), 3):
        sub = np.asarray(subset)
        dec = {dev: code.decode(sub, [msgs[dev][i] for i in subset])
               for dev in parts}
        for name, v in dec["cpu"].items():
            assert v.dtype == torch.float32
            assert torch.equal(dec[cuda][name].cpu(), v), (subset, name)


@pytest.mark.gpu
def test_gpu_compress_matches_cpu(cuda, partition_grads):
    gen = torch.Generator().manual_seed(5)
    for name, g in partition_grads[0].items():
        res = torch.randn(g.shape, generator=gen) * 1e-4
        code, new = compress(g.detach(), res)
        gcode, gnew = compress(g.detach().to(cuda), res.to(cuda))
        assert torch.equal(gcode.q.cpu(), code.q), name
        assert torch.equal(gcode.scale.cpu(), code.scale), name
        assert torch.equal(gnew.cpu(), new), name
        assert torch.equal(decompress(gcode, tuple(g.shape)).cpu(),
                           decompress(code, tuple(g.shape))), name
