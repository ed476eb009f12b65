"""The launch tools' counter on the card (marker ``gpu``, skipped without
a CUDA device; no JAX import, so the file runs where only torch is
installed).

* a reduced gemma-2b prefill and decode step, and a reduced rwkv6-3b
  prefill (one ``wkv`` launch a layer, reported to the counter), counted
  on CUDA tensors and on meta tensors: FLOPs, bytes and the kernels'
  reports equal; the meta run launches nothing.
"""

import pytest
import torch

from repro_torch.configs import get_reduced_config
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.launch.cost_analysis import analyze
from repro_torch.models import build_model

B, T, CACHE = 2, 32, 64


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _count(arch, device):
    model = build_model(get_reduced_config(arch), device=device)
    params = model.make_params()
    if device.type == "cuda":
        with torch.no_grad():
            for p in params.parameters():
                p.normal_(0.0, 0.02)
    tokens = torch.zeros((B, T), dtype=torch.int32, device=device)
    cache = model.init_cache(B, CACHE)
    reset_launch_counts()
    with torch.no_grad():
        _, pre = analyze(model.prefill, params, {"tokens": tokens}, cache)
        _, dec = analyze(model.decode_step, params, cache,
                         {"tokens": tokens[:, :1]}, T)
    if device.type == "cuda":
        torch.cuda.synchronize()
    return pre, dec, launch_counts()


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ("gemma-2b", "rwkv6-3b"))
def test_gpu_counts_equal_meta(cuda, arch):
    pre_c, dec_c, launches_c = _count(arch, cuda)
    pre_m, dec_m, launches_m = _count(arch, torch.device("meta"))
    for got, want in ((pre_c, pre_m), (dec_c, dec_m)):
        assert got.flops == want.flops
        assert got.flops_by_dtype == want.flops_by_dtype
        assert got.bytes_accessed == want.bytes_accessed
        assert got.kernels == want.kernels
    assert launches_m == {}
    n_layers = get_reduced_config(arch).n_layers
    if arch == "rwkv6-3b":
        assert launches_c == {"wkv": n_layers}
        assert pre_c.kernels["wkv"]["calls"] == n_layers
    else:
        assert launches_c == {}
