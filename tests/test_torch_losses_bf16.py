"""The port's training losses with bf16 weights (the default build)
against the JAX package's, on the CPU: every family's ``BuiltModel.loss``
on its reduced config (the weights and batches of
``tests/test_torch_losses.py``), unpatched, against ``jax.grad`` of the
reference's loss.  The loss within 1e-2 and every gradient within 5% of
its largest entry (bf16 rounding points, as the serving slices' 5%;
measured at most 2.7%).  RWKV-6's bf16 gradients are held by direction,
a cosine above 0.95 a parameter: its backward sums bf16 cotangents that
cancel (the bonus ``u``'s gradient differs by 26% relative L2, its
cosine 0.97) in another order than XLA's transpose.
"""

import numpy as np
import pytest
import torch
from test_torch_losses import ARCHS, _both, _carried, _rel, jx  # noqa: F401


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.mark.parametrize("fam", list(ARCHS))
def test_family_bf16_loss_and_grads_match_jax(jx, fam):
    m = _carried(jx, fam, torch.bfloat16)
    loss, _, grads, want, _, ref = _both(jx, m)
    assert _rel(loss, want) < 1e-2
    for name, g in grads.items():
        assert g.dtype == m["params"].get_parameter(name).dtype
        if fam == "ssm":
            a = g.double().flatten()
            b = torch.from_numpy(np.asarray(ref[name], np.float64)).flatten()
            assert float(a @ b / (a.norm() * b.norm())) > 0.95, name
        else:
            assert _rel(g, ref[name]) < 0.05, name
