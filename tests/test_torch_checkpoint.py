"""The port's checkpoint store (``checkpoint/store.py``) on the CPU: the
reference's ``tests/test_checkpoint.py`` ported (bf16 round trip, torn
writes, structure mismatch, garbage collection, the async writer), and
beside it:

* a checkpoint the JAX package's ``save_checkpoint`` writes from a numpy
  tree (bf16 through ``ml_dtypes`` included) restores bit for bit in the
  port, and one the port writes restores bit for bit in the JAX package;
* the async writer snapshots the tensors before ``save`` returns: an
  in-place update right after it does not reach the file;
* a ``TrainState`` (exact and int8 moments) through its flat tree, the
  store and ``from_tree``, bit for bit.
"""

import os
import tempfile

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import (
    AsyncCheckpointer,
    gc_checkpoints,
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)
from repro_torch.configs import get_reduced_config
from repro_torch.models import build_model
from repro_torch.optim import adamw
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.training import TrainState, init_train_state


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax")
    jnp = pytest.importorskip("jax.numpy")
    import repro.checkpoint as jckpt
    return dict(jnp=jnp, ckpt=jckpt)


def _tree():
    return {
        "a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
        "nested": {"b": torch.ones(4, dtype=torch.bfloat16) * 1.5,
                   "c": torch.tensor(7, dtype=torch.int32)},
    }


def test_roundtrip_including_bf16():
    with tempfile.TemporaryDirectory() as d:
        t = _tree()
        save_checkpoint(d, 3, t, metadata={"loss": 1.0})
        step, r = restore_checkpoint(d, t)
        assert step == 3
        assert r["nested"]["b"].dtype == torch.bfloat16
        assert torch.equal(r["a"], t["a"])
        assert torch.equal(r["nested"]["b"], t["nested"]["b"])
        assert torch.equal(r["nested"]["c"], t["nested"]["c"])


def test_latest_step_ignores_torn_writes():
    with tempfile.TemporaryDirectory() as d:
        save_checkpoint(d, 1, _tree())
        save_checkpoint(d, 2, _tree())
        os.makedirs(os.path.join(d, "step_00000009"))     # no manifest
        os.makedirs(os.path.join(d, "step_00000011.tmp.123"))
        assert latest_step(d) == 2


def test_structure_mismatch_rejected():
    with tempfile.TemporaryDirectory() as d:
        save_checkpoint(d, 1, _tree())
        with pytest.raises(ValueError, match="structure mismatch"):
            restore_checkpoint(d, {"different": torch.zeros(3)})


def test_gc_keeps_last_k():
    with tempfile.TemporaryDirectory() as d:
        for s in (1, 2, 3, 4):
            save_checkpoint(d, s, _tree())
        gc_checkpoints(d, keep_last=2)
        assert latest_step(d) == 4
        kept = sorted(n for n in os.listdir(d) if n.startswith("step_"))
        assert kept == ["step_00000003", "step_00000004"]


def test_async_checkpointer_surfaces_and_orders():
    with tempfile.TemporaryDirectory() as d:
        ck = AsyncCheckpointer(d, keep_last=None)
        ck.save(1, _tree())
        ck.save(2, _tree())  # implicitly waits for save 1
        ck.wait()
        assert latest_step(d) == 2
        step, _ = restore_checkpoint(d, _tree())
        assert step == 2
        ck.directory = os.path.join(d, "a_file")
        open(ck.directory, "w").close()
        ck.save(3, _tree())
        with pytest.raises(OSError):
            ck.wait()


def test_async_save_snapshots_before_returning():
    with tempfile.TemporaryDirectory() as d:
        ck = AsyncCheckpointer(d)
        t = _tree()
        ck.save(1, t)
        t["a"].add_(100.0)          # the optimizer's next in-place step
        t["nested"]["b"].mul_(2)
        ck.wait()
        _, r = restore_checkpoint(d, t)
        assert torch.equal(r["a"], torch.arange(6.0).reshape(2, 3))
        assert torch.equal(r["nested"]["b"],
                           torch.full((4,), 1.5, dtype=torch.bfloat16))


def test_reference_checkpoints_restore_bit_for_bit(jx):
    jnp, jckpt = jx["jnp"], jx["ckpt"]
    rng = np.random.default_rng(0)
    ref_tree = {
        "w": rng.standard_normal((3, 5)).astype(np.float32),
        "layers": [{"b16": np.asarray(jnp.asarray(
            rng.standard_normal((4, 2)), jnp.bfloat16))},
            {"b16": np.asarray(jnp.asarray(
                rng.standard_normal((4, 2)), jnp.bfloat16))}],
        "q": rng.integers(-127, 128, (2, 8)).astype(np.int8),
        "step": np.asarray(5, np.int32),
    }
    like = {"w": torch.zeros(3, 5), "layers": [
        {"b16": torch.zeros(4, 2, dtype=torch.bfloat16)} for _ in range(2)],
        "q": torch.zeros(2, 8, dtype=torch.int8),
        "step": torch.zeros((), dtype=torch.int32)}
    with tempfile.TemporaryDirectory() as d:
        jckpt.save_checkpoint(d, 7, ref_tree)
        step, got = restore_checkpoint(d, like)
        assert step == 7
        for i in range(2):
            b = got["layers"][i]["b16"]
            assert b.dtype == torch.bfloat16
            assert np.array_equal(
                b.view(torch.int16).numpy().view(np.uint16),
                ref_tree["layers"][i]["b16"].view(np.uint16))
        assert np.array_equal(got["w"].numpy(), ref_tree["w"])
        assert np.array_equal(got["q"].numpy(), ref_tree["q"])
        assert int(got["step"]) == 5
        # and the other way: the port writes, the reference restores
        save_checkpoint(d, 8, got)
        step, back = jckpt.restore_checkpoint(d, ref_tree, step=8)
        assert step == 8
        for i in range(2):
            assert back["layers"][i]["b16"].dtype == jnp.bfloat16
            assert np.array_equal(
                np.asarray(back["layers"][i]["b16"]).view(np.uint16),
                ref_tree["layers"][i]["b16"].view(np.uint16))
        assert np.array_equal(np.asarray(back["w"]), ref_tree["w"])


@pytest.mark.parametrize("quantized", [False, True])
def test_train_state_roundtrips_through_the_store(quantized):
    model = build_model(get_reduced_config("dbrx-132b"), device="cpu")
    opt = adamw(1e-3, AdamWConfig(quantized_state=quantized))
    state = init_train_state(model, opt, torch.Generator().manual_seed(0))
    with torch.no_grad():
        for p in state.params.parameters():
            p.add_(0.5)
    state.step = 3
    with tempfile.TemporaryDirectory() as d:
        save_checkpoint(d, 3, state.tree())
        fresh = init_train_state(model, opt,
                                 torch.Generator().manual_seed(1))
        step, tree = restore_checkpoint(d, fresh.tree())
        back = TrainState.from_tree(tree, fresh.params)
    assert step == 3 and back.step == 3
    for name, t in state.tree().items():
        assert torch.equal(back.tree()[name], t), name
