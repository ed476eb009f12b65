"""Coded and compressed gradient aggregation against the JAX package.

* ``coded_weights`` bit for bit; ``CyclicGradientCode``'s messages and
  its decode from every (N - s)-subset against the reference's, which
  computes in f64 under the tests' x64 (its numpy weights promote the
  product) where the port computes in f32, the reference's production
  dtype: each decode within a bound relative to its largest magnitude
  set per code -- 1e-6 for (4, 0) and (5, 1), 1e-5 for (6, 2), 1e-4 for
  (8, 3), the f32 emulation's errors (5.8e-8 to 1.2e-5) with headroom,
  since the decode weights grow fast with s; the cyclic supports and
  thresholds; the refusals, with the reference's texts.
* ``compress``/``decompress`` bit for bit, the error-feedback bound,
  ``compression_ratio``.
* ``compressed_psum`` in a spawned 4-rank ``gloo`` world
  (``torch_mesh_worker.py grad``): every rank's mean bit-equal, within
  1e-6 of JAX's decompress-then-mean of the same four codes, each rank's
  residual JAX's bit for bit, the int8 code and the scales on the wire;
  in a world of one against the reference's ``compressed_psum`` under
  ``shard_map`` on a one-device mesh.  The same world places reduced
  gemma-2b's training state by its sharding plan on a (data 2, model 2)
  mesh and gathers it back bit for bit.
"""

import itertools
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch_mesh_worker import GRAD_SHAPE, GRAD_STEPS, grad_inputs, \
    world_of_one

from repro_torch.optim import (
    CyclicGradientCode,
    coded_weights,
    compress,
    compressed_psum,
    compression_ratio,
    decompress,
    init_residual,
)
from repro_torch.optim import compression

TESTS = Path(__file__).resolve().parent
SRC = TESTS.parent / "src"
CODES = {(4, 0): 1e-6, (5, 1): 1e-6, (6, 2): 1e-5, (8, 3): 1e-4}


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    """A 4-rank world running the grad cases while the JAX side computes;
    collected by :func:`ranks4`."""
    outdir = tmp_path_factory.mktemp("grad_world4")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(SRC), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.Popen(
        [sys.executable, str(TESTS / "torch_mesh_worker.py"), str(outdir),
         "4", "grad"], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    yield outdir, proc
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def ranks4(world4) -> list[dict]:
    outdir, proc = world4
    _, stderr = proc.communicate(timeout=600)
    errs = "".join(p.read_text() for p in sorted(outdir.glob("*.err")))
    assert proc.returncode == 0, errs + stderr[-3000:]
    return [dict(np.load(outdir / f"rank{r}.npz")) for r in range(4)]


@pytest.fixture(scope="module")
def jx(world4):
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.optim import compression as jcomp
    from repro.optim import gradient_coding as jgc

    return {"jax": jax, "jnp": jnp, "gc": jgc, "comp": jcomp}


def _grads(n, dtype=np.float32):
    """n partition gradients: nested dicts and lists of seeded arrays."""
    rng = np.random.default_rng(n)
    return [{"layer": [{"w": rng.standard_normal((3, 5)).astype(dtype)},
                       {"w": rng.standard_normal((4,)).astype(dtype)}],
             "embed": rng.standard_normal((6, 2)).astype(dtype)}
            for _ in range(n)]


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield np.asarray(tree)


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_torch(v) for v in tree]
    return torch.from_numpy(tree)


def _rel(got, want) -> float:
    got = np.concatenate([a.ravel() for a in _leaves(got)]).astype(np.float64)
    want = np.concatenate([a.ravel() for a in _leaves(want)]).astype(
        np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


# --------------------------------------------------------------------------
# gradient coding
# --------------------------------------------------------------------------
@pytest.mark.parametrize("n,s", list(CODES))
def test_coded_weights_bit_equal(jx, n, s):
    got, want = coded_weights(n, s), jx["gc"].coded_weights(n, s)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    code = CyclicGradientCode(n, s)
    assert code.matrix is code.matrix           # cached on the instance
    assert np.array_equal(code.matrix, want)


@pytest.mark.parametrize("n,s", list(CODES))
def test_encode_decode_every_subset(jx, n, s):
    jnp = jx["jnp"]
    grads = _grads(n)
    code = CyclicGradientCode(n, s)
    jcode = jx["gc"].CyclicGradientCode(n_workers=n, n_stragglers=s)
    jgrads = jx["jax"].tree.map(jnp.asarray, grads)
    msgs = [code.encode_worker_grad(k, _to_torch(grads)) for k in range(n)]
    jmsgs = [jcode.encode_worker_grad(k, jgrads) for k in range(n)]
    for m, jm in zip(msgs, jmsgs):
        assert all(a.dtype == np.float32 for a in _leaves(
            jx["jax"].tree.map(lambda t: t.numpy(), m)))
        assert _rel(jx["jax"].tree.map(lambda t: t.numpy(), m), jm) \
            < CODES[n, s]
    total = [sum(a) for a in zip(*(list(_leaves(g)) for g in grads))]
    worst = 0.0
    for subset in itertools.combinations(range(n), n - s):
        sub = np.asarray(subset)
        assert np.array_equal(code.decode_vector(sub),
                              jcode.decode_vector(sub))
        dec = code.decode(sub, [msgs[i] for i in subset])
        jdec = jcode.decode(sub, [jmsgs[i] for i in subset])
        got = jx["jax"].tree.map(lambda t: t.numpy(), dec)
        worst = max(worst, _rel(got, jdec))
        assert _rel(got, total) < CODES[n, s] + 1e-6
    assert worst < CODES[n, s], worst


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_encode_returns_f32(dtype):
    code = CyclicGradientCode(5, 1)
    grads = [{"w": torch.full((3,), float(i + 1), dtype=dtype)}
             for i in range(5)]
    msg = code.encode_worker_grad(2, grads)
    assert msg["w"].dtype == torch.float32
    dec = code.decode(np.arange(4), [code.encode_worker_grad(k, grads)
                                     for k in range(4)])
    assert dec["w"].dtype == torch.float32
    np.testing.assert_allclose(dec["w"].numpy(), 15.0, rtol=1e-5)


def test_cyclic_support_and_threshold(jx):
    for n, s in [(6, 2), (5, 1), (4, 0), (8, 3)]:
        code = CyclicGradientCode(n_workers=n, n_stragglers=s)
        jcode = jx["gc"].CyclicGradientCode(n_workers=n, n_stragglers=s)
        assert code.recovery_threshold == jcode.recovery_threshold == n - s
        for k in range(n):
            assert code.worker_partitions(k) == jcode.worker_partitions(k)
    code = CyclicGradientCode(n_workers=6, n_stragglers=2)
    assert code.worker_partitions(5) == [5, 0, 1]
    assert code.recovery_threshold == 4
    for bad in [(3, 3), (3, -1)]:
        with pytest.raises(ValueError, match="need 0 <= s < N"):
            CyclicGradientCode(*bad)


@pytest.mark.parametrize("subset", [(0, 1), (0, 0, 1)])
def test_undecodable_subset_raises_like_reference(jx, subset):
    """Two workers of (4, 1): a residual; a repeated worker: rank
    deficient, the exact check.  The texts are the reference's."""
    sub = np.asarray(subset)
    with pytest.raises(np.linalg.LinAlgError) as err:
        CyclicGradientCode(4, 1).decode_vector(sub)
    with pytest.raises(np.linalg.LinAlgError) as jerr:
        jx["gc"].CyclicGradientCode(4, 1).decode_vector(sub)
    assert str(err.value) == str(jerr.value)
    assert "not decodable" in str(err.value)


# --------------------------------------------------------------------------
# compression
# --------------------------------------------------------------------------
@pytest.mark.parametrize("shape,dtype", [((1000,), np.float32),
                                         ((3, 300), np.float32),
                                         ((512,), np.float32),
                                         ((7, 129), "bfloat16")])
def test_compress_bit_equal(jx, shape, dtype):
    jnp = jx["jnp"]
    rng = np.random.default_rng(3)
    g = rng.standard_normal(shape).astype(np.float32)
    g.reshape(-1)[:256] = 0.0                   # a zero block: safe divide
    res = (rng.standard_normal(shape) * 1e-3).astype(np.float32)
    res.reshape(-1)[:256] = 0.0
    tg = torch.from_numpy(g)
    jg = jnp.asarray(g)
    if dtype == "bfloat16":
        tg, jg = tg.to(torch.bfloat16), jg.astype(jnp.bfloat16)
    code, new_res = compress(tg, torch.from_numpy(res))
    jcode, jnew = jx["comp"].compress(jg, jnp.asarray(res))
    assert code.q.dtype == torch.int8 and code.scale.dtype == torch.float32
    assert np.array_equal(code.q.numpy(), np.asarray(jcode.q))
    assert np.array_equal(code.scale.numpy(), np.asarray(jcode.scale))
    assert np.array_equal(new_res.numpy(), np.asarray(jnew))
    assert np.array_equal(decompress(code, shape).numpy(),
                          np.asarray(jx["comp"].decompress(jcode, shape)))
    assert init_residual(tg).dtype == torch.float32


def test_error_feedback_bound_and_ratio(jx):
    """The reference's test: the accumulated error stays within one
    step's quantization error; and the same sums as JAX's, bit for bit."""
    jnp = jx["jnp"]
    rng = np.random.default_rng(0)
    g_seq = [(rng.standard_normal(512).astype(np.float32) * np.float32(0.01))
             for _ in range(50)]
    res = init_residual(torch.from_numpy(g_seq[0]))
    jres = jx["comp"].init_residual(jnp.asarray(g_seq[0]))
    acc = torch.zeros(512)
    for g in g_seq:
        code, res = compress(torch.from_numpy(g), res)
        jcode, jres = jx["comp"].compress(jnp.asarray(g), jres)
        acc = acc + decompress(code, (512,))
        assert np.array_equal(code.q.numpy(), np.asarray(jcode.q))
    assert np.array_equal(res.numpy(), np.asarray(jres))
    acc_true = torch.from_numpy(np.sum(g_seq, axis=0))
    assert float((acc + res - acc_true).abs().max()) < 1e-4
    for shape in [(512,), (1000,), (2048, 16384), (3, 7)]:
        for dt, jdt in ((torch.float32, jnp.float32),
                        (torch.bfloat16, jnp.bfloat16)):
            assert compression_ratio(shape, dt) == \
                jx["comp"].compression_ratio(shape, jdt)
    assert round(compression_ratio((1024,)), 2) == 3.94
    assert round(compression_ratio((1024,), torch.bfloat16), 2) == 1.97


def test_compressed_psum_four_ranks(jx, ranks4):
    """Every rank's mean bit-equal and within 1e-6 of JAX's
    decompress-then-mean of the four ranks' codes; each rank's residual
    JAX's; an int8 code and f32 scales on the wire."""
    jnp, jc = jx["jnp"], jx["comp"]
    g = grad_inputs(4)
    jres = [jc.init_residual(jnp.asarray(g[0, r])) for r in range(4)]
    want_means, want_res = [], []
    for t in range(GRAD_STEPS):
        codes = []
        for r in range(4):
            code, jres[r] = jc.compress(jnp.asarray(g[t, r]), jres[r])
            codes.append(code)
        want_means.append(np.asarray(sum(jc.decompress(c, GRAD_SHAPE)
                                         for c in codes) / 4))
        want_res.append([np.asarray(x) for x in jres])
    ranks = ranks4
    for t in range(GRAD_STEPS):
        mean = ranks[0][f"psum_mean_{t}"]
        assert mean.shape == GRAD_SHAPE and mean.dtype == np.float32
        for r in range(4):
            assert np.array_equal(ranks[r][f"psum_mean_{t}"], mean)
            assert np.array_equal(ranks[r][f"psum_res_{t}"], want_res[t][r])
        err = np.abs(mean - want_means[t]).max() / np.abs(want_means[t]).max()
        assert err < 1e-6, (t, err)
    # over the (2, 2) mesh's "data" dimension: ranks r and r ^ 2
    for r in range(4):
        pair = sorted({r, r ^ 2})
        want = sum(jc.decompress(jc.compress(
            jnp.asarray(g[0, q]), jc.init_residual(jnp.asarray(g[0, q])))[0],
            GRAD_SHAPE) for q in pair) / 2
        got = ranks[r]["psum_data_mean"]
        assert np.array_equal(got, ranks[r ^ 2]["psum_data_mean"])
        assert np.abs(got - want).max() / np.abs(want).max() < 1e-6
        assert ranks[r]["psum_data_coll"].tolist() == [2, 2]
    nblocks = -(-int(np.prod(GRAD_SHAPE)) // 256)
    assert ranks[0]["psum_coll"].tolist() == [
        [4, nblocks * 256, 4 * nblocks * 256], [4, nblocks * 4,
                                                4 * nblocks * 4]]


def test_compressed_psum_world_of_one(jx, tmp_path):
    jax, jnp, jc = jx["jax"], jx["jnp"], jx["comp"]
    from jax.sharding import PartitionSpec as P

    from repro.distributed import test_mesh as jtest_mesh

    try:
        from jax import shard_map
    except ImportError:                          # older jax
        from jax.experimental.shard_map import shard_map
    g = grad_inputs(1)[:, 0]
    mesh = jtest_mesh((1,), ("dp",))
    fn = jax.jit(shard_map(lambda a, b: jc.compressed_psum(a, b, "dp"),
                           mesh=mesh, in_specs=(P(), P()),
                           out_specs=(P(), P())))
    with world_of_one(tmp_path / "rendezvous"):
        res = init_residual(torch.from_numpy(g[0]))
        for t in range(GRAD_STEPS):
            # both sides from the port's residual: compiled, XLA fuses
            # the new residual's product and difference (one rounding,
            # where the port and the reference's eager ops round twice)
            jmean, jres = fn(jnp.asarray(g[t]), jnp.asarray(res.numpy()))
            mean, res = compressed_psum(torch.from_numpy(g[t]), res)
            assert np.array_equal(mean.numpy(), np.asarray(jmean))
            assert np.abs(res.numpy() - np.asarray(jres)).max() <= \
                np.finfo(np.float32).eps * np.abs(g[t]).max()
        assert [c["group_size"] for c in compression.last_collectives] \
            == [1, 1]


# --------------------------------------------------------------------------
# the sharding plan on ranks
# --------------------------------------------------------------------------
def test_plan_placement_four_ranks(ranks4):
    """Reduced gemma-2b's exact-AdamW state on (data 2, model 2): every
    rank's shards the plan's shapes, every tensor gathered back bit for
    bit."""
    for r, out in enumerate(ranks4):
        assert out["plan_fallbacks"].tolist() == [
            "kv_heads: n_kv_heads=1 % 2 != 0 -> replicated",
            "p_kv: n_kv_heads=1 % 2 != 0 -> replicated"]
        assert out["plan_wrong_shape"].size == 0, (r, out["plan_wrong_shape"])
        assert out["plan_unequal"].size == 0, (r, out["plan_unequal"])
        local, want, n = out["plan_bytes"].tolist()
        assert local == want and n > 0
