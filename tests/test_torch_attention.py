"""The port's chunked attention and KV quantization against the JAX
package's (``models/attention.py``), on the same seeded numpy inputs.

Every mask variant of ``tests/test_attention.py`` -- causal at three
chunk sizes, bidirectional, sliding window, prefix-LM, MQA and GQA
grouping, KV padded to a chunk multiple, a ring cache's positions,
fully masked rows -- within the reference's 2e-5 (relative and
absolute) of the JAX result.  ``quantize_kv`` gives the same int8 values
and scales equal to f32 rounding; int8 attention (dequantized through
bf16) within the same 2e-5; ``ring_positions`` equal.

The flash backward (training): the gradients of q, k and v through the
port's ``torch.autograd.Function`` against ``jax.grad`` of the
reference's ``custom_vjp``, with ``chunk`` < S and the last chunk
padded, for causal, sliding-window (with a given ``scale``), prefix-LM,
soft-capped grouped-KV and bidirectional grouped cases, within 1e-5 of each gradient's largest
entry; the forward equal to the serving path's bit for bit; int8 K/V
refuses a gradient.
"""

import numpy as np
import pytest
import torch

from repro_torch.models import attention as tatt
from repro_torch.models.layers import softcap

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")
from repro.models import attention as jatt  # noqa: E402

TOL = 2e-5


def _qkv(b=2, sq=16, skv=16, h=4, kh=2, d=8, seed=0):
    rng = np.random.default_rng(seed)
    mk = lambda *s: rng.normal(size=s).astype(np.float32)
    return mk(b, sq, h, d), mk(b, skv, kh, d), mk(b, skv, kh, d)


def _both(q, k, v, **kw):
    """(port, JAX) outputs of chunked attention on the same inputs;
    position vectors and ``prefix_len`` given as numpy / int."""
    tkw, jkw = dict(kw), dict(kw)
    for name in ("q_positions", "kv_positions"):
        if name in kw:
            tkw[name] = torch.as_tensor(kw[name])
            jkw[name] = jnp.asarray(kw[name])
    if kw.get("prefix_len") is not None:
        jkw["prefix_len"] = jnp.asarray(kw["prefix_len"])
    got = tatt.chunked_attention(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), **tkw)
    want = jatt.chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), **jkw)
    return got.numpy(), np.asarray(want)


CASES = {
    "causal_chunk4": ({}, {"causal": True, "chunk": 4}),
    "causal_chunk8": ({}, {"causal": True, "chunk": 8}),
    "causal_chunk16": ({}, {"causal": True, "chunk": 16}),
    "bidirectional": ({"seed": 1}, {"causal": False, "chunk": 8}),
    "sliding_window": ({"sq": 32, "skv": 32, "seed": 2},
                       {"causal": True, "window": 8, "chunk": 8}),
    "prefix_lm": ({"sq": 24, "skv": 24, "seed": 3},
                  {"causal": True, "prefix_len": 8, "chunk": 8}),
    "mqa": ({"h": 8, "kh": 1, "seed": 4}, {"chunk": 8}),
    "gqa": ({"h": 8, "kh": 2, "seed": 11}, {"chunk": 8}),
    "pad_to_chunk": ({"sq": 10, "skv": 10, "seed": 5}, {"chunk": 4}),
    "softcap": ({"seed": 12}, {"chunk": 8, "logit_cap": 1.5}),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_chunked_attention_matches_jax(name):
    shape, kw = CASES[name]
    got, want = _both(*_qkv(**shape), **kw)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_decode_positions_match_jax():
    """One query at an explicit position against the whole KV (the
    decode form), with and without a prefix."""
    q, k, v = _qkv(b=2, sq=12, skv=12, seed=6)
    for prefix in (None, 5):
        got, want = _both(q[:, -1:], k, v, causal=True, chunk=4,
                          q_positions=np.asarray([7]), prefix_len=prefix)
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_ring_cache_matches_jax():
    """A windowed ring cache read through ``ring_positions``."""
    b, h, kh, d, w, t = 1, 2, 1, 8, 4, 7
    rng = np.random.default_rng(7)
    kring = rng.normal(size=(b, w, kh, d)).astype(np.float32)
    vring = rng.normal(size=(b, w, kh, d)).astype(np.float32)
    q = rng.normal(size=(b, 1, h, d)).astype(np.float32)
    pos = tatt.ring_positions(t, w).numpy()
    got, want = _both(q, kring, vring, causal=True, window=w, chunk=4,
                      q_positions=np.asarray([t - 1]), kv_positions=pos)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_fully_masked_rows_give_zero():
    q, k, v = _qkv(sq=4, skv=8, seed=10)
    got, want = _both(q, k, v, causal=True, chunk=4,
                      q_positions=np.asarray([-1, -1, -1, -1]))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, 0.0, atol=1e-6)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("step,window", [(0, 4), (6, 4), (9, 5), (3, 8)])
def test_ring_positions_equal(step, window):
    want = np.asarray(jatt.ring_positions(jnp.asarray(step), window))
    np.testing.assert_array_equal(tatt.ring_positions(step, window).numpy(),
                                  want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_matches_jax(dtype):
    rng = np.random.default_rng(8)
    x = rng.normal(size=(2, 16, 2, 32)).astype(np.float32)
    x[0, 3, 1] = 0.0                       # an all-zero row: the 1e-6 floor
    jx = jnp.asarray(x, dtype)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
        getattr(torch, dtype))
    got, want = tatt.quantize_kv(tx), jatt.quantize_kv(jx)
    assert got.q.dtype == torch.int8 and got.scale.dtype == torch.float32
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    np.testing.assert_allclose(got.scale.numpy(), np.asarray(want.scale),
                               rtol=2 ** -23, atol=0)
    for out in ("float32", "bfloat16"):
        back = tatt.dequantize_kv(got, getattr(torch, out)).float().numpy()
        jback = np.asarray(jatt.dequantize_kv(want, getattr(jnp, out))
                           .astype(jnp.float32))
        np.testing.assert_allclose(back, jback, rtol=TOL, atol=TOL)


def test_int8_attention_matches_jax():
    """Attention over int8 K/V (each chunk dequantized through bf16)."""
    q, k, v = _qkv(sq=8, skv=32, seed=9)
    tq = {n: tatt.quantize_kv(torch.from_numpy(a)) for n, a in
          (("k", k), ("v", v))}
    jq = {n: jatt.quantize_kv(jnp.asarray(a)) for n, a in (("k", k), ("v", v))}
    got = tatt.chunked_attention(torch.from_numpy(q), tq["k"], tq["v"],
                                 causal=False, chunk=8,
                                 kv_positions=torch.arange(32))
    want = jatt.chunked_attention(jnp.asarray(q), jq["k"], jq["v"],
                                  causal=False, chunk=8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    full = tatt.chunked_attention(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), causal=False, chunk=8)
    assert float((got - full).abs().max()) < 0.05


def test_grouping_maps_query_heads_to_kv_heads():
    """Head h reads KV head h // G: with KV head 1's values set apart,
    only query heads G..2G-1 see them."""
    q, k, v = _qkv(h=4, kh=2, seed=13)
    v = v.copy()
    v[:, :, 1] = 100.0
    out = tatt.chunked_attention(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), chunk=8).numpy()
    assert np.all(np.abs(out[:, :, :2]) < 10)
    np.testing.assert_allclose(out[:, :, 2:], 100.0, rtol=1e-5)


def test_softcap_matches_jax():
    x = np.linspace(-20, 20, 41, dtype=np.float32)
    from repro.models.layers import softcap as jsoftcap
    np.testing.assert_allclose(softcap(torch.from_numpy(x), 5.0).numpy(),
                               np.asarray(jsoftcap(jnp.asarray(x), 5.0)),
                               rtol=1e-6, atol=1e-6)
    tx = torch.from_numpy(x)
    assert softcap(tx, None) is tx


# -- the flash backward (training) -------------------------------------------
FLASH_CASES = {
    "causal": dict(h=4, kh=4),
    "window_scale": dict(h=4, kh=4, window=5, scale=0.3),
    "prefix": dict(h=4, kh=4, prefix_len=6),
    "grouped_cap": dict(h=4, kh=1, logit_cap=3.0),
    "bidirectional": dict(h=4, kh=2, causal=False),
}


@pytest.mark.parametrize("case", list(FLASH_CASES))
def test_flash_backward_matches_jax(case):
    kw = dict(FLASH_CASES[case])
    h, kh = kw.pop("h"), kw.pop("kh")
    rng = np.random.default_rng(7)
    b, s, d, chunk = 2, 13, 8, 4            # 4 chunks, the last padded
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    k = rng.standard_normal((b, s, kh, d)).astype(np.float32)
    v = rng.standard_normal((b, s, kh, d)).astype(np.float32)
    dout = rng.standard_normal((b, s, h, d)).astype(np.float32)

    def jf(qq, kk, vv):
        out = jatt.chunked_attention(qq, kk, vv, chunk=chunk, **kw)
        return jnp.sum(out * dout)

    want = jax.grad(jf, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    out = tatt.chunked_attention(tq, tk, tv, chunk=chunk, **kw)
    got = torch.autograd.grad((out * torch.from_numpy(dout)).sum(),
                              [tq, tk, tv])
    for name, g, w in zip("qkv", got, want):
        w = np.asarray(w)
        assert np.abs(g.numpy() - w).max() <= 1e-5 * np.abs(w).max(), name
    with torch.no_grad():      # the forward is the serving path's
        plain = tatt.chunked_attention(tq, tk, tv, chunk=chunk, **kw)
    assert torch.equal(plain, out.detach())


def test_int8_kv_refuses_a_gradient():
    q = torch.randn(1, 4, 2, 8, requires_grad=True)
    kv = tatt.quantize_kv(torch.randn(1, 4, 2, 8))
    with pytest.raises(ValueError, match="decode-only"):
        tatt.chunked_attention(q, kv, kv)
    with torch.no_grad():
        assert tatt.chunked_attention(q, kv, kv).shape == (1, 4, 2, 8)
