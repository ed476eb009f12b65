"""The port's WKV kernel wrapper and WKV forms against the JAX package.

CPU tests: ``kernels.wkv.wkv``, given CPU tensors, runs its plain twin
``wkv_body``; it must agree with the JAX Pallas kernel run through the
real Pallas machinery (``interpret=True``) and with the per-token scan
oracle, on the same numpy inputs, at the reference's own 2e-3
(``tests/test_wkv_kernel.py``).  The port's ``wkv_chunked`` must agree
with the JAX one at 1e-5 relative to the largest magnitude with an f32
stream (two f32 implementations of the same sums), and within 5% of it
with the bf16 stream (the reference's bf16 bound,
``tests/test_data_spectral.py``).  The model's glue around the kernel
(flattening, b-major u, zero padding to a multiple of 8) must match the
scan oracle at 1e-5 relative for any T.

A numpy-indexed model of the CUDA kernel's schedule (``_schedule_model``:
value slices, segments of chunks, the factor pre-pass, the scores a
pair at a time, the register scan's order, the batched inter-chunk
outputs with their key split) runs on the CPU at small shapes, T not a multiple
of a segment among them: 1e-5 against ``wkv_body``, the reference's 2e-3
against the Pallas kernel.

GPU tests (marker ``gpu``, skipped without a CUDA device): the CUDA
kernel against ``wkv_body`` on the card at 1e-5 relative, odd shapes
included, its launch counter and its refusals.
"""

import importlib
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.wkv import wkv, wkv_body
from repro_torch.models import rwkv6 as trwkv

PAIR_TOL = 1e-5      # two f32 implementations of the same sums
REF_TOL = 2e-3       # the reference's kernel-vs-oracle tolerance
BF16_TOL = 0.05      # the reference's bf16 bound, of the largest value
# the reference's four kernel shapes (b, h, t, k)
SHAPES = [(1, 1, 16, 8), (2, 3, 64, 16), (1, 2, 48, 32), (2, 1, 128, 64)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def jref():
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels.wkv import wkv_pallas
    from repro.models import rwkv6

    return jnp, wkv_pallas, rwkv6


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(b, h, t, kd, seed=0, decay=1.0):
    """(B, T, H, K) r, k, v, logw (clamped at -8, as the model does), u
    (H, K) and the state (B, H, K, K), float32 numpy."""
    rng = np.random.default_rng(seed)
    mk = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    r, k, v = mk(b, t, h, kd), mk(b, t, h, kd), mk(b, t, h, kd)
    logw = np.maximum(-np.abs(mk(b, t, h, kd)) * decay, -8.0)
    return r, k, v, logw.astype(np.float32), mk(h, kd), mk(b, h, kd, kd)


def _rows(x):
    """(B, T, H, K) -> (B*H, T, K), b-major (tests/test_wkv_kernel.py)."""
    b, t, h, kd = x.shape
    return np.ascontiguousarray(x.transpose(0, 2, 1, 3).reshape(b * h, t, kd))


def _planar(r, k, v, logw, u, s0):
    b, h, kd = s0.shape[0], s0.shape[1], s0.shape[2]
    return (*(_rows(x) for x in (r, k, v, logw)), np.tile(u, (b, 1)),
            s0.reshape(b * h, kd, kd))


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _port_wkv(planar):
    return [x.numpy() for x in wkv(*(torch.from_numpy(a) for a in planar))]


@pytest.mark.parametrize("oracle", ["pallas", "scan"])
@pytest.mark.parametrize("b,h,t,kd", SHAPES)
def test_wkv_twin_matches_reference(jref, b, h, t, kd, oracle):
    jnp, wkv_pallas, jrwkv = jref
    ins = _inputs(b, h, t, kd, seed=kd + t)
    planar = _planar(*ins)
    o, sf = _port_wkv(planar)
    if oracle == "pallas":
        o_ref, s_ref = wkv_pallas(*(jnp.asarray(a) for a in planar),
                                  interpret=True)
    else:
        o_bt, s_bt = jrwkv.wkv_scan_reference(*(jnp.asarray(a) for a in ins))
        o_ref, s_ref = _rows(np.asarray(o_bt)), np.asarray(s_bt).reshape(
            sf.shape)
    np.testing.assert_allclose(o, np.asarray(o_ref), rtol=REF_TOL,
                               atol=REF_TOL)
    np.testing.assert_allclose(sf, np.asarray(s_ref), rtol=REF_TOL,
                               atol=REF_TOL)


@pytest.mark.parametrize("oracle", ["pallas", "scan"])
def test_wkv_twin_strong_decay_no_nan(jref, oracle):
    """Decays far past the clamp: every factor stays finite and the
    selected scores discard the overflowing pairs."""
    jnp, wkv_pallas, jrwkv = jref
    ins = _inputs(1, 2, 32, 16, seed=7, decay=12.0)
    planar = _planar(*ins)
    o, sf = _port_wkv(planar)
    assert np.isfinite(o).all() and np.isfinite(sf).all()
    if oracle == "pallas":
        o_ref, _ = wkv_pallas(*(jnp.asarray(a) for a in planar),
                              interpret=True)
    else:
        o_ref = _rows(np.asarray(jrwkv.wkv_scan_reference(
            *(jnp.asarray(a) for a in ins))[0]))
    np.testing.assert_allclose(o, np.asarray(o_ref), rtol=REF_TOL,
                               atol=REF_TOL)


@pytest.mark.parametrize("b,h,t,kd", SHAPES)
def test_scan_reference_matches_jax(jref, b, h, t, kd):
    jnp, _, jrwkv = jref
    ins = _inputs(b, h, t, kd, seed=3 + t)
    o, s = trwkv.wkv_scan_reference(*(torch.from_numpy(a) for a in ins))
    o_ref, s_ref = jrwkv.wkv_scan_reference(*(jnp.asarray(a) for a in ins))
    assert _rel(o, o_ref) < PAIR_TOL
    assert _rel(s, s_ref) < PAIR_TOL


@pytest.mark.parametrize("stream", ["f32", "bf16"])
@pytest.mark.parametrize("b,h,t,kd,chunk", [(2, 3, 40, 16, 16),
                                            (1, 2, 24, 32, 8),
                                            (2, 1, 64, 64, 16)])
def test_wkv_chunked_matches_jax(jref, b, h, t, kd, chunk, stream):
    jnp, _, jrwkv = jref
    ins = _inputs(b, h, t, kd, seed=11 + t)
    tdt, jdt, tol = ((torch.float32, jnp.float32, PAIR_TOL) if stream == "f32"
                     else (torch.bfloat16, jnp.bfloat16, BF16_TOL))
    o, s = trwkv.wkv_chunked(*(torch.from_numpy(a) for a in ins),
                             chunk=chunk, stream_dtype=tdt)
    o_ref, s_ref = jrwkv.wkv_chunked(*(jnp.asarray(a) for a in ins),
                                     chunk=chunk, stream_dtype=jdt)
    assert o.dtype == torch.float32 and s.dtype == torch.float32
    assert _rel(o, o_ref) < tol
    assert _rel(s, s_ref) < tol


@pytest.mark.parametrize("t", [1, 5, 8, 13, 21])
def test_prefill_glue_pads_any_length(t):
    """The prefill's WKV (kernel layout, zero padding to a multiple of 8)
    against the scan oracle: padded steps change neither the kept
    outputs nor the final state."""
    ins = [torch.from_numpy(a) for a in _inputs(2, 3, t, 16, seed=t)]
    o, s = trwkv._wkv_prefill(*ins)
    o_ref, s_ref = trwkv.wkv_scan_reference(*ins)
    assert o.shape == o_ref.shape and s.shape == s_ref.shape
    assert _rel(o, o_ref) < PAIR_TOL
    assert _rel(s, s_ref) < PAIR_TOL


# -- the kernel's schedule, modelled index for index ----------------------
twkv = importlib.import_module("repro_torch.kernels.wkv")
KMAX = 64        # csrc/wkv.cu: every key loop runs to 64, zeros past K
WKV_CU = Path(twkv.__file__).resolve().parent / "csrc" / "wkv.cu"
BUILD = {name: int(re.search(rf"#define {name} (\d+)", WKV_CU.read_text())
                   .group(1)) for name in ("WKV_VB", "WKV_G", "WKV_NT")}
NT = BUILD["WKV_NT"]     # threads a block


def test_schedule_constants_match_the_source():
    assert (BUILD["WKV_VB"], BUILD["WKV_G"]) == (twkv.VALUE_BLOCK,
                                                 twkv.SEGMENT_CHUNKS)
    assert re.search(rf"constexpr int KMAX = {twkv.MAX_K};",
                     WKV_CU.read_text())


def _split_dot(a, b, lanes):
    """sum_j a[..., j] b[..., j] over KMAX keys as ``lanes`` lanes take
    them: lane q the float4 groups q, q + lanes, ...; partial sums, then
    the xor-shuffle tree."""
    kg = KMAX // 4
    part = (a * b).reshape(*a.shape[:-1], kg // lanes, lanes, 4)
    part = part.sum(-1).sum(-2)                       # (..., lanes)
    while part.shape[-1] > 1:
        h = part.shape[-1] // 2
        part = part[..., :h] + part[..., h:]
    return part[..., 0]


def _schedule_model(r, k, v, logw, u, state, vb, g):
    """csrc/wkv.cu's schedule in torch ops: the same slices, segments,
    factor planes, scores, key split and scan order."""
    bh, t, kd = r.shape
    pad = lambda x: torch.nn.functional.pad(x, (0, KMAX - kd))
    r, k, lw, u = pad(r), pad(k), pad(logw), pad(u)
    o = torch.zeros(bh, t, kd)
    s_out = torch.zeros(bh, kd, kd)
    ct, ts = twkv.CT, g * twkv.CT
    vq = vb // 4
    js = max(1, NT // (ts // 2 * vq))    # phase D: two steps a unit, keys split
    for v0 in range(0, kd, vb):
        vn = min(vb, kd - v0)
        vs = torch.zeros(bh, t, vb)
        vs[..., :vn] = v[..., v0:v0 + vn]
        st = torch.zeros(bh, KMAX, vb)
        st[:, :kd, :vn] = state[:, :, v0:v0 + vn]
        for t0 in range(0, t, ts):
            nch = min(g, (t - t0) // ct)
            rows = slice(t0, t0 + nch * ct)
            rc, kc, lc, vc = (x[:, rows].reshape(bh, nch, ct, -1)
                              for x in (r, k, lw, vs))
            # (A) the factor planes of every chunk of the segment, each a
            # product of two exponentials
            p = torch.cumsum(lc, dim=2)
            pm1 = torch.cat([torch.zeros_like(p[:, :, :1]), p[:, :, :-1]], 2)
            cc, pe = p[:, :, ct // 2:ct // 2 + 1], p[:, :, -1:]
            e_pe, e_np = torch.exp(pe), torch.exp(-p)
            rin = rc * torch.exp(pm1)
            rdc = rin * torch.exp(-cc)
            kgr, kdc = kc * (torch.exp(cc) * e_np), kc * (e_pe * e_np)
            dnd = e_pe[:, :, 0]                           # (bh, nch, KMAX)
            # (B) scores s < t, the bonus on the diagonal: a thread a pair
            sc = torch.zeros(bh, nch, ct, ct)
            for ti in range(ct):
                for si in range(ti + 1):
                    if si < ti:
                        sc[..., ti, si] = _split_dot(rdc[:, :, ti],
                                                     kgr[:, :, si], 1)
                    else:
                        sc[..., ti, si] = _split_dot(
                            rc[:, :, ti] * kc[:, :, ti], u[:, None], 1)
            # (C) the register scan: each chunk's starting state kept
            starts = []
            for c in range(nch):
                starts.append(st)
                acc = torch.zeros_like(st)
                for si in range(ct):
                    acc = acc + kdc[:, c, si, :, None] * vc[:, c, si, None]
                st = st * dnd[:, c, :, None] + acc
            # (D) every output of the segment: the key split, then intra
            sc_st = torch.stack(starts, 1)                # (bh, nch, K, vb)
            inter = _split_dot(rin[..., None, :].expand(*rin.shape[:3], vb,
                                                        KMAX),
                               sc_st[:, :, None].transpose(-1, -2), js)
            out = inter
            for si in range(ct):
                out = out + torch.where(
                    torch.arange(ct)[:, None] >= si,
                    sc[..., si, None] * vc[:, :, si, None], 0.0)
            o[:, rows, v0:v0 + vn] = out.reshape(bh, nch * ct, vb)[..., :vn]
        s_out[:, :, v0:v0 + vn] = st[:, :kd, :vn]
    return o, s_out


@pytest.mark.parametrize("vb,g", [(32, 2), (16, 2), (16, 1), (64, 2)])
@pytest.mark.parametrize("bh,t,kd,decay", [(3, 40, 16, 1.0),
                                           (2, 24, 64, 1.0),
                                           (4, 56, 48, 12.0),
                                           (1, 8, 8, 1.0)])
def test_schedule_model_matches_twin_and_pallas(jref, bh, t, kd, decay, vb,
                                                g):
    """The kernel's schedule at T not a multiple of its segment, K below
    and at the slice width: 1e-5 against ``wkv_body``, the reference's
    tolerance against the Pallas kernel in interpret mode."""
    jnp, wkv_pallas, _ = jref
    rng = np.random.default_rng(bh * 100 + t + kd)
    mk = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    lw = np.maximum(-np.abs(mk(bh, t, kd)) * decay, -8.0).astype(np.float32)
    planar = (mk(bh, t, kd), mk(bh, t, kd), mk(bh, t, kd), lw, mk(bh, kd),
              mk(bh, kd, kd))
    o, sf = _schedule_model(*(torch.from_numpy(a) for a in planar), vb, g)
    o_ref, s_ref = wkv_body(*(torch.from_numpy(a) for a in planar))
    assert torch.isfinite(o).all() and torch.isfinite(sf).all()
    assert _rel(o, o_ref) < PAIR_TOL
    assert _rel(sf, s_ref) < PAIR_TOL
    o_j, s_j = wkv_pallas(*(jnp.asarray(a) for a in planar), interpret=True)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_j), rtol=REF_TOL,
                               atol=REF_TOL)
    np.testing.assert_allclose(sf.numpy(), np.asarray(s_j), rtol=REF_TOL,
                               atol=REF_TOL)


def _refusal_args(case):
    planar = [torch.from_numpy(a) for a in _planar(*_inputs(1, 2, 16, 8))]
    if case == "t_not_multiple_of_8":
        planar[:4] = [x[:, :12] for x in planar[:4]]
    elif case == "float64":
        planar[3] = planar[3].double()
    elif case == "u_shape":
        planar[4] = planar[4][:1]
    elif case == "mismatched_rows":
        planar[1] = planar[1][:, :8]
    return planar


@pytest.mark.parametrize("case,exc", [("t_not_multiple_of_8", ValueError),
                                      ("float64", TypeError),
                                      ("u_shape", ValueError),
                                      ("mismatched_rows", ValueError)])
def test_wkv_refuses(case, exc):
    with pytest.raises(exc):
        wkv(*_refusal_args(case))


# -- on the card -----------------------------------------------------------
@pytest.mark.gpu
@pytest.mark.parametrize("bh,t,kd,decay", [(160, 512, 64, 1.0),
                                           (3, 24, 16, 1.0),
                                           (5, 8, 8, 1.0),
                                           (7, 40, 48, 1.0),
                                           (4, 64, 64, 12.0),
                                           (1, 520, 64, 1.0),
                                           (6, 72, 12, 12.0),
                                           (2, 48, 5, 1.0),
                                           (160, 504, 64, 12.0)])
def test_wkv_kernel_matches_twin(cuda, bh, t, kd, decay):
    """Odd shapes: a partial last segment (T = 24, 40, 72, 504, 520),
    K < the value slice (5, 8, 12, 16), K not a multiple of four (5),
    BH = 1, strong decay, and the model's full (160, 512, 64)."""
    rng = np.random.default_rng(bh + t)
    mk = lambda *shape: torch.as_tensor(
        rng.standard_normal(shape).astype(np.float32), device=cuda)
    r, k, v = mk(bh, t, kd), mk(bh, t, kd), mk(bh, t, kd)
    logw = torch.clamp(-mk(bh, t, kd).abs() * decay, min=-8.0)
    u, s0 = mk(bh, kd), mk(bh, kd, kd)
    o, sf = wkv(r, k, v, logw, u, s0)
    o_ref, s_ref = wkv_body(r, k, v, logw, u, s0)
    torch.cuda.synchronize()
    assert torch.isfinite(o).all() and torch.isfinite(sf).all()
    assert _rel(o.cpu(), o_ref.cpu()) < PAIR_TOL
    assert _rel(sf.cpu(), s_ref.cpu()) < PAIR_TOL


@pytest.mark.gpu
def test_wkv_kernel_counts_launches(cuda):
    args = [torch.from_numpy(a).to(cuda)
            for a in _planar(*_inputs(2, 2, 16, 16))]
    _build.reset_launch_counts()
    wkv(*args)
    wkv_body(*args)
    torch.cuda.synchronize()
    assert _build.launch_counts() == {"wkv": 1}


@pytest.mark.gpu
def test_wkv_kernel_refuses_on_card(cuda):
    args = [torch.from_numpy(a).to(cuda)
            for a in _planar(*_inputs(1, 1, 8, 72))]
    with pytest.raises(NotImplementedError, match="head-size"):
        wkv(*args)
    args = [torch.from_numpy(a).to(cuda)
            for a in _planar(*_inputs(1, 2, 16, 8))]
    args[0] = args[0].transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        wkv(*args)
