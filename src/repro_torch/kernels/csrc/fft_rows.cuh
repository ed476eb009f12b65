// Batched B-point DFT of contiguous rows: a mixed-radix Stockham FFT in
// shared memory, on planar float32.
//
//   out[row, k] = sum_j x[row, j] * w^(j*k),   w = exp(-2*pi*i/B)
//
// in natural order: exactly the row pass T @ F_B of the four-step, for the
// dense DFT matrix F_B[j][k] = w^((j*k) mod B) the plane tables hold.
//
// Stockham autosort.  A pass of radix R over a row of B = R * m points,
// with ns the product of the radices before it, takes butterfly j < m:
//
//   v[r]  = src[j + r*m] * w^(r * (j mod ns) * B/(ns*R))     r < R
//   y[c]  = sum_r v[r] * w^(((r*c) mod R) * m)               c < R
//   dst[(j - j mod ns)*R + j mod ns + c*ns] = y[c]
//
// and after the last pass the row is in natural order, with no
// bit-reversal.  Radices 2, 4 and 8 run as butterflies with the exact
// constants +-1 and +-i (w^m and w^(3m) for radix 8 from the table);
// 3, 5 and 7 as unrolled R-point products in registers, their R-1
// constants read from the table once a pass; any other factor p (a large
// prime: B = 4093 runs one pass of 4093) as a dense pass over shared
// memory: the same pre-twiddle, in place, then one thread per output pair
// (h, p - h) of a butterfly, each term one table entry w^((r*h mod p)*m)
// and its conjugate.  Every twiddle is thus an entry of one f32 table of
// w^t, t < B (built in float64 from the integer-reduced angle, as the
// plane tables are), indexed by an exponent reduced mod B -- bit for bit
// an entry of F_B -- or, in a dense pass, that entry's conjugate.  The
// table sits in shared memory, staged once a block.  Under
// precision="bf16" the kernel takes the bf16 table (TW = __nv_bfloat16,
// each entry that of the bf16 plane, bit for bit) and widens it to f32 as
// it stages it; the passes read f32 from shared memory as before.  They
// also take a table in global memory of either type (fft_block.cuh's
// longest rows), widening each read.
//
// Layout.  A block takes `rows` consecutive rows (ceil(2048 / B), at
// least one): the rows are contiguous in memory, so the block's load and
// store are one contiguous run, 16 bytes a thread where the addresses
// allow.  Between passes the rows ping-pong between two planar buffers,
// padded one word in 32 (pad(a) = a + a/32) so the strided butterfly
// stores of the early passes do not conflict on the banks.  The radix
// plan (fourstep_fft.fft_rows_plan) and the word offsets of the shared
// arrays (fourstep_fft.fft_rows_layout, the one reckoning of the working
// set) are computed in Python and passed in at launch.  The table is
// padded the same way: a dense pass reads it at stride r across a warp.
//
// What bounds it on the H100: bytes.  An FFT needs 5*B*log2(B) flops a
// row, far under its traffic (16 bytes a point, read once and written
// once): the dense passes of large prime factors are the exception, and
// only such lengths pay operations past the bytes.
//
// Callers: fourstep.cu (fourstep_stage2_f32, the two-pass row pass),
// coded_bucket_streaming.cu (the row pass) and encode_fourstep.cu (the
// row pass past the fold; the folded encode runs run_passes on its own
// block of rows and applies G as it stores).  fft_block.cuh runs
// run_passes over whole four-step rows and stores them scrambled; its
// layout chooses per length whether the buffers are padded and the table
// staged, so the passes take their padding maps as template arguments
// (Pad32, the constant map, by default).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <cstring>

#include "common.cuh"

namespace fft_rows {

// passes a plan holds: a B that fits a block has at most 8
constexpr int kMaxPasses = 16;
constexpr int kThreads = 256;
// Registers capped for six blocks an SM (40 a thread): a 2048-point
// block's 38 KB of shared memory then lets five run at once, where the
// 64 registers the kernel takes uncapped let four -- more rows in flight
// for the loads of a bytes-bound kernel
constexpr int kMinBlocks = 6;

struct Plan {
  int n;     // row length B
  int rows;  // rows a block takes
  int passes;
  int radix[kMaxPasses];
};

// Word offsets of the shared arrays, then the total, in this order; the
// caller computes them (fourstep_fft.fft_rows_layout): the two planar row
// buffers, then the table's two planes, every plane padded.
struct Layout {
  long long x, y, tab, total;
};

__device__ __forceinline__ int pad(int a) { return a + (a >> 5); }

// pad() as the passes take it: Pad32, the default, pads one word in 32;
// Pad{shift} is the same map with the shift chosen at run time (31 pads
// nothing, for the non-negative indices the passes form), for a kernel
// whose layout decides per length what it pads (fft_block.cuh).
struct Pad32 {
  __device__ __forceinline__ int operator()(int a) const { return pad(a); }
};
struct Pad {
  int shift;
  __device__ __forceinline__ int operator()(int a) const {
    return a + (a >> shift);
  }
};

// (r, i) = a * b on planar complex scalars.
__device__ __forceinline__ void cmul(float& r, float& i, float ar, float ai,
                                     float br, float bi) {
  r = ar * br - ai * bi;
  i = ar * bi + ai * br;
}

// In-place R-point DFT of (vr, vi) for R in 2, 4, 8, or any R through the
// constants cw^q = w^(q*m) (q < R), read from the table.
template <int R>
__device__ __forceinline__ void butterfly(float* vr, float* vi,
                                          const float* cwr,
                                          const float* cwi) {
  if constexpr (R == 2) {
    const float ar = vr[0], ai = vi[0];
    vr[0] = ar + vr[1];
    vi[0] = ai + vi[1];
    vr[1] = ar - vr[1];
    vi[1] = ai - vi[1];
  } else if constexpr (R == 4) {
    const float s0r = vr[0] + vr[2], s0i = vi[0] + vi[2];
    const float d0r = vr[0] - vr[2], d0i = vi[0] - vi[2];
    const float s1r = vr[1] + vr[3], s1i = vi[1] + vi[3];
    const float d1r = vr[1] - vr[3], d1i = vi[1] - vi[3];
    vr[0] = s0r + s1r;
    vi[0] = s0i + s1i;
    vr[2] = s0r - s1r;
    vi[2] = s0i - s1i;
    // y1 = d0 - i*d1, y3 = d0 + i*d1
    vr[1] = d0r + d1i;
    vi[1] = d0i - d1r;
    vr[3] = d0r - d1i;
    vi[3] = d0i + d1r;
  } else if constexpr (R == 8) {
    float er[4] = {vr[0], vr[2], vr[4], vr[6]};
    float ei[4] = {vi[0], vi[2], vi[4], vi[6]};
    float orr[4] = {vr[1], vr[3], vr[5], vr[7]};
    float oi[4] = {vi[1], vi[3], vi[5], vi[7]};
    butterfly<4>(er, ei, cwr, cwi);
    butterfly<4>(orr, oi, cwr, cwi);
    // o[k] *= w8^k: 1, w8 (table), -i, w8^3 (table)
    float tr, ti;
    cmul(tr, ti, orr[1], oi[1], cwr[1], cwi[1]);
    orr[1] = tr;
    oi[1] = ti;
    tr = oi[2];
    oi[2] = -orr[2];
    orr[2] = tr;
    cmul(tr, ti, orr[3], oi[3], cwr[3], cwi[3]);
    orr[3] = tr;
    oi[3] = ti;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      vr[k] = er[k] + orr[k];
      vi[k] = ei[k] + oi[k];
      vr[k + 4] = er[k] - orr[k];
      vi[k + 4] = ei[k] - oi[k];
    }
  } else {
    float yr[R], yi[R];
#pragma unroll
    for (int c = 0; c < R; ++c) {
      yr[c] = vr[0];
      yi[c] = vi[0];
#pragma unroll
      for (int r = 1; r < R; ++r)
        cmac(yr[c], yi[c], vr[r], vi[r], cwr[(r * c) % R], cwi[(r * c) % R]);
    }
#pragma unroll
    for (int c = 0; c < R; ++c) {
      vr[c] = yr[c];
      vi[c] = yi[c];
    }
  }
}

// One pass of radix R (unrolled) over `rows` rows of n points; pb pads
// the buffers' indices, pt the table's; TT the table's element type.
template <int R, class PB = Pad32, class PT = Pad32, class TT = float>
__device__ void pass_radix(const float* sr, const float* si, float* dr,
                           float* di, const TT* tr, const TT* ti, int n,
                           int ns, int rows, int tid, int nt, PB pb = PB(),
                           PT pt = PT()) {
  const int m = n / R;
  const int unit = n / (ns * R);  // twiddle exponent step of r * (j mod ns)
  float cwr[R], cwi[R];
#pragma unroll
  for (int q = 0; q < R; ++q) {
    cwr[q] = widen(tr[pt(q * m)]);
    cwi[q] = widen(ti[pt(q * m)]);
  }
  for (int bf = tid; bf < rows * m; bf += nt) {
    const int row = bf / m, j = bf - row * m;
    const int k = j % ns;
    const int rb = row * n;
    float vr[R], vi[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int a = pb(rb + j + r * m);
      vr[r] = sr[a];
      vi[r] = si[a];
    }
    if (k != 0) {
#pragma unroll
      for (int r = 1; r < R; ++r) {
        const int e = pt(k * r * unit);
        float xr, xi;
        cmul(xr, xi, vr[r], vi[r], widen(tr[e]), widen(ti[e]));
        vr[r] = xr;
        vi[r] = xi;
      }
    }
    butterfly<R>(vr, vi, cwr, cwi);
    const int o = rb + (j - k) * R + k;
#pragma unroll
    for (int c = 0; c < R; ++c) {
      const int a = pb(o + c * ns);
      dr[a] = vr[c];
      di[a] = vi[c];
    }
  }
}

// One dense pass of any radix p (a prime past the unrolled ones): the
// radix pass's pre-twiddle, in place over src, then the p-point DFT of
// each butterfly with one thread per output pair (h, p - h), whose terms
// share one table entry: y[h] takes w^((r*h mod p)*m), y[p - h] its
// conjugate.  Half the table reads of one thread per output.  pb, pt as
// in pass_radix.
template <class PB = Pad32, class PT = Pad32, class TT = float>
__device__ void pass_dense(float* sr, float* si, float* dr, float* di,
                           const TT* tr, const TT* ti, int n, int ns, int p,
                           int rows, int tid, int nt, PB pb = PB(),
                           PT pt = PT()) {
  const int m = n / p;
  const int unit = n / (ns * p);
  if (ns > 1) {
    for (int w = tid; w < rows * n; w += nt) {  // w = row*n + r*m + j
      const int rem = w % n;
      const int r = rem / m, j = rem - r * m;
      const int e = pt(r * (j % ns) * unit);
      if (e != 0) {
        const int a = pb(w);
        float xr, xi;
        cmul(xr, xi, sr[a], si[a], widen(tr[e]), widen(ti[e]));
        sr[a] = xr;
        si[a] = xi;
      }
    }
    __syncthreads();
  }
  const int half = p / 2 + 1;  // h = 0, and the pairs (h, p - h)
  for (int w = tid; w < rows * m * half; w += nt) {
    const int row = w / (m * half), rem = w - row * m * half;
    const int h = rem / m, j = rem - h * m;
    const int k = j % ns;
    const int rb = row * n;
    const int step = h * m;
    float ar = 0.f, ai = 0.f, br = 0.f, bi = 0.f;
    int idx = 0;
    for (int r = 0; r < p; ++r) {
      const int a = pb(rb + j + r * m);
      const int t = pt(idx);
      const float xr = sr[a], xi = si[a];
      const float wr = widen(tr[t]), wi = widen(ti[t]);
      cmac(ar, ai, xr, xi, wr, wi);
      cmac(br, bi, xr, xi, wr, -wi);
      idx += step;
      if (idx >= n) idx -= n;
    }
    const int o = rb + (j - k) * p + k;
    dr[pb(o + h * ns)] = ar;
    di[pb(o + h * ns)] = ai;
    if (h > 0 && 2 * h != p) {
      dr[pb(o + (p - h) * ns)] = br;
      di[pb(o + (p - h) * ns)] = bi;
    }
  }
}

__device__ __forceinline__ bool aligned16(const void* a, const void* b) {
  return ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) &
          15) == 0;
}

// The plan's passes over `rows` rows of p.n points, ping-ponging between
// the buffers (s, d): on return s holds the transformed rows.  pb, pt and
// TT as in pass_radix.
template <class PB = Pad32, class PT = Pad32, class TT = float>
__device__ __forceinline__ void run_passes(float*& sr, float*& si,
                                           float*& dr, float*& di,
                                           const TT* tr, const TT* ti,
                                           const Plan& p, int rows, int tid,
                                           int nt, PB pb = PB(),
                                           PT pt = PT()) {
  const int n = p.n;
  int ns = 1;
  for (int s = 0; s < p.passes; ++s) {
    const int R = p.radix[s];
    switch (R) {
      case 2:
        pass_radix<2>(sr, si, dr, di, tr, ti, n, ns, rows, tid, nt, pb,
                      pt);
        break;
      case 3:
        pass_radix<3>(sr, si, dr, di, tr, ti, n, ns, rows, tid, nt, pb,
                      pt);
        break;
      case 4:
        pass_radix<4>(sr, si, dr, di, tr, ti, n, ns, rows, tid, nt, pb,
                      pt);
        break;
      case 5:
        pass_radix<5>(sr, si, dr, di, tr, ti, n, ns, rows, tid, nt, pb,
                      pt);
        break;
      case 7:
        pass_radix<7>(sr, si, dr, di, tr, ti, n, ns, rows, tid, nt, pb,
                      pt);
        break;
      case 8:
        pass_radix<8>(sr, si, dr, di, tr, ti, n, ns, rows, tid, nt, pb,
                      pt);
        break;
      default:
        pass_dense(sr, si, dr, di, tr, ti, n, ns, R, rows, tid, nt, pb,
                   pt);
    }
    __syncthreads();
    float* t = sr;
    sr = dr;
    dr = t;
    t = si;
    si = di;
    di = t;
    ns *= R;
  }
}

// x (n_rows, n) -> out (n_rows, n), each row's DFT; tw: the table, f32 or
// bf16.  Grid: ceil(n_rows / p.rows) blocks of kThreads.
template <class TW>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
fft_rows_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                float* __restrict__ outr, float* __restrict__ outi,
                const TW* __restrict__ twr, const TW* __restrict__ twi,
                long long n_rows, Plan p, Layout o) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x, nt = blockDim.x;
  const int n = p.n;
  const int plane = (int)((o.y - o.x) / 2);
  const long long row0 = (long long)blockIdx.x * p.rows;
  const int rows = (int)min((long long)p.rows, n_rows - row0);
  const int count = rows * n;
  const long long base = row0 * n;
  float* tr = smem + o.tab;
  float* ti = tr + (o.total - o.tab) / 2;
  for (int t = tid; t < n; t += nt) {
    tr[pad(t)] = widen(twr[t]);
    ti[pad(t)] = widen(twi[t]);
  }
  float* sr = smem + o.x;
  float* si = sr + plane;
  float* dr = smem + o.y;
  float* di = dr + plane;
  const float* gr = xr + base;
  const float* gi = xi + base;
  int head = 0;
  if (aligned16(gr, gi)) {
    head = count & ~3;
    for (int t = tid; t < (count >> 2); t += nt) {
      const float4 a = reinterpret_cast<const float4*>(gr)[t];
      const float4 b = reinterpret_cast<const float4*>(gi)[t];
      const int e = 4 * t;
      sr[pad(e)] = a.x;
      sr[pad(e + 1)] = a.y;
      sr[pad(e + 2)] = a.z;
      sr[pad(e + 3)] = a.w;
      si[pad(e)] = b.x;
      si[pad(e + 1)] = b.y;
      si[pad(e + 2)] = b.z;
      si[pad(e + 3)] = b.w;
    }
  }
  for (int t = head + tid; t < count; t += nt) {
    sr[pad(t)] = gr[t];
    si[pad(t)] = gi[t];
  }
  __syncthreads();
  run_passes(sr, si, dr, di, tr, ti, p, rows, tid, nt);
  float* hr = outr + base;
  float* hi = outi + base;
  head = 0;
  if (aligned16(hr, hi)) {
    head = count & ~3;
    for (int t = tid; t < (count >> 2); t += nt) {
      const int e = 4 * t;
      reinterpret_cast<float4*>(hr)[t] = make_float4(
          sr[pad(e)], sr[pad(e + 1)], sr[pad(e + 2)], sr[pad(e + 3)]);
      reinterpret_cast<float4*>(hi)[t] = make_float4(
          si[pad(e)], si[pad(e + 1)], si[pad(e + 2)], si[pad(e + 3)]);
    }
  }
  for (int t = head + tid; t < count; t += nt) {
    hr[t] = sr[pad(t)];
    hi[t] = si[pad(t)];
  }
}

// Launch fft_rows_kernel on `stream`: x, out (n_rows, n) planes; tw: the
// table's (n,) planes, f32 or bf16; radix: the plan's `passes` radices
// (product n); rows: rows a block takes; layout: the 4 words of Layout
// (host memory).  Returns the first CUDA error.
template <class TW>
static inline int launch(const float* xr, const float* xi, float* outr,
                         float* outi, const TW* twr, const TW* twi,
                         long long n_rows, int n, const int* radix,
                         int passes, int rows, const long long* layout,
                         cudaStream_t stream) {
  if (passes < 0 || passes > kMaxPasses || rows < 1 || n < 1)
    return (int)cudaErrorInvalidValue;
  Plan p;
  memset(&p, 0, sizeof(p));
  p.n = n;
  p.rows = rows;
  p.passes = passes;
  for (int s = 0; s < passes; ++s) p.radix[s] = radix[s];
  Layout o;
  memcpy(&o, layout, sizeof(o));
  const size_t smem = (size_t)o.total * sizeof(float);
  if (smem > kSmemDefault) {
    const cudaError_t err = cudaFuncSetAttribute(
        fft_rows_kernel<TW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long blocks = (n_rows + rows - 1) / rows;
  if (blocks < 1) return 0;
  fft_rows_kernel<TW><<<(unsigned)blocks, kThreads, smem, stream>>>(
      xr, xi, outr, outi, twr, twi, n_rows, p, o);
  return (int)cudaGetLastError();
}

}  // namespace fft_rows
