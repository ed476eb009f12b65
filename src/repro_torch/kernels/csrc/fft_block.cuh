// One-block four-step DFT: the L-point DFT of contiguous rows, each row
// whole in one block's shared memory, stored in the four-step's scrambled
// digit order.  Planar float32.
//
// For a plan L = f1 * f2 * ... * fk and a batch row x, with X its DFT:
//
//   out[t] = X[perm(t)],   t = (c1, c2, ..., ck) in the plan's digits,
//   perm(t) = c1 + f1*c2 + f1*f2*c3 + ... + f1*...*f(k-1)*ck
//
// (c1 the most significant digit of t, base f1; ck the least, base fk).
// That is the order the TPU kernels of the JAX package's
// kernels/fourstep_fft.py leave: fourstep_fused (k = 2, (A, B):
// out[c, d] = X[c + d*A] at flat c*B + d) and multistep_fused's one-block
// mode (k stages).  The dispatch layer unscrambles with one transpose or
// permute, as it does for the reference.  The plan decides only the
// store: the DFT itself is the same for every plan of L.
//
// Design.  A block takes `rows` consecutive rows (fft_rows_per_block(L):
// two at L = 1024, one past 2048):
//
// 1. Load: one contiguous run into a planar shared buffer, 16 bytes a
//    thread where aligned, a scalar tail, as fft_rows_kernel loads.
// 2. Passes: fft_rows::run_passes with the radix plan fft_rows_plan(L) and
//    the L-point f32 table of w^t (fourstep_fft.fft_rows_twiddles), whose
//    entries are those of F_A, W, F_B and every stage's DFT and twiddle
//    plane, bit for bit: the card reads none of those planes.  The row
//    leaves in natural order; large prime factors run as dense passes.
// 3. Scrambled store: thread t writes output words 4t .. 4t+3 as one
//    float4 where aligned (a scalar tail), so the global store stays
//    coalesced, reading word e of the natural row at perm(e).  The
//    digits come from k - 1 divisions, each one multiply-high by a
//    host-computed reciprocal (Store.mul, exact for dividend and divisor
//    under 2^15, which every length that fits a block is); where the last
//    factor is a multiple of 4 the float4's four words differ in the last
//    digit alone, so one perm a float4 does (Store.quad).  A warp's
//    strided shared reads: at (32, 32) and (64, 16) the one-in-32 padding
//    puts its 32 words on 32 banks, at (16, 16, 4) on 16 banks, two words
//    each (tests/test_torch_fftblock.py counts them).
//
// Layout: fourstep_fft.fft_block_layout(L), the one reckoning of the
// working set, passed in at launch as fft_rows::Layout.  The two row
// buffers always; the table in shared memory (padded) where it fits, else
// read from global memory, where its 8*L bytes stay in L2 (tab == total
// says so); the buffers padded one word in 32 where that fits, else not
// (plane words == rows*L says so: only L in (14088, 14528]).  So one
// kernel serves every length the dense design's gates admit.  The table
// is f32, or bf16 under precision="bf16" (TW): staged, it is widened as
// it lands; in global memory, the passes widen each read.
//
// What bounds it on the H100: bytes.  512 rows of L = 1024 (the s = 4096
// plan's worker rows) move 8.4 MB, 0.0025 ms at 3.35 TB/s, against about
// 0.0004 ms of FP32 work counted as an FFT (5*L*log2(L) flops a row).
// The dense design it replaces ran 8*L*(A + B) flops a row (10.2x an
// FFT's at (32, 32)), every MAC waiting on an L1 load of its DFT entry.
// On an H100 (700 W) at that shape this kernel takes 2% more than the row
// FFT alone stored in natural order (fft_rows_kernel): the store is
// nearly free, and the passes' round trips through shared memory are
// what remains (tools/fourstep_block_ab.py).  Registers are capped at 64,
// four blocks an SM: at five (48 registers) ptxas spilled 20 bytes and
// the kernel ran 4% slower; a block of 128 threads and one row timed the
// same, one row in 256 threads 5% slower.
//
// Callers: fourstep.cu (fourstep_fused_f32: k = 2) and multistep.cu
// (multistep_block_f32: block mode) -- one kernel, two stores.

#pragma once

#include <cuda_runtime.h>

#include <cstring>
#include <type_traits>

#include "common.cuh"
#include "fft_rows.cuh"

namespace fft_block {

constexpr int kMaxDigits = 32;  // fourstep_fft.MAX_STAGES
constexpr int kThreads = fft_rows::kThreads;
constexpr int kMinBlocks = 4;
constexpr int kMaxLength = 1 << 15;  // the reciprocals' exact range

// The scrambled store's plan: the factors of L (factors of 1 dropped: a
// base-1 digit is always 0), the reciprocal of each, and each digit's
// weight in perm; row_mul splits a block's word index into (row, word).
// quad: where the last factor is a multiple of 4, the weight of the last
// digit -- the four words of a float4 then differ in that digit alone,
// so perm(e + u) = perm(e) + u * quad -- else 0.
struct Store {
  int k;
  int f[kMaxDigits];
  unsigned mul[kMaxDigits];  // ceil(2^31 / f)
  int stride[kMaxDigits];    // f1 * ... * f(i-1)
  unsigned row_mul;          // ceil(2^31 / L)
  int quad;
};

// a / d for 0 <= a, d < 2^15, mul = ceil(2^31 / d): (a * mul) >> 31.
__device__ __forceinline__ int quot(int a, unsigned mul) {
  return (int)__umulhi((unsigned)a << 1, mul);
}

// The natural word, before padding, that output word e of the block
// (row e / n) reads.
__device__ __forceinline__ int source(int e, int n, const Store& st) {
  const int row = quot(e, st.row_mul);
  int j = e - row * n;
  int p = 0;
  for (int i = st.k - 1; i > 0; --i) {  // least significant digit first
    const int q = quot(j, st.mul[i]);
    p += (j - q * st.f[i]) * st.stride[i];
    j = q;
  }
  return row * n + p + j;  // the last quotient is c1, weight 1
}

// x (n_rows, n) -> out (n_rows, n): each row's DFT, stored scrambled.
// Grid: ceil(n_rows / p.rows) blocks of kThreads.
template <class TW>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
fft_block_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                 float* __restrict__ outr, float* __restrict__ outi,
                 const TW* __restrict__ twr,
                 const TW* __restrict__ twi, long long n_rows,
                 const __grid_constant__ fft_rows::Plan p,
                 fft_rows::Layout o, const __grid_constant__ Store st) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x, nt = blockDim.x;
  const int n = p.n;
  const int plane = (int)((o.y - o.x) / 2);
  const long long row0 = (long long)blockIdx.x * p.rows;
  const int rows = (int)min((long long)p.rows, n_rows - row0);
  const int count = rows * n;
  const long long base = row0 * n;
  const fft_rows::Pad pb{plane > p.rows * n ? 5 : 31};
  const bool staged = o.total > o.tab;
  const fft_rows::Pad pt{staged ? 5 : 31};
  // f32: the table staged or read in place, one pointer; bf16: staged
  // (widened) into shared memory, or read and widened in place
  const float* tr = nullptr;
  const float* ti = nullptr;
  if (staged) {
    float* sr_ = smem + o.tab;
    float* si_ = sr_ + (o.total - o.tab) / 2;
    for (int t = tid; t < n; t += nt) {
      sr_[pt(t)] = widen(twr[t]);
      si_[pt(t)] = widen(twi[t]);
    }
    tr = sr_;
    ti = si_;
  } else if constexpr (std::is_same<TW, float>::value) {
    tr = twr;
    ti = twi;
  }
  float* sr = smem + o.x;
  float* si = sr + plane;
  float* dr = smem + o.y;
  float* di = dr + plane;
  const float* gr = xr + base;
  const float* gi = xi + base;
  int head = 0;
  if (fft_rows::aligned16(gr, gi)) {
    head = count & ~3;
    for (int t = tid; t < (count >> 2); t += nt) {
      const float4 a = reinterpret_cast<const float4*>(gr)[t];
      const float4 b = reinterpret_cast<const float4*>(gi)[t];
      const int e = 4 * t;
      sr[pb(e)] = a.x;
      sr[pb(e + 1)] = a.y;
      sr[pb(e + 2)] = a.z;
      sr[pb(e + 3)] = a.w;
      si[pb(e)] = b.x;
      si[pb(e + 1)] = b.y;
      si[pb(e + 2)] = b.z;
      si[pb(e + 3)] = b.w;
    }
  }
  for (int t = head + tid; t < count; t += nt) {
    sr[pb(t)] = gr[t];
    si[pb(t)] = gi[t];
  }
  __syncthreads();
  if constexpr (std::is_same<TW, float>::value)
    fft_rows::run_passes(sr, si, dr, di, tr, ti, p, rows, tid, nt, pb, pt);
  else if (staged)
    fft_rows::run_passes(sr, si, dr, di, tr, ti, p, rows, tid, nt, pb, pt);
  else
    fft_rows::run_passes(sr, si, dr, di, twr, twi, p, rows, tid, nt, pb, pt);
  float* hr = outr + base;
  float* hi = outi + base;
  head = 0;
  if (fft_rows::aligned16(hr, hi)) {
    head = count & ~3;
    for (int t = tid; t < (count >> 2); t += nt) {
      const int e = 4 * t;
      const int w0 = source(e, n, st);
      int a[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        a[u] = pb(st.quad ? w0 + u * st.quad
                          : u ? source(e + u, n, st) : w0);
      reinterpret_cast<float4*>(hr)[t] =
          make_float4(sr[a[0]], sr[a[1]], sr[a[2]], sr[a[3]]);
      reinterpret_cast<float4*>(hi)[t] =
          make_float4(si[a[0]], si[a[1]], si[a[2]], si[a[3]]);
    }
  }
  for (int t = head + tid; t < count; t += nt) {
    const int a = pb(source(t, n, st));
    hr[t] = sr[a];
    hi[t] = si[a];
  }
}

// Launch fft_block_kernel on `stream`: x, out (n_rows, n) planes, n the
// product of the k factors (the store's digits, f1 first); tw: the (n,)
// table planes, f32 or bf16; radix: the row FFT's `passes` radices
// (product n); rows: rows a block takes; layout: the 4 words of
// fft_rows::Layout (host memory).  Returns the first CUDA error.
template <class TW>
static inline int launch(const float* xr, const float* xi, float* outr,
                         float* outi, const TW* twr, const TW* twi,
                         long long n_rows, const int* factors, int k,
                         const int* radix, int passes, int rows,
                         const long long* layout, cudaStream_t stream) {
  if (k < 1 || k > kMaxDigits || passes < 0 ||
      passes > fft_rows::kMaxPasses || rows < 1)
    return (int)cudaErrorInvalidValue;
  Store st;
  memset(&st, 0, sizeof(st));
  long long n = 1;
  for (int s = 0; s < k; ++s) {
    const int f = factors[s];
    if (f < 1 || f >= kMaxLength) return (int)cudaErrorInvalidValue;
    if (f == 1) continue;
    st.f[st.k] = f;
    st.mul[st.k] = (unsigned)(((1ULL << 31) + f - 1) / f);
    st.stride[st.k] = (int)n;
    ++st.k;
    n *= f;
  }
  long long prod = 1;
  for (int s = 0; s < passes; ++s) prod *= radix[s];
  if (prod != n || n >= kMaxLength || rows * n >= kMaxLength)
    return (int)cudaErrorInvalidValue;
  st.row_mul = (unsigned)(((1ULL << 31) + n - 1) / n);
  if (st.k > 0 && st.f[st.k - 1] % 4 == 0) st.quad = st.stride[st.k - 1];
  fft_rows::Plan p;
  memset(&p, 0, sizeof(p));
  p.n = (int)n;
  p.rows = rows;
  p.passes = passes;
  for (int s = 0; s < passes; ++s) p.radix[s] = radix[s];
  fft_rows::Layout o;
  memcpy(&o, layout, sizeof(o));
  const size_t smem = (size_t)o.total * sizeof(float);
  if (smem > kSmemDefault) {
    const cudaError_t err = cudaFuncSetAttribute(
        fft_block_kernel<TW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long blocks = (n_rows + rows - 1) / rows;
  if (blocks < 1) return 0;
  fft_block_kernel<TW><<<(unsigned)blocks, kThreads, smem, stream>>>(
      xr, xi, outr, outi, twr, twi, n_rows, p, o, st);
  return (int)cudaGetLastError();
}

}  // namespace fft_block
