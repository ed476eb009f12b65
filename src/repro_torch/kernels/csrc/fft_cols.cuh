// Batched n-point DFT down the columns of (batch, n, ld) matrices: the
// mixed-radix Stockham FFT of fft_rows.cuh, run over a tile of columns.
//
//   Y[z][c][col] = sum_a x[z][a][col] * w^(a*c)  (* W[c][col / g]),
//   w = exp(-2*pi*i/n)
//
// the column pass (F_n @ M) * W of a four-step, with the twiddle W
// optional.  The schedule is fft_rows.cuh's, pass for pass: the same
// radix plan (fourstep_fft.fft_rows_plan(n)), the same f32 table of w^t
// (fft_rows_twiddles(n)) indexed by an exponent reduced mod n -- every
// twiddle bit for bit an entry of F_n --, radices 2, 4 and 8 as exact
// butterflies, 3, 5 and 7 unrolled, any other prime a dense pass over
// output pairs (h, p - h).  Only the addressing differs.  The table and
// the twiddle W are f32 or, under precision="bf16", bf16 (TW): the table
// is widened as it is staged, each W entry as it is read.
//
// Layout.  A block takes one tile: TC consecutive columns (TC a power of
// two) of one matrix, read at the row stride ld, so each of the n rows
// of the tile is one contiguous run of TC floats a plane (16 bytes a
// thread where the addresses allow).  In shared memory the tile is
// point-major, word (point * TC + column), padded one word in 32
// (pad(a) = a + a/32, as the row FFT pads): a butterfly's R points are
// (n/R)*TC words apart, and a block's threads spread over butterflies x
// columns, the column fastest, so a warp reads whole runs of words.  The
// two buffers ping-pong between passes; the table sits beside them.  TC
// and the word offsets come from Python (fourstep_fft.fft_cols_tile and
// fft_cols_layout, the one reckoning of the working set): TC * n points
// up to 4096 a tile, so n = 512 takes TC = 8 (32-byte runs) in 70 KB,
// and n = 4096 or a prime such as 4093 TC = 1.
//
// Epilogue.  The twiddle W (n, ld / g) multiplies the last pass's
// results as they are written, read in runs of the tile's columns.  Then
// one of two store maps:
//   transposed:     column col of the tile becomes the contiguous output
//                   row col of n points (out (batch, ld, n)): a tile's
//                   output is one contiguous run;
//   de-interleaved: column col = b*g + i goes to out[z][c][i][b]
//                   (out (batch, n, g, ld / g)); g = 1 is the plain
//                   layout of the input, TC floats a run.
//
// What bounds it on the H100: bytes, as the row FFT: 5*n*log2(n) flops a
// column against 16 bytes a point read and written once.  Its accesses
// are shorter than the row FFT's: 32-byte runs at TC = 8, which the
// loads make whole 128-byte lines of in L2 (load_line), and at TC < 8,
// only for n > 512 where the shared memory forces it, runs under a
// sector.  The twiddle adds a read as large as the tile (n * TC values a
// block), from L2, since every matrix of the batch shares W.  A prime
// n's dense pass is bound by its shared-memory reads instead.
//
// Callers: fourstep.cu (fourstep_streaming_f32, both passes, and
// fourstep_stage1_f32), coded_bucket_streaming.cu and encode_fourstep.cu
// (the column pass).

#pragma once

#include "fft_rows.cuh"

namespace fft_cols {

using fft_rows::aligned16;
using fft_rows::butterfly;
using fft_rows::cmul;
using fft_rows::pad;

constexpr int kMaxPasses = fft_rows::kMaxPasses;
constexpr int kThreads = 256;
// A 512-point tile of 8 columns takes 70 KB of shared memory: three
// blocks an SM, so registers are capped at 85 a thread
constexpr int kMinBlocks = 3;

// 16 bytes of a tile row, asking L2 to fetch the whole 128-byte line: a
// tile reads 32 bytes of each line and the neighbouring tiles' blocks,
// running at the same time, the rest, which they then find in L2
__device__ __forceinline__ float4 load_line(const float* p) {
  float4 v;
  asm volatile("ld.global.nc.L2::128B.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "l"(p));
  return v;
}

struct Plan {
  int n;   // points a column
  int lg;  // log2 of TC, the columns of a tile
  int passes;
  int radix[kMaxPasses];
};

// The epilogue: the twiddle (nullptr for none), read as W[point][(col0 +
// col) / g] at row stride wld = ld / g, on the tile's live columns only
template <class TW>
struct Twiddle {
  const TW* wr;
  const TW* wi;
  int wld, col0, g, cols;
};

template <class TW>
__device__ __forceinline__ void twiddle(float& r, float& i,
                                        const Twiddle<TW>& w, int point,
                                        int col) {
  if (w.wr == nullptr || col >= w.cols) return;
  const long long e = (long long)point * w.wld + (w.col0 + col) / w.g;
  float xr, xi;
  cmul(xr, xi, r, i, ldg_f32(w.wr + e), ldg_f32(w.wi + e));
  r = xr;
  i = xi;
}

// One pass of radix R (unrolled) over the tile's TC = 1 << lg columns of
// n points: butterfly j of column col reads points j + r*m.
template <int R, class TW>
__device__ void pass_radix(const float* sr, const float* si, float* dr,
                           float* di, const float* tr, const float* ti,
                           int n, int ns, int lg, Twiddle<TW> w, int tid,
                           int nt) {
  const int m = n / R;
  const int unit = n / (ns * R);  // twiddle exponent step of r * (j mod ns)
  const int tc = 1 << lg;
  float cwr[R], cwi[R];
#pragma unroll
  for (int q = 0; q < R; ++q) {
    cwr[q] = tr[pad(q * m)];
    cwi[q] = ti[pad(q * m)];
  }
  for (int bf = tid; bf < (m << lg); bf += nt) {
    const int j = bf >> lg, col = bf & (tc - 1);
    const int k = j % ns;
    float vr[R], vi[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int a = pad(((j + r * m) << lg) + col);
      vr[r] = sr[a];
      vi[r] = si[a];
    }
    if (k != 0) {
#pragma unroll
      for (int r = 1; r < R; ++r) {
        const int e = pad(k * r * unit);
        float xr, xi;
        cmul(xr, xi, vr[r], vi[r], tr[e], ti[e]);
        vr[r] = xr;
        vi[r] = xi;
      }
    }
    butterfly<R>(vr, vi, cwr, cwi);
    const int o = (j - k) * R + k;
#pragma unroll
    for (int c = 0; c < R; ++c) {
      twiddle(vr[c], vi[c], w, o + c * ns, col);
      const int a = pad(((o + c * ns) << lg) + col);
      dr[a] = vr[c];
      di[a] = vi[c];
    }
  }
}

// One dense pass of any radix p, as fft_rows::pass_dense: the pre-twiddle
// in place over src, then one thread per output pair (h, p - h) of a
// butterfly and column.
template <class TW>
__device__ void pass_dense(float* sr, float* si, float* dr, float* di,
                           const float* tr, const float* ti, int n, int ns,
                           int p, int lg, Twiddle<TW> w, int tid, int nt) {
  const int m = n / p;
  const int unit = n / (ns * p);
  const int tc = 1 << lg;
  if (ns > 1) {
    for (int x = tid; x < (n << lg); x += nt) {  // x = (r*m + j)*TC + col
      const int point = x >> lg;
      const int r = point / m, j = point - r * m;
      const int e = pad(r * (j % ns) * unit);
      if (e != 0) {
        const int a = pad(x);
        float xr, xi;
        cmul(xr, xi, sr[a], si[a], tr[e], ti[e]);
        sr[a] = xr;
        si[a] = xi;
      }
    }
    __syncthreads();
  }
  const int half = p / 2 + 1;  // h = 0, and the pairs (h, p - h)
  for (int x = tid; x < ((m * half) << lg); x += nt) {
    const int col = x & (tc - 1), rem = x >> lg;
    const int h = rem / m, j = rem - h * m;
    const int k = j % ns;
    const int step = h * m;
    float ar = 0.f, ai = 0.f, br = 0.f, bi = 0.f;
    int idx = 0;
    for (int r = 0; r < p; ++r) {
      const int a = pad(((j + r * m) << lg) + col);
      const int t = pad(idx);
      const float xr = sr[a], xi = si[a], wr = tr[t], wi = ti[t];
      cmac(ar, ai, xr, xi, wr, wi);
      cmac(br, bi, xr, xi, wr, -wi);
      idx += step;
      if (idx >= n) idx -= n;
    }
    const int o = (j - k) * p + k;
    twiddle(ar, ai, w, o + h * ns, col);
    dr[pad(((o + h * ns) << lg) + col)] = ar;
    di[pad(((o + h * ns) << lg) + col)] = ai;
    if (h > 0 && 2 * h != p) {
      twiddle(br, bi, w, o + (p - h) * ns, col);
      dr[pad(((o + (p - h) * ns) << lg) + col)] = br;
      di[pad(((o + (p - h) * ns) << lg) + col)] = bi;
    }
  }
}

// x (batch, n, ld) -> out: (batch, ld, n) when trans, else (batch, n, g,
// ld / g); tw: the table's (n,) planes; wr, wi: (n, ld / g) or nullptr;
// both TW.  Grid: batch * tiles blocks of kThreads, tiles = ceil(ld / TC).
template <class TW>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
fft_cols_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                float* __restrict__ outr, float* __restrict__ outi,
                const TW* __restrict__ twr, const TW* __restrict__ twi,
                const TW* __restrict__ wr, const TW* __restrict__ wi,
                int ld, int g, int trans, int tiles, Plan p,
                fft_rows::Layout o) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x, nt = blockDim.x;
  const int n = p.n, lg = p.lg, tc = 1 << lg;
  const long long z = blockIdx.x / tiles;
  const int col0 = (int)(blockIdx.x - z * tiles) << lg;
  const int cols = min(tc, ld - col0);  // the tile's live columns
  const int plane = (int)((o.y - o.x) / 2);
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
  const long long base = z * n * (long long)ld;
  const float* gr = xr + base + col0;
  const float* gi = xi + base + col0;
  // load: point a, column t -> word a*TC + t; dead columns read as zero
  if (((tc | ld) & 3) == 0 && aligned16(xr + base, xi + base)) {
    const int q4 = tc >> 2;
    for (int e = tid; e < n * q4; e += nt) {
      const int a = e / q4, t = (e - a * q4) << 2;
      float4 va = make_float4(0.f, 0.f, 0.f, 0.f), vb = va;
      if (t < cols) {
        va = load_line(gr + (long long)a * ld + t);
        vb = load_line(gi + (long long)a * ld + t);
      }
      const int w = (a << lg) + t;
      sr[pad(w)] = va.x;
      sr[pad(w + 1)] = va.y;
      sr[pad(w + 2)] = va.z;
      sr[pad(w + 3)] = va.w;
      si[pad(w)] = vb.x;
      si[pad(w + 1)] = vb.y;
      si[pad(w + 2)] = vb.z;
      si[pad(w + 3)] = vb.w;
    }
  } else {
    for (int e = tid; e < (n << lg); e += nt) {
      const int a = e >> lg, t = e & (tc - 1);
      const bool live = t < cols;
      sr[pad(e)] = live ? gr[(long long)a * ld + t] : 0.f;
      si[pad(e)] = live ? gi[(long long)a * ld + t] : 0.f;
    }
  }
  __syncthreads();
  const Twiddle<TW> none = {nullptr, nullptr, 0, 0, 1, 0};
  const Twiddle<TW> last = {wr, wi, ld / g, col0, g, cols};
  if (p.passes == 0 && wr != nullptr) {  // n = 1: no pass to fold it into
    for (int t = tid; t < cols; t += nt) {
      float r = sr[pad(t)], i = si[pad(t)];
      twiddle(r, i, last, 0, t);
      sr[pad(t)] = r;
      si[pad(t)] = i;
    }
    __syncthreads();
  }
  int ns = 1;
  for (int s = 0; s < p.passes; ++s) {
    const int R = p.radix[s];
    const Twiddle<TW> w = s + 1 == p.passes ? last : none;
    switch (R) {
      case 2:
        pass_radix<2>(sr, si, dr, di, tr, ti, n, ns, lg, w, tid, nt);
        break;
      case 3:
        pass_radix<3>(sr, si, dr, di, tr, ti, n, ns, lg, w, tid, nt);
        break;
      case 4:
        pass_radix<4>(sr, si, dr, di, tr, ti, n, ns, lg, w, tid, nt);
        break;
      case 5:
        pass_radix<5>(sr, si, dr, di, tr, ti, n, ns, lg, w, tid, nt);
        break;
      case 7:
        pass_radix<7>(sr, si, dr, di, tr, ti, n, ns, lg, w, tid, nt);
        break;
      case 8:
        pass_radix<8>(sr, si, dr, di, tr, ti, n, ns, lg, w, tid, nt);
        break;
      default:
        pass_dense(sr, si, dr, di, tr, ti, n, ns, R, lg, w, tid, nt);
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
  if (trans) {
    // the tile's cols output rows of n points: one run from row col0
    const long long ob = (z * ld + col0) * (long long)n;
    float* hr = outr + ob;
    float* hi = outi + ob;
    const int count = cols * n;
    int head = 0;
    if (aligned16(hr, hi)) {
      head = count & ~3;
      for (int t = tid; t < (count >> 2); t += nt) {
        float vr[4], vi[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int e = 4 * t + u, col = e / n;
          const int a = pad(((e - col * n) << lg) + col);
          vr[u] = sr[a];
          vi[u] = si[a];
        }
        reinterpret_cast<float4*>(hr)[t] =
            make_float4(vr[0], vr[1], vr[2], vr[3]);
        reinterpret_cast<float4*>(hi)[t] =
            make_float4(vi[0], vi[1], vi[2], vi[3]);
      }
    }
    for (int e = head + tid; e < count; e += nt) {
      const int col = e / n;
      const int a = pad(((e - col * n) << lg) + col);
      hr[e] = sr[a];
      hi[e] = si[a];
    }
    return;
  }
  float* hr = outr + base;
  float* hi = outi + base;
  if (g == 1 && ((tc | ld) & 3) == 0 && aligned16(hr, hi)) {
    const int q4 = cols >> 2;
    for (int e = tid; e < n * q4; e += nt) {
      const int c = e / q4, t = (e - c * q4) << 2;
      const int w = (c << lg) + t;
      const long long off = (long long)c * ld + col0 + t;
      *reinterpret_cast<float4*>(hr + off) = make_float4(
          sr[pad(w)], sr[pad(w + 1)], sr[pad(w + 2)], sr[pad(w + 3)]);
      *reinterpret_cast<float4*>(hi + off) = make_float4(
          si[pad(w)], si[pad(w + 1)], si[pad(w + 2)], si[pad(w + 3)]);
    }
    return;
  }
  const int nb = ld / g;
  for (int e = tid; e < n * cols; e += nt) {
    const int c = e / cols, t = e - c * cols;
    const int col = col0 + t, b = col / g, i = col - b * g;
    const long long off = ((long long)c * g + i) * nb + b;
    const int a = pad((c << lg) + t);
    hr[off] = sr[a];
    hi[off] = si[a];
  }
}

// One transform's plan, from the host (fourstep_fft.fft_cols_spec, and
// fft_rows_spec for a row FFT): its length, its tile (log2 of the
// columns of a column FFT's tile, or the rows a block of the row FFT
// takes), its radices and the word offsets of its shared arrays.
struct FftSpec {
  int n, tile, passes;
  int radix[kMaxPasses];
  long long layout[4];
};

// Launch fft_cols_kernel on `stream`: x (batch, n, ld) planes; out as the
// kernel states; tw: the table's (n,) planes; w: (n, ld / g) twiddle
// planes of the table's type, or nullptr; s: the plan, its tile log2 of
// TC (host memory).  Returns the first CUDA error.
template <class TW>
static inline int launch(const float* xr, const float* xi, float* outr,
                         float* outi, const TW* twr, const TW* twi,
                         const typename same_type<TW>::type* wr,
                         const typename same_type<TW>::type* wi,
                         long long batch, int ld, int g, bool trans,
                         const FftSpec& s, cudaStream_t stream) {
  if (s.passes < 0 || s.passes > kMaxPasses || s.n < 1 || ld < 1 ||
      g < 1 || ld % g != 0 || s.tile < 0 || s.tile > 10 ||
      (trans && g != 1))
    return (int)cudaErrorInvalidValue;
  Plan p;
  memset(&p, 0, sizeof(p));
  p.n = s.n;
  p.lg = s.tile;
  p.passes = s.passes;
  for (int k = 0; k < s.passes; ++k) p.radix[k] = s.radix[k];
  fft_rows::Layout o;
  memcpy(&o, s.layout, sizeof(o));
  const size_t smem = (size_t)o.total * sizeof(float);
  if (smem > kSmemDefault) {
    const cudaError_t err = cudaFuncSetAttribute(
        fft_cols_kernel<TW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long tiles = ((long long)ld + (1 << s.tile) - 1) >> s.tile;
  const long long blocks = batch * tiles;
  if (blocks < 1) return 0;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  fft_cols_kernel<TW><<<(unsigned)blocks, kThreads, smem, stream>>>(
      xr, xi, outr, outi, twr, twi, wr, wi, ld, g, trans ? 1 : 0,
      (int)tiles, p, o);
  return (int)cudaGetLastError();
}

}  // namespace fft_cols
