// RWKV-6 WKV recurrence, chunked and factorised: outputs o and the final
// state for every (batch, head) row.
//
// Replaces the JAX package's kernels/wkv.py::wkv_pallas (the RWKV-6
// prefill's token mixing).  Per row bh, with the state S (K, V = K) and
// chunks of CT = 8 steps of r, k, v and the log decay lw (<= 0):
//
//   p      = cumsum(lw)  (inclusive),  pm1 = p shifted by one (exclusive)
//   c      = p[CT/2]     (the re-centring; factor exponents stay within
//                         (CT/2 + 1) * 8 because the model clamps lw >= -8)
//   o[t]   = (r[t] * exp(pm1[t])) @ S
//          + sum_{s < t} [(r[t] * exp(pm1[t] - c)) . (k[s] * exp(c - p[s]))] v[s]
//          + (sum_k r[t] * k[t] * u) v[t]
//   S      = S * exp(p[CT-1])[:, None] + (k * exp(p[CT-1] - p))^T @ v
//
// The decay scales the state's rows (the key axis).  The intra-chunk
// scores take the strict lower triangle by SELECTION: pairs with t < s
// are never formed, so their products (which may overflow) cannot reach
// the output; the bonus sits on the diagonal (s == t).
//
// What bounds it on the H100: bytes at the least work (r, k, v, lw in and
// o out: 20 bytes a step and key for about 5*K flops).  The recurrence is
// a chain over T, but column v of S (and of o) depends only on r, k, lw
// and v[:, v], so the design takes its parallelism from the value axis
// and from the work no state enters:
//
// - grid: one block per (row, slice of VB value columns), the slice
//   fastest, so the K/VB blocks of a row run together and share r, k and
//   lw through L2; no block depends on another.  Each block carries its
//   K x VB slice of the state in registers and recomputes the row's
//   decay factors (CT x K exponentials a chunk).
// - segments of G chunks, double-buffered in shared memory by cp.async:
//   the next segment's r, k, lw and v[:, slice] load while this one
//   computes.  Per segment, with every thread busy and no state:
//   (A) the cumulative decay and the four factor planes of every chunk;
//   (B) every chunk's masked scores, a thread a pair: the 28 pairs s < t
//   on the first warps, the 8 bonuses s == t on the next, so no warp
//   runs both dots.  (C) The state scan is the only serial part: each
//   thread owns fixed (j, 4 v) entries and walks the segment's chunks
//   with no barrier, writing each chunk's starting state to shared
//   memory.  (D) After one barrier, every output of the segment at once:
//   o = r e^{pm1} . S_chunk + the scores against v, a thread two steps
//   by four columns over a share of the keys.  Three barriers a segment.
// - K <= 64 at compile time: every loop over the key axis runs to 64,
//   unrolled; a smaller K reads zeros past it (r, k, lw and the state's
//   rows), which leave o and S unchanged.  FP32 on CUDA cores with FP32
//   sums throughout (TF32 tensor cores would miss the 1e-5 gate).
//
// VB (value columns a block), G (chunks a segment) and NT (threads) were
// chosen by timing at the model's (160, 512, 64): 320 blocks, three an
// SM by shared memory, registers budgeted to keep three (no spill).
// tools/wkv_ab.py --sweep builds the other points with -DWKV_VB, -DWKV_G
// and -DWKV_NT (PERF.md lists them).  No runtime knob.

#include "common.cuh"

#ifndef WKV_VB
#define WKV_VB 32
#endif
#ifndef WKV_G
#define WKV_G 2
#endif
#ifndef WKV_NT
#define WKV_NT 128
#endif

namespace {

constexpr int CT = 8;          // time chunk, as the TPU kernel's
constexpr int KMAX = 64;       // the head size the model uses
constexpr int VB = WKV_VB;     // value columns a block
constexpr int G = WKV_G;       // chunks a segment
constexpr int NT = WKV_NT;     // threads a block
constexpr int TS = G * CT;     // steps a segment
constexpr int VQ = VB / 4;     // float4 columns of a slice
constexpr int KR = KMAX + 4;   // padded [t][j] row of the factor planes
constexpr int VR = VB + 4;     // padded [j][v] row of the chunk states
static_assert(VB % 4 == 0 && KMAX % VB == 0, "VB: a multiple of 4 dividing 64");
static_assert(NT % VQ == 0 && KMAX % (NT / VQ) == 0, "state map");
// phase B's threads: the pairs s < t of the segment's chunks, then, from
// the next warp on, the bonuses
constexpr int NLOW = CT * (CT - 1) / 2;
constexpr int DIAG0 = (G * NLOW + 31) & ~31;
static_assert(DIAG0 + G * CT <= NT, "one thread a score pair");

// shared memory, in floats: two load buffers, then the factor planes
constexpr int RAW_R = 0;                       // r      [TS][KR]
constexpr int RAW_K = RAW_R + TS * KR;         // k      [TS][KR]
constexpr int RAW_L = RAW_K + TS * KR;         // lw     [TS][KMAX]
constexpr int RAW_V = RAW_L + TS * KMAX;       // v      [TS][VB]
constexpr int RAW = RAW_V + TS * VB;           // one buffer
constexpr int F_RIN = 2 * RAW;                 // r e^{pm1}       [TS][KR]
constexpr int F_RDC = F_RIN + TS * KR;         // r e^{pm1 - c}   [TS][KR]
constexpr int F_KGR = F_RDC + TS * KR;         // k e^{c - p}     [TS][KR]
constexpr int F_KDC = F_KGR + TS * KR;         // k e^{pe - p}    [G][KMAX][CT]
constexpr int F_DND = F_KDC + G * KMAX * CT;   // e^{pe}          [G][KMAX]
constexpr int F_SC = F_DND + G * KMAX;         // scores, bonus   [G][CT][CT]
constexpr int F_U = F_SC + G * CT * CT;        // u               [KMAX]
constexpr int F_ST = F_U + KMAX;               // chunk states    [G][KMAX][VR]
constexpr int SMEM_FLOATS = F_ST + G * KMAX * VR;
constexpr int SMEM_BYTES = SMEM_FLOATS * 4;
// blocks an SM holds by shared memory (228 KB, 1 KB reserved a block):
// the register budget is set to keep them all
constexpr int MIN_BLOCKS = 233472 / (SMEM_BYTES + 1024) < 1   ? 1
                           : 233472 / (SMEM_BYTES + 1024) > 8 ? 8
                           : 233472 / (SMEM_BYTES + 1024);
static_assert(RAW % 4 == 0 && F_RIN % 4 == 0 && F_KDC % 4 == 0 &&
                  F_ST % 4 == 0,
              "float4 alignment");

#ifdef WKV_PHASE_CLOCKS
// cycles the blocks spent in each phase, summed over blocks (thread 0's
// clock from barrier to barrier): wait + issue, A, B, C, D.  A timing
// build only (tools/wkv_ab.py --phases)
__device__ unsigned long long wkv_phase_cycles[5];
#define PHASE_MARK(i)                  \
  do {                                 \
    const long long now = clock64();   \
    ph[i] += now - tick;               \
    tick = now;                        \
  } while (0)
#else
#define PHASE_MARK(i) \
  do {                \
  } while (0)
#endif

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void fma4(float4& acc, float a, const float4& b) {
  acc.x = fmaf(a, b.x, acc.x);
  acc.y = fmaf(a, b.y, acc.y);
  acc.z = fmaf(a, b.z, acc.z);
  acc.w = fmaf(a, b.w, acc.w);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__global__ void __launch_bounds__(NT, MIN_BLOCKS)
wkv_kernel(const float* __restrict__ r, const float* __restrict__ k,
           const float* __restrict__ v, const float* __restrict__ lw,
           const float* __restrict__ u, const float* __restrict__ s0,
           float* __restrict__ o, float* __restrict__ sout, int T, int K,
           int nvs) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x;
  const long long row = blockIdx.x / nvs;
  const int v0 = (blockIdx.x % nvs) * VB;
  const int vn = min(VB, K - v0);                // live columns of the slice
  const long long base = row * (long long)T * K;
  const bool vec = (K & 3) == 0;                 // 16-byte rows
  const int nseg = (T + TS - 1) / TS;

  // what the copies never write (keys past K, columns past the slice's
  // end) stays zero in both buffers
  if (K < KMAX || vn < VB) {
    for (int i = tid; i < 2 * RAW; i += NT) sm[i] = 0.f;
    __syncthreads();
  }
  for (int j = tid; j < KMAX; j += NT) sm[F_U + j] = j < K ? u[row * K + j] : 0.f;

  auto load_segment = [&](int g) {
    float* buf = sm + (g & 1) * RAW;
    const int t0 = g * TS;
    const int nst = min(TS, T - t0);
    const long long off = base + (long long)t0 * K;
    if (vec) {       // 16-byte slots of every row; those past K skip
      for (int i = tid; i < nst * (KMAX / 4); i += NT) {
        const int t = i / (KMAX / 4), j = 4 * (i % (KMAX / 4));
        if (j >= K) continue;
        const long long src = off + (long long)t * K + j;
        cp_async16(buf + RAW_R + t * KR + j, r + src);
        cp_async16(buf + RAW_K + t * KR + j, k + src);
        cp_async16(buf + RAW_L + t * KMAX + j, lw + src);
      }
      for (int i = tid; i < nst * VQ; i += NT) {
        const int t = i / VQ, c = 4 * (i % VQ);
        if (c >= vn) continue;
        cp_async16(buf + RAW_V + t * VB + c, v + off + (long long)t * K + v0 + c);
      }
    } else {
      for (int i = tid; i < nst * K; i += NT) {
        const int t = i / K, j = i % K;
        const long long src = off + (long long)t * K + j;
        cp_async4(buf + RAW_R + t * KR + j, r + src);
        cp_async4(buf + RAW_K + t * KR + j, k + src);
        cp_async4(buf + RAW_L + t * KMAX + j, lw + src);
      }
      for (int i = tid; i < nst * vn; i += NT) {
        const int t = i / vn, c = i % vn;
        cp_async4(buf + RAW_V + t * VB + c, v + off + (long long)t * K + v0 + c);
      }
    }
    cp_async_commit();
  };
  load_segment(0);

  // the state slice in registers: thread owns rows jb + q*JSTEP, columns
  // 4*v4 .. 4*v4+3
  constexpr int JSTEP = NT / VQ;
  constexpr int JT = KMAX / JSTEP;
  const int v4 = tid % VQ, jb = tid / VQ;
  float4 S[JT];
#pragma unroll
  for (int q = 0; q < JT; ++q) {
    const int j = jb + q * JSTEP;
    float e[4];
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int c = 4 * v4 + x;
      e[x] = (j < K && c < vn) ? s0[(row * K + j) * K + v0 + c] : 0.f;
    }
    S[q] = make_float4(e[0], e[1], e[2], e[3]);
  }

#ifdef WKV_PHASE_CLOCKS
  long long ph[5] = {0, 0, 0, 0, 0};
  long long tick = clock64();
#endif
  for (int g = 0; g < nseg; ++g) {
    const float* buf = sm + (g & 1) * RAW;
    const int t0 = g * TS;
    const int nch = min(G, (T - t0) / CT);
    cp_async_wait_all();
    __syncthreads();                 // this segment landed; the last one's
    if (g + 1 < nseg) load_segment(g + 1);   // readers are done
    PHASE_MARK(0);

    // (A) the decay factors: one thread (or H threads) a (chunk, key).
    // e^{pm1 - c} is formed as e^{pm1} e^{-c} (>= e^{-56}, <= e^{40}),
    // e^{c - p} and e^{pe - p} as e^{c} or e^{pe} (>= e^{-64}) times
    // e^{-p} (<= e^{64}): every partial stays a normal float under the
    // clamp, and a (chunk, key) takes 19 exponentials, not 33
    {
      constexpr int H = (G * KMAX >= NT) ? 1 : NT / (G * KMAX);
      constexpr int TH = CT / H;
      for (int it = tid; it < G * KMAX * H; it += NT) {
        const int j = it % KMAX, c = (it / KMAX) % G, h = it / (KMAX * G);
        if (c >= nch) continue;
        const int r0 = c * CT;
        float p[CT];
        float acc = 0.f;
#pragma unroll
        for (int t = 0; t < CT; ++t) {
          acc += buf[RAW_L + (r0 + t) * KMAX + j];
          p[t] = acc;
        }
        const float cc = p[CT / 2], pe = p[CT - 1];
        const float e_pe = expf(pe), e_c = expf(cc), e_nc = expf(-cc);
#pragma unroll
        for (int t = 0; t < CT; ++t) {
          if (t / TH != h) continue;
          const float e_pm1 = t == 0 ? 1.f : expf(p[t - 1]);
          const float e_np = expf(-p[t]);
          const float rr = buf[RAW_R + (r0 + t) * KR + j];
          const float kk = buf[RAW_K + (r0 + t) * KR + j];
          const float rin = rr * e_pm1;
          sm[F_RIN + (r0 + t) * KR + j] = rin;
          sm[F_RDC + (r0 + t) * KR + j] = rin * e_nc;
          sm[F_KGR + (r0 + t) * KR + j] = kk * (e_c * e_np);
          sm[F_KDC + (c * KMAX + j) * CT + t] = kk * (e_pe * e_np);
        }
        if (h == 0) sm[F_DND + c * KMAX + j] = e_pe;
      }
    }
    __syncthreads();
    PHASE_MARK(1);

    // (B) the scores of every chunk: the 28 pairs s < t of each chunk on
    // the first threads (pair p is t = the triangle root of p, s the
    // rest), the 8 bonuses s == t on the next, so no warp runs both
    // dots; pairs s > t are never formed
    {
      const int it = tid;
      if (it < G * NLOW) {
        const int c = it / NLOW, pr = it % NLOW;
        const int t = (int)((1.f + sqrtf(1.f + 8.f * pr)) * 0.5f);
        const int s = pr - t * (t - 1) / 2;
        if (c < nch) {
          const int rt = c * CT + t, rs = c * CT + s;
          float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll 4
          for (int j = 0; j < KMAX; j += 4) {
            const float4 a = ld4(sm + F_RDC + rt * KR + j);
            const float4 b = ld4(sm + F_KGR + rs * KR + j);
            a0 = fmaf(a.x, b.x, a0);
            a1 = fmaf(a.y, b.y, a1);
            a2 = fmaf(a.z, b.z, a2);
            a3 = fmaf(a.w, b.w, a3);
          }
          sm[F_SC + rt * CT + s] = (a0 + a1) + (a2 + a3);
        }
      } else if (it >= DIAG0 && it < DIAG0 + G * CT) {
        const int rt = it - DIAG0, c = rt / CT;
        if (c < nch) {
          float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll 4
          for (int j = 0; j < KMAX; j += 4) {
            const float4 a = ld4(buf + RAW_R + rt * KR + j);
            const float4 b = ld4(buf + RAW_K + rt * KR + j);
            const float4 w = ld4(sm + F_U + j);
            a0 = fmaf(a.x * b.x, w.x, a0);
            a1 = fmaf(a.y * b.y, w.y, a1);
            a2 = fmaf(a.z * b.z, w.z, a2);
            a3 = fmaf(a.w * b.w, w.w, a3);
          }
          sm[F_SC + rt * CT + rt % CT] = (a0 + a1) + (a2 + a3);
        }
      }
    }

    PHASE_MARK(2);

    // (C) the state scan, the only serial part: no barrier between chunks
    for (int c = 0; c < nch; ++c) {
#pragma unroll
      for (int q = 0; q < JT; ++q) {
        const int j = jb + q * JSTEP;
        *reinterpret_cast<float4*>(sm + F_ST + (c * KMAX + j) * VR + 4 * v4) =
            S[q];
      }
      float4 vv[CT];
#pragma unroll
      for (int s = 0; s < CT; ++s) vv[s] = ld4(buf + RAW_V + (c * CT + s) * VB + 4 * v4);
#pragma unroll
      for (int q = 0; q < JT; ++q) {
        const int j = jb + q * JSTEP;
        const float* kd = sm + F_KDC + (c * KMAX + j) * CT;
        const float4 ka = ld4(kd), kb = ld4(kd + 4);
        const float kds[CT] = {ka.x, ka.y, ka.z, ka.w, kb.x, kb.y, kb.z, kb.w};
        float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int s = 0; s < CT; ++s) fma4(acc, kds[s], vv[s]);
        const float d = sm[F_DND + c * KMAX + j];
        S[q].x = fmaf(S[q].x, d, acc.x);
        S[q].y = fmaf(S[q].y, d, acc.y);
        S[q].z = fmaf(S[q].z, d, acc.z);
        S[q].w = fmaf(S[q].w, d, acc.w);
      }
    }
    __syncthreads();
    PHASE_MARK(3);

    // (D) every output of the segment: a unit is two steps of one chunk
    // by four columns, JS lanes a unit splitting the keys, reduced by
    // shuffles; then each lane finishes one step's intra sum and store
    {
      constexpr int RT = 2;
      constexpr int UNITS = TS / RT * VQ;
      constexpr int JS = UNITS >= NT ? 1 : NT / UNITS;
      constexpr int NG = KMAX / 4 / JS;
      constexpr int TOTAL = UNITS * JS;
      static_assert(JS <= 32 && (KMAX / 4) % JS == 0, "key split");
      for (int it0 = 0; it0 < TOTAL; it0 += NT) {
        const int it = it0 + tid;
        const int js = it % JS, un = it / JS;
        const int c4 = un % VQ, r0 = (un / VQ) * RT;
        const int c = r0 / CT;
        const bool live = it < TOTAL && c < nch;
        float4 acc[RT];
#pragma unroll
        for (int x = 0; x < RT; ++x) acc[x] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (live) {
#pragma unroll
          for (int i = 0; i < NG; ++i) {
            const int j = 4 * (js + JS * i);
            const float* st = sm + F_ST + (c * KMAX + j) * VR + 4 * c4;
            const float4 s0v = ld4(st), s1v = ld4(st + VR),
                         s2v = ld4(st + 2 * VR), s3v = ld4(st + 3 * VR);
#pragma unroll
            for (int x = 0; x < RT; ++x) {
              const float4 a = ld4(sm + F_RIN + (r0 + x) * KR + j);
              fma4(acc[x], a.x, s0v);
              fma4(acc[x], a.y, s1v);
              fma4(acc[x], a.z, s2v);
              fma4(acc[x], a.w, s3v);
            }
          }
        }
#pragma unroll
        for (int m = 1; m < JS; m <<= 1) {
#pragma unroll
          for (int x = 0; x < RT; ++x) {
            acc[x].x += __shfl_xor_sync(0xffffffffu, acc[x].x, m);
            acc[x].y += __shfl_xor_sync(0xffffffffu, acc[x].y, m);
            acc[x].z += __shfl_xor_sync(0xffffffffu, acc[x].z, m);
            acc[x].w += __shfl_xor_sync(0xffffffffu, acc[x].w, m);
          }
        }
#pragma unroll
        for (int x = 0; x < RT; ++x) {
          if (!live || (JS > 1 && x != js)) continue;
          const int rt = r0 + x, t = rt % CT;
          float4 out = acc[x];
          for (int s = 0; s <= t; ++s)
            fma4(out, sm[F_SC + rt * CT + s],
                 ld4(buf + RAW_V + (c * CT + s) * VB + 4 * c4));
          float* dst = o + base + (long long)(t0 + rt) * K + v0 + 4 * c4;
          if (vec && 4 * c4 < vn) {
            *reinterpret_cast<float4*>(dst) = out;
          } else if (!vec) {
            const float e[4] = {out.x, out.y, out.z, out.w};
#pragma unroll
            for (int y = 0; y < 4; ++y)
              if (4 * c4 + y < vn) dst[y] = e[y];
          }
        }
      }
    }
    PHASE_MARK(4);
  }
#ifdef WKV_PHASE_CLOCKS
  if (tid == 0)
    for (int i = 0; i < 5; ++i)
      atomicAdd(&wkv_phase_cycles[i], (unsigned long long)ph[i]);
#endif

#pragma unroll
  for (int q = 0; q < JT; ++q) {
    const int j = jb + q * JSTEP;
    if (j >= K) continue;
    const float e[4] = {S[q].x, S[q].y, S[q].z, S[q].w};
#pragma unroll
    for (int x = 0; x < 4; ++x)
      if (4 * v4 + x < vn) sout[(row * K + j) * K + v0 + 4 * v4 + x] = e[x];
  }
}

cudaError_t set_smem() {
  static cudaError_t err = cudaFuncSetAttribute(
      wkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  return err;
}

}  // namespace

// r, k, v, lw, o: (bh, T, K); u: (bh, K); s0, sout: (bh, K, K); all f32,
// contiguous.  T % 8 == 0 and 1 <= K <= 64; the wrapper checks.
extern "C" int wkv_f32(const float* r, const float* k, const float* v,
                       const float* lw, const float* u, const float* s0,
                       float* o, float* sout, int bh, int T, int K,
                       void* stream) {
  if (K < 1 || K > KMAX || T % CT != 0) return (int)cudaErrorInvalidValue;
  const int nvs = (K + VB - 1) / VB;
  if ((long long)bh * nvs > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const cudaError_t err = set_smem();
  if (err != cudaSuccess) return (int)err;
  wkv_kernel<<<bh * nvs, NT, SMEM_BYTES, (cudaStream_t)stream>>>(
      r, k, v, lw, u, s0, o, sout, T, K, nvs);
  return (int)cudaGetLastError();
}

// The compiled design: {VB, G, threads, shared bytes, resident blocks an
// SM (the occupancy calculator)}.
extern "C" int wkv_design(int* out) {
  out[0] = VB;
  out[1] = G;
  out[2] = NT;
  out[3] = SMEM_BYTES;
  cudaError_t err = set_smem();
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[4], wkv_kernel,
                                                        NT, SMEM_BYTES);
  return (int)err;
}

// A timing build's phase cycles since the last read (then zeroed):
// {wait + issue, A, B, C, D}; cudaErrorNotSupported in the shipped build.
extern "C" int wkv_phase_cycles_read(unsigned long long* out) {
#ifdef WKV_PHASE_CLOCKS
  cudaError_t err = cudaMemcpyFromSymbol(out, wkv_phase_cycles,
                                         5 * sizeof(unsigned long long));
  const unsigned long long zero[5] = {0, 0, 0, 0, 0};
  if (err == cudaSuccess)
    err = cudaMemcpyToSymbol(wkv_phase_cycles, zero, sizeof(zero));
  return (int)err;
#else
  (void)out;
  return (int)cudaErrorNotSupported;
#endif
}
