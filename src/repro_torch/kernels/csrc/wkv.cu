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
// scores take the strict lower triangle by SELECTION: pairs with t <= s
// are never formed, so their products (which may overflow) cannot reach
// the output.
//
// What bounds it on the H100: bytes at the least work (r, k, v, lw in and
// o out: 20 bytes a step and key for about 5*K flops), but this first
// design is latency-bound: one block per row walks its T/8 chunks in
// series, five barriers a chunk.  The (K, K) state (16 KiB at K = 64)
// stays in shared memory for the whole T loop, each chunk of r, k, v and
// lw is staged into shared memory once (coalesced), and only o and the
// final state are written back.  No tensor cores, no TMA: later work.

#include "common.cuh"

namespace {

constexpr int CT = 8;         // time chunk, as the TPU kernel's
constexpr int KMAX = 64;      // the head size the model uses
constexpr int KP = KMAX + 1;  // padded row: conflict-free column walks
constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
wkv_kernel(const float* __restrict__ r, const float* __restrict__ k,
           const float* __restrict__ v, const float* __restrict__ lw,
           const float* __restrict__ u, const float* __restrict__ s0,
           float* __restrict__ o, float* __restrict__ sout, int T, int K) {
  __shared__ float S[KMAX * KMAX];
  __shared__ float sr[CT][KMAX], sk[CT][KMAX], sv[CT][KMAX], slw[CT][KMAX];
  __shared__ float rinter[CT][KMAX];  // r * exp(pm1): against the state
  __shared__ float rdec[CT][KP];      // r * exp(pm1 - c)
  __shared__ float kgrow[CT][KP];     // k * exp(c - p)
  __shared__ float kdec[CT][KMAX];    // k * exp(p_end - p)
  __shared__ float dend[KMAX];        // exp(p_end): the state's row decay
  __shared__ float su[KMAX];
  __shared__ float sc[CT][CT];        // masked intra-chunk scores
  __shared__ float coef[CT];          // diagonal bonus sum_k r k u

  const int tid = threadIdx.x;
  const long long row = blockIdx.x;
  const long long base = row * (long long)T * K;
  const int KK = K * K;
  for (int i = tid; i < KK; i += THREADS) S[i] = s0[row * KK + i];
  for (int i = tid; i < K; i += THREADS) su[i] = u[row * K + i];

  const int n = CT * K;
  for (int t0 = 0; t0 < T; t0 += CT) {
    const long long off = base + (long long)t0 * K;
    for (int i = tid; i < n; i += THREADS) {
      const int t = i / K, j = i % K;
      sr[t][j] = r[off + i];
      sk[t][j] = k[off + i];
      sv[t][j] = v[off + i];
      slw[t][j] = lw[off + i];
    }
    __syncthreads();

    // decay factors: one thread per key index walks the chunk's cumsum
    if (tid < K) {
      const int j = tid;
      float p[CT];
      float acc = 0.f;
#pragma unroll
      for (int t = 0; t < CT; ++t) {
        acc += slw[t][j];
        p[t] = acc;
      }
      const float c = p[CT / 2];
      const float pe = p[CT - 1];
#pragma unroll
      for (int t = 0; t < CT; ++t) {
        const float pm1 = t == 0 ? 0.f : p[t - 1];
        rinter[t][j] = sr[t][j] * expf(pm1);
        rdec[t][j] = sr[t][j] * expf(pm1 - c);
        kgrow[t][j] = sk[t][j] * expf(c - p[t]);
        kdec[t][j] = sk[t][j] * expf(pe - p[t]);
      }
      dend[j] = expf(pe);
    }
    __syncthreads();

    // the strict lower triangle of scores, and the diagonal bonus
    if (tid < CT * CT) {
      const int t = tid / CT, s = tid % CT;
      float acc = 0.f;
      if (t > s) {
        for (int j = 0; j < K; ++j) acc = fmaf(rdec[t][j], kgrow[s][j], acc);
      }
      sc[t][s] = acc;
    } else if (tid < CT * CT + CT) {
      const int t = tid - CT * CT;
      float acc = 0.f;
      for (int j = 0; j < K; ++j) acc = fmaf(sr[t][j] * sk[t][j], su[j], acc);
      coef[t] = acc;
    }
    __syncthreads();

    // outputs: inter-chunk (against the carried state), intra, bonus
    for (int i = tid; i < n; i += THREADS) {
      const int t = i / K, vv = i % K;
      float inter = 0.f;
      for (int j = 0; j < K; ++j) inter = fmaf(rinter[t][j], S[j * K + vv], inter);
      float intra = 0.f;
      for (int s = 0; s < t; ++s) intra = fmaf(sc[t][s], sv[s][vv], intra);
      o[off + i] = inter + intra + coef[t] * sv[t][vv];
    }
    __syncthreads();

    // the state to the chunk's end
    for (int i = tid; i < KK; i += THREADS) {
      const int j = i / K, vv = i % K;
      float acc = 0.f;
#pragma unroll
      for (int s = 0; s < CT; ++s) acc = fmaf(kdec[s][j], sv[s][vv], acc);
      S[i] = fmaf(S[i], dend[j], acc);
    }
    __syncthreads();
  }
  for (int i = tid; i < KK; i += THREADS) sout[row * KK + i] = S[i];
}

}  // namespace

// r, k, v, lw, o: (bh, T, K); u: (bh, K); s0, sout: (bh, K, K); all f32,
// contiguous.  T % 8 == 0 and 1 <= K <= 64; the wrapper checks.
extern "C" int wkv_f32(const float* r, const float* k, const float* v,
                       const float* lw, const float* u, const float* s0,
                       float* o, float* sout, int bh, int T, int K,
                       void* stream) {
  if (K < 1 || K > KMAX || T % CT != 0) return (int)cudaErrorInvalidValue;
  wkv_kernel<<<bh, THREADS, 0, (cudaStream_t)stream>>>(r, k, v, lw, u, s0, o,
                                                        sout, T, K);
  return (int)cudaGetLastError();
}
