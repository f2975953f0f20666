// The prefill of Kimi Delta Attention (KDA, models/kda.py: the gated
// delta-rule linear attention of Kimi-Linear-48B-A3B) between its
// projections, for Hopper (sm_90a): one launch a layer, one block per
// (row, head) of the packed ragged rows, each row from a zero state.
//
// A block walks its row's chunks of 64 positions in order, the fp32 state
// S [128 k, 128 v] held in shared memory from the first chunk to the last,
// and per chunk
//   1. applies the causal depthwise conv (4 taps, zero before the row's
//      start) and SiLU to the head's raw q, k, v, L2-normalises q and k
//      (x / sqrt(sum x^2 + 1e-6)), q times 128^-1/2, and computes the
//      log-decay g = -exp(A_log[h]) * softplus(f + dt_bias) of every key
//      channel and beta = sigmoid(b[h]); positions past the row's end are
//      zero (q = k = v = g = beta = 0 leave the state as it is);
//   2. takes gc, the cumulative sum of g along the chunk (gc <= 0, falling);
//   3. forms the decayed pairs A[c, j] = sum_d q_cd k_jd exp(gc_cd - gc_jd)
//      (j <= c) and L[c, j] the same with k_c (j < c), without overflow:
//      the chunk is cut into four sub-blocks of 16; inside a sub-block
//      every term's exponent (<= 0) is taken directly, and for c in
//      sub-block I after j in J the exponent splits into three parts that
//      are each <= 0: (gc_c - b_I) + (b_I - e_J) + (e_J - gc_j), with b_I
//      the gc of I's first position and e_J of J's last;
//   4. solves the UT form by forward substitution, one column a thread:
//      with M = diag(beta) L, w = (I + M)^-1 diag(beta) (exp(gc) . k) and
//      u = (I + M)^-1 diag(beta) v;
//   5. runs the state pass: v_new = u - w S, o = (exp(gc) . q) S + A v_new,
//      S <- diag(exp(gc_63)) S + k_d^T v_new with k_d = exp(gc_63 - gc) . k;
//   6. writes RMSNorm(o) * w_norm * sigmoid(gate + g_bias) in bf16.
// After the last chunk it writes S into the row's decode state and the
// row's last 3 raw q, k, v inputs (oldest first, 0 before the row) into
// its conv state. Every product and sum runs in fp32 on the CUDA cores
// (FFMA): the inputs are read in bf16 once and rounded to fp32.
//
// Replaces no TPU kernel: the JAX package has no LM. It replaces the plain
// twin (models/kda.py::kda_prefill_plain: the conv, norms and gates, then
// chunk_kda's chunk-major fp32 tensors, its pairs, a batched triangular
// solve and a state pass of ~5 launches a chunk, then the gated norm).
//
// What bounds it: operations. A chunk of one head is ~4.6 M FMA (the three
// 64 x 128 x 128 state products and the 64 x 64 x 128 one, the pairs, the
// substitution); the topics prompts' ~5,230 tokens a call are ~82 chunks
// per head, so 20 layers of 32 heads are ~0.5 TFLOP a call, ~7 ms at the
// card's 67 TFLOP/s of fp32 FFMA, against ~1.5 ms for the bytes (~40 KB of
// bf16 inputs and 8 KB of output a token and layer). The design keeps
// everything of a chunk in shared memory (~223 KB: the state, four 64 x
// 128 working tiles, the packed pairs), so nothing but the inputs, the
// output and the final state touches device memory, and runs each product
// as register tiles of 8 x 4 or 4 x 4 outputs a thread fed by 16-byte
// shared loads (the A operand stored k-major, broadcast across a warp).
// One 512-thread block fits an SM; 8 rows x 32 heads give 256 blocks, two
// waves over the 132 SMs, longest rows first (the wrapper's order). On an
// H100 a layer of the class prompts (8 rows of ~3,960 tokens) takes ~8.2
// ms against a 2.1 ms bound: the state products run at ~60% of the FFMA
// peak, while the per-chunk steps around them (conv and gates, the pairs'
// exponents, the substitution) are latency-bound at 16 warps an SM and
// take half of the time.
//
// C interface (loaded with ctypes): kda_prefill_fwd returns the
// cudaError_t of its launch; 0 means the kernel was launched.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kD = 128;                 // d_k = d_v
constexpr int kK = 4;                   // the conv's taps
constexpr int kC = 64;                  // the chunk
constexpr int kSub = 16;                // sub-block of the pairs
constexpr int kNSub = kC / kSub;
constexpr int kThreads = 512;           // 16 warps
constexpr int kWarps = kThreads / 32;
constexpr int kRowP = 132;              // stride of [64 positions][128]
constexpr int kRowT = 68;               // stride of [128][64 positions]
constexpr float kL2Eps = 1e-6f;
constexpr float kQScale = 0.08838834764831845f;   // 128^-1/2

// Shared memory, in floats. Q, K: [64][132] row-major or [128][68]
// k-major (transposed) in turn; V, G: [64][132].
constexpr int kOffS = 0;                           // S [128][128]
constexpr int kBigT = kD * kRowT;
constexpr int kBigP = kC * kRowP;
constexpr int kOffQ = kOffS + kD * kD;             // q, Qr, qg^T, q.S, o
constexpr int kOffK = kOffQ + kBigT;               // k, Kr, w^T
constexpr int kOffV = kOffK + kBigT;               // v, u, v_new
constexpr int kOffG = kOffV + kBigP;               // g, gc, Kc, k_d
constexpr int kOffPK = kOffG + kBigP;              // [64][68] M and A^T
constexpr int kOffB = kOffPK + kC * kRowT;         // b_I [4][128]
constexpr int kOffE = kOffB + kNSub * kD;          // e_J [4][128]
constexpr int kOffM = kOffE + kNSub * kD;          // exp(b_I - e_J) [6][128]
constexpr int kOffDec = kOffM + 6 * kD;            // exp(gc_63) [128]
constexpr int kOffBeta = kOffDec + kD;             // beta [64]
constexpr int kSmemFloats = kOffBeta + kC;
constexpr size_t kSmem = kSmemFloats * sizeof(float);
static_assert(kBigT >= kBigP, "a transposed tile must fit its buffer");
static_assert(kSmem <= 232448, "over the 227 KB a block may use");

__device__ __forceinline__ float bf(bf16 x) { return __bfloat162float(x); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float4 ld4(const float* s) {
  return *reinterpret_cast<const float4*>(s);
}

__device__ __forceinline__ void st4(float* s, float4 v) {
  *reinterpret_cast<float4*>(s) = v;
}

__device__ __forceinline__ float at(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// 4 consecutive bf16 (8-byte aligned) -> fp32
__device__ __forceinline__ void load_bf4(const bf16* src, float* dst) {
  const __nv_bfloat162* s2 = reinterpret_cast<const __nv_bfloat162*>(src);
  const float2 a = __bfloat1622float2(s2[0]);
  const float2 b = __bfloat1622float2(s2[1]);
  dst[0] = a.x;
  dst[1] = a.y;
  dst[2] = b.x;
  dst[3] = b.y;
}

__global__ void __launch_bounds__(kThreads, 1)
kda_prefill_kernel(const bf16* __restrict__ p, long long p_stride,
                   const bf16* __restrict__ fg,
                   const bf16* __restrict__ conv_w,
                   const float* __restrict__ A_log,
                   const float* __restrict__ dt_bias,
                   const bf16* __restrict__ g_bias,
                   const bf16* __restrict__ o_norm, float eps,
                   const int* __restrict__ rows, float* __restrict__ state,
                   bf16* __restrict__ conv_state, bf16* __restrict__ out,
                   int N, int H) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  float* S = sm + kOffS;
  float* Qb = sm + kOffQ;
  float* Kb = sm + kOffK;
  float* Vb = sm + kOffV;
  float* Gb = sm + kOffG;
  float* PK = sm + kOffPK;
  float* BV = sm + kOffB;
  float* EV = sm + kOffE;
  float* MV = sm + kOffM;
  float* DEC = sm + kOffDec;
  float* BETA = sm + kOffBeta;

  const int W = H * kD;
  const int slot = blockIdx.x / H, h = blockIdx.x % H;
  const int row = rows[3 * slot], start = rows[3 * slot + 1];
  const int len = rows[3 * slot + 2];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const float A = expf(A_log[h]);

  for (int i = tid; i < kD * kD / 4; i += kThreads)
    st4(S + 4 * i, make_float4(0.f, 0.f, 0.f, 0.f));

  for (int c0 = 0; c0 < len; c0 += kC) {
    // 1. conv + SiLU, norms, gates: warp w the positions w + 16 i, lane l
    // the channels 4l .. 4l + 3
    {
      const int d = 4 * lane;
      float cw[3][4][kK];
#pragma unroll
      for (int which = 0; which < 3; ++which)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          load_bf4(conv_w + static_cast<size_t>(which * W + h * kD + d + j)
                   * kK, cw[which][j]);
      float dtb[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) dtb[j] = dt_bias[h * kD + d + j];
      for (int pp = warp; pp < kC; pp += kWarps) {
        const int t = c0 + pp;
        float y[3][4] = {}, g[4] = {}, beta = 0.f;
        if (t < len) {
#pragma unroll
          for (int which = 0; which < 3; ++which) {
            float x[kK][4];
#pragma unroll
            for (int m = 0; m < kK; ++m) {
              if (t - m >= 0) {
                const bf16* src = p + static_cast<size_t>(start + t - m)
                                  * p_stride + which * W + h * kD + d;
#pragma unroll
                for (int j = 0; j < 4; ++j) x[m][j] = bf(src[j]);
              } else {
#pragma unroll
                for (int j = 0; j < 4; ++j) x[m][j] = 0.f;
              }
            }
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              float v = x[0][j] * cw[which][j][kK - 1];
#pragma unroll
              for (int m = 1; m < kK; ++m) v += x[m][j] * cw[which][j][kK - 1 - m];
              y[which][j] = v / (1.f + expf(-v));
            }
          }
          float f[4];
          load_bf4(fg + static_cast<size_t>(start + t) * W + h * kD + d, f);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float z = f[j] + dtb[j];
            const float sp = z > 20.f ? z : log1pf(expf(z));
            g[j] = -A * sp;
          }
          beta = 1.f / (1.f + expf(-bf(p[static_cast<size_t>(start + t)
                                           * p_stride + 3 * W + 2 * kD + h])));
        }
        float sq = 0.f, sk = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          sq += y[0][j] * y[0][j];
          sk += y[1][j] * y[1][j];
        }
        sq = warp_sum(sq);
        sk = warp_sum(sk);
        const float rq = rsqrtf(sq + kL2Eps), rk = rsqrtf(sk + kL2Eps);
        st4(Qb + pp * kRowP + d,
            make_float4(y[0][0] * rq * kQScale, y[0][1] * rq * kQScale,
                        y[0][2] * rq * kQScale, y[0][3] * rq * kQScale));
        st4(Kb + pp * kRowP + d, make_float4(y[1][0] * rk, y[1][1] * rk,
                                             y[1][2] * rk, y[1][3] * rk));
        st4(Vb + pp * kRowP + d,
            make_float4(y[2][0], y[2][1], y[2][2], y[2][3]));
        st4(Gb + pp * kRowP + d, make_float4(g[0], g[1], g[2], g[3]));
        if (lane == 0) BETA[pp] = beta;
      }
    }
    __syncthreads();

    // 2. gc along the chunk, one channel a thread; b_I, e_J, the decay
    if (tid < kD) {
      float run = 0.f;
      for (int pp = 0; pp < kC; ++pp) {
        run += Gb[pp * kRowP + tid];
        Gb[pp * kRowP + tid] = run;
        if (pp % kSub == 0) BV[(pp / kSub) * kD + tid] = run;
        if (pp % kSub == kSub - 1) EV[(pp / kSub) * kD + tid] = run;
      }
      DEC[tid] = expf(run);
    }
    __syncthreads();

    // 3a. the pairs inside each sub-block, exponents taken directly: the
    // 4 x 120 pairs c > j one a thread, the 64 diagonal entries of A (q_c
    // . k_c) two a thread of the last 32
    if (tid < kNSub * kSub * (kSub - 1) / 2) {
      const int I = tid / (kSub * (kSub - 1) / 2);
      const int r = tid % (kSub * (kSub - 1) / 2);
      int cl = 1;
      while ((cl + 1) * cl / 2 <= r) ++cl;
      const int c = I * kSub + cl, j = I * kSub + (r - cl * (cl - 1) / 2);
      float a = 0.f, l = 0.f;
      for (int d = 0; d < kD; d += 4) {
        const float4 qc = ld4(Qb + c * kRowP + d), kc = ld4(Kb + c * kRowP + d);
        const float4 gc = ld4(Gb + c * kRowP + d), kj = ld4(Kb + j * kRowP + d);
        const float4 gj = ld4(Gb + j * kRowP + d);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = at(kj, e) * expf(at(gc, e) - at(gj, e));
          a += at(qc, e) * x;
          l += at(kc, e) * x;
        }
      }
      PK[j * kRowT + c] = a;                // A[c, j] at [j][c]
      PK[c * kRowT + j] = BETA[c] * l;      // M[c, j] at [c][j]
    } else {
      for (int c = tid - kNSub * kSub * (kSub - 1) / 2; c < kC;
           c += kThreads - kNSub * kSub * (kSub - 1) / 2) {
        float a = 0.f;
        for (int d = 0; d < kD; d += 4) {
          const float4 qc = ld4(Qb + c * kRowP + d);
          const float4 kc = ld4(Kb + c * kRowP + d);
          a += qc.x * kc.x;
          a += qc.y * kc.y;
          a += qc.z * kc.z;
          a += qc.w * kc.w;
        }
        PK[c * kRowT + c] = a;
      }
    }
    __syncthreads();

    // 3b. Qr = q exp(gc - b_I), Kr = k exp(gc - b_I), Kc = k exp(e_I - gc)
    // in place (I the position's sub-block); exp(b_I - e_J) for I > J
    for (int i = tid; i < kC * kD / 4; i += kThreads) {
      const int pp = i / (kD / 4), d = 4 * (i % (kD / 4)), I = pp / kSub;
      const float4 q4 = ld4(Qb + pp * kRowP + d), k4 = ld4(Kb + pp * kRowP + d);
      const float4 g4 = ld4(Gb + pp * kRowP + d);
      const float4 b4 = ld4(BV + I * kD + d), e4 = ld4(EV + I * kD + d);
      float qr[4], kr[4], kc[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float eb = expf(at(g4, e) - at(b4, e));
        qr[e] = at(q4, e) * eb;
        kr[e] = at(k4, e) * eb;
        kc[e] = at(k4, e) * expf(at(e4, e) - at(g4, e));
      }
      st4(Qb + pp * kRowP + d, make_float4(qr[0], qr[1], qr[2], qr[3]));
      st4(Kb + pp * kRowP + d, make_float4(kr[0], kr[1], kr[2], kr[3]));
      st4(Gb + pp * kRowP + d, make_float4(kc[0], kc[1], kc[2], kc[3]));
    }
    for (int i = tid; i < 6 * kD; i += kThreads) {
      const int pr = i / kD, d = i % kD;
      const int I = pr < 1 ? 1 : pr < 3 ? 2 : 3, J = pr - I * (I - 1) / 2;
      MV[i] = expf(BV[I * kD + d] - EV[J * kD + d]);
    }
    __syncthreads();

    // 3c. the pairs across sub-blocks I > J: 6 tiles of 16 x 16, a thread
    // 2 x 2 entries of A and of L
    if (tid < 6 * 64) {
      const int pr = tid / 64, sub = tid % 64;
      const int I = pr < 1 ? 1 : pr < 3 ? 2 : 3, J = pr - I * (I - 1) / 2;
      const int c = I * kSub + 2 * (sub / 8), j = J * kSub + 2 * (sub % 8);
      float a[2][2] = {}, l[2][2] = {};
      for (int d = 0; d < kD; d += 4) {
        const float4 m4 = ld4(MV + pr * kD + d);
        const float4 q0 = ld4(Qb + c * kRowP + d);
        const float4 q1 = ld4(Qb + (c + 1) * kRowP + d);
        const float4 k0 = ld4(Kb + c * kRowP + d);
        const float4 k1 = ld4(Kb + (c + 1) * kRowP + d);
        const float4 j0 = ld4(Gb + j * kRowP + d);
        const float4 j1 = ld4(Gb + (j + 1) * kRowP + d);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float m = at(m4, e);
          const float qm[2] = {at(q0, e) * m, at(q1, e) * m};
          const float km[2] = {at(k0, e) * m, at(k1, e) * m};
          const float kj[2] = {at(j0, e), at(j1, e)};
#pragma unroll
          for (int x = 0; x < 2; ++x)
#pragma unroll
            for (int y = 0; y < 2; ++y) {
              a[x][y] += qm[x] * kj[y];
              l[x][y] += km[x] * kj[y];
            }
        }
      }
#pragma unroll
      for (int x = 0; x < 2; ++x)
#pragma unroll
        for (int y = 0; y < 2; ++y) {
          PK[(j + y) * kRowT + c + x] = a[x][y];
          PK[(c + x) * kRowT + j + y] = BETA[c + x] * l[x][y];
        }
    }
    __syncthreads();

    // 4. forward substitution (threads 0-127: w's columns, 128-255: u's)
    // while threads 256-511 stage qg^T and then turn Kc into k_d
    {
      float x[kC];
      if (tid < kD) {
        float eb[kNSub];
#pragma unroll
        for (int I = 0; I < kNSub; ++I) eb[I] = expf(BV[I * kD + tid]);
#pragma unroll
        for (int pp = 0; pp < kC; ++pp)
          x[pp] = BETA[pp] * (Kb[pp * kRowP + tid] * eb[pp / kSub]);
      } else if (tid < 2 * kD) {
#pragma unroll
        for (int pp = 0; pp < kC; ++pp)
          x[pp] = BETA[pp] * Vb[pp * kRowP + tid - kD];
      } else {
        const int k = (tid - 2 * kD) % kD, p0 = ((tid - 2 * kD) / kD) * 32;
        const float e0 = expf(BV[(p0 / kSub) * kD + k]);
        const float e1 = expf(BV[(p0 / kSub + 1) * kD + k]);
#pragma unroll
        for (int i = 0; i < 32; ++i)
          x[i] = Qb[(p0 + i) * kRowP + k] * (i < kSub ? e0 : e1);
      }
      __syncthreads();
      if (tid < 2 * kD) {
#pragma unroll
        for (int pp = 1; pp < kC; ++pp) {
          const float* mrow = PK + pp * kRowT;
          float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int j = 0; j < pp; j += 4) {
            const float4 m4 = ld4(mrow + j);
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (j + e < pp) acc[e] += at(m4, e) * x[j + e];
          }
          x[pp] -= (acc[0] + acc[1]) + (acc[2] + acc[3]);
        }
        if (tid < kD) {
#pragma unroll
          for (int pp = 0; pp < kC; pp += 4)
            st4(Kb + tid * kRowT + pp,
                make_float4(x[pp], x[pp + 1], x[pp + 2], x[pp + 3]));
        } else {
#pragma unroll
          for (int pp = 0; pp < kC; ++pp) Vb[pp * kRowP + tid - kD] = x[pp];
        }
      } else {
        const int k = (tid - 2 * kD) % kD, p0 = ((tid - 2 * kD) / kD) * 32;
#pragma unroll
        for (int i = 0; i < 32; i += 4)
          st4(Qb + k * kRowT + p0 + i,
              make_float4(x[i], x[i + 1], x[i + 2], x[i + 3]));
        for (int i = tid - 2 * kD; i < kC * kD / 4; i += kThreads - 2 * kD) {
          const int pp = i / (kD / 4), d = 4 * (i % (kD / 4));
          const int I = pp / kSub;
          const float4 kc = ld4(Gb + pp * kRowP + d);
          const float4 e4 = ld4(EV + I * kD + d);
          const float4 last = ld4(EV + (kNSub - 1) * kD + d);
          st4(Gb + pp * kRowP + d,
              make_float4(kc.x * expf(last.x - e4.x),
                          kc.y * expf(last.y - e4.y),
                          kc.z * expf(last.z - e4.z),
                          kc.w * expf(last.w - e4.w)));
        }
      }
    }
    __syncthreads();

    // 5a. [w; qg] S: rows 8 rg .. 8 rg + 7 of the 128 stacked rows (w's
    // 64, then qg's), columns 4 cg .. 4 cg + 3
    {
      const int rg = (warp / 4) * 4 + lane / 8, cg = (warp % 4) * 8 + lane % 8;
      const float* X = (rg < 8 ? Kb : Qb) + (rg % 8) * 8;
      float acc[8][4] = {};
#pragma unroll 4
      for (int k = 0; k < kD; ++k) {
        const float4 x0 = ld4(X + k * kRowT), x1 = ld4(X + k * kRowT + 4);
        const float4 s4 = ld4(S + k * kD + 4 * cg);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float xi = i < 4 ? at(x0, i) : at(x1, i - 4);
          acc[i][0] += xi * s4.x;
          acc[i][1] += xi * s4.y;
          acc[i][2] += xi * s4.z;
          acc[i][3] += xi * s4.w;
        }
      }
      const int p0 = (rg % 8) * 8;
      if (rg < 8) {                 // v_new = u - w S, in place of u
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          float* dst = Vb + (p0 + i) * kRowP + 4 * cg;
          const float4 u4 = ld4(dst);
          st4(dst, make_float4(u4.x - acc[i][0], u4.y - acc[i][1],
                               u4.z - acc[i][2], u4.w - acc[i][3]));
        }
      }
      __syncthreads();              // qg^T is read no more
      if (rg >= 8) {
#pragma unroll
        for (int i = 0; i < 8; ++i)
          st4(Qb + (p0 + i) * kRowP + 4 * cg,
              make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]));
      }
    }
    __syncthreads();

    // 5b. o = qg S + A v_new (warp w 4 positions, lane l the columns 4l ..
    // 4l + 3), then S <- diag(decay) S + k_d^T v_new (warp w the key rows
    // 8w .. 8w + 7, lane l the same columns). A v_new's length grows with
    // the position, so the four warps of each scheduler (w, w + 4, w + 8,
    // w + 12) take position groups whose lengths sum alike.
    {
      const int p0 = 4 * warp, c = 4 * lane;
      float acc[4][4] = {};
      for (int j = 0; j <= p0 + 3; ++j) {
        const float4 a4 = ld4(PK + j * kRowT + p0);
        const float4 v4 = ld4(Vb + j * kRowP + c);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float ai = j <= p0 + i ? at(a4, i) : 0.f;
          acc[i][0] += ai * v4.x;
          acc[i][1] += ai * v4.y;
          acc[i][2] += ai * v4.z;
          acc[i][3] += ai * v4.w;
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float* dst = Qb + (p0 + i) * kRowP + c;
        const float4 o4 = ld4(dst);
        st4(dst, make_float4(o4.x + acc[i][0], o4.y + acc[i][1],
                             o4.z + acc[i][2], o4.w + acc[i][3]));
      }

      const int k0 = 8 * warp;
      float s[8][4];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float4 s4 = ld4(S + (k0 + i) * kD + c);
        const float dk = DEC[k0 + i];
        s[i][0] = s4.x * dk;
        s[i][1] = s4.y * dk;
        s[i][2] = s4.z * dk;
        s[i][3] = s4.w * dk;
      }
#pragma unroll 4
      for (int j = 0; j < kC; ++j) {
        const float4 k0v = ld4(Gb + j * kRowP + k0);
        const float4 k1v = ld4(Gb + j * kRowP + k0 + 4);
        const float4 v4 = ld4(Vb + j * kRowP + c);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float ki = i < 4 ? at(k0v, i) : at(k1v, i - 4);
          s[i][0] += ki * v4.x;
          s[i][1] += ki * v4.y;
          s[i][2] += ki * v4.z;
          s[i][3] += ki * v4.w;
        }
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
        st4(S + (k0 + i) * kD + c,
            make_float4(s[i][0], s[i][1], s[i][2], s[i][3]));
    }
    __syncthreads();

    // 6. the gated RMSNorm: warp w the positions w + 16 i, lane l the
    // channels 4l .. 4l + 3
    {
      const int d = 4 * lane;
      float nw[4], gb[4];
      load_bf4(o_norm + d, nw);
      load_bf4(g_bias + h * kD + d, gb);
      for (int pp = warp; pp < kC && c0 + pp < len; pp += kWarps) {
        const float4 o4 = ld4(Qb + pp * kRowP + d);
        const float ss = warp_sum(o4.x * o4.x + o4.y * o4.y + o4.z * o4.z +
                                  o4.w * o4.w);
        const float r = rsqrtf(ss / kD + eps);
        const size_t tok = static_cast<size_t>(start + c0 + pp);
        float gl[4];
        load_bf4(fg + (static_cast<size_t>(N) + tok) * W + h * kD + d, gl);
        float y[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          y[j] = at(o4, j) * r * nw[j] / (1.f + expf(-(gl[j] + gb[j])));
        __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(out + tok * W + h * kD + d);
        dst[0] = __floats2bfloat162_rn(y[0], y[1]);
        dst[1] = __floats2bfloat162_rn(y[2], y[3]);
      }
    }
    __syncthreads();
  }

  // the final state and the last 3 raw inputs (oldest first, 0 before the
  // row's start)
  float* dst = state + (static_cast<size_t>(row) * H + h) * kD * kD;
  for (int i = tid; i < kD * kD / 4; i += kThreads)
    st4(dst + 4 * i, ld4(S + 4 * i));
  for (int i = tid; i < 3 * (kK - 1) * kD; i += kThreads) {
    const int which = i / ((kK - 1) * kD), j = (i / kD) % (kK - 1);
    const int d = i % kD, t = len - (kK - 1) + j;
    const int col = which * W + h * kD + d;
    conv_state[(static_cast<size_t>(row) * (kK - 1) + j) * 3 * W + col] =
        t >= 0 ? p[static_cast<size_t>(start + t) * p_stride + col]
               : __float2bfloat16_rn(0.f);
  }
}

}  // namespace

extern "C" {

// p: [N, 3W + 256 + H] rows p_stride elements apart (in_proj's output: raw
// q, k, v, then f_a, g_a, then beta's logits), fg: [2, N, W] (W_fb's and
// W_gb's outputs), conv_w: [3W, 4], A_log: fp32 [H], dt_bias: fp32 [W],
// g_bias: [W], o_norm: [128], rows: int32 [R, 3] (row, start, length: the
// rows packed in [0, N), listed longest first), state: fp32 [R, H, 128,
// 128] (written), conv_state: [R, 3, 3W] (written, oldest input first),
// out: [N, W]; W = 128 H; bf16 unless stated, dense, 16-byte aligned. The
// Python wrapper checks all of this before it calls.
int kda_prefill_fwd(const void* p, long long p_stride, const void* fg,
                    const void* conv_w, const void* A_log,
                    const void* dt_bias, const void* g_bias,
                    const void* o_norm, float eps, const void* rows,
                    void* state, void* conv_state, void* out, int R, int N,
                    int H, void* stream) {
  static int ready[256] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 256 || !ready[dev]) {
    err = cudaFuncSetAttribute(kda_prefill_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kSmem));
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < 256) ready[dev] = 1;
  }
  kda_prefill_kernel<<<R * H, kThreads, kSmem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(p), p_stride, static_cast<const bf16*>(fg),
      static_cast<const bf16*>(conv_w), static_cast<const float*>(A_log),
      static_cast<const float*>(dt_bias), static_cast<const bf16*>(g_bias),
      static_cast<const bf16*>(o_norm), eps, static_cast<const int*>(rows),
      static_cast<float*>(state), static_cast<bf16*>(conv_state),
      static_cast<bf16*>(out), N, H);
  return static_cast<int>(cudaGetLastError());
}

const char* kda_prefill_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
