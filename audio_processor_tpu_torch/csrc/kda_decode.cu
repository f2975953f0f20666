// One decode step of Kimi Delta Attention (KDA, models/kda.py: the gated
// delta-rule linear attention of Kimi-Linear-48B-A3B) between its
// projections, for Hopper (sm_90a): one launch a layer, one block per
// (head, row).
//
// A block reads its head's 3 x 128 raw q, k, v (in_proj's output), their
// last 3 inputs (the conv state) and the 4-tap depthwise kernels, and
//   1. shifts the conv state in place, applies the conv and SiLU in fp32;
//   2. L2-normalises q and k (x / sqrt(sum x^2 + 1e-6)), q times 128^-1/2;
//   3. computes the per-channel decay a = exp(-exp(A_log[h]) *
//      softplus(f + dt_bias)) of its 128 key channels and beta =
//      sigmoid(b[h]);
//   4. updates the fp32 state S [128 k, 128 v] in place in one read and one
//      write: with S' = diag(a) S, pred = S'^T k and qa = S'^T q are summed
//      in the same pass, u = beta (v - pred), the block writes S' + k u^T
//      and the output o = S'^T q + (q . k) u (= S_new^T q);
//   5. writes RMSNorm(o) * w_norm * sigmoid(gate + g_bias) in bf16 (fp32
//      statistics, eps given).
//
// Replaces no TPU kernel: the JAX package has no LM. It replaces, per KDA
// layer of each decode step's CUDA graph, the plain twin's ~20 launches
// (models/kda.py::kda_decode_plain: the conv's concatenation, products and
// sum, the state shift, two norms, the gate's softplus and exps, beta, two
// state passes, the products with q and k, the gated norm).
//
// What bounds it: bytes. A block moves its head's state twice (64 KB read,
// 64 KB written, fp32) and ~2 KB of inputs; at 8 rows x 32 heads a layer
// moves 33.6 MB, ~10 us at 3.35 TB/s. The arithmetic is ~6 FLOP per state
// element read, far below what the CUDA cores sustain at that bandwidth,
// so the state pass runs on the CUDA cores: thread t holds 16 key rows x 4
// value columns of S in registers (warp w the rows 16w .. 16w + 15, lane l
// the columns 4l .. 4l + 3, so each row of a warp's load is one 512-byte
// line); the column sums over the 8 warps meet in shared memory.
//
// C interface (loaded with ctypes): kda_decode_fwd returns the cudaError_t
// of its launch; 0 means the kernel was launched.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kD = 128;                 // d_k = d_v
constexpr int kK = 4;                   // the conv's taps
constexpr int kThreads = 256;           // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kRows = kD / kWarps;      // 16 key rows a warp
constexpr float kL2Eps = 1e-6f;

__device__ __forceinline__ float bf(bf16 x) { return __bfloat162float(x); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(kThreads)
kda_decode_kernel(const bf16* __restrict__ p, long long p_stride,
                  const bf16* __restrict__ fg, const bf16* __restrict__ conv_w,
                  const float* __restrict__ A_log,
                  const float* __restrict__ dt_bias,
                  const bf16* __restrict__ g_bias,
                  const bf16* __restrict__ o_norm, float eps,
                  float* __restrict__ state, bf16* __restrict__ conv_state,
                  bf16* __restrict__ out, int R, int H) {
  __shared__ float qs[kD], ks[kD], vs[kD], as[kD], us[kD];
  __shared__ float red_p[kWarps][kD], red_q[kWarps][kD];
  __shared__ float sums[3][kWarps];
  const int h = blockIdx.x, r = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int W = H * kD;
  const bf16* pr = p + static_cast<size_t>(r) * p_stride;

  // 1. conv + SiLU of the head's q, k, v channels; the conv state shifted
  for (int i = tid; i < 3 * kD; i += kThreads) {
    const int which = i / kD, c = i % kD;
    const int col = which * W + h * kD + c;
    bf16* cs = conv_state + static_cast<size_t>(r) * (kK - 1) * 3 * W + col;
    const bf16 x_new = pr[col];
    const bf16 s0 = cs[0], s1 = cs[3 * W], s2 = cs[6 * W];
    const bf16* w = conv_w + static_cast<size_t>(col) * kK;
    float y = bf(w[0]) * bf(s0);
    y += bf(w[1]) * bf(s1);
    y += bf(w[2]) * bf(s2);
    y += bf(w[3]) * bf(x_new);
    cs[0] = s1;
    cs[3 * W] = s2;
    cs[6 * W] = x_new;
    y = y / (1.f + expf(-y));
    (which == 0 ? qs : which == 1 ? ks : vs)[c] = y;
  }
  // 3. the decay of the head's key channels
  const float A = expf(A_log[h]);
  for (int c = tid; c < kD; c += kThreads) {
    const int col = h * kD + c;
    const float f = bf(fg[static_cast<size_t>(r) * W + col]) + dt_bias[col];
    const float sp = f > 20.f ? f : log1pf(expf(f));
    as[c] = expf(-A * sp);
  }
  const float beta = 1.f / (1.f + expf(-bf(pr[3 * W + 2 * kD + h])));
  __syncthreads();

  // 2. the norms of q and k, and q . k after them
  {
    float sq = 0.f, sk = 0.f;
    for (int c = tid; c < kD; c += kThreads) {
      sq += qs[c] * qs[c];
      sk += ks[c] * ks[c];
    }
    sq = warp_sum(sq);
    sk = warp_sum(sk);
    if (lane == 0) {
      sums[0][warp] = sq;
      sums[1][warp] = sk;
    }
  }
  __syncthreads();
  float nq = 0.f, nk = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    nq += sums[0][w];
    nk += sums[1][w];
  }
  const float rq = rsqrtf(nq + kL2Eps) * rsqrtf(static_cast<float>(kD));
  const float rk = rsqrtf(nk + kL2Eps);
  __syncthreads();
  for (int c = tid; c < kD; c += kThreads) {
    qs[c] *= rq;
    ks[c] *= rk;
  }
  __syncthreads();
  float qk = 0.f;
  for (int c = tid; c < kD; c += kThreads) qk += qs[c] * ks[c];
  qk = warp_sum(qk);
  if (lane == 0) sums[2][warp] = qk;

  // 4. the state pass: rows 16 * warp + i, columns 4 * lane + j
  float4* S = reinterpret_cast<float4*>(
      state + (static_cast<size_t>(r) * H + h) * kD * kD);
  const int row0 = warp * kRows;
  float4 s[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) s[i] = S[(row0 + i) * (kD / 4) + lane];
  float4 pp = make_float4(0.f, 0.f, 0.f, 0.f), pq = pp;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const float a = as[row0 + i], kk = ks[row0 + i], qq = qs[row0 + i];
    s[i].x *= a;
    s[i].y *= a;
    s[i].z *= a;
    s[i].w *= a;
    pp.x += kk * s[i].x;
    pp.y += kk * s[i].y;
    pp.z += kk * s[i].z;
    pp.w += kk * s[i].w;
    pq.x += qq * s[i].x;
    pq.y += qq * s[i].y;
    pq.z += qq * s[i].z;
    pq.w += qq * s[i].w;
  }
  reinterpret_cast<float4*>(red_p[warp])[lane] = pp;
  reinterpret_cast<float4*>(red_q[warp])[lane] = pq;
  __syncthreads();
  float o = 0.f;
  if (tid < kD) {
    float pred = 0.f, qa = 0.f, dot = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      pred += red_p[w][tid];
      qa += red_q[w][tid];
      dot += sums[2][w];
    }
    const float u = beta * (vs[tid] - pred);
    us[tid] = u;
    o = qa + dot * u;
  }
  __syncthreads();
  const float4 u4 = reinterpret_cast<const float4*>(us)[lane];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const float kk = ks[row0 + i];
    s[i].x += kk * u4.x;
    s[i].y += kk * u4.y;
    s[i].z += kk * u4.z;
    s[i].w += kk * u4.w;
    S[(row0 + i) * (kD / 4) + lane] = s[i];
  }

  // 5. the gated RMSNorm of o (threads 0 .. 127 hold one value each)
  float so = warp_sum(tid < kD ? o * o : 0.f);
  if (lane == 0) sums[0][warp] = so;
  __syncthreads();
  if (tid < kD) {
    float tot = 0.f;
#pragma unroll
    for (int w = 0; w < kD / 32; ++w) tot += sums[0][w];
    const int col = h * kD + tid;
    const float gl = bf(fg[static_cast<size_t>(R + r) * W + col]) +
                     bf(g_bias[col]);
    const float y = o * rsqrtf(tot / kD + eps) * bf(o_norm[tid]) /
                    (1.f + expf(-gl));
    out[static_cast<size_t>(r) * W + col] = __float2bfloat16_rn(y);
  }
}

}  // namespace

extern "C" {

// p: [R, 3W + 256 + H] rows p_stride elements apart (in_proj's output: raw
// q, k, v, then f_a, g_a, then beta's logits), fg: [2, R, W] (W_fb's and
// W_gb's outputs), conv_w: [3W, 4], A_log: fp32 [H], dt_bias: fp32 [W],
// g_bias: [W], o_norm: [128], state: fp32 [R, H, 128, 128] (in place),
// conv_state: [R, 3, 3W] (in place, oldest input first), out: [R, W]; W =
// 128 H; bf16 unless stated, dense, 16-byte aligned. The Python wrapper
// checks all of this before it calls.
int kda_decode_fwd(const void* p, long long p_stride, const void* fg,
                   const void* conv_w, const void* A_log, const void* dt_bias,
                   const void* g_bias, const void* o_norm, float eps,
                   void* state, void* conv_state, void* out, int R, int H,
                   void* stream) {
  kda_decode_kernel<<<dim3(H, R), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(p), p_stride, static_cast<const bf16*>(fg),
      static_cast<const bf16*>(conv_w), static_cast<const float*>(A_log),
      static_cast<const float*>(dt_bias), static_cast<const bf16*>(g_bias),
      static_cast<const bf16*>(o_norm), eps, static_cast<float*>(state),
      static_cast<bf16*>(conv_state), static_cast<bf16*>(out), R, H);
  return static_cast<int>(cudaGetLastError());
}

const char* kda_decode_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
