// Flash attention with an optional materialised additive bias, for
// Hopper (sm_90a).
//
// Computes, per (batch b, head h, query row l):
//
//   s[l, m] = (q_l . k_m + ab[b, h, l, m]) * scale      (fp32; ab optional)
//   o[l]    = sum_m T(p[l, m]) v_m / sum_m p[l, m],  p = exp(s - max_m s)
//
// with T(p) the probabilities rounded to v's type before the p.v
// product, the row sum taken over the fp32 p, and a row whose sum is 0
// written as 0 (the guard of the stock kernel). No mask input: a padded
// kv position comes in as a large negative entry of ab.
//
// Replaces the stock Pallas TPU kernel
// jax.experimental.pallas.ops.tpu.flash_attention, which the reference
// calls with a materialised [B, H, L, L] bf16 bias at
// audio_processor_tpu/models/wav2vec2bert.py:276 (attention_impl "flash")
// and without one in tools/profile_kernel_parts.py:416 and
// tools/profile_attn_micro.py:83. The TPU kernel holds a [block_q,
// block_k] score tile in VMEM and carries m/l/acc in scratch across
// sequential kv grid steps; here a block loops over kv itself.
//
// Design: the layout of flash_rel_attention.cu (attention_tile.cuh): one
// block of 256 threads per (b, h, 64-row q tile), 64-column kv steps, an
// fp32 online softmax. Where that kernel gathers its bias from bucket
// logits in shared memory, this one reads the thread's 4x4 patch of the
// bias tile straight from HBM into registers (one 8- or 16-byte load per
// row), issued before the barrier of the step so that the load overlaps
// the k/v staging. Each bias element is read exactly once.
//
// What bounds it. The products are 4*B*H*L^2*d FLOP (0.32 TFLOP at B=48,
// H=16, L=1280, d=64) on CUDA cores as fp32 FMA; the bias adds 2*L^2
// bytes per (b, h) of HBM reads (2.5 GB per call at that shape in bf16,
// about 0.75 ms at 3.35 TB/s), far below the FMA time, so the kernel is
// compute-bound like flash_rel_attention.cu. Tensor cores (mma.sync /
// wgmma) are the next step for both.
//
// C interface (loaded with ctypes): flash_attention_fwd returns the
// cudaError_t of the launch; 0 means the kernel was launched.

#include "attention_tile.cuh"

namespace {

using namespace attn;

template <typename T, typename AB, bool kHasBias>
__global__ void __launch_bounds__(kThreads, 2)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const AB* __restrict__ ab,
                       T* __restrict__ out, int L, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Tiles& s = *reinterpret_cast<Tiles*>(smem_raw);

  const int tid = threadIdx.x;
  const int tx = tid & 15;     // owns kv columns / output dims tx*4 .. +3
  const int ty = tid >> 4;     // owns q rows ty*4 .. +3
  const int q0 = blockIdx.x * kBQ;
  const size_t bh = blockIdx.y;  // b * H + h
  const size_t base = bh * L * kD;

  load_transposed(s.qt, q + base + static_cast<size_t>(q0) * kD, tid);

  // The thread's first bias row: ab[b, h, q0 + ty*4, tx*4].
  const AB* abp = nullptr;
  if constexpr (kHasBias)
    abp = ab + (bh * L + q0 + ty * 4) * static_cast<size_t>(L) + tx * 4;

  float o[4][4];
  float m_i[4];
  float l_i[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_i[i] = -INFINITY;
    l_i[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) o[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < L; k0 += kBK) {
    float bias[4][4];
    if constexpr (kHasBias) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        load4(abp + static_cast<size_t>(i) * L + k0, bias[i]);
    }
    // The previous step is done with kt, v and pt (and, on the first
    // step, the q tile is staged).
    __syncthreads();
    load_kv(s, k + base + static_cast<size_t>(k0) * kD,
            v + base + static_cast<size_t>(k0) * kD, tid);
    __syncthreads();

    float sc[4][4];
    qk_patch(s, ty, tx, sc);

    // Bias, scale; then the online-softmax update.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float x = sc[i][j];
        if constexpr (kHasBias) x += bias[i][j];
        x *= scale;
        sc[i][j] = x;
        mx = fmaxf(mx, x);
      }
      mx = half_warp_max(mx);
      const float m_new = fmaxf(m_i[i], mx);
      const float alpha = expf(m_i[i] - m_new);   // 0 on the first step
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(sc[i][j] - m_new);
        rs += p;                                  // row sum of fp32 p
        sc[i][j] = round_to<T>(p);                // p.v sees T(p)
      }
      l_i[i] = l_i[i] * alpha + half_warp_sum(rs);
      m_i[i] = m_new;
#pragma unroll
      for (int j = 0; j < 4; ++j) o[i][j] *= alpha;
    }
    store_p(s, ty, tx, sc);
    __syncthreads();
    pv_patch(s, ty, tx, o);
  }

  T* op = out + base + static_cast<size_t>(q0) * kD;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float denom = l_i[i] == 0.f ? 1.f : l_i[i];
    const int r = ty * 4 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      store(op + r * kD + tx * 4 + j, o[i][j] / denom);
  }
}

template <typename T, typename AB, bool kHasBias>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* ab, void* out, int B, int H, int L,
                   float scale, cudaStream_t stream) {
  auto kernel = flash_attention_kernel<T, AB, kHasBias>;
  const int smem = static_cast<int>(sizeof(Tiles));
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(L / kBQ, B * H);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const AB*>(ab),
      static_cast<T*>(out), L, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_typed(const void* q, const void* k, const void* v,
                         const void* ab, int ab_kind, void* out, int B,
                         int H, int L, float scale, cudaStream_t stream) {
  switch (ab_kind) {
    case 0:
      return launch<T, float, false>(q, k, v, ab, out, B, H, L, scale,
                                     stream);
    case 1:
      return launch<T, __nv_bfloat16, true>(q, k, v, ab, out, B, H, L,
                                            scale, stream);
    case 2:
      return launch<T, float, true>(q, k, v, ab, out, B, H, L, scale,
                                    stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q, k, v, out: [B, H, L, 64] contiguous, fp32 (is_bf16 = 0) or bf16
// (is_bf16 = 1). ab: [B, H, L, L] contiguous, absent (ab_kind 0, ab may
// be null), bf16 (ab_kind 1) or fp32 (ab_kind 2), 16-byte aligned. L must
// be a multiple of 64. The caller (the Python wrapper) checks all of this
// before it calls.
int flash_attention_fwd(const void* q, const void* k, const void* v,
                        const void* ab, int ab_kind, void* out, int B, int H,
                        int L, float scale, int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch_typed<__nv_bfloat16>(q, k, v, ab, ab_kind, out, B, H,
                                            L, scale, st)
              : launch_typed<float>(q, k, v, ab, ab_kind, out, B, H, L,
                                    scale, st);
  return static_cast<int>(err);
}

const char* flash_attention_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
