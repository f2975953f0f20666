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
// Design of the bf16 instances (the model's): tensor cores, per
// attention_tc.cuh, the layout of flash_rel_attention.cu's bf16 instance:
// one block of one warpgroup per (b, h, 64-row q tile), 64-column kv
// tiles through a 2-stage cp.async ring; S = q . k^T and O += p . v with
// wgmma (bf16 operands, fp32 accumulation), p kept in registers. The
// [64, 64] bias tile rides in the same ring stage as its k and v tiles
// (one coalesced cp.async pass, each bias element read from HBM once) and
// is read from shared memory in the fragment's layout. Scale and log2 e
// are folded into one multiply before an exp2 online softmax.
//
// What bounds it. The products are 4*B*H*L^2*d FLOP (0.32 TFLOP at B=48,
// H=16, L=1280, d=64: 0.33 ms at the 989 TFLOP/s bf16 peak). The bias
// adds 2*L^2 bytes per (b, h) of HBM reads in bf16: 2.52 GB per call at
// that shape, which with 0.5 GB of q/k/v/o is 0.90 ms at 3.35 TB/s. So
// with a bias the kernel is memory-bound, and the ring keeps the next
// tile's bias in flight while the current one computes; without one it is
// compute-bound like flash_rel_attention.cu.
//
// The fp32 instances keep the CUDA-core design of attention_tile.cuh: one
// block of 256 threads per (b, h, 64-row q tile), a 4x4 patch of scores
// per thread, fp32 FMA products, each thread's 4x4 bias patch read from
// HBM into registers before the barrier of the step.
//
// C interface (loaded with ctypes): flash_attention_fwd returns the
// cudaError_t of the launch; 0 means the kernel was launched.

#include "attention_tc.cuh"
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

// The bf16 instances, on tensor cores (attention_tc.cuh). Shared memory:
// the q tile and a ring of kStages kv stages, each a k tile, a v tile and
// (with a bias) the [64, 64] bias tile in AB, all swizzled.
namespace tc {

using namespace attn_tc;
// attn (the fp32 instances') has constants of the same names.
using attn_tc::kBK;
using attn_tc::kBQ;
using attn_tc::kD;
using attn_tc::kThreads;

constexpr int kStages = 2;

template <typename AB, bool kHasBias>
struct Layout {
  static constexpr int kAbRowBytes = kBK * static_cast<int>(sizeof(AB));
  static constexpr int kStageBytes =
      2 * kTileBytes + (kHasBias ? kBQ * kAbRowBytes : 0);
  static constexpr int kSmemBytes = 1024 + kTileBytes + kStages * kStageBytes;
};

// The two bias values of row r, columns col and col + 1, of a swizzled
// bias tile, in fp32.
__device__ __forceinline__ float2 bias_pair(const unsigned char* t, int r,
                                            int col, __nv_bfloat16) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
      t + swz<kBK * 2>(r, col * 2)));
}
__device__ __forceinline__ float2 bias_pair(const unsigned char* t, int r,
                                            int col, float) {
  return *reinterpret_cast<const float2*>(t + swz<kBK * 4>(r, col * 4));
}

template <typename AB, bool kHasBias>
__global__ void __launch_bounds__(kThreads, 3)
flash_attention_kernel_tc(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          const AB* __restrict__ ab,
                          __nv_bfloat16* __restrict__ out, int L,
                          float scale) {
  using Lay = Layout<AB, kHasBias>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* const smem = align1024(smem_raw);
  unsigned char* const qs = smem;
  unsigned char* const ring = smem + kTileBytes;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int c2 = (lane & 3) * 2;
  const int row0 = (tid >> 5) * 16;    // the warp's first row in the tile
  const int q0 = blockIdx.x * kBQ;
  const size_t bh = blockIdx.y;        // b * H + h
  const size_t base = bh * L * kD;
  const int n_tiles = L / kBK;
  const auto* kb = reinterpret_cast<const unsigned char*>(k + base);
  const auto* vb = reinterpret_cast<const unsigned char*>(v + base);
  // The block's bias rows: ab[b, h, q0 .. q0 + 63, :].
  const auto* abb = reinterpret_cast<const unsigned char*>(
      ab + (bh * L + q0) * static_cast<size_t>(L));
  const size_t ab_stride = static_cast<size_t>(L) * sizeof(AB);

  auto load_tile = [&](int j) {
    if (j < n_tiles) {
      unsigned char* st = ring + (j % kStages) * Lay::kStageBytes;
      copy_tile_async<128>(st, kb + static_cast<size_t>(j) * kTileBytes, 128,
                           tid);
      copy_tile_async<128>(st + kTileBytes,
                           vb + static_cast<size_t>(j) * kTileBytes, 128,
                           tid);
      if constexpr (kHasBias)
        copy_tile_async<Lay::kAbRowBytes>(
            st + 2 * kTileBytes, abb + static_cast<size_t>(j) * Lay::kAbRowBytes,
            ab_stride, tid);
    }
    cp_async_commit();
  };
  copy_tile_async<128>(
      qs, reinterpret_cast<const unsigned char*>(q + base + q0 * kD), 128,
      tid);
  cp_async_commit();
#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) load_tile(j);
  cp_async_wait<kStages - 1>();        // the q tile
  fence_async_shared();
  __syncthreads();

  const float c = scale * kLog2e;      // scores in the log2 domain
  float o[8][4] = {};
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};

  for (int j = 0; j < n_tiles; ++j) {
    cp_async_wait<kStages - 2>();      // tile j (this thread's copies)
    fence_async_shared();
    __syncthreads();                   // everyone's; stage j - 1 is free
    load_tile(j + kStages - 1);
    const unsigned char* st = ring + (j % kStages) * Lay::kStageBytes;

    float t[8][4];
    qk_tile(qs, st, t);
    if constexpr (kHasBias) {
      const unsigned char* abt = st + 2 * kTileBytes;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const float2 b0 = bias_pair(abt, row0 + g, n * 8 + c2, AB());
        const float2 b1 = bias_pair(abt, row0 + g + 8, n * 8 + c2, AB());
        t[n][0] += b0.x;
        t[n][1] += b0.y;
        t[n][2] += b1.x;
        t[n][3] += b1.y;
      }
    }
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) t[n][i] *= c;

    uint32_t pf[4][4];
    softmax_step<false>(t, m, l, o, pf);   // the row sum of the fp32 p
    pv_tile(st + kTileBytes, pf, o);
  }

  float denom[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float s = quad_sum(l[h]);
    denom[h] = s == 0.f ? 1.f : s;
  }
  store_o(out + base + static_cast<size_t>(q0) * kD, row0, lane, o, denom);
}

template <typename AB, bool kHasBias>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* ab, void* out, int B, int H, int L,
                   float scale, cudaStream_t stream) {
  auto kernel = flash_attention_kernel_tc<AB, kHasBias>;
  const int smem = Layout<AB, kHasBias>::kSmemBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(L / kBQ, B * H);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const AB*>(ab),
      static_cast<__nv_bfloat16*>(out), L, scale);
  return cudaGetLastError();
}

}  // namespace tc

template <typename T, typename AB, bool kHasBias>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* ab, void* out, int B, int H, int L,
                   float scale, cudaStream_t stream) {
  if constexpr (sizeof(T) == 2) {
    return tc::launch<AB, kHasBias>(q, k, v, ab, out, B, H, L, scale, stream);
  } else {
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
