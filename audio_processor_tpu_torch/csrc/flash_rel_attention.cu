// Flash attention with the relative-key position bias built inside the
// kernel, for Hopper (sm_90a).
//
// Computes, per (batch b, head h, query row l):
//
//   s[l, m] = (q_l . k_m + s_rel[l, clip(m - l, -left, right) + left]) * scale
//             + (kv_mask[b, m] - 1) * 1e9
//   o[l]    = sum_m exp(s[l, m] - max_m s[l, :]) v_m / max(rowsum, 1e-37)
//
// with s_rel[l, p] = q_l . E[p] (the bucket logits, fp32 accumulation)
// and right = P - 1 - left. The additive -1e9 mask after scaling and the
// 1e-37 floor are kept from the TPU version, so no row produces NaN, not
// even a fully masked one.
//
// Replaces the two Pallas kernels of
// audio_processor_tpu/models/flash_rel_attention.py: `_kernel_onepass`
// (one kv pass with a plain row softmax over a [qb, L] VMEM score tile)
// and `_kernel` (the kv-streaming online-softmax variant). Both compute
// the same function; this kernel computes it once, in the streaming
// form: the onepass layout does not carry over, because a [64, 1280]
// fp32 score tile is 320 KB and a block has at most 227 KB of shared
// memory. The TPU's barrel-shifted rel table (masked `pltpu.roll`s, a
// lane-alignment workaround) is not needed either: each score gathers
// its bias directly from the bucket logits held in shared memory.
//
// Design. One block of 256 threads per (b, h, 64-row q tile). At block
// start the q tile is staged in shared memory (fp32, transposed) and the
// bucket logits s_rel[64, P] are computed there. The block then walks
// the kv axis in 64-column tiles with the fp32 online-softmax m/l/acc
// recurrence. A thread owns a 4x4 patch of the score tile and the same
// rows of a 4x4 patch of the output, so the row max and row sum reduce
// over the 16 lanes of a half warp with shuffles.
//
// What bounds it. At the production geometry (B=48, H=16, L=1280, d=64)
// the two products take 4*B*H*L^2*d = 0.32 TFLOP per layer against about
// 0.5 GB of q/k/v/o traffic: some 640 FLOP per byte, far above the
// card's balance point, so the kernel is compute-bound. This first form
// runs the products as plain fp32 FMA loops over shared memory (about
// 8 FMAs per 16-byte shared load); it does not use the tensor cores yet
// (mma.sync / wgmma with bf16 operands is the next step).
//
// C interface (loaded with ctypes): flash_rel_attention_fwd returns the
// cudaError_t of the launch; 0 means the kernel was launched.

#include "attention_tile.cuh"

namespace {

using namespace attn;

constexpr int kPMax = 128;     // bucket table rows

struct Smem {
  Tiles t;
  float srel[kBQ][kPMax + 1];  // bucket logits s_rel[r][p]
  float kvbias[kBK];           // (kv_mask - 1) * 1e9
};

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
flash_rel_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ e,
                 const float* __restrict__ kv_mask, T* __restrict__ out,
                 int H, int L, int P, int left, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& s = *reinterpret_cast<Smem*>(smem_raw);

  const int tid = threadIdx.x;
  const int tx = tid & 15;     // owns kv columns / output dims tx*4 .. +3
  const int ty = tid >> 4;     // owns q rows ty*4 .. +3
  const int q0 = blockIdx.x * kBQ;
  const int bh = blockIdx.y;   // b * H + h
  const int b = bh / H;
  const size_t base = static_cast<size_t>(bh) * L * kD;
  const int right = P - 1 - left;

  load_transposed(s.t.qt, q + base + static_cast<size_t>(q0) * kD, tid);
  __syncthreads();

  // Bucket logits s_rel[r][p] = q_r . E[p], fp32 accumulation.
  for (int i = tid; i < kBQ * P; i += kThreads) {
    const int r = i % kBQ;
    const int p = i / kBQ;
    const T* ep = e + p * kD;
    float acc = 0.f;
#pragma unroll 16
    for (int d = 0; d < kD; ++d) acc = fmaf(s.t.qt[d][r], to_f32(ep[d]), acc);
    s.srel[r][p] = acc;
  }

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
  const float* maskp = kv_mask + static_cast<size_t>(b) * L;

  for (int k0 = 0; k0 < L; k0 += kBK) {
    // The previous step is done with kt, v, pt and kvbias (and, on the
    // first step, every thread's s_rel writes are visible).
    __syncthreads();
    load_kv(s.t, k + base + static_cast<size_t>(k0) * kD,
            v + base + static_cast<size_t>(k0) * kD, tid);
    if (tid < kBK) s.kvbias[tid] = (maskp[k0 + tid] - 1.0f) * 1e9f;
    __syncthreads();

    float sc[4][4];
    qk_patch(s.t, ty, tx, sc);

    // Relative bias, scale, kv mask; then the online-softmax update.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
      const int l = q0 + r;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx * 4 + j;
        const int dist = min(max(k0 + c - l, -left), right);
        const float x = (sc[i][j] + s.srel[r][dist + left]) * scale
                        + s.kvbias[c];
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
        sc[i][j] = p;
        rs += p;
      }
      rs = half_warp_sum(rs);
      l_i[i] = l_i[i] * alpha + rs;
      m_i[i] = m_new;
#pragma unroll
      for (int j = 0; j < 4; ++j) o[i][j] *= alpha;
    }
    store_p(s.t, ty, tx, sc);
    __syncthreads();
    pv_patch(s.t, ty, tx, o);
  }

  T* op = out + base + static_cast<size_t>(q0) * kD;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float denom = fmaxf(l_i[i], 1e-37f);
    const int r = ty * 4 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      store(op + r * kD + tx * 4 + j, o[i][j] / denom);
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* e, const void* kv_mask, void* out, int B,
                   int H, int L, int P, int left, float scale,
                   cudaStream_t stream) {
  const int smem = static_cast<int>(sizeof(Smem));
  cudaError_t err = cudaFuncSetAttribute(
      flash_rel_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(L / kBQ, B * H);
  flash_rel_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(e),
      static_cast<const float*>(kv_mask), static_cast<T*>(out), H, L, P,
      left, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q, k, v, out: [B, H, L, 64] contiguous, fp32 (is_bf16 = 0) or bf16
// (is_bf16 = 1); e: [P, 64] in the same type; kv_mask: [B, L] fp32 {0,1}.
// L must be a multiple of 64, 1 <= P <= 128, 0 <= left < P. The caller
// (the Python wrapper) checks all of this before it calls.
int flash_rel_attention_fwd(const void* q, const void* k, const void* v,
                            const void* e, const void* kv_mask, void* out,
                            int B, int H, int L, int P, int left,
                            float scale, int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch<__nv_bfloat16>(q, k, v, e, kv_mask, out, B, H, L, P,
                                      left, scale, st)
              : launch<float>(q, k, v, e, kv_mask, out, B, H, L, P, left,
                              scale, st);
  return static_cast<int>(err);
}

const char* flash_rel_attention_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
