// The flash-rel ablation kernels, for Hopper (sm_90a): flash attention
// from a precomputed bucket-logit table, with parts switched off at
// compile time so that their cost can be read from the difference.
//
// Replaces the three Pallas kernels of tools/profile_kernel_parts.py:
// `_kernel_variant` (:37, modes full, noselect, norel, nomax, nosoftmax,
// noexp), `_kb640_kernel` (:181) and `_bare_kernel` (:134). Each mode
// computes the formula of its TPU kernel (with the tool's 256-wide
// wrapped table, the width it was written for), wrong-by-design ones
// included; models/flash_rel_parts.py holds the plain twins. Per (b, h,
// query row l), over kv steps of kStep columns:
//
//   s[l, m] = (q_l . k_m + rel[l, m]) * scale + (kv_mask[b, m] - 1) * 1e9
//     rel = s_rel[l, clip(m - l, -left, right) + left]     (kSat)
//         = u[l, (m - l + left) mod 256], u = [s_rel | 0]   (kWrap)
//         = 0                                              (kNone)
//     the mask term only when kMasked (the bare kernel has none);
//   per step:  online:    m' = max(m, max_step s), p = exp(s - m'),
//                         alpha = exp(m - m')
//              noexp:     the same with exp(x) replaced by x * 0.5
//                         (NaN by design: the first alpha is -inf, and
//                         -inf * 0 starts l and o at NaN)
//              nomax:     p = exp(s), alpha = 1
//              nosoftmax: p = s, alpha = 1 (inf by design where the row
//                         sum is not positive: o / 1e-37)
//              l = alpha * l + rowsum(p),  o = alpha * o + bf16(p) . v
//   rowsum: "ones" sums bf16(p) (the TPU kernels get it from a ones
//   column appended to v), "reduce" sums the fp32 p;
//   o[l] = o / max(l, 1e-37)   (NaN stays NaN).
//
// Design: the layout of flash_rel_attention.cu (attention_tile.cuh),
// one block of 256 threads per (b, h, 64-row q tile), with the kv step
// as a template parameter: a step of kStep columns is kStep / 64 score
// tiles kept in registers (64 or 160 floats a thread), so the running
// max and the rescale run once per step, as the TPU kernel's m/l
// recurrence does once per grid step. The TPU kernels barrel-shift a
// wrapped table and select the saturated columns against a distance
// grid because Mosaic has no lane gather; here each score reads its
// bucket logit from the 64 x 128 s_rel tile in shared memory by index.
//
// What bounds it: the same 4*B*H*L^2*d FLOP of fp32 FMA as
// flash_rel_attention.cu (compute-bound on CUDA cores); the s_rel input
// adds 512 bytes per query row of HBM reads. kStep = 640 holds 160 score
// registers a thread and runs one block per SM.
//
// C interface (loaded with ctypes): flash_rel_parts_fwd returns the
// cudaError_t of the launch; 0 means the kernel was launched.

#include "attention_tile.cuh"

namespace {

using namespace attn;
using bf16 = __nv_bfloat16;

enum Bias { kNone, kSat, kWrap };
enum Softmax { kOnline, kNoMax, kNoSoftmax, kNoExp };

constexpr int kTable = 128;  // s_rel columns
constexpr int kWrapW = 256;  // wrapped table width of kWrap

struct Smem {
  Tiles t;
  float srel[kBQ][kTable + 1];  // s_rel rows of the q tile
  float kvbias[kBK];            // (kv_mask - 1) * 1e9 of the kv tile
};

template <int kBias, int kSoft, int kStep, bool kOnes, bool kMasked>
__global__ void __launch_bounds__(kThreads, kStep > 256 ? 1 : 2)
parts_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
             const bf16* __restrict__ v, const float* __restrict__ s_rel,
             const float* __restrict__ kv_mask, bf16* __restrict__ out,
             int H, int L, int P, int left, float scale) {
  constexpr int kSubs = kStep / kBK;
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
  if constexpr (kBias != kNone) {
    const float* sp = s_rel + (static_cast<size_t>(bh) * L + q0) * kTable;
    for (int i = tid; i < kBQ * kTable; i += kThreads)
      s.srel[i / kTable][i % kTable] = sp[i];
  }
  const float* maskp =
      kMasked ? kv_mask + static_cast<size_t>(b) * L : nullptr;

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

  for (int st = 0; st < L; st += kStep) {
    // Scores of the whole step, one 64-column tile at a time.
    float sc[kSubs][4][4];
#pragma unroll
    for (int sub = 0; sub < kSubs; ++sub) {
      const int k0 = st + sub * kBK;
      __syncthreads();   // every thread is done with kt, kvbias, pt, v
      load_transposed(s.t.kt, k + base + static_cast<size_t>(k0) * kD, tid);
      if (kMasked && tid < kBK)
        s.kvbias[tid] = (maskp[k0 + tid] - 1.0f) * 1e9f;
      __syncthreads();
      qk_patch(s.t, ty, tx, sc[sub]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty * 4 + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tx * 4 + j;
          const int dist = k0 + c - (q0 + r);    // m - l
          float x = sc[sub][i][j];
          if constexpr (kBias == kSat) {
            x += s.srel[r][min(max(dist, -left), right) + left];
          } else if constexpr (kBias == kWrap) {
            const int w = (dist + left) & (kWrapW - 1);
            x += w < kTable ? s.srel[r][w] : 0.f;
          }
          x *= scale;
          if constexpr (kMasked) x += s.kvbias[c];
          sc[sub][i][j] = x;
        }
      }
    }

    // The step's softmax update; sc becomes bf16(p).
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float alpha = 1.f;
      float m_new = 0.f;
      if constexpr (kSoft == kOnline || kSoft == kNoExp) {
        float mx = -INFINITY;
#pragma unroll
        for (int sub = 0; sub < kSubs; ++sub)
#pragma unroll
          for (int j = 0; j < 4; ++j) mx = fmaxf(mx, sc[sub][i][j]);
        m_new = fmaxf(m_i[i], half_warp_max(mx));
        alpha = kSoft == kOnline ? expf(m_i[i] - m_new)
                                 : (m_i[i] - m_new) * 0.5f;
        m_i[i] = m_new;
      }
      float rs = 0.f;
#pragma unroll
      for (int sub = 0; sub < kSubs; ++sub)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float x = sc[sub][i][j];
          float p;
          if constexpr (kSoft == kOnline) p = expf(x - m_new);
          else if constexpr (kSoft == kNoExp) p = (x - m_new) * 0.5f;
          else if constexpr (kSoft == kNoMax) p = expf(x);
          else p = x;
          const float pr = round_to<bf16>(p);
          rs += kOnes ? pr : p;
          sc[sub][i][j] = pr;
        }
      l_i[i] = alpha * l_i[i] + half_warp_sum(rs);
#pragma unroll
      for (int j = 0; j < 4; ++j) o[i][j] *= alpha;
    }

    // o += bf16(p) . v, one 64-column tile at a time.
#pragma unroll
    for (int sub = 0; sub < kSubs; ++sub) {
      __syncthreads();   // every thread is done with kt, pt and v
      store_p(s.t, ty, tx, sc[sub]);
      load_v(s.t, v + base + static_cast<size_t>(st + sub * kBK) * kD, tid);
      __syncthreads();
      pv_patch(s.t, ty, tx, o);
    }
  }

  bf16* op = out + base + static_cast<size_t>(q0) * kD;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float l = l_i[i];
    const float denom = (l != l || l > 1e-37f) ? l : 1e-37f;
    const int r = ty * 4 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      store(op + r * kD + tx * 4 + j, o[i][j] / denom);
  }
}

template <int kBias, int kSoft, int kStep, bool kOnes, bool kMasked>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* s_rel, const void* kv_mask, void* out, int B,
                   int H, int L, int P, int left, float scale,
                   cudaStream_t stream) {
  auto kernel = parts_kernel<kBias, kSoft, kStep, kOnes, kMasked>;
  const int smem = static_cast<int>(sizeof(Smem));
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(L / kBQ, B * H);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const float*>(s_rel),
      static_cast<const float*>(kv_mask), static_cast<bf16*>(out), H, L, P,
      left, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q, k, v, out: [B, H, L, 64] contiguous bf16; s_rel: [B, H, L, 128]
// fp32 (read by configs 0, 1, 6); kv_mask: [B, L] fp32 {0, 1} (read by
// configs 0-6). config: 0 full, 1 noselect, 2 norel, 3 nomax,
// 4 nosoftmax, 5 noexp (256-column steps, ones row sum, masked), 6 kb640
// (full with 640-column steps), 7 bare ones, 8 bare reduce (no bias, no
// mask). L must be a multiple of the step, 1 <= P <= 128, 0 <= left < P.
// The caller (the Python wrapper) checks all of this before it calls.
int flash_rel_parts_fwd(const void* q, const void* k, const void* v,
                        const void* s_rel, const void* kv_mask, void* out,
                        int B, int H, int L, int P, int left, float scale,
                        int config, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PARTS_LAUNCH(...)                                                  \
  launch<__VA_ARGS__>(q, k, v, s_rel, kv_mask, out, B, H, L, P, left,     \
                      scale, st)
  cudaError_t err;
  switch (config) {
    case 0: err = PARTS_LAUNCH(kSat, kOnline, 256, true, true); break;
    case 1: err = PARTS_LAUNCH(kWrap, kOnline, 256, true, true); break;
    case 2: err = PARTS_LAUNCH(kNone, kOnline, 256, true, true); break;
    case 3: err = PARTS_LAUNCH(kNone, kNoMax, 256, true, true); break;
    case 4: err = PARTS_LAUNCH(kNone, kNoSoftmax, 256, true, true); break;
    case 5: err = PARTS_LAUNCH(kNone, kNoExp, 256, true, true); break;
    case 6: err = PARTS_LAUNCH(kSat, kOnline, 640, true, true); break;
    case 7: err = PARTS_LAUNCH(kNone, kOnline, 256, true, false); break;
    case 8: err = PARTS_LAUNCH(kNone, kOnline, 256, false, false); break;
    default: err = cudaErrorInvalidValue;
  }
#undef PARTS_LAUNCH
  return static_cast<int>(err);
}

const char* flash_rel_parts_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
