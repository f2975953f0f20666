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
// Design of the bf16 instance (the main path's): tensor cores, per
// attention_tc.cuh. One block of one warpgroup per (b, h, 64-row q
// tile); the kv axis streams in 64-column tiles through a 2-stage
// cp.async ring of swizzled bf16 shared-memory tiles. At block start each
// warp computes its 16 rows' bucket logits s_rel[16, P] = q . E^T with
// mma.sync (bf16 E read straight from global memory as the B fragment,
// fp32 accumulation, as the TPU kernels' MXU dot) into shared memory.
// Per kv tile: S = q . k^T with wgmma (q and k from shared memory); the
// relative bias by tile class (a warp's tile wholly left or right of the
// band -left <= m - l <= right adds one saturated value per row,
// s_rel[r][0] or s_rel[r][P-1]; only a tile that meets the band gathers
// per element: 3 of 20 tiles of a row at L = 1280, left = 64, right = 8);
// scale, log2 e and the -1e9 mask folded into one FMA; an online softmax
// in registers (exp2, row max and sum over the four lanes of a quad); p
// rounded to bf16 and packed straight into the register A operand of
// O += p . v (wgmma, v transposed from shared memory). As in both TPU
// kernels, the row sum adds the bf16-rounded p.
//
// What bounds it. At the production geometry (B=48, H=16, L=1280, d=64)
// the two products take 4*B*H*L^2*d = 0.32 TFLOP per layer (0.33 ms at
// the 989 TFLOP/s bf16 peak) against about 0.5 GB of q/k/v/o traffic
// (0.15 ms): compute-bound. The B*H*L^2 = 1.26e9 exponentials need about
// 0.3 ms on the SFUs, a second limit close to the first: this kernel
// runs the products and the softmax of a tile one after the other, so it
// does not overlap the two (ROADMAP, Queue 2).
//
// The fp32 instance keeps the CUDA-core design of attention_tile.cuh: one
// block of 256 threads per (b, h, 64-row q tile), fp32 tiles in shared
// memory, a 4x4 patch of scores per thread, fp32 FMA products, the fp32 p
// summed; its bias gathered per element from s_rel in shared memory.
//
// C interface (loaded with ctypes): flash_rel_attention_fwd returns the
// cudaError_t of the launch; 0 means the kernel was launched.

#include "attention_tc.cuh"
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

// The bf16 instance, on tensor cores (attention_tc.cuh). Shared memory:
// the q tile, a ring of kStages kv stages (k tile, v tile, 64 mask
// values) and the bucket logits s_rel[64][P rounded up to 8, + 4] in fp32.
namespace tc {

using namespace attn_tc;
// attn (the fp32 instance's) has constants of the same names.
using attn_tc::kBK;
using attn_tc::kBQ;
using attn_tc::kD;
using attn_tc::kThreads;

constexpr int kStages = 2;
// k tile, v tile, 64 mask values; stages stay 1024-byte aligned.
constexpr int kStageBytes = 2 * kTileBytes + 1024;

__host__ __device__ constexpr int srel_stride(int P) {
  return ((P + 7) & ~7) + 4;
}
constexpr int smem_bytes(int P) {
  return 1024 + kTileBytes + kStages * kStageBytes + kBQ * srel_stride(P) * 4;
}

__global__ void __launch_bounds__(kThreads, 3)
flash_rel_kernel_tc(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    const __nv_bfloat16* __restrict__ e,
                    const float* __restrict__ kv_mask,
                    __nv_bfloat16* __restrict__ out, int H, int L, int P,
                    int left, float scale) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* const smem = align1024(smem_raw);
  unsigned char* const qs = smem;
  unsigned char* const ring = smem + kTileBytes;
  float* const srel = reinterpret_cast<float*>(ring + kStages * kStageBytes);
  const int S = srel_stride(P);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int c2 = (lane & 3) * 2;
  const int row0 = (tid >> 5) * 16;    // the warp's first row in the tile
  const int q0 = blockIdx.x * kBQ;
  const int bh = blockIdx.y;           // b * H + h
  const int b = bh / H;
  const size_t base = static_cast<size_t>(bh) * L * kD;
  const int right = P - 1 - left;
  const int n_tiles = L / kBK;
  const auto* kb = reinterpret_cast<const unsigned char*>(k + base);
  const auto* vb = reinterpret_cast<const unsigned char*>(v + base);
  const float* maskp = kv_mask + static_cast<size_t>(b) * L;

  // Tile j's k, v and mask into stage j % kStages (an empty group past
  // the last tile keeps the group count uniform).
  auto load_tile = [&](int j) {
    if (j < n_tiles) {
      unsigned char* st = ring + (j % kStages) * kStageBytes;
      copy_tile_async<128>(st, kb + static_cast<size_t>(j) * kTileBytes, 128,
                           tid);
      copy_tile_async<128>(st + kTileBytes,
                           vb + static_cast<size_t>(j) * kTileBytes, 128,
                           tid);
      if (tid < kBK / 4)
        cp_async16(st + 2 * kTileBytes + tid * 16, maskp + j * kBK + tid * 4);
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

  uint32_t qf[4][4];
  load_q_frags(qs, row0, lane, qf);

  // Bucket logits of the warp's rows, s_rel[r][p] = q_r . E[p], on the
  // tensor cores (bf16 E as the B operand, read straight from global
  // memory: E[p][d .. d+1] is one 32-bit word of the fragment). Rows are
  // private to their warp, so a warp barrier is enough.
  for (int np = 0; np < (P + 7) / 8; ++np) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    const int p = np * 8 + g;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t b0 = 0, b1 = 0;
      if (p < P) {
        const auto* ep = reinterpret_cast<const uint32_t*>(
            e + p * kD + kk * 16 + c2);
        b0 = ep[0];
        b1 = ep[4];
      }
      mma_bf16(acc, qf[kk], b0, b1);
    }
    *reinterpret_cast<float2*>(&srel[(row0 + g) * S + np * 8 + c2]) =
        make_float2(acc[0], acc[1]);
    *reinterpret_cast<float2*>(&srel[(row0 + g + 8) * S + np * 8 + c2]) =
        make_float2(acc[2], acc[3]);
  }
  __syncwarp();
  const float* srow[2] = {srel + (row0 + g) * S, srel + (row0 + g + 8) * S};
  // The saturated bias of a row: left of the band s_rel[r][0], right of
  // it s_rel[r][P - 1].
  const float lo[2] = {srow[0][0], srow[1][0]};
  const float hi[2] = {srow[0][P - 1], srow[1][P - 1]};

  const float c = scale * kLog2e;      // scores in the log2 domain
  const float mask_c = 1e9f * kLog2e;  // the -1e9 mask, after scaling
  const int l0 = q0 + row0;            // the warp's first query row
  float o[8][4] = {};
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};

  for (int j = 0; j < n_tiles; ++j) {
    cp_async_wait<kStages - 2>();      // tile j (this thread's copies)
    fence_async_shared();
    __syncthreads();                   // everyone's; stage j - 1 is free
    load_tile(j + kStages - 1);
    const unsigned char* st = ring + (j % kStages) * kStageBytes;
    const float* mk = reinterpret_cast<const float*>(st + 2 * kTileBytes);
    const int k0 = j * kBK;

    float t[8][4];
    qk_tile(qs, st, t);

    // Relative bias by tile class: a tile wholly left (right) of the band
    // -left <= m - l <= right adds one saturated value per row; only a
    // tile that meets the band gathers per element.
    if (k0 + kBK - 1 - l0 < -left || k0 - (l0 + 15) > right) {
      const bool is_left = k0 + kBK - 1 - l0 < -left;
      const float rb[2] = {is_left ? lo[0] : hi[0], is_left ? lo[1] : hi[1]};
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) t[n][i] += rb[i >> 1];
    } else {
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int dist = k0 + n * 8 + c2 + (i & 1) - (l0 + g + (i >> 1) * 8);
          t[n][i] += srow[i >> 1][min(max(dist, -left), right) + left];
        }
    }
    // Scale and kv mask, in the log2 domain.
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float2 mv = *reinterpret_cast<const float2*>(mk + n * 8 + c2);
      const float b0 = (mv.x - 1.f) * mask_c;
      const float b1 = (mv.y - 1.f) * mask_c;
      t[n][0] = fmaf(t[n][0], c, b0);
      t[n][1] = fmaf(t[n][1], c, b1);
      t[n][2] = fmaf(t[n][2], c, b0);
      t[n][3] = fmaf(t[n][3], c, b1);
    }

    uint32_t pf[4][4];
    softmax_step<true>(t, m, l, o, pf);
    pv_tile(st + kTileBytes, pf, o);
  }

  float denom[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) denom[h] = fmaxf(quad_sum(l[h]), 1e-37f);
  store_o(out + base + static_cast<size_t>(q0) * kD, row0, lane, o, denom);
}

cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* e, const void* kv_mask, void* out, int B,
                   int H, int L, int P, int left, float scale,
                   cudaStream_t stream) {
  const int smem = smem_bytes(P);
  cudaError_t err = cudaFuncSetAttribute(
      flash_rel_kernel_tc, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(L / kBQ, B * H);
  flash_rel_kernel_tc<<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(e),
      static_cast<const float*>(kv_mask), static_cast<__nv_bfloat16*>(out),
      H, L, P, left, scale);
  return cudaGetLastError();
}

}  // namespace tc

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
      is_bf16 ? tc::launch(q, k, v, e, kv_mask, out, B, H, L, P, left, scale,
                           st)
              : launch<float>(q, k, v, e, kv_mask, out, B, H, L, P, left,
                              scale, st);
  return static_cast<int>(err);
}

const char* flash_rel_attention_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
