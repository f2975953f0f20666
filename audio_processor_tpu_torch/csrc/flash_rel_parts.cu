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
// Design: the shipped bf16 flash_rel kernel's (flash_rel_attention.cu,
// on attention_tc.cuh), so that the differences between configs price
// the parts of the kernel the main path runs. One block of one
// warpgroup (128 threads) per (b, h, 64-row q tile). S = q . k^T is
// wgmma m64n64k16 with q and k from 128B-swizzled shared tiles; O +=
// p . v is wgmma with p packed to bf16 in registers and v MN-major. At
// block start the q tile and the tile's 64 x 128 fp32 s_rel rows come
// into shared memory by cp.async. k and v tiles (a k tile with its 64
// mask values) stream through one 4-slot cp.async ring in the order the
// step consumes them, with fence.proxy.async before the tensor cores
// read; while the softmax of a step runs, its first v tiles are in
// flight. The bias: kSat by tile class as the shipped kernel (a warp's
// 16 rows against a 64-column tile wholly left or right of the band add
// one saturated value per row; only band tiles gather), kWrap a gather
// per element, kNone nothing; then scale and the mask in one FMA. The
// exp2 modes (online, nomax) run in the log2 domain (scale * log2 e and
// 1e9 * log2 e folded, as shipped); nosoftmax and noexp are defined on
// the natural-domain scores and see those. The softmax is
// attention_tc.cuh's, in pieces over the tiles of a step.
//
// The kv step is a template parameter, because the TPU kernels run the
// max/rescale recurrence once per grid step (the twins do the same, and
// the tolerance of the comparison assumes the same steps on both
// sides). kStep = 256: the step's four score tiles stay live as wgmma
// accumulators (128 registers a thread, beside o's 32); one max, one
// alpha and one rescale of o a step, then p and p . v tile by tile.
// kStep = 640 would need 320 accumulator registers a thread, past the
// 255 one thread may have. This kernel computes such a step's scores
// twice instead: a max pass over its ten k tiles, then, tile by tile,
// the scores again, p and p . v (the ring streams each k tile twice).
// That keeps one warpgroup, one block layout and one code path for all
// nine configs; the price is 1.5x the step's q . k^T, a quarter more
// tensor-core work, and a third more ring items, which kb640's time
// includes. Two consumer warpgroups
// splitting the step's columns would avoid it, but need a row-max and
// row-sum exchange through shared memory and an o reduction at the end:
// a layout the shipped kernel does not have, whose cost would then be
// read as the step width's.
//
// What bounds it: the two products, 4*B*H*L^2*d FLOP (0.33 ms at the 989
// TFLOP/s bf16 peak at B=48, H=16, L=1280, d=64), beside the s_rel read
// (512 bytes per query row: 0.5 GB, 0.15 ms at 3.35 TB/s) and the q, k,
// v, o traffic; the exponentials need about as long on the SFUs as the
// products on the tensor cores, and a tile's products and its softmax
// run one after the other, as in the shipped kernel. Four live score
// tiles take 203-255 registers a thread, so 2 blocks (8 warps) share an
// SM, where the shipped kernel's 147 allow 3.
//
// C interface (loaded with ctypes): flash_rel_parts_fwd returns the
// cudaError_t of the launch; 0 means the kernel was launched.

#include "attention_tc.cuh"

namespace {

using namespace attn_tc;
using bf16 = __nv_bfloat16;

enum Bias { kNone, kSat, kWrap };

constexpr int kTable = 128;             // s_rel columns
constexpr int kWrapW = 256;             // wrapped table width of kWrap
constexpr int kSrelStride = kTable + 4; // floats per s_rel row in smem
constexpr int kStages = 4;              // ring slots
// A k tile and its 64 mask values, or a v tile; slots stay 1024-byte
// aligned.
constexpr int kSlotBytes = kTileBytes + 1024;

constexpr int smem_bytes(bool has_bias) {
  return 1024 + kTileBytes + kStages * kSlotBytes +
         (has_bias ? kBQ * kSrelStride * 4 : 0);
}

template <int kBias, int kSoft, int kStep, bool kOnes, bool kMasked>
__global__ void __launch_bounds__(kThreads, 2)
parts_kernel_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const float* __restrict__ s_rel,
                const float* __restrict__ kv_mask, bf16* __restrict__ out,
                int H, int L, int P, int left, float scale) {
  constexpr int kSubs = kStep / kBK;         // 64-column tiles a step
  constexpr bool kTwoPass = kSubs > 4;       // kStep = 640
  constexpr int kLive = kTwoPass ? 1 : kSubs;
  // One pass unrolls its tile loops (the live tiles are indexed by the
  // loop counter); two passes keep theirs rolled: unrolled, ten tiles
  // twice over, kb640 took 2.2x as long on the H100.
  constexpr int kUnroll = kTwoPass ? 1 : kSubs;
  // Ring items a step: k tiles, then v tiles; two-pass: k tiles, then
  // (k, v) pairs.
  constexpr int kItems = kTwoPass ? 3 * kSubs : 2 * kSubs;
  constexpr bool kLog2 = kSoft == kOnline || kSoft == kNoMax;

  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* const smem = align1024(smem_raw);
  unsigned char* const qs = smem;
  unsigned char* const ring = smem + kTileBytes;
  float* const srel = reinterpret_cast<float*>(ring + kStages * kSlotBytes);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int c2 = (lane & 3) * 2;
  const int row0 = (tid >> 5) * 16;    // the warp's first row in the tile
  const int q0 = blockIdx.x * kBQ;
  const int bh = blockIdx.y;           // b * H + h
  const size_t base = static_cast<size_t>(bh) * L * kD;
  const int right = P - 1 - left;
  const int n_items = L / kStep * kItems;
  const auto* kb = reinterpret_cast<const unsigned char*>(k + base);
  const auto* vb = reinterpret_cast<const unsigned char*>(v + base);
  const float* maskp =
      kMasked ? kv_mask + static_cast<size_t>(bh / H) * L : nullptr;

  // Ring item i into slot i % kStages (an empty group past the last item
  // keeps the group count uniform).
  auto load_item = [&](int i) {
    if (i < n_items) {
      const int w = i % kItems;
      bool is_v = w >= kSubs;
      int sub = w;
      if (is_v) {
        sub = kTwoPass ? (w - kSubs) >> 1 : w - kSubs;
        is_v = kTwoPass ? ((w - kSubs) & 1) : true;
      }
      const int j = i / kItems * kSubs + sub;   // the kv tile
      unsigned char* st = ring + (i % kStages) * kSlotBytes;
      copy_tile_async<128>(st,
                           (is_v ? vb : kb) + static_cast<size_t>(j) *
                                                  kTileBytes,
                           128, tid);
      if (kMasked && !is_v && tid < kBK / 4)
        cp_async16(st + kTileBytes + tid * 16, maskp + j * kBK + tid * 4);
    }
    cp_async_commit();
  };

  copy_tile_async<128>(
      qs, reinterpret_cast<const unsigned char*>(q + base + q0 * kD), 128,
      tid);
  if constexpr (kBias != kNone) {
    const auto* sp = reinterpret_cast<const unsigned char*>(
        s_rel + (static_cast<size_t>(bh) * L + q0) * kTable);
#pragma unroll
    for (int it = 0; it < kBQ * kTable / 4 / kThreads; ++it) {
      const int i = tid + it * kThreads;
      const int r = i / (kTable / 4);
      const int c = i % (kTable / 4);
      cp_async16(srel + r * kSrelStride + c * 4, sp + i * 16);
    }
  }
  cp_async_commit();
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) load_item(i);
  cp_async_wait<kStages - 1>();        // the q tile and s_rel
  fence_async_shared();
  __syncthreads();

  // The next item of the ring: waits for it (everyone's copies), then
  // refills the slot the previous item left.
  int next = 0;
  auto consume = [&]() -> const unsigned char* {
    cp_async_wait<kStages - 2>();
    fence_async_shared();
    __syncthreads();
    load_item(next + kStages - 1);
    return ring + (next++ % kStages) * kSlotBytes;
  };

  const float* srow[2] = {srel + (row0 + g) * kSrelStride,
                          srel + (row0 + g + 8) * kSrelStride};
  float lo[2] = {0.f, 0.f};
  float hi[2] = {0.f, 0.f};
  if constexpr (kBias == kSat) {
    // The saturated bias of a row: left of the band s_rel[r][0], right
    // of it s_rel[r][P - 1].
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      lo[h] = srow[h][0];
      hi[h] = srow[h][P - 1];
    }
  }
  const float c = kLog2 ? scale * kLog2e : scale;
  const float mask_c = kLog2 ? 1e9f * kLog2e : 1e9f;
  const int l0 = q0 + row0;            // the warp's first query row

  // The scores of the kv tile at column k0, staged in slot st: q . k^T,
  // the bias, scale and mask.
  auto score = [&](const unsigned char* st, int k0, float (&t)[8][4]) {
    qk_tile(qs, st, t);
    if constexpr (kBias == kSat) {
      if (k0 + kBK - 1 - l0 < -left || k0 - (l0 + 15) > right) {
        const bool is_left = k0 + kBK - 1 - l0 < -left;
        const float rb[2] = {is_left ? lo[0] : hi[0],
                             is_left ? lo[1] : hi[1]};
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i) t[n][i] += rb[i >> 1];
      } else {
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int dist =
                k0 + n * 8 + c2 + (i & 1) - (l0 + g + (i >> 1) * 8);
            t[n][i] += srow[i >> 1][min(max(dist, -left), right) + left];
          }
      }
    } else if constexpr (kBias == kWrap) {
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int w = (k0 + n * 8 + c2 + (i & 1) -
                         (l0 + g + (i >> 1) * 8) + left) & (kWrapW - 1);
          t[n][i] += w < kTable ? srow[i >> 1][w] : 0.f;
        }
    }
    if constexpr (kMasked) {
      const float* mk = reinterpret_cast<const float*>(st + kTileBytes);
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
    } else {
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) t[n][i] *= c;
    }
  };

  float o[8][4] = {};
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};

  for (int s0 = 0; s0 < L; s0 += kStep) {
    float t[kLive][8][4];
    float mx[2] = {m[0], m[1]};
    // The step's row max: its kLive tiles kept live (one pass), or every
    // tile's scores computed and dropped (the max pass of two).
#pragma unroll kUnroll
    for (int sub = 0; sub < (kTwoPass ? kSubs : kLive); ++sub) {
      float (&ts)[8][4] = t[kTwoPass ? 0 : sub];
      score(consume(), s0 + sub * kBK, ts);
      if constexpr (has_max<kSoft>()) tile_max(ts, mx);
    }
    float alpha[2];
    step_max<kSoft>(mx, m, alpha);
    rescale_o<kSoft>(alpha, o);
    float rs[2] = {0.f, 0.f};
#pragma unroll kUnroll
    for (int sub = 0; sub < kSubs; ++sub) {
      float (&ts)[8][4] = t[kTwoPass ? 0 : sub];
      if constexpr (kTwoPass) score(consume(), s0 + sub * kBK, ts);
      uint32_t pf[4][4];
      tile_p<kOnes, kSoft>(ts, m, rs, pf);
      pv_tile(consume(), pf, o);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + rs[h];
  }

  // o / max(l, 1e-37), where a NaN l stays NaN (noexp's output).
  float denom[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float s = quad_sum(l[h]);
    denom[h] = (s != s || s > 1e-37f) ? s : 1e-37f;
  }
  store_o(out + base + static_cast<size_t>(q0) * kD, row0, lane, o, denom);
}

template <int kBias, int kSoft, int kStep, bool kOnes, bool kMasked>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* s_rel, const void* kv_mask, void* out, int B,
                   int H, int L, int P, int left, float scale,
                   cudaStream_t stream) {
  auto kernel = parts_kernel_tc<kBias, kSoft, kStep, kOnes, kMasked>;
  constexpr int smem = smem_bytes(kBias != kNone);
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
// configs 0-6); all 16-byte aligned. config: 0 full, 1 noselect, 2
// norel, 3 nomax, 4 nosoftmax, 5 noexp (256-column steps, ones row sum,
// masked), 6 kb640 (full with 640-column steps), 7 bare ones, 8 bare
// reduce (no bias, no mask). L must be a multiple of the step,
// 1 <= P <= 128, 0 <= left < P. The caller (the Python wrapper) checks
// all of this before it calls.
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
