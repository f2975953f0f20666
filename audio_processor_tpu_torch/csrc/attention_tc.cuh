// Tensor-core tile machinery shared by the bf16 instances of the port's
// streaming attention kernels (flash_rel_attention.cu, flash_attention.cu)
// and by the flash-rel ablation kernels (flash_rel_parts.cu).
//
// Layout: one block of one warpgroup (4 warps, 128 threads) per (batch b,
// head h, 64-row q tile), walking the kv axis in 64-column tiles. Both
// products are warpgroup MMAs (wgmma.mma_async m64n64k16, bf16 operands,
// fp32 accumulators), four k-steps of 16 each:
//
//   S[64, 64]  = Q[64, 64] . K^T      A = Q, B = K: both K-major tiles in
//                                     shared memory, read by descriptor
//   O[64, 64] += P[64, 64] . V        A = P from registers, B = V, an
//                                     MN-major (transposed) shared tile
//
// The accumulator layout gives warp w rows 16w .. 16w + 15, and a thread
// two of them (g = lane/4 and g + 8) with, per 8-column group, two
// adjacent columns (2 * (lane % 4) + {0, 1}). That is the m16n8 C layout
// of mma.sync, and for bf16 the S accumulators of two adjacent 8-column
// groups, packed to bf16x2, are exactly the register A fragment of one
// k-step of P . V: p never leaves the registers. A row max or row sum
// reduces over the four lanes of a quad.
//
// Tiles are bf16 in shared memory, 64 rows of 128 bytes (a bias tile of
// fp32 has 256-byte rows), 1024-byte aligned, with the 16-byte chunks of
// row r XOR-swizzled by r % 8: the hardware's 128-byte swizzle, which the
// wgmma descriptors name, and under which the eight rows of every
// fragment-shaped read (ldmatrix, a bias tile) fall in eight different
// bank groups. The kv tiles stream through a ring of kStages stages
// filled by cp.async (16 bytes a thread, coalesced): while the warpgroup
// computes on tile j, the copies of tile j + kStages - 1 are in flight.
// A fence.proxy.async after each wait makes the copies visible to the
// tensor cores' shared-memory reads.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace attn_tc {

constexpr int kD = 64;               // head size
constexpr int kBQ = 64;              // q rows per block
constexpr int kBK = 64;              // kv columns per tile
constexpr int kWarps = 4;            // 16 q rows each
constexpr int kThreads = kWarps * 32;
constexpr int kTileBytes = kBK * kD * 2;      // one bf16 [64, 64] tile
constexpr float kLog2e = 1.4426950408889634f;

// Byte offset of byte ``byte`` of row ``r`` in a swizzled tile whose rows
// are kRowBytes long (128 or 256).
template <int kRowBytes>
__device__ __forceinline__ int swz(int r, int byte) {
  return r * kRowBytes + ((((byte >> 4) ^ (r & 7))) << 4) + (byte & 15);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The first 1024-byte aligned address at or after p (wgmma's swizzled
// operands need 1024-byte aligned tiles); a kernel asks for 1024 bytes
// of dynamic shared memory more than it lays out.
__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024u - (smem_addr(p) & 1023u)) & 1023u);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// 64 rows of kRowBytes bytes, row stride src_stride bytes in global
// memory, into a swizzled shared tile, 16 bytes per copy.
template <int kRowBytes>
__device__ __forceinline__ void copy_tile_async(unsigned char* dst,
                                                const unsigned char* src,
                                                size_t src_stride, int tid) {
  constexpr int kChunks = kRowBytes / 16;
#pragma unroll
  for (int it = 0; it < 64 * kChunks / kThreads; ++it) {
    const int i = tid + it * kThreads;
    const int r = i / kChunks;
    const int c = i % kChunks;
    cp_async16(dst + swz<kRowBytes>(r, c * 16), src + r * src_stride + c * 16);
  }
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
// c += a . b, m16n8k16, bf16 operands, fp32 accumulators (the q . E^T
// bucket logits of flash_rel_attention.cu, once per block).
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// (lo, hi) rounded to bf16 and packed, lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}
// The sum of the two bf16 halves of a packed pair, in fp32.
__device__ __forceinline__ float sum_bf16x2(uint32_t x) {
  return __uint_as_float(x << 16) + __uint_as_float(x & 0xffff0000u);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// The warp's A fragments of Q (rows row0 .. row0 + 15, all 64 columns)
// from a swizzled bf16 tile: qf[kk] covers columns kk*16 .. kk*16 + 15.
__device__ __forceinline__ void load_q_frags(const unsigned char* qs,
                                             int row0, int lane,
                                             uint32_t (&qf)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    ldmatrix_x4(qf[kk], qs + swz<128>(row0 + (lane & 15),
                                      (kk * 2 + (lane >> 4)) * 16));
}

// wgmma operand descriptors for a swizzled bf16 tile of 128-byte rows
// (the hardware's 128-byte swizzle: 16-byte chunk c of row r at chunk
// c ^ (r % 8), 8-row atoms of 1024 bytes, tile base 1024-byte aligned):
// start address, leading and stride byte offsets (16-byte units) and the
// layout type 1 (128-byte swizzle). K-major (q and k: the reduction runs
// along the row): 8-row groups 1024 bytes apart; a k-step of 16 values
// advances the start by 32 bytes. MN-major (v, reduction down the rows):
// 8-row groups along K 1024 bytes apart; a k-step of 16 rows advances the
// start by 2048 bytes. Both offsets are set to 1024 bytes for v, where
// only the K-direction one is read (one 64-wide atom along N).
__device__ __forceinline__ uint64_t wg_desc(const void* p, uint32_t lbo) {
  const uint64_t addr = smem_addr(p);
  return ((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Shared-memory writes of this thread (cp.async included, once waited
// for) become visible to the tensor cores' reads (the async proxy).
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The 32 accumulator operands of an m64n64 wgmma, d[8][4] in register order.
#define D_REGS                                                               \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
  "%30, %31"
#define D_ROW(d, n)                                                          \
  "+f"(d[n][0]), "+f"(d[n][1]), "+f"(d[n][2]), "+f"(d[n][3])
#define D_OPERANDS(d)                                                        \
  D_ROW(d, 0), D_ROW(d, 1), D_ROW(d, 2), D_ROW(d, 3), D_ROW(d, 4),           \
      D_ROW(d, 5), D_ROW(d, 6), D_ROW(d, 7)

// d (+)= A . B, m64n64k16, both operands from shared memory (K-major),
// fp32 accumulators in the m16n8 C layout of each warp: d[n] holds
// columns n*8 + 2*(lane % 4) + {0, 1} of rows lane/4 and lane/4 + 8 of
// the warp's 16. scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss(float (&d)[8][4], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{" D_REGS "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : D_OPERANDS(d)
      : "l"(da), "l"(db), "r"(scale_d));
}

// d += A . B, m64n64k16, A from registers (the m16n8k16 A fragment of
// each warp's 16 rows), B from shared memory MN-major (transposed).
__device__ __forceinline__ void wgmma_rs_t(float (&d)[8][4],
                                           const uint32_t (&a)[4],
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{" D_REGS "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : D_OPERANDS(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// s = the block's 64 q rows . the staged k tile's 64 rows (each warp gets
// its 16 rows), one warpgroup, four k-steps of 16.
__device__ __forceinline__ void qk_tile(const unsigned char* qs,
                                        const unsigned char* ks,
                                        float (&s)[8][4]) {
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_ss(s, wg_desc(qs + kk * 32, 1), wg_desc(ks + kk * 32, 1),
             kk > 0);
  wg_commit();
  wg_wait0();
}

// o += p . (the staged v tile); pf[kk] is the A fragment of kv rows
// kk*16 .. kk*16 + 15.
__device__ __forceinline__ void pv_tile(const unsigned char* vs,
                                        const uint32_t (&pf)[4][4],
                                        float (&o)[8][4]) {
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_rs_t(o, pf[kk], wg_desc(vs + kk * 2048, 1024 >> 4));
  wg_commit();
  wg_wait0();
}

// The softmax of a kv step, in pieces. The shipped kernels run kOnline
// on one 64-column tile a step (softmax_step); the ablation kernels of
// flash_rel_parts.cu run every mode on steps of several tiles:
//   kOnline    p = exp2(t - m), alpha = exp2(m_old - m)  (t in the log2
//              domain: scaled by log2 e)
//   kNoMax     p = exp2(t), alpha = 1                     (log2 domain)
//   kNoSoftmax p = t, alpha = 1                           (natural domain)
//   kNoExp     p = (t - m) * 0.5, alpha = (m_old - m) * 0.5 (natural)
// where m is the running row max over the steps so far, this step's
// included. A step: tile_max over each of its tiles (modes with a max),
// step_max, rescale_o, then tile_p over each tile (p . V after each),
// and l = alpha * l + rs.
enum Softmax { kOnline, kNoMax, kNoSoftmax, kNoExp };

template <int kMode>
__host__ __device__ constexpr bool has_max() {
  return kMode == kOnline || kMode == kNoExp;
}

// Folds a tile's scores into the thread's row maxima mx (rows g, g + 8).
__device__ __forceinline__ void tile_max(const float (&t)[8][4],
                                         float (&mx)[2]) {
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    mx[0] = fmaxf(mx[0], fmaxf(t[n][0], t[n][1]));
    mx[1] = fmaxf(mx[1], fmaxf(t[n][2], t[n][3]));
  }
}

// The step's row maxima (mx: this thread's, folded from m and every tile
// of the step) become the running max m; alpha is the factor of the old
// l and o. Modes without a max: alpha = 1.
template <int kMode>
__device__ __forceinline__ void step_max(float (&mx)[2], float (&m)[2],
                                         float (&alpha)[2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if constexpr (has_max<kMode>()) {
      mx[h] = quad_max(mx[h]);
      // kOnline: 0 on the first step (m = -inf); kNoExp: -inf there,
      // and -inf * 0 starts l and o at NaN, as the TPU kernel does.
      alpha[h] = kMode == kOnline ? ex2(m[h] - mx[h])
                                  : (m[h] - mx[h]) * 0.5f;
      m[h] = mx[h];
    } else {
      alpha[h] = 1.f;
    }
  }
}

template <int kMode>
__device__ __forceinline__ void rescale_o(const float (&alpha)[2],
                                          float (&o)[8][4]) {
  if constexpr (has_max<kMode>()) {
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }
  }
}

template <int kMode>
__device__ __forceinline__ float p_of(float t, float m) {
  if constexpr (kMode == kOnline) return ex2(t - m);
  else if constexpr (kMode == kNoMax) return ex2(t);
  else if constexpr (kMode == kNoSoftmax) return t;
  else return (t - m) * 0.5f;
}

// p of one tile of scores t, rounded to bf16 and packed as the A
// fragments of p . V in pf; adds the tile's part of the thread's two row
// sums to rs. kSumRounded: the row sum adds the bf16-rounded p (as the
// TPU kernels' ones-lane sum does) rather than the fp32 p.
template <bool kSumRounded, int kMode>
__device__ __forceinline__ void tile_p(const float (&t)[8][4],
                                       const float (&m)[2], float (&rs)[2],
                                       uint32_t (&pf)[4][4]) {
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const float p0 = p_of<kMode>(t[n][0], m[0]);
    const float p1 = p_of<kMode>(t[n][1], m[0]);
    const float p2 = p_of<kMode>(t[n][2], m[1]);
    const float p3 = p_of<kMode>(t[n][3], m[1]);
    const uint32_t lo = pack_bf16(p0, p1);   // row g
    const uint32_t hi = pack_bf16(p2, p3);   // row g + 8
    if (kSumRounded) {
      rs[0] += sum_bf16x2(lo);
      rs[1] += sum_bf16x2(hi);
    } else {
      rs[0] += p0 + p1;
      rs[1] += p2 + p3;
    }
    // n-tile 2kk gives a0 (row g) and a1 (row g + 8); 2kk + 1 gives a2, a3.
    pf[n >> 1][(n & 1) * 2] = lo;
    pf[n >> 1][(n & 1) * 2 + 1] = hi;
  }
}

// One online-softmax step of one tile, the shipped kernels' step: the
// scores t (already in the log2 domain) of the thread's two rows update
// the running max m and the thread's partial row sums l (the quad's four
// partial sums are added at the end), o is rescaled, and p lands in pf.
template <bool kSumRounded>
__device__ __forceinline__ void softmax_step(float (&t)[8][4], float (&m)[2],
                                             float (&l)[2], float (&o)[8][4],
                                             uint32_t (&pf)[4][4]) {
  float mx[2] = {m[0], m[1]};
  tile_max(t, mx);
  float alpha[2];
  step_max<kOnline>(mx, m, alpha);
  float rs[2] = {0.f, 0.f};
  tile_p<kSumRounded, kOnline>(t, m, rs, pf);
#pragma unroll
  for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + rs[h];
  rescale_o<kOnline>(alpha, o);
}

// o / denom for the thread's two rows into out (bf16 [rows, 64]), rows
// row0 + g and row0 + g + 8.
__device__ __forceinline__ void store_o(__nv_bfloat16* out, int row0,
                                        int lane, const float (&o)[8][4],
                                        const float (&denom)[2]) {
  const int g = lane >> 2;
  const int c = (lane & 3) * 2;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    *reinterpret_cast<uint32_t*>(out + (row0 + g) * kD + n * 8 + c) =
        pack_bf16(o[n][0] / denom[0], o[n][1] / denom[0]);
    *reinterpret_cast<uint32_t*>(out + (row0 + g + 8) * kD + n * 8 + c) =
        pack_bf16(o[n][2] / denom[1], o[n][3] / denom[1]);
  }
}

}  // namespace attn_tc
