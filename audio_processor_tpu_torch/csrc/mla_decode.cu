// The absorbed multi-head latent attention (MLA) of one decode step of the
// topic LM (models/moe_lm.py, DeepSeek-V3's block at Moonlight-16B-A3B's
// widths), between its projections, for Hopper (sm_90a): two launches a
// layer.
//
// 1. mla_decode_prep (one block per row) reads the row's q_proj output
//    [H * 192] and kv_a_proj_with_mqa output [576] and in one pass
//    - writes q_nope head-major, q_nope[h, r, 0:128], the layout of the
//      absorption product (q_nope . W_kvb,k per head, a library bmm);
//    - writes q_pe[r, h, 0:64] rotated in DeepSeek-V3's pairing: element i
//      of the first half is x[2i] cos_i - x[2i+1] sin_i, of the second
//      x[2i+1] cos_i' + x[2i] sin_i' (i' = i + 32), each product and the
//      sum rounded in fp32 as models/moe_lm.py::apply_rope computes them,
//      then rounded once to bf16;
//    - writes the row's latent into the cache at pos[r]: c (the first 512
//      values) under kv_a_layernorm's RMSNorm (fp32 statistics, x * rstd
//      * gain in fp32, rounded once), then k_pe rotated as q_pe is. A pos
//      outside [0, cap) writes nothing.
// 2. mla_decode_attention (one cluster of 8 blocks per row) computes, per
//    head h of the row, over the cached positions j that visible[r, j]
//    marks:
//
//      s_j = scale * (q_lat[h] . c_j + q_pe[h] . k_pe_j)      fp32
//      o_lat[h] = sum_j exp(s_j - max s) c_j / sum_j exp(s_j - max s)
//
//    and writes o_lat[h, r, 0:512] in bf16, head-major for the W_kvb,v
//    product. A row with no visible position gets NaN, as softmax does.
//
// Replaces no TPU kernel: the JAX package has no LM. It replaces, per
// layer of each decode step's CUDA graph, the decode's op chain between
// the projections: two RoPEs of eight launches each, the latent RMSNorm,
// two concatenations and the cache scatter (one launch now), then the
// concatenated query, the score product over the whole capacity bucket,
// its cast and scale, the mask, the softmax, the cast back, the P.c
// product and the output's copy (one launch now). Each launch cost a node
// of the graph and ~2-3 us of mostly idle card time.
//
// What bounds it: bytes. The attention reads each visible cached position
// once for all heads (576 bf16, 1,152 B) and the row's queries: at the
// topics cell's shapes (8 rows at positions ~1,270-1,470 of a 1,536
// capacity) a layer reads ~13 MB, ~4 us at 3.35 TB/s. The arithmetic,
// 4 FLOP per head and value, is ~30 FLOP per byte, above what the CUDA
// cores sustain at that bandwidth, so the products run on the tensor cores
// (mma.sync m16n8k16 bf16, fp32 accumulation): the 16 heads are exactly
// the MMA's 16 rows, and each cache byte is loaded once for all of them.
// The prep moves ~60 KB a layer; its time is the launch's.
//
// Design of the attention. A row's capacity is cut into 64-position tiles,
// dealt round-robin to the 8 blocks of the row's cluster (so 8 rows fill
// 64 of the 132 SMs). A block reads its tiles' visible bytes and drops
// every tile whose mask is all false, so it loads nothing past the row's
// last visible position; the mask itself is never derived from a
// position. (Its first tile's load starts before that read, as it is the
// first visible one whenever the row reaches it; a wrong guess is drained
// and dropped.) It keeps the 16 x 576 query tile in shared memory and each
// warp's A fragments of its quarter of the 576 dims in registers, and
// streams its tiles through a two-slot ring of padded shared-memory rows
// (cp.async, the next tile in flight while this one is used). Per tile,
// 8 warps: each multiplies a quarter of the dims for half of the 64
// positions; the four partial scores are summed, scaled, masked and put
// through an online softmax in fp32 (running max and sum per head); P is
// rounded to bf16 and each warp accumulates P.c for 64 of the 512 values
// in fp32 registers. At the end the blocks of a cluster meet (cluster
// barrier): each holds its unnormalised partial, running max and sum in
// shared memory, and block b combines heads b and b + 8 from all eight
// partials through distributed shared memory, so the splits cost no second
// launch and no trip through device memory.
//
// How close it comes (one H100 at 700 W, graph-timed over 27 layers'
// caches): at the cell's shapes 14.7 us a launch against the 3.9 us byte
// bound. About 1.7 us is the clustered launch itself and ~8 us the chain
// every block walks whatever its tiles (mask and query reads, the first
// tile's load, the cluster's meeting and combine); each further tile
// costs a block ~2.3 us, where shared memory alone (the tile written once
// and read twice by the MMAs) takes ~0.9 us.
//
// C interface (loaded with ctypes): each *_fwd returns the cudaError_t of
// its launch; 0 means the kernel was launched.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

using bf16 = __nv_bfloat16;

constexpr int kNope = 128;             // qk_nope_head_dim
constexpr int kRope = 64;              // qk_rope_head_dim
constexpr int kLora = 512;             // kv_lora_rank: c's width
constexpr int kLat = kLora + kRope;    // 576 values a cached position
constexpr int kQk = kNope + kRope;     // 192: a head's q in q_proj's output
constexpr int kHeads = 16;             // the MMA's rows; at most 16 real

// ---- prep ------------------------------------------------------------

constexpr int kPrepThreads = 256;
static_assert(2 * kPrepThreads == kLora, "two values of c a thread");

__device__ __forceinline__ float bf(bf16 x) { return __bfloat162float(x); }

// x: 64 values in DeepSeek-V3's interleaved pairs; writes o[i] and o[i + 32]
// for pair i, in apply_rope's fp32 order (no fused multiply-add).
__device__ __forceinline__ void rope_pair(const bf16* x, const float* cs,
                                          const float* sn, int i, bf16* o) {
  const float even = bf(x[2 * i]), odd = bf(x[2 * i + 1]);
  const int j = i + kRope / 2;
  o[i] = __float2bfloat16_rn(
      __fadd_rn(__fmul_rn(even, cs[i]), __fmul_rn(-odd, sn[i])));
  o[j] = __float2bfloat16_rn(
      __fadd_rn(__fmul_rn(odd, cs[j]), __fmul_rn(even, sn[j])));
}

__global__ void __launch_bounds__(kPrepThreads)
mla_prep_kernel(const bf16* __restrict__ q, const bf16* __restrict__ kv,
                const float* __restrict__ cosv, const float* __restrict__ sinv,
                const bf16* __restrict__ gain, float eps,
                const long long* __restrict__ pos, bf16* cache,
                long long row_stride, int cap, int R, int H,
                bf16* __restrict__ q_nope, bf16* __restrict__ q_pe) {
  __shared__ float warp_sq[kPrepThreads / 32];
  const int r = blockIdx.x;
  const int t = threadIdx.x;
  const bf16* qr = q + static_cast<size_t>(r) * H * kQk;
  const float* cs = cosv + static_cast<size_t>(r) * kRope;
  const float* sn = sinv + static_cast<size_t>(r) * kRope;

  // q_nope, 16 bytes a thread
  for (int i = t; i < H * (kNope / 8); i += kPrepThreads) {
    const int h = i / (kNope / 8), c = i % (kNope / 8);
    *reinterpret_cast<uint4*>(q_nope + (static_cast<size_t>(h) * R + r) *
                                           kNope + c * 8) =
        *reinterpret_cast<const uint4*>(qr + h * kQk + c * 8);
  }
  // q_pe, rotated
  for (int i = t; i < H * (kRope / 2); i += kPrepThreads) {
    const int h = i / (kRope / 2);
    rope_pair(qr + h * kQk + kNope, cs, sn, i % (kRope / 2),
              q_pe + (static_cast<size_t>(r) * H + h) * kRope);
  }

  // the latent: RMSNorm of c (2 values a thread), then k_pe rotated
  const bf16* kr = kv + static_cast<size_t>(r) * kLat;
  const float c0 = bf(kr[2 * t]), c1 = bf(kr[2 * t + 1]);
  float sq = c0 * c0 + c1 * c1;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, o);
  if (t % 32 == 0) warp_sq[t / 32] = sq;
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int w = 0; w < kPrepThreads / 32; ++w) total += warp_sq[w];
  const long long p = pos[r];
  if (p < 0 || p >= cap) return;
  bf16* dst = cache + static_cast<size_t>(r) * row_stride +
              static_cast<size_t>(p) * kLat;
  const float rstd = rsqrtf(total / kLora + eps);
  dst[2 * t] = __float2bfloat16_rn(c0 * rstd * bf(gain[2 * t]));
  dst[2 * t + 1] = __float2bfloat16_rn(c1 * rstd * bf(gain[2 * t + 1]));
  if (t < kRope / 2) rope_pair(kr + kLora, cs, sn, t, dst + kLora);
}

// ---- attention -------------------------------------------------------

constexpr int kThreads = 256;                 // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;                     // cached positions a tile
constexpr int kSplits = 8;                    // blocks a row: one cluster
constexpr int kMaxTiles = 16;                 // a block's tiles at 8,192
constexpr int kRowPad = kLat + 8;             // smem row: 1,168 B, so the
                                              // 8 rows of an ldmatrix fall
                                              // on distinct banks
constexpr int kPPad = kTile + 8;              // P's smem row
constexpr int kRedPad = kTile + 4;            // a partial score row
constexpr int kKParts = 4;                    // the scores' dims in 4 parts
constexpr int kKWarp = kLat / kKParts;        // 144 dims a warp's scores
constexpr int kKSteps = kKWarp / 16;          // 9 k16 steps
constexpr int kNWarp = kTile / (kWarps / kKParts);   // 32 positions
constexpr int kCWarp = kLora / kWarps;        // 64 values a warp's P.c
constexpr int kChunks = kLat * 2 / 16;        // 72 16-byte pieces a position

constexpr size_t kRingBytes = 2ull * kTile * kRowPad * sizeof(bf16);
constexpr size_t kQBytes = static_cast<size_t>(kHeads) * kRowPad * 2;
constexpr size_t kRedBytes =
    static_cast<size_t>(kKParts) * kHeads * kRedPad * sizeof(float);
constexpr size_t kPBytes = static_cast<size_t>(kHeads) * kPPad * 2;
constexpr size_t kSmem = kRingBytes + kQBytes + kRedBytes + kPBytes +
                         3 * kHeads * sizeof(float) + 2 * kTile +
                         2 * kMaxTiles * sizeof(int) + 16;
static_assert(kHeads * kLora * sizeof(float) <= kRingBytes,
              "the partial output lives in the ring once it is drained");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__global__ void __cluster_dims__(kSplits, 1, 1) __launch_bounds__(kThreads, 1)
mla_attention_kernel(const bf16* __restrict__ q_lat,
                     const bf16* __restrict__ q_pe,
                     const bf16* __restrict__ cache, long long row_stride,
                     const uint8_t* __restrict__ visible,
                     bf16* __restrict__ out, int R, int H, int cap,
                     float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);
  bf16* qs = reinterpret_cast<bf16*>(smem + kRingBytes);
  float* red = reinterpret_cast<float*>(smem + kRingBytes + kQBytes);
  bf16* ps = reinterpret_cast<bf16*>(smem + kRingBytes + kQBytes + kRedBytes);
  float* m_s = reinterpret_cast<float*>(smem + kRingBytes + kQBytes +
                                        kRedBytes + kPBytes);
  float* l_s = m_s + kHeads;
  float* a_s = l_s + kHeads;
  uint8_t* mask_s = reinterpret_cast<uint8_t*>(a_s + kHeads);   // [2][64]
  int* flags = reinterpret_cast<int*>(mask_s + 2 * kTile);      // [16]
  int* tiles = flags + kMaxTiles;                               // [16]
  float* opart = reinterpret_cast<float*>(smem);   // [16][512], after

  cg::cluster_group cluster = cg::this_cluster();
  const int split = static_cast<int>(cluster.block_rank());
  const int r = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tg = lane % 4;       // the MMA fragments' row, pair
  const bf16* crow = cache + static_cast<size_t>(r) * row_stride;
  const uint8_t* vrow = visible + static_cast<size_t>(r) * cap;
  const int candidates = (cap / kTile - split + kSplits - 1) / kSplits;

  auto issue = [&](int t, int slot) {   // tile t into a slot, and its mask
    bf16* dst = ring + slot * kTile * kRowPad;
    const bf16* src = crow + static_cast<size_t>(t) * kTile * kLat;
    for (int k = tid; k < kTile * kChunks; k += kThreads) {
      const int j = k / kChunks, c = k % kChunks;
      cp_async16(dst + j * kRowPad + c * 8, src + j * kLat + c * 8);
    }
    cp_async_commit();
    if (tid < kTile / 4)
      reinterpret_cast<uint32_t*>(mask_s + slot * kTile)[tid] =
          reinterpret_cast<const uint32_t*>(vrow + t * kTile)[tid];
  };
  // the first candidate's load starts before the mask is read: it is the
  // first visible tile whenever the row reaches it (a prefix mask)
  if (candidates > 0) issue(split, 0);

  // this block's tiles (split, split + 8, ...) with a visible position
  for (int i = warp; i < candidates; i += kWarps) {
    const int t = split + i * kSplits;
    const uint16_t v = *reinterpret_cast<const uint16_t*>(
        vrow + t * kTile + lane * 2);
    const bool any = __any_sync(0xffffffffu, v != 0);
    if (lane == 0) flags[i] = any;
  }
  if (tid < kHeads) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }
  // the query tile: q_lat (head-major) then q_pe; rows past H are zero
  for (int k = tid; k < kHeads * kChunks; k += kThreads) {
    const int h = k / kChunks, c = k % kChunks;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (h < H)
      v = c < kLora / 8
              ? *reinterpret_cast<const uint4*>(
                    q_lat + (static_cast<size_t>(h) * R + r) * kLora + c * 8)
              : *reinterpret_cast<const uint4*>(
                    q_pe + (static_cast<size_t>(r) * H + h) * kRope +
                    (c - kLora / 8) * 8);
    *reinterpret_cast<uint4*>(qs + h * kRowPad + c * 8) = v;
  }
  __syncthreads();
  __shared__ int n_tiles;
  if (tid == 0) {
    int n = 0;
    for (int i = 0; i < candidates; ++i)
      if (flags[i]) tiles[n++] = split + i * kSplits;
    n_tiles = n;
  }
  __syncthreads();
  const int n = n_tiles;
  if (candidates > 0 && (n == 0 || tiles[0] != split)) {
    cp_async_wait_all();          // the guess was wrong: drain it first
    __syncthreads();
    if (n > 0) issue(tiles[0], 0);
  }

  const int kq = warp % kKParts;               // this warp's dims
  const int half = warp / kKParts;             // and positions (scores)
  uint32_t qa[kKSteps][4];                     // its A fragments
#pragma unroll
  for (int ks = 0; ks < kKSteps; ++ks)
    ldsm_x4(qa[ks], qs + (lane % 16) * kRowPad + kq * kKWarp + ks * 16 +
                        (lane / 16) * 8);

  float o[kCWarp / 8][4];                      // P.c, 8 n-tiles
#pragma unroll
  for (int nt = 0; nt < kCWarp / 8; ++nt)
    o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;

  for (int i = 0; i < n; ++i) {
    cp_async_wait_all();
    __syncthreads();              // tile i landed; tile i - 1 fully used
    if (i + 1 < n) issue(tiles[i + 1], (i + 1) & 1);
    const bf16* kt = ring + (i & 1) * kTile * kRowPad;
    const uint8_t* mk = mask_s + (i & 1) * kTile;

    // partial scores over this warp's 144 dims and 32 positions
    float s[kNWarp / 8][4];
#pragma unroll
    for (int nt = 0; nt < kNWarp / 8; ++nt)
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kKSteps; ++ks) {
      const int col = kq * kKWarp + ks * 16 + ((lane / 8) % 2) * 8;
#pragma unroll
      for (int np = 0; np < kNWarp / 16; ++np) {
        uint32_t b[4];
        ldsm_x4(b, kt + (half * kNWarp + np * 16 + lane % 8 +
                         (lane / 16) * 8) * kRowPad + col);
        mma(s[2 * np], qa[ks], b[0], b[1]);
        mma(s[2 * np + 1], qa[ks], b[2], b[3]);
      }
    }
    float* rw = red + kq * kHeads * kRedPad + half * kNWarp;
#pragma unroll
    for (int nt = 0; nt < kNWarp / 8; ++nt) {
      const int c = nt * 8 + 2 * tg;
      *reinterpret_cast<float2*>(rw + g * kRedPad + c) =
          make_float2(s[nt][0], s[nt][1]);
      *reinterpret_cast<float2*>(rw + (g + 8) * kRedPad + c) =
          make_float2(s[nt][2], s[nt][3]);
    }
    __syncthreads();

    // online softmax: thread = (head tid / 16, positions (tid % 16) * 4 ..)
    {
      const int h = tid / 16, c0 = (tid % 16) * 4;
      float sc[4], mx = -INFINITY;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float v = 0.f;
#pragma unroll
        for (int w = 0; w < kKParts; ++w)
          v += red[(w * kHeads + h) * kRedPad + c0 + e];
        sc[e] = mk[c0 + e] ? v * scale : -INFINITY;
        mx = fmaxf(mx, sc[e]);
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = m_s[h];
      const float m_new = fmaxf(m_old, mx);    // finite: a tile has a
                                               // visible position
      float sum = 0.f;
      __align__(8) bf16 pb[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        pb[e] = __float2bfloat16_rn(expf(sc[e] - m_new));
        sum += bf(pb[e]);
      }
      *reinterpret_cast<uint2*>(ps + h * kPPad + c0) =
          *reinterpret_cast<const uint2*>(pb);
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      __syncwarp();
      if (tid % 16 == 0) {
        const float alpha = expf(m_old - m_new);   // 0 while m_old is -inf
        m_s[h] = m_new;
        l_s[h] = l_s[h] * alpha + sum;
        a_s[h] = alpha;
      }
    }
    __syncthreads();

    // P.c over this warp's 64 values
    const float al0 = a_s[g], al1 = a_s[g + 8];
#pragma unroll
    for (int nt = 0; nt < kCWarp / 8; ++nt) {
      o[nt][0] *= al0;
      o[nt][1] *= al0;
      o[nt][2] *= al1;
      o[nt][3] *= al1;
    }
#pragma unroll
    for (int ks = 0; ks < kTile / 16; ++ks) {
      uint32_t pa[4];
      ldsm_x4(pa, ps + (lane % 16) * kPPad + ks * 16 + (lane / 16) * 8);
#pragma unroll
      for (int np = 0; np < kCWarp / 16; ++np) {
        uint32_t b[4];
        ldsm_x4_t(b, kt + (ks * 16 + lane % 8 + ((lane / 8) % 2) * 8) *
                              kRowPad +
                         warp * kCWarp + np * 16 + (lane / 16) * 8);
        mma(o[2 * np], pa, b[0], b[1]);
        mma(o[2 * np + 1], pa, b[2], b[3]);
      }
    }
  }

  // this block's partial into shared memory (over the drained ring)
  __syncthreads();
#pragma unroll
  for (int nt = 0; nt < kCWarp / 8; ++nt) {
    const int c = warp * kCWarp + nt * 8 + 2 * tg;
    *reinterpret_cast<float2*>(opart + g * kLora + c) =
        make_float2(o[nt][0], o[nt][1]);
    *reinterpret_cast<float2*>(opart + (g + 8) * kLora + c) =
        make_float2(o[nt][2], o[nt][3]);
  }
  cluster.sync();

  // block b combines heads b, b + 8 from the cluster's 8 partials
  for (int h = split; h < H; h += kSplits) {
    float mp[kSplits], lp[kSplits], M = -INFINITY;
#pragma unroll
    for (int b = 0; b < kSplits; ++b) {
      mp[b] = cluster.map_shared_rank(m_s, b)[h];
      lp[b] = cluster.map_shared_rank(l_s, b)[h];
      M = fmaxf(M, mp[b]);
    }
    const int c = tid * 2;                      // 2 of the 512 values
    float2 v[kSplits];
#pragma unroll
    for (int b = 0; b < kSplits; ++b)
      v[b] = *reinterpret_cast<const float2*>(
          cluster.map_shared_rank(opart, b) + h * kLora + c);
    float acc0 = 0.f, acc1 = 0.f, L = 0.f;
#pragma unroll
    for (int b = 0; b < kSplits; ++b) {
      if (mp[b] == -INFINITY) continue;         // no visible tile there
      const float w = expf(mp[b] - M);
      L += w * lp[b];
      acc0 += w * v[b].x;
      acc1 += w * v[b].y;
    }
    const float inv = M == -INFINITY ? __int_as_float(0x7fffffff) : 1.f / L;
    *reinterpret_cast<__nv_bfloat162*>(
        out + (static_cast<size_t>(h) * R + r) * kLora + c) =
        __floats2bfloat162_rn(acc0 * inv, acc1 * inv);
  }
  cluster.sync();                 // peers read this block's shared memory
}

}  // namespace

extern "C" {

// q: [R, H * 192] (q_proj's output), kv: [R, 576] (kv_a_proj_with_mqa's),
// cos, sin: fp32 [R, 64] at each row's position, gain: bf16 [512], pos:
// int64 [R] on the device, cache: row r at cache + r * row_stride
// elements, [cap, 576] dense; q_nope: [H, R, 128], q_pe: [R, H, 64]. bf16
// unless stated, dense, 16-byte aligned; 1 <= H <= 16. The Python wrapper
// checks all of this before it calls.
int mla_decode_prep_fwd(const void* q, const void* kv, const void* cosv,
                        const void* sinv, const void* gain, float eps,
                        const void* pos, void* cache, long long row_stride,
                        int cap, int R, int H, void* q_nope, void* q_pe,
                        void* stream) {
  mla_prep_kernel<<<R, kPrepThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(kv),
      static_cast<const float*>(cosv), static_cast<const float*>(sinv),
      static_cast<const bf16*>(gain), eps,
      static_cast<const long long*>(pos), static_cast<bf16*>(cache),
      row_stride, cap, R, H, static_cast<bf16*>(q_nope),
      static_cast<bf16*>(q_pe));
  return static_cast<int>(cudaGetLastError());
}

// q_lat: [H, R, 512], q_pe: [R, H, 64], cache as for the prep with cap a
// multiple of 64 up to 8,192, visible: bool [R, cap] (one byte each),
// out: [H, R, 512]; bf16 unless stated, dense, 16-byte aligned.
int mla_decode_attention_fwd(const void* q_lat, const void* q_pe,
                             const void* cache, long long row_stride,
                             const void* visible, void* out, int R, int H,
                             int cap, float scale, void* stream) {
  // once per device (the attribute belongs to its context), on the first
  // launch there, which runs eagerly before any graph captures one
  static int ready[256] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 256 || !ready[dev]) {
    err = cudaFuncSetAttribute(mla_attention_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kSmem));
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < 256) ready[dev] = 1;
  }
  mla_attention_kernel<<<dim3(kSplits, R), kThreads, kSmem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q_lat), static_cast<const bf16*>(q_pe),
      static_cast<const bf16*>(cache), row_stride,
      static_cast<const uint8_t*>(visible), static_cast<bf16*>(out), R, H,
      cap, scale);
  return static_cast<int>(cudaGetLastError());
}

const char* mla_decode_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
