// Tile machinery shared by the port's streaming attention kernels
// (flash_rel_attention.cu, flash_attention.cu, flash_rel_parts.cu).
//
// Layout: one block of 256 threads
// per (batch b, head h, 64-row q tile), walking the kv axis in 64-column
// tiles. Thread (ty, tx) of the 16 x 16 thread grid owns a 4 x 4 patch of
// the 64 x 64 score tile (q rows ty*4 .. +3, kv columns tx*4 .. +3) and
// the same rows of a 4 x 4 patch of the output (head dims tx*4 .. +3), so
// a row max or row sum reduces over the 16 lanes of a half warp. Tiles
// are staged in shared memory as fp32; q, k and p are transposed so that
// every step of the two inner products is two 16-byte shared loads for
// 16 FMAs. Head size 64 only.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace attn {

constexpr int kD = 64;         // head size
constexpr int kBQ = 64;        // q rows per block
constexpr int kBK = 64;        // kv columns per tile
constexpr int kThreads = 256;  // 16 x 16 thread grid, 4x4 outputs each
constexpr int kLd = kBQ + 4;   // padded row of the transposed tiles

struct Tiles {
  float qt[kD][kLd];           // q tile, transposed: qt[d][r]
  float kt[kD][kLd];           // k tile, transposed: kt[d][c]
  float v[kBK][kD + 4];        // v tile: v[c][d]
  float pt[kBK][kLd];          // probabilities, transposed: pt[c][r]
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// x rounded to T and widened back: what a product with a T operand sees.
template <typename T>
__device__ __forceinline__ float round_to(float x);
template <>
__device__ __forceinline__ float round_to<float>(float x) { return x; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// Four consecutive values (16-byte aligned for float, 8 for bf16).
__device__ __forceinline__ void load4(const float* p, float out[4]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  out[0] = x.x; out[1] = x.y; out[2] = x.z; out[3] = x.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p,
                                      float out[4]) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  out[0] = a.x; out[1] = a.y; out[2] = b.x; out[3] = b.y;
}

// Max and sum over the 16 lanes that share a row group (lanes 0-15 and
// 16-31 of a warp are two separate groups).
__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// 64 rows of 64 values starting at src, transposed into dst[d][row].
template <typename T>
__device__ __forceinline__ void load_transposed(float (*dst)[kLd],
                                                const T* __restrict__ src,
                                                int tid) {
  for (int i = tid; i < kBQ * kD; i += kThreads)
    dst[i % kD][i / kD] = to_f32(src[i]);
}

template <typename T>
__device__ __forceinline__ void load_v(Tiles& s, const T* __restrict__ src,
                                       int tid) {
  for (int i = tid; i < kBK * kD; i += kThreads)
    s.v[i / kD][i % kD] = to_f32(src[i]);
}

// The k tile (transposed) and the v tile of one kv step in one pass,
// two global loads in flight per iteration.
template <typename T>
__device__ __forceinline__ void load_kv(Tiles& s, const T* __restrict__ k,
                                        const T* __restrict__ v, int tid) {
  for (int i = tid; i < kBK * kD; i += kThreads) {
    const int c = i / kD;
    const int d = i % kD;
    s.kt[d][c] = to_f32(k[i]);
    s.v[c][d] = to_f32(v[i]);
  }
}

// sc[i][j] = q_{ty*4+i} . k_{tx*4+j} over the staged q and k tiles.
__device__ __forceinline__ void qk_patch(const Tiles& s, int ty, int tx,
                                         float sc[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < kD; ++d) {
    const float4 a = *reinterpret_cast<const float4*>(&s.qt[d][ty * 4]);
    const float4 b = *reinterpret_cast<const float4*>(&s.kt[d][tx * 4]);
    const float av[4] = {a.x, a.y, a.z, a.w};
    const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(av[i], bv[j], sc[i][j]);
  }
}

// The thread's 4x4 patch of p into the transposed p tile.
__device__ __forceinline__ void store_p(Tiles& s, int ty, int tx,
                                        const float p[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s.pt[tx * 4 + j][ty * 4 + i] = p[i][j];
}

// o[i][j] += sum_c p[ty*4+i][c] * v[c][tx*4+j] over the staged tiles.
__device__ __forceinline__ void pv_patch(const Tiles& s, int ty, int tx,
                                         float o[4][4]) {
#pragma unroll 8
  for (int c = 0; c < kBK; ++c) {
    const float4 a = *reinterpret_cast<const float4*>(&s.pt[c][ty * 4]);
    const float4 b = *reinterpret_cast<const float4*>(&s.v[c][tx * 4]);
    const float av[4] = {a.x, a.y, a.z, a.w};
    const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) o[i][j] = fmaf(av[i], bv[j], o[i][j]);
  }
}

}  // namespace attn
