// The conformer's LayerNorm over bf16 rows with fp32 statistics, fused with
// the residual add before it and the padding mask or SiLU after it, for
// Hopper (sm_90a): models/layer_norm.py::add_layer_norm, six launches per
// conformer layer of models/wav2vec2bert.py.
//
// Per row of width C (x, and the branch a when given, bf16):
//
//   r = bf16(bf16(a * alpha) + x)            (r = x without a branch)
//   y = bf16((r - mean(r)) * rsqrt(var(r) + eps) * gamma + beta)
//   y = bf16(y * bf16(mask[row]))  or  y = bf16(silu(y))      (optional)
//
// with mean and var over the row in fp32 and gamma, beta fp32. Each rounding
// is one the plain PyTorch composition it replaces makes (a bf16 product, a
// bf16 add, an fp32 LayerNorm of the upcast row cast back, then a bf16 mask
// product or SiLU), so r is bit for bit the plain r and y differs from the
// plain y only by the order of the row's fp32 sums: one bf16 step at most,
// away from 0 (near 0 that order's ~1e-6 is larger than a bf16 step).
// It writes y and, when asked, r (the residual stream of the next layer).
// Without a branch it also takes x as the depthwise convolution leaves it,
// [B, C, L], and writes y [B, L, C] (add_layer_norm_cols_kernel).
//
// Replaces no TPU kernel: the JAX package's layer_norm
// (audio_processor_tpu/models/wav2vec2bert.py:150) is plain XLA, which fuses
// the add, the casts and the norm by itself. In eager PyTorch the same
// composition was five to seven passes over a [B, L, C] activation: the add
// (or a product and an add), the fp32 upcast, the norm, the downcast, the
// mask product or SiLU, each through device memory.
//
// What bounds it: bytes. It reads x (and a) and writes y (and r), 2 bytes an
// element each, and the arithmetic is ~10 FLOP per element. At 48 x 1280
// rows of 1024 a launch with a branch and both outputs moves 503 MB
// (0.150 ms at 3.35 TB/s); the plain composition moved about 1.5 GB.
//
// Design. A block of 256 threads; a row of C is held by T threads (a power
// of two, T = C / 32 at the main path's C = 1024: one warp per row, eight
// rows per block), each owning kVecs 16-byte vectors of 8 elements, the
// vectors of neighbouring threads adjacent in memory, so every load and
// store is a whole coalesced 16 bytes. The row stays in registers from the
// load to the store: the sum, then the sum of squared deviations from the
// mean (two reductions, shuffles within the warp and, for T > 32, a word
// per warp in shared memory). gamma and beta go to shared memory once per
// block, and the grid is one wave of resident blocks that walks the rows, so
// they are read once per block and not once per row. From [B, C, L] a block
// stages 16 frames of every channel in shared memory (a column's 32 bytes by
// two neighbouring threads, so every 32-byte sector read is whole) and
// normalises them as rows from there, which spares the copy to [B, L, C]:
// 252 MB of traffic a layer at 48 x 1280.
//
// C interface (loaded with ctypes): add_layer_norm_fwd returns the
// cudaError_t of the launch; 0 means the kernel was launched.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kVecs = 4;                      // 16-byte vectors a thread owns
constexpr int kMaxWidth = 128 * kVecs * 8;    // 4096: T up to 128
constexpr int kTile = 16;                     // frames a cols block stages

enum Epilogue { kNone = 0, kMask = 1, kSilu = 2 };

__device__ __forceinline__ void unpack(const uint4& u, float* f) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {   // element 2i is the low half
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ uint4 pack(const float* f) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    w[i] = *reinterpret_cast<const uint32_t*>(&h);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// The sum of v over the T threads of a row (every thread gets it; T a power
// of two, the same in every thread). For T > 32 the row's warps meet in red,
// which the caller does not reuse before the block has passed another
// barrier.
__device__ __forceinline__ float row_sum(float v, float* red, int T) {
  for (int o = (T < 32 ? T : 32) / 2; o > 0; o >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o);
  if (T > 32) {
    if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
    __syncthreads();
    const int first = threadIdx.x / T * (T / 32);
    v = 0.f;
    for (int i = 0; i < T / 32; ++i) v += red[first + i];
  }
  return v;
}

// The row's statistics from r (the T threads' vectors lane + k * T; zeros
// off the row), then y written at yrow (when live): every thread of the block
// calls it, since for T > 32 it meets the row's other warps at a barrier.
__device__ __forceinline__ void normalize(const float (&r)[kVecs][8],
                                          int T, int lane, int vecs, bool live,
                                          int C, float eps, const float* gb,
                                          int epilogue, float m,
                                          __nv_bfloat16* yrow, float* red) {
  float sum = 0.f;
#pragma unroll
  for (int k = 0; k < kVecs; ++k) {
#pragma unroll
    for (int e = 0; e < 8; ++e) sum += r[k][e];
  }
  const float inv_c = 1.f / static_cast<float>(C);
  const float mean = row_sum(sum, red, T) * inv_c;
  float sq = 0.f;
#pragma unroll
  for (int k = 0; k < kVecs; ++k) {
    if (lane + k * T < vecs) {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float d = r[k][e] - mean;
        sq = fmaf(d, d, sq);
      }
    }
  }
  const float rstd = rsqrtf(row_sum(sq, red + kThreads / 32, T) * inv_c
                            + eps);
#pragma unroll
  for (int k = 0; k < kVecs; ++k) {
    const int v = lane + k * T;
    if (!live || v >= vecs) continue;
    const float* g = gb + v * 8;
    const float* b = gb + C + v * 8;
    float out[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      float o = round_bf16((r[k][e] - mean) * rstd * g[e] + b[e]);
      if (epilogue == kMask) o *= m;
      else if (epilogue == kSilu) o = o / (1.f + expf(-o));
      out[e] = o;
    }
    *reinterpret_cast<uint4*>(yrow + v * 8) = pack(out);
  }
}

__device__ __forceinline__ void load_params(const float* gamma,
                                            const float* beta, int C,
                                            float* gb) {
  for (int i = threadIdx.x; i < C; i += kThreads) {
    gb[i] = gamma[i];
    gb[C + i] = beta[i];
  }
}

// Rows of x [rows, C] (and of the branch a), T threads a row.
__global__ void __launch_bounds__(kThreads, 3)
add_layer_norm_kernel(int T, const __nv_bfloat16* __restrict__ x,
                      const __nv_bfloat16* __restrict__ a,
                      const float* __restrict__ gamma,
                      const float* __restrict__ beta,
                      const float* __restrict__ mask,
                      __nv_bfloat16* __restrict__ r_out,
                      __nv_bfloat16* __restrict__ y, int rows, int C,
                      float alpha, float eps, int epilogue) {
  const int rows_at_once = kThreads / T;
  extern __shared__ float gb[];               // gamma [C], then beta [C]
  __shared__ float red[2 * kThreads / 32];
  load_params(gamma, beta, C, gb);
  __syncthreads();

  const int vecs = C / 8;
  const int lane = threadIdx.x % T;           // owns vectors lane + k * T
  for (long long row0 = static_cast<long long>(blockIdx.x) * rows_at_once;
       row0 < rows;
       row0 += static_cast<long long>(gridDim.x) * rows_at_once) {
    const long long row = row0 + threadIdx.x / T;
    const bool live = row < rows;
    const size_t base = static_cast<size_t>(live ? row : 0) * C;

    uint4 xv[kVecs], av[kVecs];
#pragma unroll
    for (int k = 0; k < kVecs; ++k) {          // every load before any use
      const int v = lane + k * T;
      const bool ok = live && v < vecs;
      const uint4 zero = make_uint4(0, 0, 0, 0);
      xv[k] = ok ? *reinterpret_cast<const uint4*>(x + base + v * 8) : zero;
      av[k] = ok && a != nullptr
                  ? *reinterpret_cast<const uint4*>(a + base + v * 8)
                  : zero;
    }
    float r[kVecs][8];
#pragma unroll
    for (int k = 0; k < kVecs; ++k) {
      unpack(xv[k], r[k]);
      if (a != nullptr) {
        float f[8];
        unpack(av[k], f);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float p = alpha == 1.f ? f[e] : round_bf16(f[e] * alpha);
          r[k][e] = round_bf16(p + r[k][e]);
        }
        const int v = lane + k * T;
        if (r_out != nullptr && live && v < vecs)
          *reinterpret_cast<uint4*>(r_out + base + v * 8) = pack(r[k]);
      }
    }
    const float m = epilogue == kMask && live ? round_bf16(mask[row]) : 1.f;
    normalize(r, T, lane, vecs, live, C, eps, gb, epilogue, m, y + base,
              red);
  }
}

// x [B, C, L] (the depthwise convolution's output), normalised over C for
// each of the B * L frames into y [B, L, C]. A block takes kTile frames of
// one sequence at a time: their C x kTile columns are read 16 bytes (8
// frames) a thread where L is a multiple of 8, else an element at a time,
// transposed into shared memory, and normalised from there as rows.
__global__ void __launch_bounds__(kThreads, 3)
add_layer_norm_cols_kernel(int T, const __nv_bfloat16* __restrict__ x,
                           const float* __restrict__ gamma,
                           const float* __restrict__ beta,
                           const float* __restrict__ mask,
                           __nv_bfloat16* __restrict__ y, int B, int L,
                           int C, float eps, int epilogue) {
  const int rows_at_once = kThreads / T;
  extern __shared__ float gb[];               // gamma, beta, then the tile
  __shared__ float red[2 * kThreads / 32];
  const int pitch = C + 8;                    // bf16; rows stay 16-B aligned
  uint16_t* tile = reinterpret_cast<uint16_t*>(gb + 2 * C);   // bf16 bits
  load_params(gamma, beta, C, gb);

  const int vecs = C / 8;
  const int lane = threadIdx.x % T;
  const int tiles_per_seq = (L + kTile - 1) / kTile;
  const long long tiles = static_cast<long long>(B) * tiles_per_seq;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int b = static_cast<int>(t / tiles_per_seq);
    const int l0 = static_cast<int>(t % tiles_per_seq) * kTile;
    const uint16_t* xs = reinterpret_cast<const uint16_t*>(x)
                         + static_cast<size_t>(b) * C * L + l0;
    __syncthreads();                          // the last tile is read
    // column c, frames l0 + f0 .. l0 + f0 + 7, for (c, f0) = (i / 2,
    // 8 * (i % 2)): neighbouring threads read a column's 32 bytes
    for (int i = threadIdx.x; i < 2 * C; i += kThreads) {
      const int c = i >> 1, f0 = (i & 1) * 8;
      const uint16_t* col = xs + static_cast<size_t>(c) * L + f0;
      uint32_t w[4] = {0, 0, 0, 0};           // element 2j is the low half
      if (L % 8 == 0) {
        if (l0 + f0 < L) {
          const uint4 u = *reinterpret_cast<const uint4*>(col);
          w[0] = u.x, w[1] = u.y, w[2] = u.z, w[3] = u.w;
        }
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          if (l0 + f0 + e < L)
            w[e / 2] |= static_cast<uint32_t>(col[e]) << (16 * (e % 2));
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        tile[(f0 + 2 * j) * pitch + c] = static_cast<uint16_t>(w[j]);
        tile[(f0 + 2 * j + 1) * pitch + c] =
            static_cast<uint16_t>(w[j] >> 16);
      }
    }
    __syncthreads();
    // every thread runs the same number of rounds (normalize may meet the
    // row's other warps at a barrier)
    const int rounds = (kTile + rows_at_once - 1) / rows_at_once;
    for (int f = threadIdx.x / T; f < rounds * rows_at_once;
         f += rows_at_once) {
      const bool live = f < kTile && l0 + f < L;
      const uint16_t* src = tile + (live ? f : 0) * pitch;
      float r[kVecs][8];
#pragma unroll
      for (int k = 0; k < kVecs; ++k) {
        const int v = lane + k * T;
        const uint4 u = live && v < vecs
                            ? *reinterpret_cast<const uint4*>(src + v * 8)
                            : make_uint4(0, 0, 0, 0);
        unpack(u, r[k]);
      }
      const size_t row = static_cast<size_t>(b) * L + l0 + (live ? f : 0);
      const float m = epilogue == kMask && live ? round_bf16(mask[row]) : 1.f;
      normalize(r, T, lane, vecs, live, C, eps, gb, epilogue, m,
                y + row * C, red);
    }
  }
}

cudaError_t grid_of(const void* kernel, size_t smem, long long work,
                    int* grid) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && smem > 48 * 1024)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, smem);
  const long long wave = static_cast<long long>(sms) * (per_sm > 0 ? per_sm
                                                                   : 1);
  *grid = static_cast<int>(work < wave ? work : wave);
  return err;
}

cudaError_t launch(const void* x, const void* a, const void* gamma,
                   const void* beta, const void* mask, void* r_out, void* y,
                   int rows, int L, int C, float alpha, float eps,
                   int epilogue, cudaStream_t stream) {
  // T: the least power of two whose threads hold a row in kVecs vectors
  int T = 1;
  while (T * kVecs * 8 < C) T *= 2;
  const auto* bx = static_cast<const __nv_bfloat16*>(x);
  const auto* g = static_cast<const float*>(gamma);
  const auto* be = static_cast<const float*>(beta);
  const auto* mk = static_cast<const float*>(mask);
  auto* by = static_cast<__nv_bfloat16*>(y);
  size_t smem = 2 * static_cast<size_t>(C) * sizeof(float);
  int grid = 0;
  cudaError_t err;
  if (L == 0) {
    const auto kernel = add_layer_norm_kernel;
    err = grid_of(reinterpret_cast<const void*>(kernel), smem,
                  (rows + kThreads / T - 1) / (kThreads / T), &grid);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kThreads, smem, stream>>>(
        T, bx, static_cast<const __nv_bfloat16*>(a), g, be, mk,
        static_cast<__nv_bfloat16*>(r_out), by, rows, C, alpha, eps,
        epilogue);
  } else {
    const auto kernel = add_layer_norm_cols_kernel;
    smem += static_cast<size_t>(kTile) * (C + 8) * sizeof(__nv_bfloat16);
    const int B = rows / L;
    err = grid_of(reinterpret_cast<const void*>(kernel), smem,
                  static_cast<long long>(B) * ((L + kTile - 1) / kTile),
                  &grid);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kThreads, smem, stream>>>(T, bx, g, be, mk, by, B, L, C,
                                             eps, epilogue);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x, a, r_out, y: [rows, C] bf16; gamma, beta: [C] fp32; mask: [rows] fp32;
// all contiguous and 16-byte aligned, C a multiple of 8 in [8, 4096]. a null:
// no branch (r = x; r_out must be null); r_out null: r is not written; mask
// is read only under epilogue 1 (mask) and may be null otherwise; epilogue 2
// is SiLU. L > 0: x is [rows / L, C, L] instead (each sequence's channels
// as rows of L frames), and a and r_out are null. The Python wrapper checks
// all of this before it calls.
int add_layer_norm_fwd(const void* x, const void* a, const void* gamma,
                       const void* beta, const void* mask, void* r_out,
                       void* y, int rows, int L, int C, float alpha,
                       float eps, int epilogue, void* stream) {
  if (C < 8 || C % 8 != 0 || C > kMaxWidth || rows < 0 || L < 0
      || (L > 0 && (rows % L != 0 || a != nullptr || r_out != nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  return static_cast<int>(launch(x, a, gamma, beta, mask, r_out, y, rows, L,
                                 C, alpha, eps, epilogue,
                                 static_cast<cudaStream_t>(stream)));
}

const char* add_layer_norm_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
