// Attention of one query position per (row, head) over a K/V cache, for
// Hopper (sm_90a): the self- and the cross-attention of the text decoder
// of models/seamless_s2t.py, one launch each per layer and decode step.
//
// Computes, per row r and head h (head size d = 64):
//
//   s_j = scale * (q . k_j) + bias[r, j]                  fp32, bias optional
//   o   = sum_j exp(s_j - max s) v_j / sum_j exp(s_j - max s)
//
// with every sum in fp32 and o written once, in the input type (bf16 or
// fp32). q and o are [R, H * 64], the layout of the projections around it.
//
// Self mode (pos given): the block writes its row's new key and value
// (k_new, v_new: [R, H * 64]) into the caches [R, H, Lk, 64] at *pos, a
// device scalar, so one captured CUDA graph serves every position, and
// attends over positions 0 .. *pos only, taking the new key and value from
// k_new / v_new rather than back from the cache. Masking the later
// positions with finfo.min, as the plain chain does, gives them weight 0
// exactly, so this is the same function. A *pos outside [0, Lk) writes
// nothing and gives NaN. Cross mode: attends over all Lk keys
// ([R, H, Lk, 64]) under the additive bias [R, Lk] (the padded adaptor
// frames' finfo.min); a row whose every key is masked gets uniform weights,
// as softmax does, since finfo.min swallows every score.
//
// Replaces no TPU kernel: the JAX package has no text decoder. It replaces
// a chain of eight small launches per attention (query scaling, two cache
// writes, two batched products, the bias add, the softmax, two casts)
// inside each decode step's CUDA graph, where each launch costs a node of
// the graph and ~3 us of mostly idle card time.
//
// What bounds it: bytes. It reads q, the keys and values it attends over
// and the bias once, and writes o (and in self mode one cache row): at 48
// rows x 16 heads, cross over 161 frames is 31.7 MB of K/V (9.5 us at
// 3.35 TB/s); self at position 52, 10.4 MB (3.1 us). The arithmetic is
// 4 * d FLOP per key, 2 FLOP per byte in bf16, far below the tensor cores'
// line, so it runs on the CUDA cores.
//
// Design. One block of 128 threads per (row, head): 768 blocks at 48 rows,
// up to 6 resident per SM, so the card holds them all at once. A key (128 B
// in bf16, 256 B in fp32) is read by 8 (16) threads, 16 B each, so one load
// instruction of the block covers 16 (8) keys, one per key slot. The block
// makes one pass over the keys: in each round a thread issues the loads of
// kUnroll keys and of their values before it uses any of them (8 loads of
// 16 B in flight per thread), and each slot keeps its own online softmax
// (running max, row sum and fp32 P.V partial sum, rescaled once a round), so
// no round waits for a reduction over the block and no score is stored. A
// self launch below position 64 is one round; cross over 161 frames three.
// The slots' partial results are merged once at the end in shared memory.
// The cache write comes last, after every load of the block.
//
// C interface (loaded with ctypes): decode_attention_fwd returns the
// cudaError_t of the launch; 0 means the kernel was launched.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kD = 64;          // head size
constexpr int kThreads = 128;
constexpr int kUnroll = 4;      // keys (and values) loaded per thread a round

template <typename T>
struct Elem;

template <>
struct Elem<float> {
  static constexpr int kVec = 4;     // elements per 16-byte load
  static __device__ __forceinline__ void unpack(const uint4& u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
  static __device__ __forceinline__ float from_float(float x) { return x; }
};

template <>
struct Elem<__nv_bfloat16> {
  static constexpr int kVec = 8;
  static __device__ __forceinline__ void unpack(const uint4& u, float* f) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {   // element 2i is the low half
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ __nv_bfloat16 from_float(float x) {
    return __float2bfloat16_rn(x);
  }
};

__device__ __forceinline__ uint4 load16(const void* p) {
  return *reinterpret_cast<const uint4*>(p);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 6)
decode_attention_kernel(const T* __restrict__ q, T* k, T* v,
                        const T* __restrict__ k_new,
                        const T* __restrict__ v_new,
                        const long long* __restrict__ pos,
                        const float* __restrict__ bias, T* __restrict__ out,
                        int H, int Lk, float scale) {
  using E = Elem<T>;
  constexpr int kVec = E::kVec;
  constexpr int kTpk = kD / kVec;            // threads per key: 8 or 16
  constexpr int kSlots = kThreads / kTpk;    // keys per load: 16 or 8
  constexpr int kRound = kSlots * kUnroll;   // keys per round of loads
  __shared__ float part[kSlots][kD];
  __shared__ float slot_max[kSlots];
  __shared__ float slot_sum[kSlots];

  const int tid = threadIdx.x;
  const int lane = tid % kTpk;               // owns dims lane*kVec .. +kVec
  const int slot = tid / kTpk;               // owns keys slot, slot+kSlots..
  const size_t bh = blockIdx.x;              // r * H + h
  const size_t r = bh / H;
  const size_t row = bh * kD + lane * kVec;  // q, out, k_new, v_new offset
  const size_t base = bh * static_cast<size_t>(Lk) * kD + lane * kVec;

  int n = Lk;
  int self = -1;                             // the new key's position
  if (pos != nullptr) {
    const long long p = *pos;
    if (p < 0 || p >= Lk) {
      const float nan = __int_as_float(0x7fffffff);
      if (tid < kD) out[bh * kD + tid] = E::from_float(nan);
      return;
    }
    self = static_cast<int>(p);
    n = self + 1;
  }
  auto key = [&](int j) {
    return j == self ? load16(k_new + row)
                     : load16(k + base + static_cast<size_t>(j) * kD);
  };
  auto value = [&](int j) {
    return j == self ? load16(v_new + row)
                     : load16(v + base + static_cast<size_t>(j) * kD);
  };

  const uint4 qv = load16(q + row);
  float m = -INFINITY;                       // this slot's running max,
  float l = 0.f;                             // sum of exp(s - m)
  float acc[kVec];                           // and sum of exp(s - m) v
#pragma unroll
  for (int e = 0; e < kVec; ++e) acc[e] = 0.f;

  for (int j0 = 0; j0 < n; j0 += kRound) {
    uint4 kr[kUnroll], vr[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = j0 + u * kSlots + slot;
      kr[u] = j < n ? key(j) : make_uint4(0, 0, 0, 0);
      vr[u] = j < n ? value(j) : make_uint4(0, 0, 0, 0);
    }
    float qf[kVec];
    E::unpack(qv, qf);
    float sc[kUnroll];
    float m_new = m;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = j0 + u * kSlots + slot;
      float f[kVec];
      E::unpack(kr[u], f);
      float dot = 0.f;
#pragma unroll
      for (int e = 0; e < kVec; ++e) dot = fmaf(qf[e], f[e], dot);
#pragma unroll
      for (int o = kTpk / 2; o > 0; o >>= 1)   // every lane gets the sum
        dot += __shfl_xor_sync(0xffffffffu, dot, o);
      sc[u] = j < n ? dot * scale + (bias != nullptr ? bias[r * Lk + j]
                                                    : 0.f)
                    : -INFINITY;
      m_new = fmaxf(m_new, sc[u]);
    }
    if (m_new == -INFINITY) continue;        // no key of this slot yet
    const float alpha = expf(m - m_new);     // 0 while m is -inf
    l *= alpha;
#pragma unroll
    for (int e = 0; e < kVec; ++e) acc[e] *= alpha;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const float p = expf(sc[u] - m_new);   // 0 past the last key
      float f[kVec];
      E::unpack(vr[u], f);
      l += p;
#pragma unroll
      for (int e = 0; e < kVec; ++e) acc[e] = fmaf(p, f[e], acc[e]);
    }
    m = m_new;
  }

#pragma unroll
  for (int e = 0; e < kVec; ++e) part[slot][lane * kVec + e] = acc[e];
  if (lane == 0) {
    slot_max[slot] = m;
    slot_sum[slot] = l;
  }
  __syncthreads();
  if (tid < kD) {
    float mx = slot_max[0];
#pragma unroll
    for (int i = 1; i < kSlots; ++i) mx = fmaxf(mx, slot_max[i]);
    float o = 0.f, sum = 0.f;
#pragma unroll
    for (int i = 0; i < kSlots; ++i) {
      const float w = slot_max[i] == -INFINITY ? 0.f
                                               : expf(slot_max[i] - mx);
      o = fmaf(w, part[i][tid], o);
      sum = fmaf(w, slot_sum[i], sum);
    }
    out[bh * kD + tid] = E::from_float(o / sum);
  }
  if (self >= 0 && tid < kTpk) {             // the new key and value
    const size_t at = base + static_cast<size_t>(self) * kD;
    *reinterpret_cast<uint4*>(k + at) = load16(k_new + row);
    *reinterpret_cast<uint4*>(v + at) = load16(v_new + row);
  }
}

template <typename T>
cudaError_t launch_typed(const void* q, void* k, void* v, const void* k_new,
                         const void* v_new, const void* pos,
                         const void* bias, void* out, int R, int H, int Lk,
                         float scale, cudaStream_t stream) {
  decode_attention_kernel<T><<<R * H, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<T*>(k), static_cast<T*>(v),
      static_cast<const T*>(k_new), static_cast<const T*>(v_new),
      static_cast<const long long*>(pos), static_cast<const float*>(bias),
      static_cast<T*>(out), H, Lk, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q, out: [R, H * 64]; k, v: [R, H, Lk, 64]; all contiguous, one type: fp32
// (is_bf16 = 0) or bf16 (is_bf16 = 1), 16-byte aligned. Self mode: pos a
// device int64 scalar, k_new and v_new [R, H * 64] like q, bias null.
// Cross mode: pos, k_new and v_new null; bias null or fp32 [R, Lk]. The
// Python wrapper checks all of this before it calls.
int decode_attention_fwd(const void* q, void* k, void* v, const void* k_new,
                         const void* v_new, const void* pos,
                         const void* bias, void* out, int R, int H, int Lk,
                         float scale, int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch_typed<__nv_bfloat16>(q, k, v, k_new, v_new, pos, bias,
                                            out, R, H, Lk, scale, st)
              : launch_typed<float>(q, k, v, k_new, v_new, pos, bias, out, R,
                                    H, Lk, scale, st);
  return static_cast<int>(err);
}

const char* decode_attention_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
