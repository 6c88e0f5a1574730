// Shared device helpers of the attention kernels (flash forward and
// backward, dense and paged decode): f32/bf16 vector loads and stores, the
// decode kernels' warp geometry and 16-byte unpacking (f32, bf16, f16,
// int8), row loads (f32, bf16, f16, int8), and the attention-dropout keep
// mask.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace flash {

constexpr float kNegInf = -1e30f;  // the masked-score sentinel

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  uint2 raw = *reinterpret_cast<const uint2*>(p);
  float2 a = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&raw.x));
  float2 b = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
  uint2 raw;
  raw.x = *reinterpret_cast<uint32_t*>(&a);
  raw.y = *reinterpret_cast<uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = raw;
}

template <int BYTES> struct Vec;
template <> struct Vec<2> { using type = uint16_t; };
template <> struct Vec<4> { using type = uint32_t; };
template <> struct Vec<8> { using type = uint2; };
template <> struct Vec<16> { using type = uint4; };

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_float(int8_t x) { return static_cast<float>(x); }

// round to nearest even, as torch's .to() and the reference's astype
template <typename T>
__device__ __forceinline__ T from_float(float x) {
  if constexpr (std::is_same<T, float>::value) {
    return x;
  } else if constexpr (std::is_same<T, __half>::value) {
    return __float2half_rn(x);
  } else {
    return __float2bfloat16(x);
  }
}

// N contiguous values at p (aligned to N * sizeof(T), or to 16 bytes when
// that is more) -> f32: one load of up to 16 bytes, or several
template <typename T, int N>
__device__ __forceinline__ void load_row(const T* p, float* out) {
  constexpr int BYTES = N * static_cast<int>(sizeof(T));
  if constexpr (BYTES <= 16) {
    using V = typename Vec<BYTES>::type;
    V raw = *reinterpret_cast<const V*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = to_float(e[i]);
  } else {
    load_row<T, N / 2>(p, out);
    load_row<T, N / 2>(p + N / 2, out + N / 2);
  }
}

// The decode kernels' warp geometry at element type T (f32, bf16, f16 or
// int8)
// and head dim D: a key row is taken by a lane group of LPR lanes, each
// loading 16 bytes (VEC values) NCH times; a warp-wide load covers RPW
// rows, a lane group takes U rows a step.
template <typename T, int D>
struct Dec {
  static constexpr int VEC = 16 / (int)sizeof(T);  // values a 16-byte load
  static constexpr int LPR = D / VEC < 32 ? D / VEC : 32;  // lanes a row
  static constexpr int NCH = D / (VEC * LPR);  // 16-byte chunks a lane a row
  static constexpr int NE = VEC * NCH;         // dims a lane owns
  static constexpr int RPW = 32 / LPR;         // key rows a warp-wide load
  static constexpr int U = 2;                  // key rows a lane group a step
  static constexpr int KK = RPW * U;           // keys a warp step
};

// 16 bytes of T -> f32
template <typename T>
__device__ __forceinline__ void unpack(const uint4& raw, float* out) {
  if constexpr (std::is_same<T, float>::value) {
    out[0] = __uint_as_float(raw.x);
    out[1] = __uint_as_float(raw.y);
    out[2] = __uint_as_float(raw.z);
    out[3] = __uint_as_float(raw.w);
  } else if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  } else if constexpr (std::is_same<T, __half>::value) {
    const __half2* h = reinterpret_cast<const __half2*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __half22float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  } else {
    const int8_t* e = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
    for (int i = 0; i < 16; ++i) out[i] = static_cast<float>(e[i]);
  }
}

// x rounded to T and back: the reference rounds the probabilities and ds
// to the input dtype before each product with V, K, Q or dO (an identity
// for f32)
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  if constexpr (std::is_same<T, float>::value) {
    return x;
  } else if constexpr (std::is_same<T, __half>::value) {
    return __half2float(__float2half_rn(x));
  } else {
    return __bfloat162float(__float2bfloat16(x));
  }
}

// Attention dropout, bit for bit the TPU kernel's _dropout_keep
// (paddle_tpu/ops/pallas/flash_attention.py): a murmur3 finalizer over the
// global element position gid = q_pos * sk + k_pos (uint32, wrapping),
// xor-ed with the seed and the folded batch*head index. The element is kept
// when the top 24 bits of the hash reach thresh = int(rate * 2^24). Forward
// and backward kernels regenerate the same mask; none is stored.
__device__ __forceinline__ uint32_t dropout_mix(int seed, int bh) {
  return (uint32_t)seed * 0x9E3779B9u + (uint32_t)bh * 0x85EBCA6Bu;
}

__device__ __forceinline__ bool dropout_keep(uint32_t mix, int q_pos,
                                             int k_pos, int sk,
                                             uint32_t thresh) {
  uint32_t x = ((uint32_t)q_pos * (uint32_t)sk + (uint32_t)k_pos) ^ mix;
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return (x >> 8) >= thresh;
}

}  // namespace flash
