// Shared device helpers of the attention kernels (flash forward and
// backward, dense and paged decode): f32/bf16 vector loads and stores, the
// decode kernels' warp geometry and 16-byte unpacking (f32, bf16, f16,
// int8), row loads (f32, bf16, f16, int8), the attention-dropout keep
// mask, and the dense attention mask's reads.
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

// A dense attention mask of the flash forward and backward (their
// kernels' DENSE instantiations, csrc/flash_attention_{fwd,bwd}.cu): one
// tensor that broadcasts to [B, H, Sq, Sk], read in place through its four
// element strides, 0 on a broadcast dimension (a [B, 1, 1, Sk] padding
// mask is B * Sk values, never expanded). The folded batch*head index bh
// is b * heads + h. As the reference's dense path applies it, after the
// scale and the causal mask: a bool keep-mask masks where it is false (the
// reference's where(mask, logits, -inf)); a float mask (f32, bf16 or f16,
// widened to f32) is added to the scaled score, -inf included. `lo` is the
// low part of the row log-sum-exp (two_sum below), [bh, sq] f32 right after
// lse: the forward writes it, the backward reads it.
enum MaskKind { kMaskBool = 1, kMaskF32 = 2, kMaskBf16 = 3, kMaskF16 = 4 };

struct DenseMask {
  const void* ptr;
  long long sb, sh, sr, sc;  // element strides of b, h, the query, the key
  int heads;
  int kind;  // a MaskKind
  float* lo;
};

// the C entries' check of a mask: a known kind over at least one head
__host__ __forceinline__ bool mask_ok(const DenseMask& m) {
  return m.kind >= kMaskBool && m.kind <= kMaskF16 && m.heads > 0;
}

// the element offset of (b, h, 0, 0) for the folded index bh
__device__ __forceinline__ long long mask_base(const DenseMask& m, int bh) {
  return (long long)(bh / m.heads) * m.sb + (long long)(bh % m.heads) * m.sh;
}

// the bias at element `at` of a float mask of kind KIND, in f32
template <int KIND>
__device__ __forceinline__ float mask_bias(const DenseMask& m, long long at) {
  if constexpr (KIND == kMaskF32)
    return static_cast<const float*>(m.ptr)[at];
  else if constexpr (KIND == kMaskBf16)
    return __bfloat162float(static_cast<const __nv_bfloat16*>(m.ptr)[at]);
  else
    return __half2float(static_cast<const __half*>(m.ptr)[at]);
}

// (hidden, bias) of one score at (qpos, key) for the CUDA-core kernels:
// hidden where a bool mask is false, else the float mask's bias (0 for a
// bool mask and past the edge)
__device__ __forceinline__ void mask_at(const DenseMask& m, long long base,
                                        int qpos, int key, int sq, int sk,
                                        bool& hidden, float& bias) {
  hidden = false;
  bias = 0.f;
  if (qpos >= sq || key >= sk) return;
  const long long at = base + qpos * m.sr + key * m.sc;
  switch (m.kind) {
    case kMaskBool: hidden = !static_cast<const uint8_t*>(m.ptr)[at]; break;
    case kMaskF32: bias = mask_bias<kMaskF32>(m, at); break;
    case kMaskBf16: bias = mask_bias<kMaskBf16>(m, at); break;
    default: bias = mask_bias<kMaskF16>(m, at); break;
  }
}

// The dense mask on one tile of raw scores in an accumulator (the layout
// of the flash kernels' online softmax and softmax gradient: element i at
// row `row0 + 8 ((i / 2) % 2)`, column `col0 + 8 (i / 4) + i % 2`, both
// absolute; KT: rows are keys and columns queries). s becomes the scaled
// score s * scale, plus a float mask's bias; a false entry of a bool mask
// sets bit i of the result. Positions at or past sq or sk read nothing (a
// bias of 0 there).
template <int KIND, bool KT, int N>
__device__ __forceinline__ uint32_t mask_tile_k(float (&s)[N],
                                                const DenseMask& m,
                                                long long base, int row0,
                                                int col0, int sq, int sk,
                                                float scale) {
  static_assert(N <= 32, "one bit an element");
  uint32_t hidden = 0u;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int r = row0 + 8 * ((i >> 1) & 1), c = col0 + 8 * (i >> 2) + (i & 1);
    const int qpos = KT ? c : r, key = KT ? r : c;
    const bool in = qpos < sq && key < sk;
    const long long at = base + qpos * m.sr + key * m.sc;
    // the scale and the bias each rounded, as the reference's logits *
    // scale + bias: at a bias of -1e4 one fused rounding moves s by up to
    // 1e-3, and p by as much relative
    s[i] = __fmul_rn(s[i], scale);
    if constexpr (KIND == kMaskBool) {
      if (in && !static_cast<const uint8_t*>(m.ptr)[at]) hidden |= 1u << i;
    } else {
      s[i] = __fadd_rn(s[i], in ? mask_bias<KIND>(m, at) : 0.f);
    }
  }
  return hidden;
}

template <bool KT, int N>
__device__ __forceinline__ uint32_t mask_tile(float (&s)[N],
                                              const DenseMask& m,
                                              long long base, int row0,
                                              int col0, int sq, int sk,
                                              float scale) {
  switch (m.kind) {
    case kMaskBool:
      return mask_tile_k<kMaskBool, KT>(s, m, base, row0, col0, sq, sk,
                                        scale);
    case kMaskF32:
      return mask_tile_k<kMaskF32, KT>(s, m, base, row0, col0, sq, sk,
                                       scale);
    case kMaskBf16:
      return mask_tile_k<kMaskBf16, KT>(s, m, base, row0, col0, sq, sk,
                                        scale);
    default:
      return mask_tile_k<kMaskF16, KT>(s, m, base, row0, col0, sq, sk,
                                       scale);
  }
}

// The row log-sum-exp under a dense mask, m + log(l), as two floats: hi,
// the f32 sum, and lo = (m + log l) - hi exactly (Knuth's two-sum). A
// biased row can sit far from 0: with every key at -3.4e38 (a common
// bias), hi is m and log(l) lives in lo alone, so the backward's p =
// exp((s - hi) - lo) keeps it.
__device__ __forceinline__ void two_sum(float a, float b, float& hi,
                                        float& lo) {
  hi = __fadd_rn(a, b);
  const float bb = __fsub_rn(hi, a);
  lo = __fadd_rn(__fsub_rn(a, __fsub_rn(hi, bb)), __fsub_rn(b, bb));
}

// a float's NaN test on its bits (nvcc folded a floating-point form such
// as x - x to 0, which lost the NaN)
__device__ __forceinline__ bool is_nan(float x) {
  return (__float_as_uint(x) & 0x7fffffffu) > 0x7f800000u;
}

// A cut element's p in the backward under a dense mask (the causal mask's
// or a bool mask's): 0, or NaN where the row's lse is NaN (a row with no
// visible key, whose softmax the reference gives as NaN at every key).
__device__ __forceinline__ float cut_p(float lse) {
  return is_nan(lse) ? __uint_as_float(0x7fc00000u) : 0.f;
}

// the lowest running max of a dense-mask softmax: -FLT_MAX, below which no
// finite biased score lies (the plain kernels' -1e30 would floor a bias
// such as -3.4e38)
constexpr float kLowest = -3.402823466e38f;

}  // namespace flash
