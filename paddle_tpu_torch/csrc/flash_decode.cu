// Dense single-query flash-decode for Hopper (sm_90a), CUDA C++ with a plain
// C entry.
//
// Replaces the Pallas TPU kernel that paddle_tpu/ops/pallas/flash_attention.py
// runs through flash_decode (_fwd_call -> _fwd_kernel with causal=False and
// kv_lens). Same function: one query row per (batch b, head h) attends the
// first lens[b] keys of a dense padded cache, s = (q . k) * sm_scale in f32,
// an online softmax in f32, p rounded to the cache dtype before its product
// with V (as the TPU kernel rounds it), o = acc / l in q's dtype; a row with
// lens[b] = 0 gives 0. q is [B, 1, H, D], k and v [B, S, H, D], all read in
// place through their strides: no folded [B*H, S, D] copy of the cache is
// made. The TPU kernel's 8-row query padding and its S % block_k rule exist
// only for Mosaic and are gone; the kernel masks its own ragged edge.
//
// What bounds it on the H100: bytes. A step reads every live key and value
// once, 2 * lens * D values per (b, h), for ~4 FLOPs per value read, far
// below the card's balance point: the floor is the live cache at 3.35 TB/s.
// What the design does about that:
//   - flash-decoding: the keys of each (b, h) are cut into `splits` chunks
//     of `chunk` keys, one block per (chunk, h, b), so a decode batch of
//     B*H = 128 rows still puts several blocks on each of the 132 SMs; each
//     block reads only the part of its chunk below lens[b] and leaves at
//     once when its chunk starts past it;
//   - in a block, 4 warps take turns over the chunk's keys; a warp loads
//     several whole key rows at once (one coalesced row per load, each lane
//     D/32 contiguous values) before it computes, keeping loads in flight;
//     the warps' (m, l, acc) are merged in shared memory and the block
//     writes one f32 partial state;
//   - a second, small kernel combines the partial states of each (b, h) in
//     chunk order and writes o.
// Not yet done: 16-byte loads at D=64, TMA, and one launch in place of two.

#include "flash_common.cuh"

namespace {

using flash::from_float;
using flash::kNegInf;
using flash::load_row;
using flash::round_to;
using flash::warp_sum;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;

// element strides of a [B, S, H, D] tensor (the last stride is 1)
struct Strides {
  long long b, s, h;
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
decode_partial_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const int* __restrict__ lens,
                      float* __restrict__ part_acc,
                      float* __restrict__ part_ml, int heads, int s_max,
                      int chunk, int splits, Strides qs, Strides ks,
                      Strides vs, float sm_scale) {
  constexpr int N = D / 32;   // dims per lane
  constexpr int KK = 512 / D; // key rows a warp loads before computing
  __shared__ float sm_m[kWarps];
  __shared__ float sm_l[kWarps];
  __shared__ __align__(16) float sm_acc[kWarps][D];

  const int split = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int len = min(max(lens[b], 0), s_max);
  const int k_begin = split * chunk;
  if (k_begin >= len) return;  // the combine reads only chunks below len
  const int k_end = min(len, k_begin + chunk);

  const T* kb = k + b * ks.b + h * ks.h + lane * N;
  const T* vb = v + b * vs.b + h * vs.h + lane * N;
  float qr[N], acc[N];
  load_row<T, N>(q + b * qs.b + h * qs.h + lane * N, qr);
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] = 0.f;
  float m = kNegInf;
  float l = 0.f;

  for (int k0 = k_begin + warp * KK; k0 < k_end; k0 += kWarps * KK) {
    float kr[KK][N], vr[KK][N];
#pragma unroll
    for (int j = 0; j < KK; ++j) {
      const int kpos = k0 + j;
      if (kpos < k_end) {
        load_row<T, N>(kb + kpos * ks.s, kr[j]);
        load_row<T, N>(vb + kpos * vs.s, vr[j]);
      } else {
#pragma unroll
        for (int i = 0; i < N; ++i) kr[j][i] = vr[j][i] = 0.f;
      }
    }
    float s[KK];
    float tile_max = kNegInf;
#pragma unroll
    for (int j = 0; j < KK; ++j) {
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < N; ++i) part += qr[i] * kr[j][i];
      part = warp_sum(part) * sm_scale;
      s[j] = (k0 + j < k_end) ? part : kNegInf;
      tile_max = fmaxf(tile_max, s[j]);
    }
    const float m_new = fmaxf(m, tile_max);
    const float alpha = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < KK; ++j) {
      const float p = s[j] > 0.5f * kNegInf ? expf(s[j] - m_new) : 0.f;
      psum += p;        // the row sum takes p as computed
      s[j] = round_to<T>(p);  // V is weighed by p in the cache dtype
    }
    l = l * alpha + psum;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      float a = acc[i] * alpha;
#pragma unroll
      for (int j = 0; j < KK; ++j) a += s[j] * vr[j][i];
      acc[i] = a;
    }
    m = m_new;
  }

  // merge the warps' states into the block's partial state
  if (lane == 0) {
    sm_m[warp] = m;
    sm_l[warp] = l;
  }
#pragma unroll
  for (int i = 0; i < N; ++i) sm_acc[warp][lane * N + i] = acc[i];
  __syncthreads();
  const size_t row = ((size_t)b * heads + h) * splits + split;
  for (int e = threadIdx.x; e < D; e += kThreads) {
    float mm = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mm = fmaxf(mm, sm_m[w]);
    float ll = 0.f;
    float aa = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(sm_m[w] - mm);
      ll += sm_l[w] * f;
      aa += sm_acc[w][e] * f;
    }
    part_acc[row * D + e] = aa;
    if (e == 0) {
      part_ml[row * 2] = mm;
      part_ml[row * 2 + 1] = ll;
    }
  }
}

// one block per (h, b), one thread per dim: o = sum_c acc_c e^(m_c - M) /
// sum_c l_c e^(m_c - M) over the chunks c below lens[b]
template <typename T, int D>
__global__ void __launch_bounds__(D)
decode_combine_kernel(const float* __restrict__ part_acc,
                      const float* __restrict__ part_ml,
                      const int* __restrict__ lens, T* __restrict__ out,
                      int heads, int s_max, int chunk, int splits) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int d = threadIdx.x;
  const int len = min(max(lens[b], 0), s_max);
  const int used = min(splits, (len + chunk - 1) / chunk);
  const size_t row0 = ((size_t)b * heads + h) * splits;
  float mm = kNegInf;
  for (int c = 0; c < used; ++c) mm = fmaxf(mm, part_ml[(row0 + c) * 2]);
  float ll = 0.f;
  float aa = 0.f;
  for (int c = 0; c < used; ++c) {
    const float f = expf(part_ml[(row0 + c) * 2] - mm);
    ll += part_ml[(row0 + c) * 2 + 1] * f;
    aa += part_acc[(row0 + c) * D + d] * f;
  }
  out[((size_t)b * heads + h) * D + d] =
      from_float<T>(aa / (ll == 0.f ? 1.f : ll));
}

template <typename T, int D>
void launch(const void* q, const void* k, const void* v, const int* lens,
            void* out, float* part_acc, float* part_ml, int b, int heads,
            int s_max, int splits, int chunk, Strides qs, Strides ks,
            Strides vs, float sm_scale, cudaStream_t stream) {
  decode_partial_kernel<T, D><<<dim3(splits, heads, b), kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lens, part_acc, part_ml, heads, s_max, chunk,
      splits, qs, ks, vs, sm_scale);
  decode_combine_kernel<T, D><<<dim3(heads, b), D, 0, stream>>>(
      part_acc, part_ml, lens, static_cast<T*>(out), heads, s_max, chunk,
      splits);
}

template <typename T>
int dispatch_d(int d, const void* q, const void* k, const void* v,
               const int* lens, void* out, float* part_acc, float* part_ml,
               int b, int heads, int s_max, int splits, int chunk, Strides qs,
               Strides ks, Strides vs, float sm_scale, cudaStream_t stream) {
  switch (d) {
    case 64: launch<T, 64>(q, k, v, lens, out, part_acc, part_ml, b, heads, s_max, splits, chunk, qs, ks, vs, sm_scale, stream); break;
    case 128: launch<T, 128>(q, k, v, lens, out, part_acc, part_ml, b, heads, s_max, splits, chunk, qs, ks, vs, sm_scale, stream); break;
    case 256: launch<T, 256>(q, k, v, lens, out, part_acc, part_ml, b, heads, s_max, splits, chunk, qs, ks, vs, sm_scale, stream); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return 0;
}

}  // namespace

// q: [b, 1, heads, d]; k, v: [b, s_max, heads, d]; all f32 (is_bf16 = 0) or
// bf16 (1), the last dim contiguous, every other stride given in elements
// (q_sb, q_sh; k_sb, k_ss, k_sh; v_sb, v_ss, v_sh) and a multiple of 16
// bytes. lens: [b] int32. out: [b, 1, heads, d] contiguous, q's dtype.
// part_acc: [b, heads, splits, d] f32 and part_ml: [b, heads, splits, 2] f32
// scratch; key chunk c covers [c * chunk, (c + 1) * chunk) and splits * chunk
// >= s_max. Launches both kernels on `stream` and returns cudaGetLastError()
// (0 on success).
extern "C" int flash_decode(const void* q, const void* k, const void* v,
                            const int* lens, void* out, float* part_acc,
                            float* part_ml, int b, int heads, int s_max,
                            int d, int splits, int chunk, long long q_sb,
                            long long q_sh, long long k_sb, long long k_ss,
                            long long k_sh, long long v_sb, long long v_ss,
                            long long v_sh, int is_bf16, float sm_scale,
                            void* stream) {
  if (b <= 0 || heads <= 0 || s_max <= 0 || splits <= 0 || chunk <= 0 ||
      b > 65535 || heads > 65535 || (long long)splits * chunk < s_max)
    return (int)cudaErrorInvalidValue;
  const Strides qs{q_sb, 0, q_sh}, ks{k_sb, k_ss, k_sh}, vs{v_sb, v_ss, v_sh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int err =
      is_bf16 ? dispatch_d<__nv_bfloat16>(d, q, k, v, lens, out, part_acc, part_ml, b, heads, s_max, splits, chunk, qs, ks, vs, sm_scale, st)
              : dispatch_d<float>(d, q, k, v, lens, out, part_acc, part_ml, b, heads, s_max, splits, chunk, qs, ks, vs, sm_scale, st);
  if (err) return err;
  return (int)cudaGetLastError();
}
