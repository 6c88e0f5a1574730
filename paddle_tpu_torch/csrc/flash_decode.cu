// Dense single-query flash-decode for Hopper (sm_90a), CUDA C++ with a plain
// C entry.
//
// Replaces the Pallas TPU kernel that paddle_tpu/ops/pallas/flash_attention.py
// runs through flash_decode (_fwd_call -> _fwd_kernel with causal=False and
// kv_lens). Same function: one query row per (batch b, head h) attends the
// first lens[b] keys of a dense padded cache, s = (q . k) * sm_scale in f32,
// an online softmax in f32, p rounded to the cache dtype before its product
// with V (as the TPU kernel rounds it), o = acc / l in q's dtype (f32, bf16
// or f16, the cache's; one instantiation each); a row with
// lens[b] = 0 gives 0. q is [B, 1, H, D], k and v [B, S, H, D], all read in
// place through their strides: no folded [B*H, S, D] copy of the cache is
// made. The TPU kernel's 8-row query padding and its S % block_k rule exist
// only for Mosaic and are gone; the kernel masks its own ragged edge.
//
// What bounds it on the H100: bytes. A step reads every live key and value
// once, 2 * lens * D values per (b, h), for ~4 FLOPs per value read, far
// below the card's balance point: the floor is the live cache at 3.35 TB/s
// (0.0113 ms at Llama-2-7B's bf16 shape, B=4 H=32 D=128, 576 keys; the same
// at GPT's f32 one, B=8 H=16 D=64). What the design does about that:
//   - one launch a call, flash-decoding inside it: the keys of each (b, h)
//     row are cut into `splits` chunks of `chunk` keys, one block per
//     (chunk, h, b), so a decode batch of B*H = 128 rows still puts several
//     blocks on each of the 132 SMs; a block reads only the part of its
//     chunk below lens[b] and leaves at once when its chunk starts past it.
//     A row whose keys fit one chunk is written by its block directly;
//     otherwise each block writes its f32 partial state (m, l, acc) to
//     scratch, and the last block of the row to finish (a ticket counter
//     per row: __threadfence, then atomicAdd) combines the row's partial
//     states in chunk order, writes o and resets the counter. The fixed
//     order makes two calls bit-equal whichever block finishes last;
//   - 16-byte loads: a lane owns 8 bf16 or f16, or 4 f32, consecutive dims
//     of a key row (two such chunks for f32 at D=256), so a warp-wide load
//     covers 32 / (D / 8) 16-bit rows, or 32 / (D / 4) f32 rows, at once;
//   - loads ahead of the math: a warp's next step of keys (two key rows a
//     lane group, of K and of V) is issued into a second register buffer
//     before this step's dot products, exp and p.v. Steps of two rows (four
//     and eight measured slower) keep a thread under 80 registers, so six
//     blocks (24 warps) fit on an SM and a call's blocks run in one wave;
//   - in a block, 4 warps take turns over the chunk's keys, each lane group
//     of a warp (the lanes of one key row) with its own (m, l, acc), merged
//     over the warp by shuffles and over the warps in shared memory.
// The scratch (partial states and counters) belongs to the wrapper, which
// allocates it once per device and size and keeps the counters zeroed
// between calls (each combine resets its row's). The counters assume one
// call in flight at a time, that is one stream, which is the port's case.
//
// ptxas (-Xptxas -v, sm_90a, CUDA 12.8 on the H100), registers a thread
// (chip_smoke.py's build phase prints them for every instantiation): f32
// D=64: 70, D=128: 64, D=256: 110; bf16 D=64: 76, D=128: 78, D=256: 71;
// no spills.

#include <type_traits>

#include "flash_common.cuh"

namespace {

using flash::Dec;
using flash::from_float;
using flash::kNegInf;
using flash::round_to;
using flash::unpack;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr float kLog2e = 1.4426950408889634f;

// element strides of a [B, S, H, D] tensor (the last stride is 1)
struct Strides {
  long long b, s, h;
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ lens,
                    T* __restrict__ out, float* __restrict__ part,
                    int* __restrict__ counters, int heads, int s_max,
                    int chunk, int splits, Strides qs, Strides ks,
                    Strides vs, float scale_log2) {
  using G = Dec<T, D>;
  constexpr int NE = G::NE, U = G::U, NCH = G::NCH;
  __shared__ float sm_m[kWarps];
  __shared__ float sm_l[kWarps];
  __shared__ __align__(16) float sm_acc[kWarps][D];
  __shared__ int sm_last;

  const int split = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane / G::LPR;  // the lane group: key row g of each load
  const int r = lane % G::LPR;  // the lane in the group
  const size_t row = (size_t)b * heads + h;
  T* o = out + row * D;
  const int len = min(max(lens[b], 0), s_max);
  if (len == 0) {  // no key: o = 0, written by the row's first block
    if (split == 0)
      for (int e = tid; e < D; e += kThreads) o[e] = from_float<T>(0.f);
    return;
  }
  const int k_begin = split * chunk;
  if (k_begin >= len) return;  // the combine reads only chunks below len
  const int k_end = min(len, k_begin + chunk);
  const int used = min(splits, (len + chunk - 1) / chunk);

  float qr[NE], acc[NE];
  const T* qb = q + b * qs.b + h * qs.h + r * G::VEC;
#pragma unroll
  for (int c = 0; c < NCH; ++c)
    unpack<T>(*reinterpret_cast<const uint4*>(qb + c * G::LPR * G::VEC),
              qr + c * G::VEC);
#pragma unroll
  for (int i = 0; i < NE; ++i) acc[i] = 0.f;
  float m = kNegInf;  // the raw scores' running max
  float l = 0.f;

  const T* kb = k + b * ks.b + h * ks.h + r * G::VEC;
  const T* vb = v + b * vs.b + h * vs.h + r * G::VEC;
  // lane group g of the warp step at k0 takes keys k0 + g + RPW u, u < U
  auto load = [&](int k0, uint4 (&kx)[U][NCH], uint4 (&vx)[U][NCH]) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int kpos = k0 + g + G::RPW * u;
      const bool ok = kpos < k_end;
#pragma unroll
      for (int c = 0; c < NCH; ++c) {
        const int at = c * G::LPR * G::VEC;
        kx[u][c] = ok ? *reinterpret_cast<const uint4*>(kb + kpos * ks.s + at)
                      : make_uint4(0, 0, 0, 0);
        vx[u][c] = ok ? *reinterpret_cast<const uint4*>(vb + kpos * vs.s + at)
                      : make_uint4(0, 0, 0, 0);
      }
    }
  };

  constexpr int STEP = kWarps * G::KK;
  uint4 kr[U][NCH], vr[U][NCH];
  int k0 = k_begin + warp * G::KK;
  load(k0, kr, vr);
  for (; k0 < k_end; k0 += STEP) {
    uint4 kn[U][NCH], vn[U][NCH];
    load(k0 + STEP, kn, vn);  // the next step's keys, in flight under this
    float s[U];
    float mx = m;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float part_dot = 0.f;
#pragma unroll
      for (int c = 0; c < NCH; ++c) {
        float kf[G::VEC];
        unpack<T>(kr[u][c], kf);
#pragma unroll
        for (int e = 0; e < G::VEC; ++e)
          part_dot = fmaf(qr[c * G::VEC + e], kf[e], part_dot);
      }
#pragma unroll
      for (int off = 1; off < G::LPR; off <<= 1)
        part_dot += __shfl_xor_sync(0xffffffffu, part_dot, off);
      // masked keys get p = 0 exactly; m stays finite
      s[u] = k0 + g + G::RPW * u < k_end ? part_dot
                                          : __uint_as_float(0xff800000u);
      mx = fmaxf(mx, s[u]);
    }
    const float alpha = exp2f((m - mx) * scale_log2);
    const float mb = mx * scale_log2;
    m = mx;
    float psum = 0.f;
#pragma unroll
    for (int i = 0; i < NE; ++i) acc[i] *= alpha;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const float p = exp2f(fmaf(s[u], scale_log2, -mb));
      psum += p;                        // the row sum takes p as computed
      const float pr = round_to<T>(p);  // V is weighed by p in the cache dtype
#pragma unroll
      for (int c = 0; c < NCH; ++c) {
        float vf[G::VEC];
        unpack<T>(vr[u][c], vf);
#pragma unroll
        for (int e = 0; e < G::VEC; ++e)
          acc[c * G::VEC + e] = fmaf(pr, vf[e], acc[c * G::VEC + e]);
      }
    }
    l = l * alpha + psum;
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int c = 0; c < NCH; ++c) {
        kr[u][c] = kn[u][c];
        vr[u][c] = vn[u][c];
      }
  }

  // the warp's lane groups into group 0, by a butterfly over the groups
#pragma unroll
  for (int off = G::LPR; off < 32; off <<= 1) {
    const float mo = __shfl_xor_sync(0xffffffffu, m, off);
    const float lo = __shfl_xor_sync(0xffffffffu, l, off);
    const float mm = fmaxf(m, mo);
    const float fa = exp2f((m - mm) * scale_log2);
    const float fb = exp2f((mo - mm) * scale_log2);
    l = l * fa + lo * fb;
#pragma unroll
    for (int i = 0; i < NE; ++i)
      acc[i] = acc[i] * fa + __shfl_xor_sync(0xffffffffu, acc[i], off) * fb;
    m = mm;
  }
  if (g == 0) {
#pragma unroll
    for (int c = 0; c < NCH; ++c)
#pragma unroll
      for (int e = 0; e < G::VEC; ++e)
        sm_acc[warp][(c * G::LPR + r) * G::VEC + e] = acc[c * G::VEC + e];
    if (r == 0) {
      sm_m[warp] = m;
      sm_l[warp] = l;
    }
  }
  __syncthreads();

  // the warps' states into the block's, in warp order
  float* part_acc = part;
  float* part_ml = part + (size_t)gridDim.z * heads * splits * D;
  const size_t prow = row * splits + split;
  for (int e = tid; e < D; e += kThreads) {
    float mm = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mm = fmaxf(mm, sm_m[w]);
    float ll = 0.f, aa = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = exp2f((sm_m[w] - mm) * scale_log2);
      ll += sm_l[w] * f;
      aa += sm_acc[w][e] * f;
    }
    if (used == 1) {  // the row's only block: o directly
      o[e] = from_float<T>(aa / (ll == 0.f ? 1.f : ll));
    } else {
      part_acc[prow * D + e] = aa;
      if (e == 0) {
        part_ml[prow * 2] = mm;
        part_ml[prow * 2 + 1] = ll;
      }
    }
  }
  if (used == 1) return;

  // the last block of the row to finish combines the row's partial states
  __threadfence();  // this block's partial state is visible to the others
  __syncthreads();
  if (tid == 0) {
    sm_last = atomicAdd(counters + row, 1) == used - 1;
    __threadfence();
  }
  __syncthreads();
  if (!sm_last) return;
  const float* acc_r = part_acc + row * splits * D;
  const float* ml_r = part_ml + row * splits * 2;
  for (int e = tid; e < D; e += kThreads) {
    float mm = kNegInf;
    for (int c = 0; c < used; ++c) mm = fmaxf(mm, __ldcg(ml_r + 2 * c));
    float ll = 0.f, aa = 0.f;
    for (int c = 0; c < used; ++c) {
      const float f = exp2f((__ldcg(ml_r + 2 * c) - mm) * scale_log2);
      ll += __ldcg(ml_r + 2 * c + 1) * f;
      aa += __ldcg(acc_r + (size_t)c * D + e) * f;
    }
    o[e] = from_float<T>(aa / (ll == 0.f ? 1.f : ll));
  }
  if (tid == 0) counters[row] = 0;  // ready for the next call
}

template <typename T, int D>
void launch(const void* q, const void* k, const void* v, const int* lens,
            void* out, float* part, int* counters, int b, int heads,
            int s_max, int splits, int chunk, Strides qs, Strides ks,
            Strides vs, float scale_log2, cudaStream_t stream) {
  flash_decode_kernel<T, D><<<dim3(splits, heads, b), kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lens, static_cast<T*>(out), part, counters,
      heads, s_max, chunk, splits, qs, ks, vs, scale_log2);
}

template <typename T>
int dispatch_d(int d, const void* q, const void* k, const void* v,
               const int* lens, void* out, float* part, int* counters, int b,
               int heads, int s_max, int splits, int chunk, Strides qs,
               Strides ks, Strides vs, float scale_log2,
               cudaStream_t stream) {
  switch (d) {
    case 64: launch<T, 64>(q, k, v, lens, out, part, counters, b, heads, s_max, splits, chunk, qs, ks, vs, scale_log2, stream); break;
    case 128: launch<T, 128>(q, k, v, lens, out, part, counters, b, heads, s_max, splits, chunk, qs, ks, vs, scale_log2, stream); break;
    case 256: launch<T, 256>(q, k, v, lens, out, part, counters, b, heads, s_max, splits, chunk, qs, ks, vs, scale_log2, stream); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return 0;
}

}  // namespace

// q: [b, 1, heads, d]; k, v: [b, s_max, heads, d]; all of one dtype (code
// dtype: 0 f32, 1 bf16, 2 f16), the last dim contiguous, every other stride
// given in elements (q_sb, q_sh; k_sb, k_ss, k_sh; v_sb, v_ss, v_sh) and a
// multiple of 16 bytes. lens: [b] int32. out: [b, 1, heads, d] contiguous,
// q's dtype. Key chunk c covers [c * chunk, (c + 1) * chunk) and splits *
// chunk >= s_max. part: f32 scratch of b * heads * splits * (d + 2) values
// (the partial states); counters: b * heads int32, zero on entry and left
// zero. Launches one kernel on `stream` and returns cudaGetLastError() (0
// on success); an unknown dtype code or head dim is cudaErrorInvalidValue.
// The dtype picks an instantiation on the host: no kernel branches on it.
extern "C" int flash_decode(const void* q, const void* k, const void* v,
                            const int* lens, void* out, float* part,
                            int* counters, int b, int heads, int s_max,
                            int d, int splits, int chunk, long long q_sb,
                            long long q_sh, long long k_sb, long long k_ss,
                            long long k_sh, long long v_sb, long long v_ss,
                            long long v_sh, int dtype, float sm_scale,
                            void* stream) {
  if (b <= 0 || heads <= 0 || s_max <= 0 || splits <= 0 || chunk <= 0 ||
      b > 65535 || heads > 65535 || (long long)splits * chunk < s_max)
    return (int)cudaErrorInvalidValue;
  const Strides qs{q_sb, 0, q_sh}, ks{k_sb, k_ss, k_sh}, vs{v_sb, v_ss, v_sh};
  const float scale_log2 = sm_scale * kLog2e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err;
  switch (dtype) {
    case 0: err = dispatch_d<float>(d, q, k, v, lens, out, part, counters, b, heads, s_max, splits, chunk, qs, ks, vs, scale_log2, st); break;
    case 1: err = dispatch_d<__nv_bfloat16>(d, q, k, v, lens, out, part, counters, b, heads, s_max, splits, chunk, qs, ks, vs, scale_log2, st); break;
    case 2: err = dispatch_d<__half>(d, q, k, v, lens, out, part, counters, b, heads, s_max, splits, chunk, qs, ks, vs, scale_log2, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err) return err;
  return (int)cudaGetLastError();
}
