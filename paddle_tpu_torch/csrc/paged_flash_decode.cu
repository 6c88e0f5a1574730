// Paged GQA flash-decode for Hopper (sm_90a), CUDA C++ with a plain C entry.
//
// Replaces the Pallas TPU kernel paddle_tpu/ops/pallas/flash_decode.py
// (_decode_kernel, launched by paged_flash_decode). Same function: for each
// (slot b, kv head h) the G query heads of that kv head attend the slot's
// paged K/V history — keys [0, lens[b]) found through page_table[b] in the
// head-major pools [Hkv, P, ps, D] — with an online softmax in f32.
// int8 pools are dequantized as value * scale in f32, the scales being
// [Hkv, P, ps, 1] f32 (flash_decode.py:68-70). lens[b] = 0 gives a zero row.
//
// What bounds it on the H100: bytes. Each step reads every live key and
// value once, 2 * lens * D * sizeof(pool) bytes per (slot, kv head), against
// ~4 FLOPs per value read, far below the card's balance point: the floor
// is the pages read at 3.35 TB/s. What the design does about that:
//   - one block per (slot, kv head, group of <= 4 query heads); the block
//     reads its own page_table row and lens[b] (in place of the TPU's
//     scalar prefetch) and walks only the first ceil(lens[b] / ps) pages, so
//     trash-page entries past the history are never read;
//   - all G query heads of the kv head ride one pass, so K and V are read
//     once per kv head (for G <= 4), never broadcast per query head;
//   - 8 warps split the keys; a warp loads several whole key rows at once
//     (one coalesced row per load, each lane D/32 contiguous values) before
//     it computes, keeping loads in flight; the warps' softmax states are
//     merged in shared memory at the end.
// Not yet done: splitting one slot's keys over several blocks (flash
// decoding) for small batches, and 16-byte loads for int8 at D=64.

#include "flash_common.cuh"

namespace {

using flash::kNegInf;
using flash::load_row;
using flash::warp_sum;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kGroupsPerBlock = 4;

template <typename P, int D, int GC>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const float* __restrict__ q, const P* __restrict__ kp,
                    const P* __restrict__ vp, const float* __restrict__ ksc,
                    const float* __restrict__ vsc,
                    const int* __restrict__ page_table,
                    const int* __restrict__ lens, float* __restrict__ out,
                    int hkv, int g, int num_pages, int ps, int mp,
                    float sm_scale) {
  constexpr int N = D / 32;   // dims per lane
  constexpr int KK = 512 / D; // key rows a warp loads before computing
  __shared__ float sm_m[kWarps][GC];
  __shared__ float sm_l[kWarps][GC];
  __shared__ __align__(16) float sm_acc[kWarps][GC][D];

  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int g0 = blockIdx.z * GC;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int len = min(lens[b], mp * ps);
  const int* pt = page_table + (size_t)b * mp;
  const size_t head_rows = (size_t)h * num_pages * ps;

  float qr[GC][N], acc[GC][N], m[GC], l[GC];
#pragma unroll
  for (int gi = 0; gi < GC; ++gi) {
    const int gg = g0 + gi;
    if (gg < g) {
      load_row<float, N>(q + (((size_t)b * hkv + h) * g + gg) * D + lane * N,
                         qr[gi]);
    } else {
#pragma unroll
      for (int i = 0; i < N; ++i) qr[gi][i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < N; ++i) {
      qr[gi][i] *= sm_scale;
      acc[gi][i] = 0.f;
    }
    m[gi] = kNegInf;
    l[gi] = 0.f;
  }

  for (int k0 = warp * KK; k0 < len; k0 += kWarps * KK) {
    float kr[KK][N], vr[KK][N];
#pragma unroll
    for (int j = 0; j < KK; ++j) {
      const int kpos = k0 + j;
      if (kpos < len) {
        const size_t rowi = head_rows + (size_t)pt[kpos / ps] * ps + kpos % ps;
        load_row<P, N>(kp + rowi * D + lane * N, kr[j]);
        load_row<P, N>(vp + rowi * D + lane * N, vr[j]);
        if (ksc != nullptr) {
          const float a = ksc[rowi];
          const float c = vsc[rowi];
#pragma unroll
          for (int i = 0; i < N; ++i) {
            kr[j][i] *= a;
            vr[j][i] *= c;
          }
        }
      } else {
#pragma unroll
        for (int i = 0; i < N; ++i) kr[j][i] = vr[j][i] = 0.f;
      }
    }
#pragma unroll
    for (int gi = 0; gi < GC; ++gi) {
      float s[KK];
      float tile_max = kNegInf;
#pragma unroll
      for (int j = 0; j < KK; ++j) {
        float part = 0.f;
#pragma unroll
        for (int i = 0; i < N; ++i) part += qr[gi][i] * kr[j][i];
        part = warp_sum(part);
        s[j] = (k0 + j < len) ? part : kNegInf;
        tile_max = fmaxf(tile_max, s[j]);
      }
      const float m_new = fmaxf(m[gi], tile_max);
      const float alpha = expf(m[gi] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < KK; ++j) {
        s[j] = s[j] > 0.5f * kNegInf ? expf(s[j] - m_new) : 0.f;
        psum += s[j];
      }
      l[gi] = l[gi] * alpha + psum;
#pragma unroll
      for (int i = 0; i < N; ++i) {
        float a = acc[gi][i] * alpha;
#pragma unroll
        for (int j = 0; j < KK; ++j) a += s[j] * vr[j][i];
        acc[gi][i] = a;
      }
      m[gi] = m_new;
    }
  }

  // merge the warps' partial softmax states
#pragma unroll
  for (int gi = 0; gi < GC; ++gi) {
    if (lane == 0) {
      sm_m[warp][gi] = m[gi];
      sm_l[warp][gi] = l[gi];
    }
#pragma unroll
    for (int i = 0; i < N; ++i) sm_acc[warp][gi][lane * N + i] = acc[gi][i];
  }
  __syncthreads();
  for (int e = threadIdx.x; e < GC * D; e += kThreads) {
    const int gi = e / D;
    const int d = e % D;
    const int gg = g0 + gi;
    if (gg >= g) continue;
    float mm = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mm = fmaxf(mm, sm_m[w][gi]);
    float ll = 0.f;
    float aa = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(sm_m[w][gi] - mm);
      ll += sm_l[w][gi] * f;
      aa += sm_acc[w][gi][d] * f;
    }
    out[(((size_t)b * hkv + h) * g + gg) * D + d] = aa / (ll == 0.f ? 1.f : ll);
  }
}

template <typename P, int D>
void launch(int groups_per_block, const float* q, const void* kp,
            const void* vp, const float* ksc, const float* vsc, const int* pt,
            const int* lens, float* out, int b, int hkv, int g, int num_pages,
            int ps, int mp, float sm_scale, cudaStream_t stream) {
  const P* k = static_cast<const P*>(kp);
  const P* v = static_cast<const P*>(vp);
  if (groups_per_block == 1) {
    dim3 grid(b, hkv, g);
    paged_decode_kernel<P, D, 1><<<grid, kThreads, 0, stream>>>(
        q, k, v, ksc, vsc, pt, lens, out, hkv, g, num_pages, ps, mp, sm_scale);
  } else {
    dim3 grid(b, hkv, (g + kGroupsPerBlock - 1) / kGroupsPerBlock);
    paged_decode_kernel<P, D, kGroupsPerBlock><<<grid, kThreads, 0, stream>>>(
        q, k, v, ksc, vsc, pt, lens, out, hkv, g, num_pages, ps, mp, sm_scale);
  }
}

template <typename P>
int dispatch_d(int d, int gpb, const float* q, const void* kp, const void* vp,
               const float* ksc, const float* vsc, const int* pt,
               const int* lens, float* out, int b, int hkv, int g,
               int num_pages, int ps, int mp, float sm_scale,
               cudaStream_t stream) {
  switch (d) {
    case 64: launch<P, 64>(gpb, q, kp, vp, ksc, vsc, pt, lens, out, b, hkv, g, num_pages, ps, mp, sm_scale, stream); break;
    case 128: launch<P, 128>(gpb, q, kp, vp, ksc, vsc, pt, lens, out, b, hkv, g, num_pages, ps, mp, sm_scale, stream); break;
    case 256: launch<P, 256>(gpb, q, kp, vp, ksc, vsc, pt, lens, out, b, hkv, g, num_pages, ps, mp, sm_scale, stream); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return 0;
}

}  // namespace

// q: [b, hkv, g, d] f32; k_pages, v_pages: [hkv, num_pages, ps, d] of
// pool_dtype (0 f32, 1 bf16, 2 int8); k_scale, v_scale: [hkv, num_pages, ps]
// f32 for int8 pools, else null; page_table: [b, mp] int32 (every entry a
// valid page id); lens: [b] int32; out: [b, hkv, g, d] f32. Launches on
// `stream` and returns cudaGetLastError() (0 on success).
extern "C" int paged_flash_decode(const float* q, const void* k_pages,
                                  const void* v_pages, const float* k_scale,
                                  const float* v_scale, const int* page_table,
                                  const int* lens, float* out, int b, int hkv,
                                  int g, int num_pages, int ps, int mp, int d,
                                  int pool_dtype, float sm_scale, void* stream) {
  if (b <= 0 || hkv <= 0 || g <= 0 || ps <= 0 || mp <= 0 || hkv > 65535)
    return (int)cudaErrorInvalidValue;
  if ((pool_dtype == 2) != (k_scale != nullptr && v_scale != nullptr))
    return (int)cudaErrorInvalidValue;
  const int gpb = g == 1 ? 1 : kGroupsPerBlock;
  if ((g + gpb - 1) / gpb > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err;
  switch (pool_dtype) {
    case 0: err = dispatch_d<float>(d, gpb, q, k_pages, v_pages, k_scale, v_scale, page_table, lens, out, b, hkv, g, num_pages, ps, mp, sm_scale, st); break;
    case 1: err = dispatch_d<__nv_bfloat16>(d, gpb, q, k_pages, v_pages, k_scale, v_scale, page_table, lens, out, b, hkv, g, num_pages, ps, mp, sm_scale, st); break;
    case 2: err = dispatch_d<int8_t>(d, gpb, q, k_pages, v_pages, k_scale, v_scale, page_table, lens, out, b, hkv, g, num_pages, ps, mp, sm_scale, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err) return err;
  return (int)cudaGetLastError();
}
