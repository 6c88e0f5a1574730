// Paged GQA flash-decode for Hopper (sm_90a), CUDA C++ with a plain C entry.
//
// Replaces the Pallas TPU kernel paddle_tpu/ops/pallas/flash_decode.py
// (_decode_kernel, launched by paged_flash_decode). Same function: for each
// (slot b, kv head h) the G query heads of that kv head attend the slot's
// paged K/V history — keys [0, lens[b]) found through page_table[b] in the
// head-major pools [Hkv, P, ps, D] — with an online softmax in f32; s and
// p stay f32 (the reference rounds neither). The pools are f32, bf16, f16
// or int8, one instantiation each; int8 pools are dequantized as value *
// scale in f32, the scales being [Hkv, P, ps, 1] f32 (flash_decode.py:
// 68-70). q comes in as f32 and the output goes out as f32: the wrapper
// casts both from and to q's dtype (f32, bf16 or f16), as the reference
// reads q as f32 and writes the output in q's dtype. lens[b] = 0 gives a
// zero row.
//
// What bounds it on the H100: bytes. Each step reads every live key and
// value once, 2 * lens * D * sizeof(pool) bytes per (slot, kv head), against
// ~4 FLOPs per value read, far below the card's balance point: the floor
// is the live pages at 3.35 TB/s (0.0054 ms at the serving shape, f32,
// B=8 Hkv=16 G=1 D=64 ps=16, lens 65..576). What the design does about
// that (the dense decode's design, csrc/flash_decode.cu, over a page table):
//   - one launch a call, the slot's keys split over blocks: the page table
//     row is cut into `splits` chunks of `ppc` whole pages (picked on the
//     host from shapes alone, never from lens, so the wrapper does not
//     sync), one block per (chunk, kv head and group of <= 4 query heads,
//     slot). A block reads its chunk's live page ids once into shared
//     memory, so no key waits on a table lookup, and leaves at once when
//     its chunk starts at or past min(lens[b], mp * ps): trash-page entries
//     past the history are never read. A slot whose keys fit one chunk is
//     written by its block directly; otherwise each block writes its f32
//     partial state (m, l, acc) to scratch and the last block of the (slot,
//     kv head, head group) to finish (a ticket counter: __threadfence, then
//     atomicAdd) combines the partial states in chunk order, writes the
//     output and resets the counter; the fixed order makes two calls
//     bit-equal whichever block finishes last;
//   - 16-byte loads: a key row of a page (contiguous in the pool) is taken
//     by a lane group of D * sizeof(pool) / 16 lanes (16 in f32 at D=64, 8
//     in bf16 and f16, 4 in int8; at most 32, two chunks a lane for f32 at
//     D=256),
//     whose q.k reduces in log2(group) shuffles; the int8 scales come with
//     their rows;
//   - loads ahead of the math: each thread streams its own rows through a
//     ring of four cp.async stages in shared memory (16-byte copies, zero
//     fill past the chunk), three steps of keys in flight under this
//     step's dot products, exp and p.v; a thread reads back only what it
//     copied, so the ring takes no barrier;
//   - all G query heads of the kv head ride one pass (4 a block), so K and
//     V are read once per kv head, never broadcast per query head;
//   - in a block, 4 warps take turns over the chunk's keys, each lane group
//     with its own (m, l, acc) per query head, merged over the warp by
//     shuffles and over the warps in shared memory.
// The scratch (partial states and counters) belongs to the wrapper, which
// allocates it once per device and size and keeps the counters zeroed
// between calls (each combine resets its own). The counters assume one call
// in flight at a time, on one stream: the serving engine's case.
//
// Measured (chip_smoke.py --compare-paged, H100 80GB HBM3 at 700 W, held,
// L2 flushed by a 256 MB write between launches): 0.021 ms at the serving
// shape against the one-block-a-slot kernel's 0.0265, 0.25 of the bound,
// and within 1.1x of torch.sum reading as many contiguous bytes under the
// same flush (0.019): at ~21 MB the launch with no key to read (0.0055)
// and the flush's dirty L2 lines written back under the reads (0.0188
// with a read flush) take what the bound leaves. bf16 and int8 pools
// gain 2.6-3.3x (their rows were 4- and 2-byte loads), GQA 4x. Splitting
// a slot into more chunks than one wave of blocks holds measured slower
// (a second wave), so a call aims at most at four blocks an SM; deeper
// rings (6, 8 stages), 8 warps a block and four rows a lane group a step
// measured no faster.
//
// ptxas (-Xptxas -v, sm_90a, CUDA 12.8 on the H100), registers a thread,
// no spills (chip_smoke.py's build phase prints every instantiation):
// f32 G=1 56 (D=64, 128), 72 (D=256), G=4 80-139; bf16 G=1 63-64, G=4
// 130-139; int8 G=1 119, G=4 238-239.

#include <type_traits>

#include "flash_common.cuh"
#include "tensor_core.cuh"

namespace {

using flash::Dec;
using flash::kNegInf;
using flash::unpack;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kGroupsPerBlock = 4;
constexpr int kMaxPages = 4096;  // page ids a chunk, in shared memory
constexpr float kLog2e = 1.4426950408889634f;

// the ring of cp.async stages a block streams its keys through: each
// thread owns its slots (its U rows' 16-byte chunks of K and V, and for
// int8 their scales) and reads back only what it copied, so the ring needs
// no barrier
template <typename P, int D>
struct Ring {
  using G = Dec<P, D>;
  static constexpr bool QUANT = std::is_same<P, int8_t>::value;
  static constexpr int NST = 4;  // stages: NST - 1 steps in flight
  static constexpr int CHUNKS = 2 * G::U * G::NCH;  // 16-byte chunks a lane
  static constexpr int STAGE =  // bytes a stage
      CHUNKS * kThreads * 16 + (QUANT ? 2 * G::U * kThreads * 4 : 0);
  static constexpr int BYTES = NST * STAGE;
};

template <typename P, int D, int GC>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const float* __restrict__ q, const P* __restrict__ kp,
                    const P* __restrict__ vp, const float* __restrict__ ksc,
                    const float* __restrict__ vsc,
                    const int* __restrict__ page_table,
                    const int* __restrict__ lens, float* __restrict__ out,
                    float* __restrict__ part, int* __restrict__ counters,
                    int hkv, int g, int num_pages, int ps, int mp, int ppc,
                    int splits, float scale_log2) {
  using G = Dec<P, D>;
  using R = Ring<P, D>;
  constexpr int NE = G::NE, U = G::U, NCH = G::NCH, VEC = G::VEC;
  constexpr int NST = R::NST;
  // the ring, then the chunk's live page ids
  extern __shared__ __align__(16) uint8_t dyn[];
  int* sm_pages = reinterpret_cast<int*>(dyn + R::BYTES);
  __shared__ float sm_m[kWarps][GC];
  __shared__ float sm_l[kWarps][GC];
  __shared__ __align__(16) float sm_acc[kWarps][GC][D];
  __shared__ int sm_last;

  const int split = blockIdx.x;
  const int ngroups = (g + GC - 1) / GC;
  const int h = blockIdx.y / ngroups;
  const int g0 = (blockIdx.y % ngroups) * GC;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gl = lane / G::LPR;  // the lane group: key row gl of each load
  const int r = lane % G::LPR;   // the lane in the group
  const size_t qrow0 = ((size_t)b * hkv + h) * g + g0;  // first query head
  const int len = min(max(lens[b], 0), mp * ps);
  if (len == 0) {  // no key: a zero row, written by the first chunk's block
    if (split == 0)
      for (int e = tid; e < GC * D; e += kThreads)
        if (g0 + e / D < g) out[qrow0 * D + e] = 0.f;
    return;
  }
  const int chunk = ppc * ps;  // keys a chunk
  const int k_begin = split * chunk;
  if (k_begin >= len) return;  // the combine reads only chunks below len
  const int n = min(len - k_begin, chunk);  // this block's keys
  const int used = (len + chunk - 1) / chunk;
  const int* pt = page_table + (size_t)b * mp + (size_t)split * ppc;
  for (int i = tid; i < (n + ps - 1) / ps; i += kThreads) sm_pages[i] = pt[i];

  float qr[GC][NE], acc[GC][NE], m[GC], l[GC];
#pragma unroll
  for (int gi = 0; gi < GC; ++gi) {
#pragma unroll
    for (int c = 0; c < NCH; ++c)
#pragma unroll
      for (int e = 0; e < VEC; e += 4) {
        float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
        if (g0 + gi < g)
          x = *reinterpret_cast<const float4*>(
              q + (qrow0 + gi) * D + (c * G::LPR + r) * VEC + e);
        qr[gi][c * VEC + e] = x.x;
        qr[gi][c * VEC + e + 1] = x.y;
        qr[gi][c * VEC + e + 2] = x.z;
        qr[gi][c * VEC + e + 3] = x.w;
      }
#pragma unroll
    for (int i = 0; i < NE; ++i) acc[gi][i] = 0.f;
    m[gi] = kNegInf;  // the raw scores' running max
    l[gi] = 0.f;
  }
  __syncthreads();  // the page ids are in

  const size_t head_row0 = (size_t)h * num_pages;  // the head's first page
  // lane group gl takes the chunk's keys base + gl + RPW u, u < U, the
  // warps taking turns in steps of STEP keys; (slot, row) of each key,
  // stepped without a division
  constexpr int STEP = kWarps * G::KK;
  const int step_q = STEP / ps, step_r = STEP % ps;
  int slot[U], prow[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int lk = warp * G::KK + gl + G::RPW * u;
    slot[u] = lk / ps;
    prow[u] = lk % ps;
  }
  // this thread's slots of stage s: chunk i at chunks[i * kThreads]
  auto chunks = [&](int s) {
    return reinterpret_cast<uint4*>(dyn + s * R::STAGE) + tid;
  };
  auto scales = [&](int s) {
    return reinterpret_cast<float*>(dyn + s * R::STAGE +
                                    R::CHUNKS * kThreads * 16) + tid;
  };
  // the copies of warp step j (keys base = warp KK + j STEP) into stage
  // j % NST, zero-filled past the chunk's keys; steps are issued in order
  int issued = 0;
  auto issue = [&]() {
    const int base = warp * G::KK + issued * STEP;
    uint4* ch = chunks(issued % NST);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const bool ok = base + gl + G::RPW * u < n;
      const size_t row =
          ok ? (head_row0 + sm_pages[slot[u]]) * ps + prow[u] : 0;
#pragma unroll
      for (int c = 0; c < NCH; ++c) {
        const size_t at = row * D + (c * G::LPR + r) * VEC;
        tc::cp_async16(ch + (u * NCH + c) * kThreads, kp + at, ok);
        tc::cp_async16(ch + ((U + u) * NCH + c) * kThreads, vp + at, ok);
      }
      if constexpr (R::QUANT) {
        float* sc = scales(issued % NST);
        tc::cp_async4(sc + u * kThreads, ksc + row, ok);
        tc::cp_async4(sc + (U + u) * kThreads, vsc + row, ok);
      }
      prow[u] += step_r;  // on to the same lane group's key a step later
      slot[u] += step_q;
      if (prow[u] >= ps) {
        prow[u] -= ps;
        ++slot[u];
      }
    }
    tc::cp_async_commit();
    ++issued;
  };

#pragma unroll
  for (int s = 0; s < NST - 1; ++s) issue();
  for (int i = 0, base = warp * G::KK; base < n; ++i, base += STEP) {
    tc::cp_async_wait<NST - 2>();  // this thread's copies of step i landed
    uint4 kr[U][NCH], vr[U][NCH];
    float ka[U], va[U];
    const uint4* ch = chunks(i % NST);
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int c = 0; c < NCH; ++c) {
        kr[u][c] = ch[(u * NCH + c) * kThreads];
        vr[u][c] = ch[((U + u) * NCH + c) * kThreads];
      }
      if constexpr (R::QUANT) {
        ka[u] = scales(i % NST)[u * kThreads];
        va[u] = scales(i % NST)[(U + u) * kThreads];
      }
    }
    // step i + NST - 1 into the stage step i - 1 left, read last step
    issue();
    float kf[U][NE], vf[U][NE];
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int c = 0; c < NCH; ++c) {
        unpack<P>(kr[u][c], kf[u] + c * VEC);
        unpack<P>(vr[u][c], vf[u] + c * VEC);
      }
    if constexpr (R::QUANT) {
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int e = 0; e < NE; ++e) {
          kf[u][e] *= ka[u];
          vf[u][e] *= va[u];
        }
    }
#pragma unroll
    for (int gi = 0; gi < GC; ++gi) {
      float s[U];
      float mx = m[gi];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < NE; ++e) dot = fmaf(qr[gi][e], kf[u][e], dot);
#pragma unroll
        for (int off = 1; off < G::LPR; off <<= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, off);
        // masked keys get p = 0 exactly; m stays finite
        s[u] = base + gl + G::RPW * u < n ? dot
                                           : __uint_as_float(0xff800000u);
        mx = fmaxf(mx, s[u]);
      }
      const float alpha = exp2f((m[gi] - mx) * scale_log2);
      const float mb = mx * scale_log2;
      m[gi] = mx;
      float psum = 0.f;
#pragma unroll
      for (int e = 0; e < NE; ++e) acc[gi][e] *= alpha;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float p = exp2f(fmaf(s[u], scale_log2, -mb));
        psum += p;
#pragma unroll
        for (int e = 0; e < NE; ++e)
          acc[gi][e] = fmaf(p, vf[u][e], acc[gi][e]);
      }
      l[gi] = l[gi] * alpha + psum;
    }
  }
  tc::cp_async_wait<0>();  // no copy in flight past the loop

  // the warp's lane groups into group 0, by a butterfly over the groups
#pragma unroll
  for (int off = G::LPR; off < 32; off <<= 1) {
#pragma unroll
    for (int gi = 0; gi < GC; ++gi) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[gi], off);
      const float lo = __shfl_xor_sync(0xffffffffu, l[gi], off);
      const float mm = fmaxf(m[gi], mo);
      const float fa = exp2f((m[gi] - mm) * scale_log2);
      const float fb = exp2f((mo - mm) * scale_log2);
      l[gi] = l[gi] * fa + lo * fb;
#pragma unroll
      for (int e = 0; e < NE; ++e)
        acc[gi][e] = acc[gi][e] * fa +
                     __shfl_xor_sync(0xffffffffu, acc[gi][e], off) * fb;
      m[gi] = mm;
    }
  }
  if (gl == 0) {
#pragma unroll
    for (int gi = 0; gi < GC; ++gi) {
#pragma unroll
      for (int c = 0; c < NCH; ++c)
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          sm_acc[warp][gi][(c * G::LPR + r) * VEC + e] = acc[gi][c * VEC + e];
      if (r == 0) {
        sm_m[warp][gi] = m[gi];
        sm_l[warp][gi] = l[gi];
      }
    }
  }
  __syncthreads();

  // the warps' states into the block's, in warp order; partial states are
  // [query row][chunk] with rows (b, h, query head) = qrow0 + gi
  float* part_acc = part;
  float* part_ml =
      part + (size_t)gridDim.z * hkv * g * splits * D;
  for (int e = tid; e < GC * D; e += kThreads) {
    const int gi = e / D, d = e % D;
    if (g0 + gi >= g) continue;
    float mm = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mm = fmaxf(mm, sm_m[w][gi]);
    float ll = 0.f, aa = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = exp2f((sm_m[w][gi] - mm) * scale_log2);
      ll += sm_l[w][gi] * f;
      aa += sm_acc[w][gi][d] * f;
    }
    const size_t prow = (qrow0 + gi) * splits + split;
    if (used == 1) {  // the slot's only block: the output directly
      out[(qrow0 + gi) * D + d] = aa / (ll == 0.f ? 1.f : ll);
    } else {
      part_acc[prow * D + d] = aa;
      if (d == 0) {
        part_ml[prow * 2] = mm;
        part_ml[prow * 2 + 1] = ll;
      }
    }
  }
  if (used == 1) return;

  // the last block of the (slot, kv head, head group) to finish combines
  // the partial states
  const size_t ticket = ((size_t)b * hkv + h) * ngroups + g0 / GC;
  __threadfence();  // this block's partial state is visible to the others
  __syncthreads();
  if (tid == 0) {
    sm_last = atomicAdd(counters + ticket, 1) == used - 1;
    __threadfence();
  }
  __syncthreads();
  if (!sm_last) return;
  for (int e = tid; e < GC * D; e += kThreads) {
    const int gi = e / D, d = e % D;
    if (g0 + gi >= g) continue;
    const float* acc_r = part_acc + (qrow0 + gi) * splits * D;
    const float* ml_r = part_ml + (qrow0 + gi) * splits * 2;
    float mm = kNegInf;
    for (int c = 0; c < used; ++c) mm = fmaxf(mm, __ldcg(ml_r + 2 * c));
    float ll = 0.f, aa = 0.f;
    for (int c = 0; c < used; ++c) {
      const float f = exp2f((__ldcg(ml_r + 2 * c) - mm) * scale_log2);
      ll += __ldcg(ml_r + 2 * c + 1) * f;
      aa += __ldcg(acc_r + (size_t)c * D + d) * f;
    }
    out[(qrow0 + gi) * D + d] = aa / (ll == 0.f ? 1.f : ll);
  }
  if (tid == 0) counters[ticket] = 0;  // ready for the next call
}

struct Args {
  const float* q;
  const void* kp;
  const void* vp;
  const float* ksc;
  const float* vsc;
  const int* pt;
  const int* lens;
  float* out;
  float* part;
  int* counters;
  int b, hkv, g, num_pages, ps, mp, ppc, splits;
  float scale_log2;
  cudaStream_t stream;
};

template <typename P, int D, int GC>
int launch(const Args& a) {
  const int ngroups = (a.g + GC - 1) / GC;
  const int smem = Ring<P, D>::BYTES + a.ppc * 4;
  // above 48 KB of dynamic shared memory needs the opt-in, once: the ring
  // and the most page ids a chunk takes
  static const cudaError_t attr = cudaFuncSetAttribute(
      paged_decode_kernel<P, D, GC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      Ring<P, D>::BYTES + kMaxPages * 4);
  if (attr != cudaSuccess) return (int)attr;
  paged_decode_kernel<P, D, GC>
      <<<dim3(a.splits, a.hkv * ngroups, a.b), kThreads, smem,
         a.stream>>>(a.q, static_cast<const P*>(a.kp),
                     static_cast<const P*>(a.vp), a.ksc, a.vsc, a.pt,
                     a.lens, a.out, a.part, a.counters, a.hkv, a.g,
                     a.num_pages, a.ps, a.mp, a.ppc, a.splits, a.scale_log2);
  return 0;
}

template <typename P, int D>
int launch_g(const Args& a) {
  return a.g == 1 ? launch<P, D, 1>(a) : launch<P, D, kGroupsPerBlock>(a);
}

template <typename P>
int dispatch_d(int d, const Args& a) {
  switch (d) {
    case 64: return launch_g<P, 64>(a);
    case 128: return launch_g<P, 128>(a);
    case 256: return launch_g<P, 256>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

// f(P{}) for the pool type of code `pool_dtype` (0 f32, 1 bf16, 2 int8, 3
// f16); an unknown code is cudaErrorInvalidValue
template <typename F>
int by_pool(int pool_dtype, F f) {
  switch (pool_dtype) {
    case 0: return f(float{});
    case 1: return f(__nv_bfloat16{});
    case 2: return f(int8_t{});
    case 3: return f(__half{});
  }
  return (int)cudaErrorInvalidValue;
}

// out: [blocks an SM resident, dynamic shared memory bytes, registers a
// thread, local (spill) bytes a thread] of the instantiation a call with
// these pools, head dim, query heads a kv head and pages a chunk runs
template <typename P, int D, int GC>
int residency(int ppc, int* out) {
  const int smem = Ring<P, D>::BYTES + ppc * 4;
  cudaError_t err = cudaFuncSetAttribute(
      paged_decode_kernel<P, D, GC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      Ring<P, D>::BYTES + kMaxPages * 4);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, paged_decode_kernel<P, D, GC>, kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes fa;
  err = cudaFuncGetAttributes(&fa, paged_decode_kernel<P, D, GC>);
  if (err != cudaSuccess) return (int)err;
  out[1] = smem;
  out[2] = fa.numRegs;
  out[3] = (int)fa.localSizeBytes;
  return 0;
}

template <typename P, int D>
int residency_g(int g, int ppc, int* out) {
  return g == 1 ? residency<P, D, 1>(ppc, out)
                : residency<P, D, kGroupsPerBlock>(ppc, out);
}

}  // namespace

// q: [b, hkv, g, d] f32; k_pages, v_pages: [hkv, num_pages, ps, d] of
// pool_dtype (0 f32, 1 bf16, 2 int8, 3 f16); k_scale, v_scale: [hkv,
// num_pages, ps] f32 for int8 pools, else null; page_table: [b, mp] int32
// (every live entry a valid page id); lens: [b] int32; out: [b, hkv, g, d]
// f32. The table row is cut into `splits` chunks of `ppc` pages, splits *
// ppc >= mp. part: f32 scratch of b * hkv * g * splits * (d + 2) values
// (the partial states); counters: b * hkv * ceil(g / 4) int32 (one for g =
// 1: b * hkv), zero on entry and left zero. Launches one kernel on
// `stream` and returns cudaGetLastError() (0 on success).
extern "C" int paged_flash_decode(const float* q, const void* k_pages,
                                  const void* v_pages, const float* k_scale,
                                  const float* v_scale, const int* page_table,
                                  const int* lens, float* out, float* part,
                                  int* counters, int b, int hkv, int g,
                                  int num_pages, int ps, int mp, int d,
                                  int pool_dtype, int splits, int ppc,
                                  float sm_scale, void* stream) {
  if (b <= 0 || hkv <= 0 || g <= 0 || ps <= 0 || mp <= 0 || splits <= 0 ||
      ppc <= 0 || ppc > kMaxPages || (long long)splits * ppc < mp ||
      b > 65535 || splits > 65535)
    return (int)cudaErrorInvalidValue;
  if ((pool_dtype == 2) != (k_scale != nullptr && v_scale != nullptr))
    return (int)cudaErrorInvalidValue;
  const int gpb = g == 1 ? 1 : kGroupsPerBlock;
  if ((long long)hkv * ((g + gpb - 1) / gpb) > 65535)
    return (int)cudaErrorInvalidValue;
  const Args a{q, k_pages, v_pages, k_scale, v_scale, page_table, lens, out,
               part, counters, b, hkv, g, num_pages, ps, mp, ppc, splits,
               sm_scale * kLog2e, static_cast<cudaStream_t>(stream)};
  const int err =
      by_pool(pool_dtype, [&](auto p) { return dispatch_d<decltype(p)>(d, a); });
  if (err) return err;
  return (int)cudaGetLastError();
}

// What the card makes of the instantiation a call with pools of code
// pool_dtype, head dim d, g query heads a kv head and ppc pages a chunk
// launches: out = [blocks an SM resident
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor at the call's dynamic
// shared memory), that shared memory in bytes, registers a thread, local
// (spill) bytes a thread]. Launches nothing.
extern "C" int paged_flash_decode_residency(int pool_dtype, int d, int g,
                                            int ppc, int* out) {
  if (g <= 0 || ppc <= 0 || ppc > kMaxPages) return (int)cudaErrorInvalidValue;
  return by_pool(pool_dtype, [&](auto p) {
    using P = decltype(p);
    switch (d) {
      case 64: return residency_g<P, 64>(g, ppc, out);
      case 128: return residency_g<P, 128>(g, ppc, out);
      case 256: return residency_g<P, 256>(g, ppc, out);
    }
    return (int)cudaErrorInvalidValue;
  });
}
