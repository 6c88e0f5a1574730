// Fused residual-add + LayerNorm, forward and backward, for Hopper (sm_90a),
// CUDA C++ with a plain C entry.
//
// Replaces the four Pallas TPU kernels of paddle_tpu/ops/pallas/fused_ln.py:
//   _fwd_call   (#6)  s = x + r; y = (s - mu) * rstd * g + b; writes y, s,
//                     mu, rstd
//   _fwd_call_y (#8)  the same without writing s (post-LN blocks drop it)
//   _bwd_call   (#7)  from dy, ds and the saved (rounded) s, mu, rstd:
//                     xhat = (s - mu) * rstd, dxhat = dy * g,
//                     dx = rstd * (dxhat - mean(dxhat) - xhat * mean(dxhat *
//                     xhat)) + ds, dg = sum_rows(dy * xhat), db = sum_rows(dy)
//   _bwd_call_y (#9)  the same with s = x + r recomputed in f32 and no ds
// x, r, dy, ds, s, y, dx are [n, h] in f32, bf16 or f16 (one dtype per
// call); gamma and beta are [h] in f32 or the rows' dtype; mu and rstd are
// [n] f32; dg and db come out f32. Every value is computed in f32 and
// rounded to the storage dtype only where it is stored, as the Pallas
// bodies do: s is stored rounded by #6 and read back rounded by #7, while
// #8/#9 keep it in f32.
// The variance is the two-pass mean((s - mu)^2), as the reference.
// float16 (float16 AMP, under a GradScaler) runs the bf16 instantiations'
// code at __half: the same 2-byte chunks, chunk counts, residency and
// grids; only the conversions differ, and a sum or an output past f16's
// 65504 is stored as inf, as the reference's astype stores it.
//
// What the TPU tiling needed and this drops: the [n, 128] lane-replicated
// row statistics (_STAT_LANES) are [n] here, and the block-row picker is
// gone: any row count runs (no jnp fallback for rows that do not tile).
//
//
// What bounds it on the H100: bytes. Per element the forward reads x, r and
// writes y (and s), the backward reads dy, s (or x and r), ds and writes dx,
// for ~10 FLOPs: far below the card's balance point, so the floor is those
// bytes at 3.35 TB/s.
//
// The forward: one warp owns one row at a time and keeps it in registers
// (VPT values a lane, columns lane + 32 j, so each load instruction of a
// warp is one coalesced run), so every element is read once and written
// once; the row sums are warp shuffles.
//
// The backward (#7, #9): one warp a row, lane l owning the 16-byte chunks
// l + 32 j of it (8 bf16 or f16, or 4 f32 values each), so one warp
// instruction moves 512 bytes; and
// - one wave: __launch_bounds__(128, 4) holds a thread to 128 registers,
//   so four blocks reside on an SM where shared memory allows (every
//   16-bit row; f32 rows past 512 values fit three or two); the caller's
//   grid is two blocks an SM of the card's 132 (measured faster than
//   four), all resident at once: no tail wave;
// - the next row in flight: each warp streams its rows through two stages
//   of shared memory. Row i + 1's dy and two row tensors go out as 16-byte
//   cp.async copies, its mu and rstd as register loads, before row i is
//   worked on. A lane reads back only the chunks it copied, so no barrier
//   is needed. The row is read from shared memory once for the two sums and
//   once for dx; registers hold the dg/db accumulators and one chunk;
// - gamma read once a block, into shared memory in f32;
// - a row that is not 16-byte aligned (h * sizeof(T) not a multiple of 16,
//   or a view that starts off a 16-byte boundary) takes the same path with
//   its stages filled by scalar loads, zero past h.
// dg/db across rows: the TPU kernel adds them up over its sequential grid.
// Here each lane keeps f32 sums for its own columns over the rows its warp
// visits, the warps of a block add theirs in warp order into one partial
// row [blocks, h], and a second kernel (part of the same launch) sums the
// partial rows in a fixed order. No float atomics: the grid is a function
// of (n, h, dtype), so a seeded run repeats bit for bit.
//
// Rows wider than 1024 values (up to 8192; GPT-1.3B's are 2048) would
// need a warp to hold more than 32 values a lane in registers in the
// forward, and more than 2 x 32 dg/db accumulators in the backward, past
// 128 registers. So such a row is cut
// into W = ceil(h / 512) slices, one warp a slice, and each warp runs the
// code above on its slice: the forward's values and the backward's chunks,
// ring and accumulators are those of a row of at most 512 values. The row
// sums (the mean, then the squared deviations; m1 and m2) cross the W
// warps through shared memory, added in warp order after a named barrier
// of the row's warps. A block is 16 warps (R = 16 / W rows at once); its
// shared memory holds gamma's W slices and a two-stage ring a warp (at
// h = 8192 f32: 32 KB + 16 x 12 KB). The same partial rows and column sum
// carry dg/db, the R rows' sums added in order into the block's row.
//
// What is left: one elementwise pass over as many row bytes
// (torch.addcmul of three row tensors into a fourth) runs ~1.5x faster on
// the H100 than this backward; the second kernel's launch; and a wave's
// last rows (a warp runs ceil(n / (4 * blocks)) rows, at ERNIE's shape 16
// where the mean is 15.5).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;  // rows in flight per block
constexpr int kThreads = 32 * kWarps;
constexpr int kColX = 32;  // column-sum kernel: columns per block
constexpr int kColY = 16;  // ... and partial rows summed side by side

template <typename T>
__device__ __forceinline__ float to_f(T v);
template <>
__device__ __forceinline__ float to_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <>
__device__ __forceinline__ float to_f<__half>(__half v) {
  return __half2float(v);
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's .to()
}
// round to nearest even; past f16's largest finite 65504 the value becomes
// inf, as torch's .to() and the reference's astype make it (no saturation:
// an overflow is what a loss scaler looks for)
template <>
__device__ __forceinline__ __half from_f<__half>(float v) {
  return __float2half_rn(v);
}

// dtype codes of the C entries: the rows' and gamma/beta's
constexpr int kF32 = 0, kBF16 = 1, kF16 = 2;

// gamma / beta in f32, or in the rows' 16-bit type T (w_low): a uniform
// two-way branch. (A three-way one on the dtype code, tried first, cost
// #6 1.66x at 8192 x 1024 on the H100: ptxas gave the forward other
// registers and, without the row sum, spills.)
template <typename T>
__device__ __forceinline__ float load_w(const void* p, int c, bool w_low) {
  return w_low ? to_f(static_cast<const T*>(p)[c])
               : static_cast<const float*>(p)[c];
}

// butterfly sum: every lane ends with the same bits
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// kSum: write s (#6) or not (#8)
template <typename T, int VPT, bool kSum>
__global__ void __launch_bounds__(kThreads)
ln_fwd_kernel(const T* __restrict__ x, const T* __restrict__ r,
              const void* __restrict__ gamma, const void* __restrict__ beta,
              bool w_low, T* __restrict__ y, T* __restrict__ s_out,
              float* __restrict__ mu_out, float* __restrict__ rstd_out,
              long long n, int h, float eps) {
  const int lane = threadIdx.x & 31;
  const long long nwarps = (long long)gridDim.x * kWarps;
  for (long long row = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
       row < n; row += nwarps) {
    const long long base = row * h;
    float s[VPT];
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
      const int c = lane + 32 * j;
      s[j] = c < h ? to_f(x[base + c]) + to_f(r[base + c]) : 0.f;
      sum += s[j];
    }
    const float mu = warp_sum(sum) / h;
    float sq = 0.f;
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
      const int c = lane + 32 * j;
      const float d = c < h ? s[j] - mu : 0.f;
      sq += d * d;
    }
    const float rstd = rsqrtf(warp_sum(sq) / h + eps);
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
      const int c = lane + 32 * j;
      if (c < h) {
        const float xhat = (s[j] - mu) * rstd;
        y[base + c] = from_f<T>(xhat * load_w<T>(gamma, c, w_low) +
                                load_w<T>(beta, c, w_low));
        if constexpr (kSum) s_out[base + c] = from_f<T>(s[j]);
      }
    }
    if (lane == 0) {
      mu_out[row] = mu;
      rstd_out[row] = rstd;
    }
  }
}

// -- the backward (#7, #9) ---------------------------------------------------

constexpr int kBwdMinBlocks = 4;  // blocks an SM: 128 registers a thread
constexpr int kChunk = 16;        // bytes a lane moves a load

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronous (L1 bypassed); the memory
// clobbers keep the compiler from moving shared loads across these
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// all but the newest N groups of this thread's copies have landed
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 16 bytes of T <-> f32
template <typename T>
__device__ __forceinline__ void unpack16(const uint4& raw, float* out) {
  const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int e = 0; e < kChunk / (int)sizeof(T); ++e) out[e] = to_f(v[e]);
}

template <typename T>
__device__ __forceinline__ uint4 pack16(const float* in) {
  uint4 raw;
  T* v = reinterpret_cast<T*>(&raw);
#pragma unroll
  for (int e = 0; e < kChunk / (int)sizeof(T); ++e) v[e] = from_f<T>(in[e]);
  return raw;
}

// The backward's geometry at row type T and C chunks a lane. A row is
// NCH = ceil(h / E) chunks of E values; lane l owns chunks l + 32 j, j < C.
// Shared memory: gamma in f32 ([C][E / 4][32 lanes][4], so a lane's float4
// reads of a chunk are one 512-byte run a warp), then a ring for each warp
// of two stages of three row tensors ([stage][tensor][chunk][16 bytes]).
template <typename T, int C>
struct Bwd {
  static constexpr int E = kChunk / (int)sizeof(T);  // values a chunk
  static constexpr int V = C * E;                    // values a lane
  static constexpr int ROW = C * 32 * kChunk;        // bytes a staged row
  static constexpr int STAGE = 3 * ROW;              // dy, a, b (or ds)
  static constexpr int GAMMA = 32 * V * 4;           // f32 gamma bytes
  static constexpr int SMEM = GAMMA + kWarps * 2 * STAGE;
};

// kSum: #7 (a = the saved s, ds added) or #9 (s = a + b recomputed, no ds).
// Writes dx and one [h] row of dg and db partials per block. vec: every
// row pointer and h * sizeof(T) are 16-byte multiples, so the stages fill
// by cp.async; else by scalar loads, zero past h.
template <typename T, int C, bool kSum>
__global__ void __launch_bounds__(kThreads, kBwdMinBlocks)
ln_bwd_kernel(const T* __restrict__ dy, const T* __restrict__ ds,
              const T* __restrict__ a, const T* __restrict__ b,
              const float* __restrict__ mu, const float* __restrict__ rstd,
              const void* __restrict__ gamma, bool w_low,
              T* __restrict__ dx, float* __restrict__ part_g,
              float* __restrict__ part_b, long long n, int h, bool vec) {
  using G = Bwd<T, C>;
  constexpr int E = G::E;
  extern __shared__ __align__(16) unsigned char smem[];
  float* gs = reinterpret_cast<float*>(smem);
  const int lane = threadIdx.x & 31;
  const int wib = threadIdx.x >> 5;
  unsigned char* ring = smem + G::GAMMA + wib * 2 * G::STAGE;
  const int nch = (h + E - 1) / E;
  const T* rows2 = kSum ? ds : b;

  // this lane's chunks of row `row` into stage s (an empty group past n)
  auto fill = [&](int s, long long row) {
    if (row < n) {
      const long long base = row * h;
      const T* src[3] = {dy + base, a + base, rows2 + base};
#pragma unroll
      for (int t = 0; t < 3; ++t) {
#pragma unroll
        for (int j = 0; j < C; ++j) {
          const int k = lane + 32 * j;
          unsigned char* dst = ring + s * G::STAGE + t * G::ROW + k * kChunk;
          if (k < nch) {
            if (vec) {
              cp_async16(dst, src[t] + k * E);
            } else {
              uint4 raw;
              T* v = reinterpret_cast<T*>(&raw);
#pragma unroll
              for (int e = 0; e < E; ++e) {
                const int c = k * E + e;
                v[e] = c < h ? src[t][c] : from_f<T>(0.f);
              }
              *reinterpret_cast<uint4*>(dst) = raw;
            }
          }
        }
      }
    }
    cp_async_commit();
  };
  // chunk j of tensor t in stage s, and gamma's values of chunk j
  auto staged = [&](int s, int t, int j, float* out) {
    unpack16<T>(*reinterpret_cast<const uint4*>(
                    ring + s * G::STAGE + t * G::ROW +
                    (lane + 32 * j) * kChunk),
                out);
  };
  auto gamma_of = [&](int j, float* out) {
#pragma unroll
    for (int q = 0; q < E / 4; ++q) {
      const float4 g4 = reinterpret_cast<const float4*>(
          gs)[(j * (E / 4) + q) * 32 + lane];
      out[4 * q] = g4.x;
      out[4 * q + 1] = g4.y;
      out[4 * q + 2] = g4.z;
      out[4 * q + 3] = g4.w;
    }
  };

  float acc_g[G::V], acc_b[G::V];
#pragma unroll
  for (int i = 0; i < G::V; ++i) acc_g[i] = acc_b[i] = 0.f;

  // the first row's copies go out before gamma is read
  const long long stride = (long long)gridDim.x * kWarps;
  long long row = (long long)blockIdx.x * kWarps + wib;
  fill(0, row);
  float m_next = row < n ? mu[row] : 0.f;
  float rs_next = row < n ? rstd[row] : 0.f;
  for (int i = threadIdx.x; i < 32 * G::V; i += kThreads) {
    const int t = i & 3, l = (i >> 2) & 31, jq = i >> 7;
    const int c = (l + 32 * (jq / (E / 4))) * E + 4 * (jq % (E / 4)) + t;
    gs[i] = c < h ? load_w<T>(gamma, c, w_low) : 0.f;
  }
  __syncthreads();
  for (int s = 0; row < n; row += stride, s ^= 1) {
    const float m = m_next, rs = rs_next;
    const long long next = row + stride;
    fill(s ^ 1, next);  // the next row's copies go out first
    if (next < n) {
      m_next = mu[next];
      rs_next = rstd[next];
    }
    cp_async_wait<1>();  // this row's copies landed

    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int j = 0; j < C; ++j) {
      if (lane + 32 * j < nch) {
        float d[E], u[E], w[E], g[E];
        staged(s, 0, j, d);
        staged(s, 1, j, u);
        if constexpr (!kSum) staged(s, 2, j, w);
        gamma_of(j, g);
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const float sv = kSum ? u[e] : u[e] + w[e];
          const float xhat = (sv - m) * rs;
          const float dxh = d[e] * g[e];
          acc_g[j * E + e] += d[e] * xhat;
          acc_b[j * E + e] += d[e];
          s1 += dxh;
          s2 += dxh * xhat;
        }
      }
    }
    const float m1 = warp_sum(s1) / h;
    const float m2 = warp_sum(s2) / h;
#pragma unroll
    for (int j = 0; j < C; ++j) {
      const int k = lane + 32 * j;
      if (k < nch) {
        float d[E], u[E], w[E], g[E], v[E];
        staged(s, 0, j, d);
        staged(s, 1, j, u);
        staged(s, 2, j, w);
        gamma_of(j, g);
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const float sv = kSum ? u[e] : u[e] + w[e];
          const float xhat = (sv - m) * rs;
          v[e] = rs * (d[e] * g[e] - m1 - xhat * m2);
          if constexpr (kSum) v[e] += w[e];
        }
        T* out = dx + row * h + k * E;
        if (vec) {
          *reinterpret_cast<uint4*>(out) = pack16<T>(v);
        } else {
#pragma unroll
          for (int e = 0; e < E; ++e)
            if (k * E + e < h) out[e] = from_f<T>(v[e]);
        }
      }
    }
  }
  cp_async_wait<0>();

  // the block's partials: each warp's accumulators into its own [2, 32 V]
  // slice of the (now idle) rings, then the warps added in warp order
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem + G::GAMMA);
  float* mine = red + wib * 2 * 32 * G::V;
#pragma unroll
  for (int j = 0; j < C; ++j) {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int c = (lane + 32 * j) * E + e;
      mine[c] = acc_g[j * E + e];
      mine[32 * G::V + c] = acc_b[j * E + e];
    }
  }
  __syncthreads();
  const long long prow = (long long)blockIdx.x * h;
  for (int c = threadIdx.x; c < h; c += kThreads) {
    float g = red[c], bb = red[32 * G::V + c];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) {
      g += red[w * 2 * 32 * G::V + c];
      bb += red[w * 2 * 32 * G::V + 32 * G::V + c];
    }
    part_g[prow + c] = g;
    part_b[prow + c] = bb;
  }
}

// dg[c] = sum over the `rows` partial rows, in a fixed order: thread (tx,
// ty) sums rows ty, ty + kColY, ...; then thread ty = 0 adds the kColY
// sums in order.
__global__ void __launch_bounds__(kColX * kColY)
colsum_kernel(const float* __restrict__ part_g,
              const float* __restrict__ part_b, int rows, int h,
              float* __restrict__ dg, float* __restrict__ db) {
  __shared__ float sg[kColY][kColX], sb[kColY][kColX];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int c = blockIdx.x * kColX + tx;
  float g = 0.f, bb = 0.f;
  if (c < h) {
    for (int i = ty; i < rows; i += kColY) {
      g += part_g[(long long)i * h + c];
      bb += part_b[(long long)i * h + c];
    }
  }
  sg[ty][tx] = g;
  sb[ty][tx] = bb;
  __syncthreads();
  if (ty == 0 && c < h) {
    for (int k = 1; k < kColY; ++k) {
      g += sg[k][tx];
      bb += sb[k][tx];
    }
    dg[c] = g;
    db[c] = bb;
  }
}

// -- rows wider than 1024 values (h in (1024, 8192]) -------------------------
//
// A row of h values is cut into W = ceil(h / 512) slices (3-16) of sw
// values (ceil(h / W) rounded up to a 16-byte chunk; the last slice takes
// what is left), one warp a slice, so a warp runs the per-warp code above
// on at most 512 values. A block is 16 warps: R = 16 / W rows (rounded
// down) of W warps each; warp wid of a block is row group g = wid / W,
// slice w = wid % W, and the 16 - W R warps left over take no row. A
// 1024-value slice would keep the backward's accumulators as at h = 1024
// (2 x 32 floats a lane), which left no room under 128 registers for the
// sums across warps (ptxas spilled 200 bytes of the f32 kernel): a
// 512-value slice keeps 2 x 16. And at 16 warps a block, 128 registers
// or fewer and more than 64 make one block an SM whatever the count
// (65,536 registers), so the plan knows the residency.

constexpr int kWarpRow = 1024;   // rows up to this run one warp a row
constexpr int kWideSlice = 512;  // the widest slice a warp takes
constexpr int kWideWarps = 16;   // warps a block, so W <= 16: h <= 8192
constexpr int kWideThreads = 32 * kWideWarps;
constexpr int kWideMaxH = kWideSlice * kWideWarps;

struct Wide {
  int warps;  // W: warps a row
  int rows;   // R: rows a block
  int sw;     // values a slice
};

__host__ __device__ __forceinline__ Wide wide_geometry(int h, int es) {
  const int w = (h + kWideSlice - 1) / kWideSlice;
  const int e = kChunk / es;
  const int per = (h + w - 1) / w;
  return {w, kWideWarps / w, (per + e - 1) / e * e};
}

// the threads of row group g alone (barrier 0 is __syncthreads)
__device__ __forceinline__ void group_barrier(int g, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + g), "r"(threads) : "memory");
}

// The row sums over a row group's W warps: warp w's butterfly sums (a, b)
// go to slot[w], the group's warps meet, and every warp adds the W pairs
// in warp order, so all hold the same bits. `slot` alternates between two
// buffers from one sum to the next: a warp that stores the sum after next
// has passed the next barrier, which every warp of its group reaches only
// after reading this one.
__device__ __forceinline__ float2 group_sum(float a, float b, float2* slot,
                                            int w, int W, int g, int lane) {
  if (lane == 0) slot[w] = make_float2(a, b);
  group_barrier(g, 32 * W);
  float2 t = slot[0];
  for (int k = 1; k < W; ++k) {
    t.x += slot[k].x;
    t.y += slot[k].y;
  }
  return t;
}

// #6 / #8 on wide rows: as ln_fwd_kernel, a warp's slice in registers
// (VPT values a lane, columns lane + 32 j of the slice), the mean and then
// the squared deviations summed over the row's warps in warp order. Two
// blocks an SM, 64 registers a thread: at one block (80 registers) it ran
// 1.26x slower at 4096 x 2048 bf16 on the H100.
template <typename T, int VPT, bool kSum>
__global__ void __launch_bounds__(kWideThreads, 2)
ln_fwd_wide_kernel(const T* __restrict__ x, const T* __restrict__ r,
                   const void* __restrict__ gamma,
                   const void* __restrict__ beta, bool w_low,
                   T* __restrict__ y, T* __restrict__ s_out,
                   float* __restrict__ mu_out, float* __restrict__ rstd_out,
                   long long n, int h, float eps) {
  __shared__ float2 red[2][kWideWarps];
  const Wide geo = wide_geometry(h, (int)sizeof(T));
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int g = wid / geo.warps, w = wid % geo.warps;
  if (g >= geo.rows) return;  // a warp left over
  const int col0 = w * geo.sw;
  const int width = min(geo.sw, h - col0);
  int buf = 0;
  for (long long row = (long long)blockIdx.x * geo.rows + g; row < n;
       row += (long long)gridDim.x * geo.rows) {
    const long long base = row * h + col0;
    float s[VPT];
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
      const int c = lane + 32 * j;
      s[j] = c < width ? to_f(x[base + c]) + to_f(r[base + c]) : 0.f;
      sum += s[j];
    }
    const float mu = group_sum(warp_sum(sum), 0.f, red[buf] + g * geo.warps,
                               w, geo.warps, g, lane).x / h;
    buf ^= 1;
    float sq = 0.f;
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
      const int c = lane + 32 * j;
      const float d = c < width ? s[j] - mu : 0.f;
      sq += d * d;
    }
    const float rstd = rsqrtf(group_sum(warp_sum(sq), 0.f,
                                        red[buf] + g * geo.warps, w,
                                        geo.warps, g, lane).x / h + eps);
    buf ^= 1;
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
      const int c = lane + 32 * j;
      if (c < width) {
        const float xhat = (s[j] - mu) * rstd;
        y[base + c] = from_f<T>(xhat * load_w<T>(gamma, col0 + c, w_low) +
                                load_w<T>(beta, col0 + c, w_low));
        if constexpr (kSum) s_out[base + c] = from_f<T>(s[j]);
      }
    }
    if (w == 0 && lane == 0) {
      mu_out[row] = mu;
      rstd_out[row] = rstd;
    }
  }
}

// The wide backward's shared memory at W warps a row and R rows a block:
// gamma in f32, W slices in the per-warp layout of Bwd<T, C> (GAMMA bytes
// each); a ring of two stages for each of the W R warps; and the m1/m2
// exchange, [2 buffers][16 warps] float2.
template <typename T, int C>
__host__ __device__ constexpr int wide_bwd_smem(int warps, int rows) {
  return warps * Bwd<T, C>::GAMMA + warps * rows * 2 * Bwd<T, C>::STAGE +
         2 * kWideWarps * (int)sizeof(float2);
}

// #7 / #9 on wide rows: as ln_bwd_kernel, each warp on its slice (C
// chunks a lane, its own ring, dgamma/dbeta accumulators for its slice's
// columns), m1 and m2 summed over the row's warps in warp order. The
// block's R rows' accumulators are added in row-group order into one
// partial row.
template <typename T, int C, bool kSum>
__global__ void __launch_bounds__(kWideThreads, 1)
ln_bwd_wide_kernel(const T* __restrict__ dy, const T* __restrict__ ds,
                   const T* __restrict__ a, const T* __restrict__ b,
                   const float* __restrict__ mu,
                   const float* __restrict__ rstd,
                   const void* __restrict__ gamma, bool w_low,
                   T* __restrict__ dx, float* __restrict__ part_g,
                   float* __restrict__ part_b, long long n, int h,
                   bool vec) {
  using G = Bwd<T, C>;
  constexpr int E = G::E;
  extern __shared__ __align__(16) unsigned char smem[];
  const Wide geo = wide_geometry(h, (int)sizeof(T));
  const int W = geo.warps, R = geo.rows;
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int g = wid / W, w = wid % W;
  float* gs = reinterpret_cast<float*>(smem) + w * 32 * G::V;
  unsigned char* ring = smem + W * G::GAMMA + wid * 2 * G::STAGE;
  float2* red = reinterpret_cast<float2*>(smem + W * G::GAMMA +
                                          W * R * 2 * G::STAGE);
  const int col0 = w * geo.sw;
  const int width = min(geo.sw, h - col0);
  const int nch = (width + E - 1) / E;
  const T* rows2 = kSum ? ds : b;

  // this lane's chunks of the slice of row `row` into stage s (an empty
  // group past n)
  auto fill = [&](int s, long long row) {
    if (row < n) {
      const long long base = row * h + col0;
      const T* src[3] = {dy + base, a + base, rows2 + base};
#pragma unroll
      for (int t = 0; t < 3; ++t) {
#pragma unroll
        for (int j = 0; j < C; ++j) {
          const int k = lane + 32 * j;
          unsigned char* dst = ring + s * G::STAGE + t * G::ROW + k * kChunk;
          if (k < nch) {
            if (vec) {
              cp_async16(dst, src[t] + k * E);
            } else {
              uint4 raw;
              T* v = reinterpret_cast<T*>(&raw);
#pragma unroll
              for (int e = 0; e < E; ++e) {
                const int c = k * E + e;
                v[e] = c < width ? src[t][c] : from_f<T>(0.f);
              }
              *reinterpret_cast<uint4*>(dst) = raw;
            }
          }
        }
      }
    }
    cp_async_commit();
  };
  auto staged = [&](int s, int t, int j, float* out) {
    unpack16<T>(*reinterpret_cast<const uint4*>(
                    ring + s * G::STAGE + t * G::ROW +
                    (lane + 32 * j) * kChunk),
                out);
  };
  auto gamma_of = [&](int j, float* out) {
#pragma unroll
    for (int q = 0; q < E / 4; ++q) {
      const float4 g4 = reinterpret_cast<const float4*>(
          gs)[(j * (E / 4) + q) * 32 + lane];
      out[4 * q] = g4.x;
      out[4 * q + 1] = g4.y;
      out[4 * q + 2] = g4.z;
      out[4 * q + 3] = g4.w;
    }
  };

  float acc_g[G::V], acc_b[G::V];
#pragma unroll
  for (int i = 0; i < G::V; ++i) acc_g[i] = acc_b[i] = 0.f;

  const long long stride = (long long)gridDim.x * R;
  long long row = g < R ? (long long)blockIdx.x * R + g : n;  // n: no row
  fill(0, row);
  float m_next = row < n ? mu[row] : 0.f;
  float rs_next = row < n ? rstd[row] : 0.f;
  // gamma: slice ws's value at its column cl sits where Bwd's layout puts
  // column cl of a row; zero past the slice and past h
  for (int i = threadIdx.x; i < W * 32 * G::V; i += blockDim.x) {
    const int ws = i / (32 * G::V), ii = i - ws * 32 * G::V;
    const int t = ii & 3, l = (ii >> 2) & 31, jq = ii >> 7;
    const int cl = (l + 32 * (jq / (E / 4))) * E + 4 * (jq % (E / 4)) + t;
    const int c = ws * geo.sw + cl;
    reinterpret_cast<float*>(smem)[i] =
        cl < geo.sw && c < h ? load_w<T>(gamma, c, w_low) : 0.f;
  }
  __syncthreads();
  int buf = 0;
  for (int s = 0; row < n; row += stride, s ^= 1) {
    const float m = m_next, rs = rs_next;
    const long long next = row + stride;
    fill(s ^ 1, next);  // the next row's copies go out first
    if (next < n) {
      m_next = mu[next];
      rs_next = rstd[next];
    }
    cp_async_wait<1>();  // this row's copies landed

    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int j = 0; j < C; ++j) {
      if (lane + 32 * j < nch) {
        float d[E], u[E], v[E], gm[E];
        staged(s, 0, j, d);
        staged(s, 1, j, u);
        if constexpr (!kSum) staged(s, 2, j, v);
        gamma_of(j, gm);
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const float sv = kSum ? u[e] : u[e] + v[e];
          const float xhat = (sv - m) * rs;
          const float dxh = d[e] * gm[e];
          acc_g[j * E + e] += d[e] * xhat;
          acc_b[j * E + e] += d[e];
          s1 += dxh;
          s2 += dxh * xhat;
        }
      }
    }
    const float2 tot = group_sum(warp_sum(s1), warp_sum(s2),
                                 red + buf * kWideWarps + g * W, w, W, g,
                                 lane);
    buf ^= 1;
    const float m1 = tot.x / h;
    const float m2 = tot.y / h;
#pragma unroll
    for (int j = 0; j < C; ++j) {
      const int k = lane + 32 * j;
      if (k < nch) {
        float d[E], u[E], v[E], gm[E], o[E];
        staged(s, 0, j, d);
        staged(s, 1, j, u);
        staged(s, 2, j, v);
        gamma_of(j, gm);
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const float sv = kSum ? u[e] : u[e] + v[e];
          const float xhat = (sv - m) * rs;
          o[e] = rs * (d[e] * gm[e] - m1 - xhat * m2);
          if constexpr (kSum) o[e] += v[e];
        }
        T* out = dx + row * h + col0 + k * E;
        if (vec) {
          *reinterpret_cast<uint4*>(out) = pack16<T>(o);
        } else {
#pragma unroll
          for (int e = 0; e < E; ++e)
            if (k * E + e < width) out[e] = from_f<T>(o[e]);
        }
      }
    }
  }
  cp_async_wait<0>();

  // the block's partials: each warp's accumulators into its row group's
  // [2, W 32 V] row of the (now idle) rings at its slice, then the R row
  // groups added in order
  __syncthreads();
  const int span = W * 32 * G::V;
  float* part = reinterpret_cast<float*>(smem + W * G::GAMMA);
  float* mine = part + g * 2 * span + w * 32 * G::V;
  if (g < R) {
#pragma unroll
    for (int j = 0; j < C; ++j) {
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int c = (lane + 32 * j) * E + e;
        mine[c] = acc_g[j * E + e];
        mine[span + c] = acc_b[j * E + e];
      }
    }
  }
  __syncthreads();
  const long long prow = (long long)blockIdx.x * h;
  for (int c = threadIdx.x; c < h; c += blockDim.x) {
    const int ws = c / geo.sw;
    const int at = ws * 32 * G::V + (c - ws * geo.sw);
    float sg = part[at], sb = part[span + at];
    for (int q = 1; q < R; ++q) {
      sg += part[q * 2 * span + at];
      sb += part[q * 2 * span + span + at];
    }
    part_g[prow + c] = sg;
    part_b[prow + c] = sb;
  }
}

// values a lane holds: the smallest that covers h / 32; 0 above h = 1024,
// the widest row the registers hold (the wrapper raises there first)
int pick_vpt(int h) {
  const int need = (h + 31) / 32;
  const int opts[] = {2, 4, 8, 16, 24, 32};
  for (int v : opts)
    if (need <= v) return v;
  return 0;
}

#define FLN_DISPATCH(VPT_VAR, CALL) \
  switch (VPT_VAR) {                \
    case 2: CALL(2); break;         \
    case 4: CALL(4); break;         \
    case 8: CALL(8); break;         \
    case 16: CALL(16); break;       \
    case 24: CALL(24); break;       \
    case 32: CALL(32); break;       \
    default: return (int)cudaErrorInvalidValue; \
  }

template <typename T, bool kSum>
int launch_fwd(const void* x, const void* r, const void* gamma,
               const void* beta, bool w_low, void* y, void* s, float* mu,
               float* rstd, long long n, int h, float eps,
               cudaStream_t stream) {
  const int vpt = pick_vpt(h);
  const long long want = (n + kWarps - 1) / kWarps;
  const int grid = (int)(want < (1LL << 30) ? want : (1LL << 30));
#define FLN_FWD(V)                                                          \
  ln_fwd_kernel<T, V, kSum><<<grid, kThreads, 0, stream>>>(                 \
      static_cast<const T*>(x), static_cast<const T*>(r), gamma, beta,      \
      w_low, static_cast<T*>(y), static_cast<T*>(s), mu, rstd, n, h, eps)
  FLN_DISPATCH(vpt, FLN_FWD)
#undef FLN_FWD
  return (int)cudaGetLastError();
}

// C: chunks a lane for a row of h values of `es` bytes, rounded up to an
// instantiated count (16-bit rows take 1-4, f32 rows 1-4, 6 or 8); 0 above
// h = 1024
int pick_chunks(int h, int es) {
  if (h > 1024) return 0;
  const int e = kChunk / es;
  const int c = ((h + e - 1) / e + 31) / 32;
  return c <= 4 ? c : (c <= 6 ? 6 : 8);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename T, int C, bool kSum>
cudaError_t bwd_attrs() {
  // above 48 KB of dynamic shared memory needs the opt-in, and all of the
  // SM's shared memory as such (the copies bypass L1): once each
  static const cudaError_t attr = [] {
    cudaError_t e = cudaFuncSetAttribute(
        ln_bwd_kernel<T, C, kSum>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, Bwd<T, C>::SMEM);
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(ln_bwd_kernel<T, C, kSum>,
                                cudaFuncAttributePreferredSharedMemoryCarveout,
                                (int)cudaSharedmemCarveoutMaxShared);
  }();
  return attr;
}

// CALL(C) for the chunk count of h values of T (a function body's end)
#define FLN_CHUNKS(CALL)                                      \
  switch (pick_chunks(h, (int)sizeof(T))) {                   \
    case 1: return CALL(1);                                   \
    case 2: return CALL(2);                                   \
    case 3: return CALL(3);                                   \
    case 4: return CALL(4);                                   \
    case 6: if constexpr (sizeof(T) == 4) return CALL(6); break; \
    case 8: if constexpr (sizeof(T) == 4) return CALL(8); break; \
  }                                                           \
  return (int)cudaErrorInvalidValue;

template <typename T, int C, bool kSum>
int launch_rows_c(const void* dy, const void* ds, const void* a,
                  const void* b, const float* mu, const float* rstd,
                  const void* gamma, bool w_low, void* dx, float* part_g,
                  float* part_b, long long n, int h, int blocks,
                  cudaStream_t stream) {
  const cudaError_t err = bwd_attrs<T, C, kSum>();
  if (err != cudaSuccess) return (int)err;
  const bool vec = (h * sizeof(T)) % kChunk == 0 && aligned16(dy) &&
                   aligned16(a) && aligned16(kSum ? ds : b) &&
                   aligned16(dx);
  ln_bwd_kernel<T, C, kSum>
      <<<blocks, kThreads, Bwd<T, C>::SMEM, stream>>>(
      static_cast<const T*>(dy), static_cast<const T*>(ds),
      static_cast<const T*>(a), static_cast<const T*>(b), mu, rstd, gamma,
      w_low, static_cast<T*>(dx), part_g, part_b, n, h, vec);
  return (int)cudaGetLastError();
}

template <typename T, bool kSum>
int launch_rows(const void* dy, const void* ds, const void* a, const void* b,
                const float* mu, const float* rstd, const void* gamma,
                bool w_low, void* dx, float* part_g, float* part_b,
                long long n, int h, int blocks, cudaStream_t stream) {
#define FLN_ROWS(CC)                                                      \
  launch_rows_c<T, CC, kSum>(dy, ds, a, b, mu, rstd, gamma, w_low, dx,  \
                             part_g, part_b, n, h, blocks, stream)
  FLN_CHUNKS(FLN_ROWS)
#undef FLN_ROWS
}

// -- the wide launches (1024 < h <= 8192) ------------------------------------

template <typename T, bool kSum>
int launch_fwd_wide(const void* x, const void* r, const void* gamma,
                    const void* beta, bool w_low, void* y, void* s,
                    float* mu, float* rstd, long long n, int h, float eps,
                    cudaStream_t stream) {
  const Wide geo = wide_geometry(h, (int)sizeof(T));
  const long long want = (n + geo.rows - 1) / geo.rows;
  const int grid = (int)(want < (1LL << 30) ? want : (1LL << 30));
  ln_fwd_wide_kernel<T, kWideSlice / 32, kSum>
      <<<grid, kWideThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(r), gamma, beta,
      w_low, static_cast<T*>(y), static_cast<T*>(s), mu, rstd, n, h, eps);
  return (int)cudaGetLastError();
}

template <typename T, bool kSum>
struct WideBwd {
  // chunks a lane for a slice of up to 512 values (2 bf16 or f16, 4 f32)
  static constexpr int C = kWideSlice / (32 * Bwd<T, 1>::E);
  static int smem(const Wide& geo) {
    return wide_bwd_smem<T, C>(geo.warps, geo.rows);
  }
  // the block's dynamic shared memory depends on W: allow all that the
  // card gives a block, and all of the SM's shared memory as such; once
  static cudaError_t attrs() {
    static const cudaError_t attr = [] {
      int dev = 0, optin = 0;
      cudaError_t e = cudaGetDevice(&dev);
      if (e == cudaSuccess)
        e = cudaDeviceGetAttribute(
            &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
      if (e == cudaSuccess)
        e = cudaFuncSetAttribute(ln_bwd_wide_kernel<T, C, kSum>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 optin);
      if (e != cudaSuccess) return e;
      return cudaFuncSetAttribute(
          ln_bwd_wide_kernel<T, C, kSum>,
          cudaFuncAttributePreferredSharedMemoryCarveout,
          (int)cudaSharedmemCarveoutMaxShared);
    }();
    return attr;
  }
};

template <typename T, bool kSum>
int launch_wide(const void* dy, const void* ds, const void* a, const void* b,
                const float* mu, const float* rstd, const void* gamma,
                bool w_low, void* dx, float* part_g, float* part_b,
                long long n, int h, int blocks, cudaStream_t stream) {
  using K = WideBwd<T, kSum>;
  const cudaError_t err = K::attrs();
  if (err != cudaSuccess) return (int)err;
  const Wide geo = wide_geometry(h, (int)sizeof(T));
  const bool vec = (h * sizeof(T)) % kChunk == 0 && aligned16(dy) &&
                   aligned16(a) && aligned16(kSum ? ds : b) &&
                   aligned16(dx);
  ln_bwd_wide_kernel<T, K::C, kSum>
      <<<blocks, kWideThreads, K::smem(geo), stream>>>(
      static_cast<const T*>(dy), static_cast<const T*>(ds),
      static_cast<const T*>(a), static_cast<const T*>(b), mu, rstd, gamma,
      w_low, static_cast<T*>(dx), part_g, part_b, n, h, vec);
  return (int)cudaGetLastError();
}

// as bwd_residency, for the wide kernel at rows of h values
template <typename T, bool kSum>
int wide_residency(int h, int* out) {
  using K = WideBwd<T, kSum>;
  cudaError_t err = K::attrs();
  if (err != cudaSuccess) return (int)err;
  const Wide geo = wide_geometry(h, (int)sizeof(T));
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, ln_bwd_wide_kernel<T, K::C, kSum>, kWideThreads, K::smem(geo));
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes fa;
  err = cudaFuncGetAttributes(&fa, ln_bwd_wide_kernel<T, K::C, kSum>);
  if (err != cudaSuccess) return (int)err;
  out[1] = K::smem(geo);
  out[2] = fa.numRegs;
  out[3] = (int)fa.localSizeBytes;
  return 0;
}

// a row width the kernels take: up to 1024 one warp a row, up to 8192 wide
bool width_ok(int h) {
  return h > kWarpRow ? h <= kWideMaxH : pick_vpt(h) != 0;
}

template <typename T, bool kSum>
int launch_bwd(const void* dy, const void* ds, const void* a, const void* b,
               const float* mu, const float* rstd, const void* gamma,
               bool w_low, void* dx, float* part_g, float* part_b,
               float* dg, float* db, long long n, int h, int blocks,
               cudaStream_t stream) {
  const int err =
      h > kWarpRow
          ? launch_wide<T, kSum>(dy, ds, a, b, mu, rstd, gamma, w_low, dx,
                                 part_g, part_b, n, h, blocks, stream)
          : launch_rows<T, kSum>(dy, ds, a, b, mu, rstd, gamma, w_low, dx,
                                 part_g, part_b, n, h, blocks, stream);
  if (err) return err;
  colsum_kernel<<<(h + kColX - 1) / kColX, dim3(kColX, kColY), 0, stream>>>(
      part_g, part_b, blocks, h, dg, db);
  return (int)cudaGetLastError();
}

// out: [blocks an SM resident, dynamic shared memory bytes, registers a
// thread, local (spill) bytes a thread] of one backward instantiation
template <typename T, int C, bool kSum>
int bwd_residency(int* out) {
  cudaError_t err = bwd_attrs<T, C, kSum>();
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, ln_bwd_kernel<T, C, kSum>, kThreads, Bwd<T, C>::SMEM);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes fa;
  err = cudaFuncGetAttributes(&fa, ln_bwd_kernel<T, C, kSum>);
  if (err != cudaSuccess) return (int)err;
  out[1] = Bwd<T, C>::SMEM;
  out[2] = fa.numRegs;
  out[3] = (int)fa.localSizeBytes;
  return 0;
}

template <typename T, bool kSum>
int residency(int h, int* out) {
#define FLN_RES(CC) bwd_residency<T, CC, kSum>(out)
  FLN_CHUNKS(FLN_RES)
#undef FLN_RES
}


// f(T{}) for the row type of dtype code `dt`; an unknown code is
// cudaErrorInvalidValue
template <typename F>
int by_dtype(int dt, F f) {
  switch (dt) {
    case kF32: return f(float{});
    case kBF16: return f(__nv_bfloat16{});
    case kF16: return f(__half{});
  }
  return (int)cudaErrorInvalidValue;
}

// gamma/beta in f32 or the rows' dtype
bool w_ok(int dt, int wdt) { return wdt == kF32 || wdt == dt; }

}  // namespace

// Forward, #6 (s != NULL: s is written) or #8 (s == NULL). x, r, y, s: n x h
// contiguous values of one dtype (code dt: 0 f32, 1 bf16, 2 f16),
// gamma/beta: h values (code wdt: f32 or dt), mu/rstd: n floats. Launches
// on `stream` and returns cudaGetLastError().
extern "C" int fused_ln_fwd(const void* x, const void* r, const void* gamma,
                            const void* beta, void* y, void* s, float* mu,
                            float* rstd, long long n, int h, float eps,
                            int dt, int wdt, void* stream) {
  if (n <= 0 || h <= 0 || !width_ok(h) || !w_ok(dt, wdt))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool w_low = wdt != kF32;
  return by_dtype(dt, [&](auto tag) {
    using T = decltype(tag);
    if (h > kWarpRow)
      return s ? launch_fwd_wide<T, true>(x, r, gamma, beta, w_low, y, s, mu,
                                          rstd, n, h, eps, st)
               : launch_fwd_wide<T, false>(x, r, gamma, beta, w_low, y,
                                           nullptr, mu, rstd, n, h, eps, st);
    return s ? launch_fwd<T, true>(x, r, gamma, beta, w_low, y, s, mu, rstd,
                                   n, h, eps, st)
             : launch_fwd<T, false>(x, r, gamma, beta, w_low, y, nullptr, mu,
                                    rstd, n, h, eps, st);
  });
}

// Backward, #7 (ds != NULL: a is the saved s, b unused) or #9 (ds == NULL:
// a = x, b = r). dy, ds, a, b, dx: n x h of one dtype (code dt); mu/rstd:
// n floats; gamma: h values (code wdt); part_g/part_b: blocks x h float
// scratch; dg/db: h floats. `blocks` is the grid of the row kernel (the
// caller's choice, a function of n, h and the dtype, so a run repeats bit
// for bit; one wave where it is at most 132 SMs x the resident blocks). Two
// kernels on `stream`; returns cudaGetLastError().
extern "C" int fused_ln_bwd(const void* dy, const void* ds, const void* a,
                            const void* b, const float* mu, const float* rstd,
                            const void* gamma, void* dx, float* part_g,
                            float* part_b, float* dg, float* db, long long n,
                            int h, int blocks, int dt, int wdt,
                            void* stream) {
  if (n <= 0 || h <= 0 || blocks <= 0 || !width_ok(h) ||
      (!ds && !b) || !w_ok(dt, wdt))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool w_low = wdt != kF32;
  return by_dtype(dt, [&](auto tag) {
    using T = decltype(tag);
    return ds ? launch_bwd<T, true>(dy, ds, a, b, mu, rstd, gamma, w_low, dx,
                                    part_g, part_b, dg, db, n, h, blocks, st)
              : launch_bwd<T, false>(dy, ds, a, b, mu, rstd, gamma, w_low, dx,
                                     part_g, part_b, dg, db, n, h, blocks,
                                     st);
  });
}

// The backward row kernel's residency for rows of h values (code dt), #7
// (with_sum) or #9: out[0] blocks an SM (cudaOccupancy...), out[1] its
// dynamic shared memory bytes, out[2] registers a thread, out[3] local
// (spill) bytes a thread. Launches nothing; returns a CUDA error or 0.
extern "C" int fused_ln_bwd_residency(int h, int dt, int with_sum,
                                      int* out) {
  if (h <= 0 || !width_ok(h))
    return (int)cudaErrorInvalidValue;
  return by_dtype(dt, [&](auto tag) {
    using T = decltype(tag);
    if (h > kWarpRow)
      return with_sum ? wide_residency<T, true>(h, out)
                      : wide_residency<T, false>(h, out);
    return with_sum ? residency<T, true>(h, out)
                    : residency<T, false>(h, out);
  });
}
