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
// x, r, dy, ds, s, y, dx are [n, h] in f32 or bf16 (one dtype per call);
// gamma and beta are [h] in f32 or bf16; mu and rstd are [n] f32; dg and db
// come out f32. Every value is computed in f32 and rounded to the storage
// dtype only where it is stored, as the Pallas bodies do: s is stored
// rounded by #6 and read back rounded by #7, while #8/#9 keep it in f32.
// The variance is the two-pass mean((s - mu)^2), as the reference.
//
// What the TPU tiling needed and this drops: the [n, 128] lane-replicated
// row statistics (_STAT_LANES) are [n] here, and the block-row picker is
// gone: any row count runs (no jnp fallback for rows that do not tile).
//
// What bounds it on the H100: bytes. Per element the forward reads x, r and
// writes y (and s), the backward reads dy, s (or x and r), ds and writes dx,
// for ~10 FLOPs: far below the card's balance point, so the floor is those
// bytes at 3.35 TB/s. What the design does about it: one warp owns one row
// at a time and keeps it in registers (VPT values a lane, columns lane +
// 32 j, so each load instruction of a warp is one coalesced run), so every
// element is read once and written once; the row sums are warp shuffles.
//
// dg/db across rows: the TPU kernel adds them up over its sequential grid.
// Here blocks run in parallel, so each lane keeps f32 partial sums for its
// own columns over the rows its warp visits, the warps of a block add theirs
// into shared memory in warp order, each block writes one partial row
// [blocks, h], and a second kernel (part of the same launch) sums the
// partial rows in a fixed order. No float atomics: a seeded run repeats bit
// for bit. The grid size is the caller's and depends on n only.
//
// Later work (not here): 16-byte vector loads, several rows a warp, TMA.

#include <cuda_bf16.h>
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

// gamma / beta in f32 or bf16 (a uniform branch)
__device__ __forceinline__ float load_w(const void* p, int c, bool bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[c])
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
              bool w_bf16, T* __restrict__ y, T* __restrict__ s_out,
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
        y[base + c] = from_f<T>(xhat * load_w(gamma, c, w_bf16) +
                                load_w(beta, c, w_bf16));
        if constexpr (kSum) s_out[base + c] = from_f<T>(s[j]);
      }
    }
    if (lane == 0) {
      mu_out[row] = mu;
      rstd_out[row] = rstd;
    }
  }
}

// kSum: #7 (a = the saved s, ds added) or #9 (s = a + b recomputed, no ds).
// Writes dx and one [h] row of dg and db partials per block.
template <typename T, int VPT, bool kSum>
__global__ void __launch_bounds__(kThreads)
ln_bwd_kernel(const T* __restrict__ dy, const T* __restrict__ ds,
              const T* __restrict__ a, const T* __restrict__ b,
              const float* __restrict__ mu, const float* __restrict__ rstd,
              const void* __restrict__ gamma, bool w_bf16,
              T* __restrict__ dx, float* __restrict__ part_g,
              float* __restrict__ part_b, long long n, int h) {
  extern __shared__ float red[];  // [2, h]: the block's dg and db
  const int lane = threadIdx.x & 31;
  const int wib = threadIdx.x >> 5;
  const long long nwarps = (long long)gridDim.x * kWarps;
  float acc_g[VPT], acc_b[VPT];
#pragma unroll
  for (int j = 0; j < VPT; ++j) acc_g[j] = acc_b[j] = 0.f;

  for (long long row = (long long)blockIdx.x * kWarps + wib; row < n;
       row += nwarps) {
    const long long base = row * h;
    const float m = mu[row], rs = rstd[row];
    float xhat[VPT], dxh[VPT];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
      const int c = lane + 32 * j;
      if (c < h) {
        const float sv = kSum ? to_f(a[base + c])
                              : to_f(a[base + c]) + to_f(b[base + c]);
        const float d = to_f(dy[base + c]);
        xhat[j] = (sv - m) * rs;
        dxh[j] = d * load_w(gamma, c, w_bf16);
        acc_g[j] += d * xhat[j];
        acc_b[j] += d;
      } else {
        xhat[j] = dxh[j] = 0.f;
      }
      s1 += dxh[j];
      s2 += dxh[j] * xhat[j];
    }
    const float m1 = warp_sum(s1) / h;
    const float m2 = warp_sum(s2) / h;
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
      const int c = lane + 32 * j;
      if (c < h) {
        float v = rs * (dxh[j] - m1 - xhat[j] * m2);
        if constexpr (kSum) v += to_f(ds[base + c]);
        dx[base + c] = from_f<T>(v);
      }
    }
  }

  // the block's partials: warps add theirs in warp order
  for (int w = 0; w < kWarps; ++w) {
    if (wib == w) {
#pragma unroll
      for (int j = 0; j < VPT; ++j) {
        const int c = lane + 32 * j;
        if (c < h) {
          red[c] = w ? red[c] + acc_g[j] : acc_g[j];
          red[h + c] = w ? red[h + c] + acc_b[j] : acc_b[j];
        }
      }
    }
    __syncthreads();
  }
  const long long prow = (long long)blockIdx.x * h;
  for (int c = threadIdx.x; c < h; c += kThreads) {
    part_g[prow + c] = red[c];
    part_b[prow + c] = red[h + c];
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
               const void* beta, bool w_bf16, void* y, void* s, float* mu,
               float* rstd, long long n, int h, float eps,
               cudaStream_t stream) {
  const int vpt = pick_vpt(h);
  const long long want = (n + kWarps - 1) / kWarps;
  const int grid = (int)(want < (1LL << 30) ? want : (1LL << 30));
#define FLN_FWD(V)                                                          \
  ln_fwd_kernel<T, V, kSum><<<grid, kThreads, 0, stream>>>(                 \
      static_cast<const T*>(x), static_cast<const T*>(r), gamma, beta,      \
      w_bf16, static_cast<T*>(y), static_cast<T*>(s), mu, rstd, n, h, eps)
  FLN_DISPATCH(vpt, FLN_FWD)
#undef FLN_FWD
  return (int)cudaGetLastError();
}

template <typename T, bool kSum>
int launch_bwd(const void* dy, const void* ds, const void* a, const void* b,
               const float* mu, const float* rstd, const void* gamma,
               bool w_bf16, void* dx, float* part_g, float* part_b,
               float* dg, float* db, long long n, int h, int blocks,
               cudaStream_t stream) {
  const int vpt = pick_vpt(h);
  const size_t smem = 2 * (size_t)h * sizeof(float);
#define FLN_BWD(V)                                                          \
  ln_bwd_kernel<T, V, kSum><<<blocks, kThreads, smem, stream>>>(            \
      static_cast<const T*>(dy), static_cast<const T*>(ds),                 \
      static_cast<const T*>(a), static_cast<const T*>(b), mu, rstd, gamma,  \
      w_bf16, static_cast<T*>(dx), part_g, part_b, n, h)
  FLN_DISPATCH(vpt, FLN_BWD)
#undef FLN_BWD
  int err = (int)cudaGetLastError();
  if (err) return err;
  colsum_kernel<<<(h + kColX - 1) / kColX, dim3(kColX, kColY), 0, stream>>>(
      part_g, part_b, blocks, h, dg, db);
  return (int)cudaGetLastError();
}

}  // namespace

// Forward, #6 (s != NULL: s is written) or #8 (s == NULL). x, r, y, s: n x h
// contiguous values of one dtype (is_bf16), gamma/beta: h values (w_bf16),
// mu/rstd: n floats. Launches on `stream` and returns cudaGetLastError().
extern "C" int fused_ln_fwd(const void* x, const void* r, const void* gamma,
                            const void* beta, void* y, void* s, float* mu,
                            float* rstd, long long n, int h, float eps,
                            int is_bf16, int w_bf16, void* stream) {
  if (n <= 0 || h <= 0 || !pick_vpt(h)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool wb = w_bf16 != 0;
  if (is_bf16)
    return s ? launch_fwd<__nv_bfloat16, true>(x, r, gamma, beta, wb, y, s,
                                               mu, rstd, n, h, eps, st)
             : launch_fwd<__nv_bfloat16, false>(x, r, gamma, beta, wb, y,
                                                nullptr, mu, rstd, n, h, eps,
                                                st);
  return s ? launch_fwd<float, true>(x, r, gamma, beta, wb, y, s, mu, rstd, n,
                                     h, eps, st)
           : launch_fwd<float, false>(x, r, gamma, beta, wb, y, nullptr, mu,
                                      rstd, n, h, eps, st);
}

// Backward, #7 (ds != NULL: a is the saved s, b unused) or #9 (ds == NULL:
// a = x, b = r). dy, ds, a, b, dx: n x h of one dtype; mu/rstd: n floats;
// gamma: h values (w_bf16); part_g/part_b: blocks x h float scratch;
// dg/db: h floats. `blocks` is the grid of the row kernel (the caller's
// choice, a function of n alone, so a run repeats bit for bit). Two
// kernels on `stream`; returns cudaGetLastError().
extern "C" int fused_ln_bwd(const void* dy, const void* ds, const void* a,
                            const void* b, const float* mu, const float* rstd,
                            const void* gamma, void* dx, float* part_g,
                            float* part_b, float* dg, float* db, long long n,
                            int h, int blocks, int is_bf16, int w_bf16,
                            void* stream) {
  if (n <= 0 || h <= 0 || blocks <= 0 || !pick_vpt(h) || (!ds && !b))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool wb = w_bf16 != 0;
  if (is_bf16)
    return ds ? launch_bwd<__nv_bfloat16, true>(dy, ds, a, b, mu, rstd, gamma,
                                                wb, dx, part_g, part_b, dg,
                                                db, n, h, blocks, st)
              : launch_bwd<__nv_bfloat16, false>(dy, ds, a, b, mu, rstd,
                                                 gamma, wb, dx, part_g,
                                                 part_b, dg, db, n, h,
                                                 blocks, st);
  return ds ? launch_bwd<float, true>(dy, ds, a, b, mu, rstd, gamma, wb, dx,
                                      part_g, part_b, dg, db, n, h, blocks,
                                      st)
            : launch_bwd<float, false>(dy, ds, a, b, mu, rstd, gamma, wb, dx,
                                       part_g, part_b, dg, db, n, h, blocks,
                                       st);
}
