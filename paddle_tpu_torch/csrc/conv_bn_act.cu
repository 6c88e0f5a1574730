// Fused 1x1 convolution + BatchNorm + ReLU (+ residual) for Hopper (sm_90a),
// CUDA C++ with a plain C entry.
//
// Replaces the Pallas TPU kernel paddle_tpu/ops/pallas/conv_bn_act.py
// (_fwd_call, :101, over _fwd_kernel / _fwd_kernel_res). Same function: in
// NHWC a 1x1 convolution is the product of x [M, Cin] (M = N*H*W rows) with
// w [Cin, Cout], and
//     y = relu((x @ w) * scale + shift [+ res])
// with the BatchNorm folded per output channel into f32 scale and shift,
// res an optional [M, Cout] residual added before the ReLU, the product
// summed in f32 and y stored once in x's dtype. The [M, Cout] product never
// reaches device memory: the epilogue runs on the accumulators in
// registers. The TPU kernel's tiling rules (Cin and Cout multiples of 128,
// a weight that fits 4 MiB of VMEM, a block of rows that divides M) exist
// for Mosaic and are gone: the kernel masks its own ragged M, Cin and Cout.
//
// What bounds it on the H100: bytes, at ten of the twelve shapes one
// ResNet-50 forward gives it in bf16 (M from 12544 to 802816, Cin and Cout
// from 64 to 2048): x, w, res and y move once each and the product does at
// most ~100 FLOPs a byte, below the card's ~295; the two Cout = 512 shapes
// from Cin >= 1024 are bound by the tensor cores. What the design does:
//   - one block of 8 warps per output tile of 128 rows x 128 columns (64
//     when Cout <= 64), so each x row is read once per column tile and the
//     weight tile, shared by all 128 rows, comes from L2;
//   - bf16: a loop over Cin in chunks of 32 staged through shared memory,
//     two stages, 16-byte cp.async copies (with zero fill past the edge)
//     where Cin or Cout is a multiple of 8 and scalar loads otherwise;
//     ldmatrix and tensor-core mma.sync m16n8k16 with f32 accumulators,
//     each warp a 64 x 32 (or 32 x 32) sub-tile; rows padded by 16 bytes so
//     the ldmatrix reads are free of bank conflicts;
//   - f32: the same block tile, CUDA-core FMAs in full f32 (no TF32), 8 x 4
//     outputs a thread, Cin in chunks of 16 prefetched into registers;
//   - the epilogue: scale and shift in f32, the residual read once, ReLU,
//     one store in x's dtype. Where Cout is a multiple of 8 (every
//     ResNet shape) the bf16 path stages acc * scale + shift in f32
//     through shared memory, 64 rows at a time, and each thread then
//     finishes 8 consecutive columns of a row with one 16-byte residual
//     read and one 16-byte store, so a warp writes whole 128-byte lines;
//     the residual tile itself is copied into shared memory (cp.async)
//     at the start, while the product is computed. On the H100 these two
//     took the 32 launches of a ResNet-50 forward from 8.86 ms (4-byte
//     stores and residual reads in fragment order, after the loop) to
//     5.99 ms against a 3.07 ms bound (chip_smoke.py, phase 19); a
//     deeper cp.async pipeline and 64-column tiles everywhere did not
//     help. Other shapes store fragment by fragment (two bf16 values at
//     a time where Cout is even).
// Not yet done: wgmma with TMA (a warp-specialised, persistent redesign in
// which one tile's epilogue overlaps the next tile's loads).

#include "tensor_core.cuh"

namespace {

using tc::cp_async16;
using tc::cp_async_commit;
using tc::cp_async_wait;
using tc::ldsm_x4;
using tc::ldsm_x4_t;
using tc::mma_bf16;

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;  // 8 warps
constexpr int kBM = 128;       // rows of a block tile
constexpr int kBK = 32;        // bf16: Cin a stage
constexpr int kPad = 8;        // bf16 of padding a shared row (16 bytes)
constexpr int kHalf = 64;      // rows a staged epilogue pass takes

// ReLU as the reference's jnp.where(y > 0, y, 0): NaN gives 0
__device__ __forceinline__ float act(float v, int relu) {
  return (relu && !(v > 0.f)) ? 0.f : v;
}

__device__ __forceinline__ float epilogue(float acc, float s, float b,
                                          float r, int relu) {
  return act(acc * s + b + r, relu);
}

// the per-launch shape and flags
struct Shape {
  long long m;  // rows
  int k;        // Cin
  int n;        // Cout
  int n_tiles;  // column tiles
  int relu;
  int vec_a;  // x rows 16-byte copyable: Cin % 8 == 0, x 16-byte aligned
  int vec_b;  // w rows 16-byte copyable: Cout % 8 == 0, w 16-byte aligned
  int pair;   // two outputs at a time: Cout even, y and res 4-byte aligned
  int stage;  // staged epilogue: Cout % 8 == 0, y and res 16-byte aligned
};

// -- bf16: tensor cores -----------------------------------------------------

// dynamic shared memory of a block: the two stages, then (with a residual
// and the staged epilogue) the residual tile [kBM][BN + kPad]; after the
// loop the stages hold the staged f32 rows [kHalf][BN + 4]
template <int BN>
struct Bf16Smem {
  bf16 a[2][kBM][kBK + kPad];
  bf16 b[2][kBK][BN + kPad];
};

template <int BN>
constexpr int res_tile_bytes() {
  return kBM * (BN + kPad) * (int)sizeof(bf16);
}

template <int BN>
__device__ __forceinline__ void load_tile_bf16(Bf16Smem<BN>& sm, int buf,
                                               const bf16* __restrict__ x,
                                               const bf16* __restrict__ w,
                                               long long m0, int n0, int k0,
                                               const Shape& sh, int tid) {
  // x rows m0..m0+127, columns k0..k0+31 -> a[buf]
  if (sh.vec_a) {
#pragma unroll
    for (int i = 0; i < (kBM * kBK / 8) / kThreads; ++i) {
      const int c = tid + i * kThreads;
      const int row = c / (kBK / 8), kc = (c % (kBK / 8)) * 8;
      const long long gm = m0 + row;
      const int gk = k0 + kc;
      const bool ok = gm < sh.m && gk < sh.k;
      cp_async16(&sm.a[buf][row][kc], ok ? x + gm * sh.k + gk : x, ok);
    }
  } else {
#pragma unroll 4
    for (int i = 0; i < (kBM * kBK) / kThreads; ++i) {
      const int e = tid + i * kThreads;
      const int row = e / kBK, kk = e % kBK;
      const long long gm = m0 + row;
      const int gk = k0 + kk;
      sm.a[buf][row][kk] = (gm < sh.m && gk < sh.k)
                               ? x[gm * sh.k + gk]
                               : __float2bfloat16(0.f);
    }
  }
  // w rows k0..k0+31, columns n0..n0+BN-1 -> b[buf]
  if (sh.vec_b) {
#pragma unroll
    for (int i = 0; i < (kBK * BN / 8) / kThreads; ++i) {
      const int c = tid + i * kThreads;
      const int kr = c / (BN / 8), nc = (c % (BN / 8)) * 8;
      const int gk = k0 + kr, gn = n0 + nc;
      const bool ok = gk < sh.k && gn < sh.n;
      cp_async16(&sm.b[buf][kr][nc],
                 ok ? w + (long long)gk * sh.n + gn : w, ok);
    }
  } else {
#pragma unroll 4
    for (int i = 0; i < (kBK * BN) / kThreads; ++i) {
      const int e = tid + i * kThreads;
      const int kr = e / BN, nn = e % BN;
      const int gk = k0 + kr, gn = n0 + nn;
      sm.b[buf][kr][nn] = (gk < sh.k && gn < sh.n)
                              ? w[(long long)gk * sh.n + gn]
                              : __float2bfloat16(0.f);
    }
  }
}

// WARPS_M x WARPS_N warps over a kBM x BN tile
template <int BN, int WARPS_M, int WARPS_N>
__global__ void __launch_bounds__(kThreads)
conv_bn_act_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                        const float* __restrict__ scale,
                        const float* __restrict__ shift,
                        const bf16* __restrict__ res, bf16* __restrict__ y,
                        Shape sh) {
  static_assert(WARPS_M * WARPS_N * 32 == kThreads, "8 warps");
  constexpr int WM = kBM / WARPS_M;  // rows a warp
  constexpr int WN = BN / WARPS_N;   // columns a warp
  constexpr int MI = WM / 16, NI = WN / 8;
  static_assert(NI % 2 == 0, "B fragments load two n-tiles at a time");
  static_assert(WM <= kHalf && kHalf % WM == 0, "a warp's rows in one half");
  static_assert(kHalf * (BN + 4) * sizeof(float) <= sizeof(Bf16Smem<BN>),
                "the staged rows fit in the stages");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Bf16Smem<BN>& sm = *reinterpret_cast<Bf16Smem<BN>*>(smem_raw);
  bf16* rs = reinterpret_cast<bf16*>(smem_raw + sizeof(Bf16Smem<BN>));
  constexpr int RLD = BN + kPad;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const long long tile = blockIdx.x;
  const int n0 = (int)(tile % sh.n_tiles) * BN;
  const long long m0 = (tile / sh.n_tiles) * kBM;

  float acc[MI][NI][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int t = 0; t < 4; ++t) acc[i][j][t] = 0.f;

  // the residual tile's copies go first, as their own commit group: they
  // land while the product is computed
  const bool res_smem = res != nullptr && sh.stage;
  if (res_smem) {
#pragma unroll
    for (int i = 0; i < (kBM * BN / 8) / kThreads; ++i) {
      const int c = tid + i * kThreads;
      const int row = c / (BN / 8), cc = (c % (BN / 8)) * 8;
      const long long gm = m0 + row;
      const int gn = n0 + cc;
      const bool ok = gm < sh.m && gn < sh.n;
      cp_async16(rs + row * RLD + cc, ok ? res + gm * sh.n + gn : res, ok);
    }
  }
  cp_async_commit();

  const int kt_n = (sh.k + kBK - 1) / kBK;
  load_tile_bf16<BN>(sm, 0, x, w, m0, n0, 0, sh, tid);
  cp_async_commit();
  for (int kt = 0; kt < kt_n; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < kt_n) {
      load_tile_bf16<BN>(sm, buf ^ 1, x, w, m0, n0, (kt + 1) * kBK, sh, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < kBK / 16; ++ks) {
      uint32_t a[MI][4];
      uint32_t b[NI][2];
#pragma unroll
      for (int i = 0; i < MI; ++i)
        ldsm_x4(a[i], &sm.a[buf][wm * WM + i * 16 + (lane % 16)]
                          [ks * 16 + (lane / 16) * 8]);
#pragma unroll
      for (int j = 0; j < NI / 2; ++j) {
        uint32_t r[4];
        ldsm_x4_t(r, &sm.b[buf][ks * 16 + (lane % 8) + ((lane / 8) % 2) * 8]
                         [wn * WN + j * 16 + (lane / 16) * 8]);
        b[2 * j][0] = r[0];
        b[2 * j][1] = r[1];
        b[2 * j + 1][0] = r[2];
        b[2 * j + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NI; ++j) mma_bf16(acc[i][j], a[i], b[j]);
    }
    __syncthreads();
  }

  // thread (lane) holds rows lane/4 and lane/4 + 8 of each 16-row tile,
  // columns 2 * (lane % 4) and +1 of each 8-column tile
  if (sh.stage) {
    // staged epilogue: v = acc * scale + shift in f32 through shared
    // memory, kHalf rows at a time (the loop's last barrier freed the
    // stages); then each thread finishes 8 consecutive columns of a row
    constexpr int LD = BN + 4;
    constexpr int TPR = BN / 8, RPP = kThreads / TPR;
    float* ot = reinterpret_cast<float*>(&sm);
    for (int half = 0; half < kBM / kHalf; ++half) {
      if ((wm * WM) / kHalf == half) {
#pragma unroll
        for (int j = 0; j < NI; ++j) {
          const int cl = wn * WN + j * 8 + (lane % 4) * 2;
          const int col = n0 + cl;
          const bool in = col < sh.n;  // Cout % 8 == 0: col + 1 too
          const float s0 = in ? scale[col] : 0.f;
          const float b0 = in ? shift[col] : 0.f;
          const float s1 = in ? scale[col + 1] : 0.f;
          const float b1 = in ? shift[col + 1] : 0.f;
#pragma unroll
          for (int i = 0; i < MI; ++i)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int rl = wm * WM + i * 16 + lane / 4 + h * 8 - half * kHalf;
              *reinterpret_cast<float2*>(&ot[rl * LD + cl]) =
                  make_float2(acc[i][j][2 * h] * s0 + b0,
                              acc[i][j][2 * h + 1] * s1 + b1);
            }
        }
      }
      __syncthreads();
      for (int r = tid / TPR; r < kHalf; r += RPP) {
        const int cl = (tid % TPR) * 8;
        const int rt = half * kHalf + r;  // row in the tile
        const long long row = m0 + rt;
        const int col = n0 + cl;
        if (row >= sh.m || col >= sh.n) continue;
        const float4 v0 = *reinterpret_cast<const float4*>(&ot[r * LD + cl]);
        const float4 v1 =
            *reinterpret_cast<const float4*>(&ot[r * LD + cl + 4]);
        float v[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
        const long long off = row * sh.n + col;
        if (res_smem) {
          const uint4 rr =
              *reinterpret_cast<const uint4*>(rs + rt * RLD + cl);
          const __nv_bfloat162* rp =
              reinterpret_cast<const __nv_bfloat162*>(&rr);
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            const float2 f = __bfloat1622float2(rp[t]);
            v[2 * t] += f.x;
            v[2 * t + 1] += f.y;
          }
        }
        uint4 out;
        __nv_bfloat162* op = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
        for (int t = 0; t < 4; ++t)
          op[t] = __floats2bfloat162_rn(act(v[2 * t], sh.relu),
                                        act(v[2 * t + 1], sh.relu));
        *reinterpret_cast<uint4*>(y + off) = out;
      }
      __syncthreads();
    }
    return;
  }

  // direct epilogue, fragment by fragment
#pragma unroll
  for (int j = 0; j < NI; ++j) {
    const int col = n0 + wn * WN + j * 8 + (lane % 4) * 2;
    if (col >= sh.n) continue;
    const bool two = col + 1 < sh.n;
    const float s0 = scale[col], b0 = shift[col];
    const float s1 = two ? scale[col + 1] : 0.f;
    const float b1 = two ? shift[col + 1] : 0.f;
#pragma unroll
    for (int i = 0; i < MI; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long row = m0 + wm * WM + i * 16 + lane / 4 + h * 8;
        if (row >= sh.m) continue;
        const long long off = row * sh.n + col;
        if (sh.pair) {  // Cout even: col + 1 < Cout, 4-byte aligned pair
          float2 r = make_float2(0.f, 0.f);
          if (res != nullptr)
            r = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(res + off));
          *reinterpret_cast<__nv_bfloat162*>(y + off) = __floats2bfloat162_rn(
              epilogue(acc[i][j][2 * h], s0, b0, r.x, sh.relu),
              epilogue(acc[i][j][2 * h + 1], s1, b1, r.y, sh.relu));
        } else {
          const float r0 = res ? __bfloat162float(res[off]) : 0.f;
          y[off] = __float2bfloat16(
              epilogue(acc[i][j][2 * h], s0, b0, r0, sh.relu));
          if (two) {
            const float r1 = res ? __bfloat162float(res[off + 1]) : 0.f;
            y[off + 1] = __float2bfloat16(
                epilogue(acc[i][j][2 * h + 1], s1, b1, r1, sh.relu));
          }
        }
      }
    }
  }
}

// -- f32: CUDA cores ----------------------------------------------------------

constexpr int kBN32 = 64;  // columns of an f32 block tile
constexpr int kBK32 = 16;  // Cin a step
constexpr int kA32 = kBM * kBK32 / kThreads;    // x values a thread loads
constexpr int kB32 = kBK32 * kBN32 / kThreads;  // w values a thread loads

// 16 x 16 threads; thread (tx, ty) owns rows ty*8..+7, columns tx*4..+3
__global__ void __launch_bounds__(kThreads)
conv_bn_act_f32_kernel(const float* __restrict__ x,
                       const float* __restrict__ w,
                       const float* __restrict__ scale,
                       const float* __restrict__ shift,
                       const float* __restrict__ res, float* __restrict__ y,
                       Shape sh) {
  __shared__ __align__(16) float sa[kBK32][kBM + 4];    // [k][m]
  __shared__ __align__(16) float sb[kBK32][kBN32 + 4];  // [k][n]
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const long long tile = blockIdx.x;
  const int n0 = (int)(tile % sh.n_tiles) * kBN32;
  const long long m0 = (tile / sh.n_tiles) * kBM;

  float ra[kA32], rb[kB32];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int i = 0; i < kA32; ++i) {
      const int e = tid + i * kThreads;
      const long long gm = m0 + e / kBK32;
      const int gk = k0 + e % kBK32;
      ra[i] = (gm < sh.m && gk < sh.k) ? x[gm * sh.k + gk] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kB32; ++i) {
      const int e = tid + i * kThreads;
      const int gk = k0 + e / kBN32, gn = n0 + e % kBN32;
      rb[i] = (gk < sh.k && gn < sh.n) ? w[(long long)gk * sh.n + gn] : 0.f;
    }
  };

  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  const int kt_n = (sh.k + kBK32 - 1) / kBK32;
  fetch(0);
  for (int kt = 0; kt < kt_n; ++kt) {
#pragma unroll
    for (int i = 0; i < kA32; ++i) {
      const int e = tid + i * kThreads;
      sa[e % kBK32][e / kBK32] = ra[i];
    }
#pragma unroll
    for (int i = 0; i < kB32; ++i) {
      const int e = tid + i * kThreads;
      sb[e / kBN32][e % kBN32] = rb[i];
    }
    __syncthreads();
    if (kt + 1 < kt_n) fetch((kt + 1) * kBK32);
#pragma unroll
    for (int kk = 0; kk < kBK32; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&sa[kk][ty * 8]);
      const float4 a1 = *reinterpret_cast<const float4*>(&sa[kk][ty * 8 + 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&sb[kk][tx * 4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bw[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bw[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int col = n0 + tx * 4 + j;
    if (col >= sh.n) continue;
    const float s = scale[col], b = shift[col];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const long long row = m0 + ty * 8 + i;
      if (row >= sh.m) continue;
      const long long off = row * sh.n + col;
      y[off] = epilogue(acc[i][j], s, b, res ? res[off] : 0.f, sh.relu);
    }
  }
}

bool aligned(const void* p, uintptr_t a) {
  return (reinterpret_cast<uintptr_t>(p) & (a - 1)) == 0;
}

// with the residual tile a block takes more than the 48 KB of static shared
// memory: opt in to its dynamic size first
template <int BN, int WARPS_M, int WARPS_N>
void launch_bf16(const bf16* x, const bf16* w, const float* scale,
                 const float* shift, const bf16* res, bf16* y, Shape sh,
                 long long m_tiles, cudaStream_t st) {
  auto kernel = conv_bn_act_bf16_kernel<BN, WARPS_M, WARPS_N>;
  const int bytes = (int)sizeof(Bf16Smem<BN>) +
                    (res != nullptr && sh.stage ? res_tile_bytes<BN>() : 0);
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           bytes) != cudaSuccess)
    return;  // the caller reads the error from cudaGetLastError()
  kernel<<<(unsigned)(m_tiles * sh.n_tiles), kThreads, bytes, st>>>(
      x, w, scale, shift, res, y, sh);
}

}  // namespace

// x [m, k] and w [k, n] row-major (contiguous) in bf16 (is_bf16) or f32;
// scale, shift [n] f32; res [m, n] in x's dtype or null; y [m, n] in x's
// dtype, written. Launches on `stream` and returns cudaGetLastError() (0 on
// success).
extern "C" int conv_bn_act(const void* x, const void* w, const float* scale,
                           const float* shift, const void* res, void* y,
                           long long m, int k, int n, int is_bf16, int relu,
                           void* stream) {
  if (m <= 0 || k <= 0 || n <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Shape sh{m, k, n, 0, relu, 0, 0, 0, 0};
  const long long m_tiles = (m + kBM - 1) / kBM;
  if (!is_bf16) {
    sh.n_tiles = (n + kBN32 - 1) / kBN32;
    conv_bn_act_f32_kernel<<<(unsigned)(m_tiles * sh.n_tiles), kThreads, 0,
                             st>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), scale,
        shift, static_cast<const float*>(res), static_cast<float*>(y), sh);
    return (int)cudaGetLastError();
  }
  sh.vec_a = k % 8 == 0 && aligned(x, 16);
  sh.vec_b = n % 8 == 0 && aligned(w, 16);
  sh.pair = n % 2 == 0 && aligned(y, 4) && (res == nullptr || aligned(res, 4));
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* wb = static_cast<const bf16*>(w);
  const bf16* rb = static_cast<const bf16*>(res);
  bf16* yb = static_cast<bf16*>(y);
  sh.stage =
      n % 8 == 0 && aligned(y, 16) && (res == nullptr || aligned(res, 16));
  if (n <= 64) {
    sh.n_tiles = (n + 63) / 64;
    launch_bf16<64, 4, 2>(xb, wb, scale, shift, rb, yb, sh, m_tiles, st);
  } else {
    sh.n_tiles = (n + 127) / 128;
    launch_bf16<128, 2, 4>(xb, wb, scale, shift, rb, yb, sh, m_tiles, st);
  }
  return (int)cudaGetLastError();
}
