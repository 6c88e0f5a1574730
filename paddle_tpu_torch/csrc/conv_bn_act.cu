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
// What bounds it on the H100, at the twelve shapes one ResNet-50 forward
// gives it (batch 256, 224 px: M from 12544 to 802816, Cin and Cout from
// 64 to 2048; chip_smoke.py's SERVE_SHAPES):
//   - bf16: bytes at ten shapes: x, w, res and y move once each and the
//     product does at most ~100 FLOPs a byte, below the card's ~295; the
//     two Cout = 512 shapes from Cin >= 1024 are bound by the tensor
//     cores. The 32 launches' bound is 3.07 ms.
//   - f32, at the f32 bar: on the tensor cores in 3xTF32 (three TF32
//     products a product, at the 495 TFLOP/s TF32 peak) bytes bound the
//     five shapes at M = 802816 and 200704 x 128 -> 512 (14-43 FLOPs a
//     byte), the other seven are bound by the products; the 32 launches'
//     bound is 7.5325 ms. On the CUDA cores (67 TFLOP/s) only the three
//     shapes with Cin = 64 would be bound by bytes, and the bound is
//     13.9509 ms.
// What the design does:
//   - one block of 8 warps per output tile of 128 rows x 128 columns (64
//     when Cout <= 64), so each x row is read once per column tile and the
//     weight tile, shared by all 128 rows, comes from L2;
//   - bf16 and f16 (conv_bn_act_tc16_kernel<T, ...>: one kernel, the
//     element type a template parameter; f16 for float16 AMP training
//     under a GradScaler, with bf16's bytes and tensor-core peak, so its
//     bound): a loop over Cin in chunks of 32 staged through shared memory,
//     two stages, 16-byte cp.async copies (with zero fill past the edge)
//     where Cin or Cout is a multiple of 8 and scalar loads otherwise;
//     ldmatrix and tensor-core mma.sync m16n8k16 (bf16 or f16) with f32
//     accumulators, each warp a 64 x 32 (or 32 x 32) sub-tile; rows padded
//     by 16 bytes so the ldmatrix reads are free of bank conflicts;
//   - f32: the tile computed transposed, y^T = w^T . x^T, so that x is the
//     K-major shared-memory operand a tf32 wgmma takes (it reads no
//     MN-major tf32 operand, and x's rows hold Cin) and w^T comes from
//     registers; two warpgroups, each 64 channels x 128 rows (x 64 rows,
//     one above the other, when Cout <= 64), wgmma m64nNk8 tf32. Each f32
//     operand is split as tc::split_tf32 splits it, hi = tf32(v), lo =
//     tf32(v - hi), and a step of 8 input channels takes lo(w).hi(x) +
//     hi(w).lo(x) + hi(w).hi(x), the dropped lo.lo being ~2^-22 of a
//     product: x's tile is split in place in shared memory (hi over x, lo
//     into a tile of its own), w's fragments in registers. Cin runs in
//     stages of 32 through three cp.async stages (16-byte copies where Cin
//     or Cout % 4 == 0 and the pointer is 16-byte aligned, 4-byte ones
//     otherwise, zero past every edge); while a stage's products run, the
//     stage two ahead starts loading into the buffers the last products
//     read and the next stage is split (its lo into the other of two lo
//     tiles). A stage's 12 products are summed apart and added to the
//     running sum in f32 once they are waited on: summed in one tensor-
//     core accumulator over all of Cin they lost low bits, 5.1e-5 of
//     max(1, |y|) from a float64 product at Cin = 2048. The residual tile
//     is copied into the output tile at the start, while the product runs;
//   - the epilogue: scale and shift in f32, the residual read once, ReLU
//     (NaN gives 0, as jnp.where), one store in x's dtype (rounded to
//     nearest even; in f16 a value past 65504 is stored as inf, never
//     saturated, as the reference's astype). Where Cout is a
//     multiple of 8 (4 in f32; every ResNet shape) acc * scale + shift is
//     staged in f32 through shared memory (bf16: 64 rows at a time) and
//     each thread then finishes 8 (f32: 4) consecutive columns of a row
//     with one 16-byte residual read and one 16-byte store, so a warp
//     writes whole 128-byte lines; the bf16 residual tile is copied into
//     shared memory (cp.async) at the start too. On the H100 the staged
//     epilogue and the residual copy took the bf16 path's 32 launches from
//     8.86 ms to 5.99 ms against its 3.07 ms bound (chip_smoke.py, phase
//     19); a deeper bf16 cp.async pipeline and 64-column tiles everywhere
//     did not help. Other shapes store fragment by fragment (bf16) or
//     value by value (f32).
// ptxas (sm_90a, CUDA 12.8): conv_bn_act_tf32_kernel<128> 244 registers,
// <64> 167, no spills; the bf16 kernels 127 and 74.
// Held on the H100 ("NVIDIA H100 80GB HBM3", 700 W; chip_smoke.py
// --compare-conv against the CUDA-core f32 kernel this one replaced, in
// turns): the f32 path's 32 launches of a forward 16.5085 ms, 0.456 of
// the 3xTF32 bound's 7.5325 (the replaced kernel 43.5596 ms; cuBLAS's f32
// GEMM alone, which computes less, 20.4465 ms); every shape 1.76-2.89x
// faster than the replaced kernel; the bf16 path unmoved (5.9787 ms
// against 5.9734). From a float64 product, of max(1, |y|): 1.2e-6 to
// 2.2e-6 at the twelve shapes (cuBLAS's f32 GEMM 1.3e-6 to 5.8e-6).
// Keeping one stage's products in flight while the next stage's
// fragments were read into a second register set ran 1.047x faster but
// summed over all of Cin in the tensor cores, and lacked the registers for
// the per-stage sums. Where it stops (reckoned, not measured: no profiler
// of the SM's pipes runs there): the tensor cores read every wgmma's B
// operand from shared memory, 64 bytes a clock at the TF32 peak, half of
// what shared memory gives, and the split, the copies in and the
// fragments share the rest; a warp-specialised version (a producer
// warpgroup copying and splitting, two consuming through mbarriers) and
// one that fetched through registers instead of cp.async both measured
// slower.
// Not yet done: TMA and a persistent grid (one tile's epilogue
// overlapping the next tile's loads).

#include "tensor_core.cuh"

namespace {

using tc::cp_async16;
using tc::cp_async_commit;
using tc::cp_async_wait;
using tc::ldsm_x4;
using tc::ldsm_x4_t;

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;  // 8 warps
constexpr int kBM = 128;       // rows of a block tile
constexpr int kBK = 32;        // bf16/f16: Cin a stage
constexpr int kPad = 8;        // 16-bit values of padding a shared row
                               // (16 bytes)
constexpr int kHalf = 64;      // rows a staged epilogue pass takes

// dtype codes of the C entry
constexpr int kF32 = 0, kBF16 = 1, kF16 = 2;

// a 16-bit value (bf16 or f16) <-> f32; to T rounds to nearest even, and
// in f16 a value past 65504 becomes inf (no saturation), as the
// reference's astype
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16(v);
}
template <>
__device__ __forceinline__ __half from_f<__half>(float v) {
  return __float2half_rn(v);
}

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
  // Cin and Cout multiples of 8 values (bf16) or 4 (f32): 16 bytes
  int vec_a;  // x rows 16-byte copyable: Cin % 8 (4), x 16-byte aligned
  int vec_b;  // w rows 16-byte copyable: Cout % 8 (4), w 16-byte aligned
  int pair;   // 16-bit, two outputs at a time: Cout even, y and res 4-byte
              // aligned
  int stage;  // 16-byte epilogue: Cout % 8 (4), y and res 16-byte aligned
};

// -- bf16 and f16: tensor cores -----------------------------------------
//
// One kernel for both 16-bit types T (bf16, f16): the same tiles, copies
// and fragments; mma.sync m16n8k16 of T with f32 accumulators; only the
// conversions at the edges differ.

// dynamic shared memory of a block: the two stages, then (with a residual
// and the staged epilogue) the residual tile [kBM][BN + kPad]; after the
// loop the stages hold the staged f32 rows [kHalf][BN + 4]
template <typename T, int BN>
struct Smem16 {
  T a[2][kBM][kBK + kPad];
  T b[2][kBK][BN + kPad];
};

template <int BN>
constexpr int res_tile_bytes() {
  return kBM * (BN + kPad) * 2;
}

template <typename T, int BN>
__device__ __forceinline__ void load_tile16(Smem16<T, BN>& sm, int buf,
                                            const T* __restrict__ x,
                                            const T* __restrict__ w,
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
      sm.a[buf][row][kk] = (gm < sh.m && gk < sh.k) ? x[gm * sh.k + gk]
                                                    : from_f<T>(0.f);
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
                              : from_f<T>(0.f);
    }
  }
}

// WARPS_M x WARPS_N warps over a kBM x BN tile
template <typename T, int BN, int WARPS_M, int WARPS_N>
__global__ void __launch_bounds__(kThreads)
conv_bn_act_tc16_kernel(const T* __restrict__ x, const T* __restrict__ w,
                        const float* __restrict__ scale,
                        const float* __restrict__ shift,
                        const T* __restrict__ res, T* __restrict__ y,
                        Shape sh) {
  static_assert(WARPS_M * WARPS_N * 32 == kThreads, "8 warps");
  constexpr int WM = kBM / WARPS_M;  // rows a warp
  constexpr int WN = BN / WARPS_N;   // columns a warp
  constexpr int MI = WM / 16, NI = WN / 8;
  static_assert(NI % 2 == 0, "B fragments load two n-tiles at a time");
  static_assert(WM <= kHalf && kHalf % WM == 0, "a warp's rows in one half");
  static_assert(kHalf * (BN + 4) * sizeof(float) <= sizeof(Smem16<T, BN>),
                "the staged rows fit in the stages");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem16<T, BN>& sm = *reinterpret_cast<Smem16<T, BN>*>(smem_raw);
  T* rs = reinterpret_cast<T*>(smem_raw + sizeof(Smem16<T, BN>));
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
  load_tile16<T, BN>(sm, 0, x, w, m0, n0, 0, sh, tid);
  cp_async_commit();
  for (int kt = 0; kt < kt_n; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < kt_n) {
      load_tile16<T, BN>(sm, buf ^ 1, x, w, m0, n0, (kt + 1) * kBK, sh,
                         tid);
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
        for (int j = 0; j < NI; ++j) tc::mma16<T>(acc[i][j], a[i], b[j]);
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
          const uint32_t* rp = reinterpret_cast<const uint32_t*>(&rr);
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            const float2 f = tc::unpack2<T>(rp[t]);
            v[2 * t] += f.x;
            v[2 * t + 1] += f.y;
          }
        }
        uint4 out;
        uint32_t* op = reinterpret_cast<uint32_t*>(&out);
#pragma unroll
        for (int t = 0; t < 4; ++t)
          op[t] = tc::pack2<T>(act(v[2 * t], sh.relu),
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
            r = tc::unpack2<T>(*reinterpret_cast<const uint32_t*>(res + off));
          *reinterpret_cast<uint32_t*>(y + off) = tc::pack2<T>(
              epilogue(acc[i][j][2 * h], s0, b0, r.x, sh.relu),
              epilogue(acc[i][j][2 * h + 1], s1, b1, r.y, sh.relu));
        } else {
          const float r0 = res ? to_f(res[off]) : 0.f;
          y[off] = from_f<T>(epilogue(acc[i][j][2 * h], s0, b0, r0, sh.relu));
          if (two) {
            const float r1 = res ? to_f(res[off + 1]) : 0.f;
            y[off + 1] = from_f<T>(
                epilogue(acc[i][j][2 * h + 1], s1, b1, r1, sh.relu));
          }
        }
      }
    }
  }
}

// -- f32: tensor cores in 3xTF32 ---------------------------------------------
//
// The block computes its tile transposed, y^T [BC x kBM] = w^T . x^T: a
// tf32 wgmma reads its shared-memory operand K-major only, and x's tile,
// whose rows hold Cin, is that as it lies in memory; w^T, the A operand,
// comes from registers, read out of w's natural [k][n] tile.

constexpr int kBK32 = 32;                   // Cin a stage: a 128-byte row
constexpr int kStages32 = 3;                // cp.async stages
constexpr int kXTile = kBM * kBK32 * 4;     // bytes of an x tile (16 KB)

// the f32 block tile: BC output channels x kBM rows, two warpgroups, each
// 64 channels x N rows (BC = 128: side by side along Cout, N = 128; BC =
// 64: one above the other along M, N = 64)
template <int BC>
struct F32Tile {
  static constexpr int WGC = BC / 64;       // warpgroups along Cout
  static constexpr int N = kBM * WGC / 2;   // rows of x a warpgroup
  static constexpr int ACC = N / 2;         // accumulators a thread
  static constexpr int LDW = BC + 8;        // floats a w row: banks 8t + g
  static constexpr int LDE = BC + 4;        // floats a staged output row
  static constexpr int W_TILE = kBK32 * LDW * 4;
  // stages of x (hi in place), two lo tiles, stages of w, the output tile
  static constexpr int LO_OFF = kStages32 * kXTile;
  static constexpr int W_OFF = LO_OFF + 2 * kXTile;
  static constexpr int E_OFF = W_OFF + kStages32 * W_TILE;
  static constexpr int SMEM = E_OFF + kBM * LDE * 4 + 1024;  // + alignment
  static_assert(SMEM <= 232448, "shared memory");
};

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return p + ((1024u - (tc::smem_u32(p) & 1023u)) & 1023u);
}

template <int R, int C>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[R][C]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < C; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// x rows m0..m0+127, Cin k0..k0+31 -> a swizzled x tile; w rows k0..k0+31,
// Cout n0..n0+BC-1 -> a w tile; zero past every edge
template <int BC>
__device__ __forceinline__ void load_tile_f32(uint8_t* xt, float* wt,
                                              const float* __restrict__ x,
                                              const float* __restrict__ w,
                                              long long m0, int n0, int k0,
                                              const Shape& sh, int tid) {
  using G = F32Tile<BC>;
#pragma unroll
  for (int i = 0; i < kBM * (kBK32 / 4) / kThreads; ++i) {
    const int c = tid + i * kThreads;
    const int row = c / (kBK32 / 4), ch = c % (kBK32 / 4);
    const long long gm = m0 + row;
    const int gk = k0 + ch * 4;
    uint8_t* dst = xt + tc::sw_offset<kBM>(row, ch);
    if (sh.vec_a) {
      const bool ok = gm < sh.m && gk < sh.k;
      cp_async16(dst, ok ? x + gm * sh.k + gk : x, ok);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = gm < sh.m && gk + e < sh.k;
        tc::cp_async4(dst + 4 * e, ok ? x + gm * sh.k + gk + e : x, ok);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kBK32 * (BC / 4) / kThreads; ++i) {
    const int c = tid + i * kThreads;
    const int kr = c / (BC / 4), nc = (c % (BC / 4)) * 4;
    const int gk = k0 + kr, gn = n0 + nc;
    float* dst = wt + kr * G::LDW + nc;
    if (sh.vec_b) {
      const bool ok = gk < sh.k && gn < sh.n;
      cp_async16(dst, ok ? w + (long long)gk * sh.n + gn : w, ok);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = gk < sh.k && gn + e < sh.n;
        tc::cp_async4(dst + e, ok ? w + (long long)gk * sh.n + gn + e : w,
                      ok);
      }
    }
  }
}

// a landed x tile split in place: hi = tf32(x) where x was, lo = tf32(x -
// hi) into `lo` at the same offset (tc::split_tf32, 16 bytes at a time)
__device__ __forceinline__ void split_tile(uint8_t* xt, uint8_t* lo,
                                           int tid) {
  uint4* h = reinterpret_cast<uint4*>(xt);
  uint4* l = reinterpret_cast<uint4*>(lo);
#pragma unroll
  for (int i = 0; i < kXTile / 16 / kThreads; ++i) {
    const int j = tid + i * kThreads;
    const uint4 v = h[j];
    uint4 hi, lw;
    tc::split_tf32(__uint_as_float(v.x), hi.x, lw.x);
    tc::split_tf32(__uint_as_float(v.y), hi.y, lw.y);
    tc::split_tf32(__uint_as_float(v.z), hi.z, lw.z);
    tc::split_tf32(__uint_as_float(v.w), hi.w, lw.w);
    h[j] = hi;
    l[j] = lw;
  }
}

template <int BC>
__global__ void __launch_bounds__(kThreads, 1)
conv_bn_act_tf32_kernel(const float* __restrict__ x,
                        const float* __restrict__ w,
                        const float* __restrict__ scale,
                        const float* __restrict__ shift,
                        const float* __restrict__ res, float* __restrict__ y,
                        Shape sh) {
  using G = F32Tile<BC>;
  constexpr int NS = kStages32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint8_t* base = align1024(smem_raw);
  uint8_t* xs = base;                                         // [NS] x tiles
  uint8_t* los = base + G::LO_OFF;                            // [2] lo tiles
  float* ws = reinterpret_cast<float*>(base + G::W_OFF);      // [NS] w tiles
  float* es = reinterpret_cast<float*>(base + G::E_OFF);      // [kBM][LDE]

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wg = warp / 4, g = lane / 4, t = lane % 4;
  const int wgc = wg % G::WGC, wgm = wg / G::WGC;
  const long long tile = blockIdx.x;
  const int n0 = (int)(tile % sh.n_tiles) * BC;
  const long long m0 = (tile / sh.n_tiles) * kBM;
  // this thread's output channels (in the tile) and first x row
  const int crow = wgc * 64 + (warp % 4) * 16 + g;
  const int xrow = wgm * G::N;

  // the residual tile, its own commit group first, lands in the output
  // tile while the product is computed
  if (res != nullptr) {
#pragma unroll 4
    for (int i = 0; i < kBM * (BC / 4) / kThreads; ++i) {
      const int c = tid + i * kThreads;
      const int row = c / (BC / 4), cc = (c % (BC / 4)) * 4;
      const long long gm = m0 + row;
      const int gn = n0 + cc;
      float* dst = es + row * G::LDE + cc;
      if (sh.stage) {
        const bool ok = gm < sh.m && gn < sh.n;
        cp_async16(dst, ok ? res + gm * sh.n + gn : res, ok);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool ok = gm < sh.m && gn + e < sh.n;
          tc::cp_async4(dst + e, ok ? res + gm * sh.n + gn + e : res, ok);
        }
      }
    }
  }
  cp_async_commit();

  const int kt_n = (sh.k + kBK32 - 1) / kBK32;
  auto load = [&](int kt) {
    const int b = kt % NS;
    load_tile_f32<BC>(xs + b * kXTile, ws + b * (G::W_TILE / 4), x, w, m0,
                      n0, kt * kBK32, sh, tid);
  };
#pragma unroll
  for (int s = 0; s < NS - 1; ++s) {
    if (s < kt_n) load(s);
    cp_async_commit();
  }
  cp_async_wait<NS - 2>();
  __syncthreads();
  split_tile(xs, los, tid);
  fence_async_smem();
  __syncthreads();

  float acc[G::ACC];
#pragma unroll
  for (int i = 0; i < G::ACC; ++i) acc[i] = 0.f;

  for (int kt = 0; kt < kt_n; ++kt) {
    // stage kt is split (hi in xs, lo in los), its w tile landed
    const int b = kt % NS;
    const float* wt = ws + b * (G::W_TILE / 4);
    uint32_t ah[4][4], al[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float* w0 = wt + (kk * 8 + t) * G::LDW + crow;
      const float* w1 = w0 + 4 * G::LDW;
      tc::split_tf32(w0[0], ah[kk][0], al[kk][0]);
      tc::split_tf32(w0[8], ah[kk][1], al[kk][1]);
      tc::split_tf32(w1[0], ah[kk][2], al[kk][2]);
      tc::split_tf32(w1[8], ah[kk][3], al[kk][3]);
    }
    const uint64_t dh = tc::sw128_desc(xs + b * kXTile + xrow * 128, 0);
    const uint64_t dl =
        tc::sw128_desc(los + (kt & 1) * kXTile + xrow * 128, 0);
    // the stage's 12 products (the two small terms of a step first, as
    // tc::mma_3xtf32 sums them) go into a sum of their own, the first
    // overwriting it, that is added to acc in f32 after the wait: the
    // tensor cores' f32 accumulation drops low bits, which over the whole
    // of Cin in one accumulator grew with Cin
    float part[G::ACC];
    tc::fence_acc(part);
    tc::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      tc::wgmma_tf32_rs<G::N>(part, al[kk], dh + 2 * kk, kk > 0);
      tc::wgmma_tf32_rs<G::N>(part, ah[kk], dl + 2 * kk);
      tc::wgmma_tf32_rs<G::N>(part, ah[kk], dh + 2 * kk);
    }
    tc::wgmma_commit();
    // under the products: the load NS - 1 stages ahead (into the stage
    // the last products read) and the split of the next stage
    if (kt + NS - 1 < kt_n) load(kt + NS - 1);
    cp_async_commit();
    if (kt + 1 < kt_n) {
      cp_async_wait<NS - 2>();
      __syncthreads();
      split_tile(xs + ((kt + 1) % NS) * kXTile, los + ((kt + 1) & 1) * kXTile,
                 tid);
    }
    tc::wgmma_wait<0>();
    tc::fence_acc(part);
#pragma unroll
    for (int i = 0; i < G::ACC; ++i) acc[i] += part[i];
    // the products read ah and al from registers until the wait: keep
    // them live up to here, so the split above cannot take their registers
    fence_regs(ah);
    fence_regs(al);
    fence_async_smem();
    __syncthreads();
  }

  // epilogue: v = act(acc * scale + shift [+ res]) into the output tile
  // (transposed back: row = x row, column = channel), then whole rows out,
  // 16 bytes a thread where Cout % 4 == 0
  float sc[2], sf[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int col = n0 + crow + 8 * h;
    sc[h] = col < sh.n ? scale[col] : 0.f;
    sf[h] = col < sh.n ? shift[col] : 0.f;
  }
#pragma unroll
  for (int i = 0; i < G::ACC; ++i) {
    const int h = (i / 2) % 2;
    const int r = xrow + 8 * (i / 4) + 2 * t + i % 2;
    float* e = es + r * G::LDE + crow + 8 * h;
    const float v = acc[i] * sc[h] + sf[h] + (res != nullptr ? *e : 0.f);
    *e = act(v, sh.relu);
  }
  __syncthreads();
  for (int c = tid; c < kBM * (BC / 4); c += kThreads) {
    const int r = c / (BC / 4), cc = (c % (BC / 4)) * 4;
    const long long row = m0 + r;
    const int col = n0 + cc;
    if (row >= sh.m || col >= sh.n) continue;
    const float* e = es + r * G::LDE + cc;
    float* out = y + row * sh.n + col;
    if (sh.stage) {
      *reinterpret_cast<float4*>(out) = *reinterpret_cast<const float4*>(e);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (col + j < sh.n) out[j] = e[j];
    }
  }
}

bool aligned(const void* p, uintptr_t a) {
  return (reinterpret_cast<uintptr_t>(p) & (a - 1)) == 0;
}

// with the residual tile a block takes more than the 48 KB of static shared
// memory: opt in to its dynamic size first
template <typename T, int BN, int WARPS_M, int WARPS_N>
void launch16(const T* x, const T* w, const float* scale, const float* shift,
              const T* res, T* y, Shape sh, long long m_tiles,
              cudaStream_t st) {
  auto kernel = conv_bn_act_tc16_kernel<T, BN, WARPS_M, WARPS_N>;
  const int bytes = (int)sizeof(Smem16<T, BN>) +
                    (res != nullptr && sh.stage ? res_tile_bytes<BN>() : 0);
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           bytes) != cudaSuccess)
    return;  // the caller reads the error from cudaGetLastError()
  kernel<<<(unsigned)(m_tiles * sh.n_tiles), kThreads, bytes, st>>>(
      x, w, scale, shift, res, y, sh);
}

template <int BC>
void launch_tf32(const float* x, const float* w, const float* scale,
                 const float* shift, const float* res, float* y, Shape sh,
                 long long m_tiles, cudaStream_t st) {
  auto kernel = conv_bn_act_tf32_kernel<BC>;
  constexpr int bytes = F32Tile<BC>::SMEM;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           bytes) != cudaSuccess)
    return;  // the caller reads the error from cudaGetLastError()
  kernel<<<(unsigned)(m_tiles * sh.n_tiles), kThreads, bytes, st>>>(
      x, w, scale, shift, res, y, sh);
}

// the 16-bit path at element type T: 64-column tiles where Cout <= 64,
// else 128
template <typename T>
void launch16_for(const void* x, const void* w, const float* scale,
                  const float* shift, const void* res, void* y, Shape sh,
                  long long m_tiles, cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  const T* rt = static_cast<const T*>(res);
  T* yt = static_cast<T*>(y);
  if (sh.n <= 64) {
    sh.n_tiles = (sh.n + 63) / 64;
    launch16<T, 64, 4, 2>(xt, wt, scale, shift, rt, yt, sh, m_tiles, st);
  } else {
    sh.n_tiles = (sh.n + 127) / 128;
    launch16<T, 128, 2, 4>(xt, wt, scale, shift, rt, yt, sh, m_tiles, st);
  }
}

}  // namespace

// x [m, k] and w [k, n] row-major (contiguous) in one dtype, by its code:
// 0 f32, 1 bf16, 2 f16; scale, shift [n] f32; res [m, n] in x's dtype or
// null; y [m, n] in x's dtype, written. Launches on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int conv_bn_act(const void* x, const void* w, const float* scale,
                           const float* shift, const void* res, void* y,
                           long long m, int k, int n, int dtype, int relu,
                           void* stream) {
  if (m <= 0 || k <= 0 || n <= 0 ||
      (dtype != kF32 && dtype != kBF16 && dtype != kF16))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Shape sh{m, k, n, 0, relu, 0, 0, 0, 0};
  const long long m_tiles = (m + kBM - 1) / kBM;
  if (dtype == kF32) {
    sh.vec_a = k % 4 == 0 && aligned(x, 16);
    sh.vec_b = n % 4 == 0 && aligned(w, 16);
    sh.stage =
        n % 4 == 0 && aligned(y, 16) && (res == nullptr || aligned(res, 16));
    const float* xf = static_cast<const float*>(x);
    const float* wf = static_cast<const float*>(w);
    const float* rf = static_cast<const float*>(res);
    float* yf = static_cast<float*>(y);
    if (n <= 64) {
      sh.n_tiles = 1;
      launch_tf32<64>(xf, wf, scale, shift, rf, yf, sh, m_tiles, st);
    } else {
      sh.n_tiles = (n + 127) / 128;
      launch_tf32<128>(xf, wf, scale, shift, rf, yf, sh, m_tiles, st);
    }
    return (int)cudaGetLastError();
  }
  sh.vec_a = k % 8 == 0 && aligned(x, 16);
  sh.vec_b = n % 8 == 0 && aligned(w, 16);
  sh.pair = n % 2 == 0 && aligned(y, 4) && (res == nullptr || aligned(res, 4));
  sh.stage =
      n % 8 == 0 && aligned(y, 16) && (res == nullptr || aligned(res, 16));
  if (dtype == kBF16)
    launch16_for<bf16>(x, w, scale, shift, res, y, sh, m_tiles, st);
  else
    launch16_for<__half>(x, w, scale, shift, res, y, sh, m_tiles, st);
  return (int)cudaGetLastError();
}
