// The 16-bit tile machinery of the flash-attention kernels on Hopper's
// tensor cores (the forward, csrc/flash_attention_fwd.cu, and the backward,
// csrc/flash_attention_bwd.cu), for bf16 and f16 alike (the element type T
// a template parameter; both are 2 bytes, so every tile, layout and
// geometry is the same): the block geometry at head dim D, 16-byte
// cp.async loads of [R x D] row tiles into wgmma's 128-byte-swizzle layout
// (zero fill past the edge; the f32 kernels' padded rows too), the two
// m64n64k16 products a tile takes (both operands from shared memory; A
// from registers with B read MN-major), the accumulator as register A
// fragments, and the epilogue that stages a T result through shared memory
// for 16-byte stores. Each rounding to T is round to nearest even with no
// saturation: in f16 a value past 65504 becomes inf.
#pragma once

#include "tensor_core.cuh"

namespace flash_tc {

using bf16 = __nv_bfloat16;
using f16 = __half;
using tc::pack2;
using tc::sw128_desc;
using tc::sw_offset;
using tc::wgmma_rs;
using tc::wgmma_ss;

constexpr float kLog2e = 1.4426950408889634f;

// tile geometry of the 16-bit (bf16, f16) kernels at head dim D
template <int D>
struct Tc {
  static constexpr int NWG = D == 256 ? 1 : 2;  // warpgroups a block
  static constexpr int NT = NWG * 128;          // threads a block
  static constexpr int ROWS = NWG * 64;         // rows a block owns
  static constexpr int BS = 64;                 // rows a streamed tile
  static constexpr int DO = D < 128 ? D : 128;  // output columns a block
  static constexpr int SPLIT = D / DO;          // blocks a row tile
  static constexpr int NB = DO / 64;            // 64-wide output blocks
  // dq blocks an SM: two fit at D=64 (128 registers a thread, no spills)
  static constexpr int DQ_BLOCKS = D == 64 ? 2 : 1;
  static constexpr int OWN = ROWS * D * 2;      // bytes of a resident tile
  static constexpr int STREAM = BS * D * 2;     // bytes of a streamed tile
  // two streamed tiles and (dk/dv) lse and delta of their rows
  static constexpr int STAGE = 2 * STREAM + 1024;
  // two resident tiles, (dq) lse and delta of their rows, two stages, and
  // slack to align the base to 1024 bytes
  static constexpr int SMEM = 2 * OWN + 1024 + 2 * STAGE + 1024;
  static_assert(ROWS * 2 * 4 <= 1024 && BS * 2 * 4 <= 1024, "stats");
  static_assert(SMEM <= 232448, "shared memory");
  // the forward: the resident Q tile and KV_STAGES stages of a K and a V
  // tile (the next tiles load under this one's products), and slack to
  // align the base; two blocks an SM at D=64 (two warpgroups each)
  static constexpr int KV_STAGES = D == 256 ? 2 : 3;
  static constexpr int FWD_BLOCKS = D == 64 ? 2 : 1;
  static constexpr int FWD_SMEM = OWN + KV_STAGES * 2 * STREAM + 1024;
  static_assert(FWD_BLOCKS * FWD_SMEM <= 232448, "forward shared memory");
};

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return p + ((1024u - (tc::smem_u32(p) & 1023u)) & 1023u);
}

// rows [r0, r0 + R) of a [S, D] array of a 16-bit T into a swizzled tile of
// R rows; rows at or past `limit` are zero-filled
template <int R, int D, int NT, typename T>
__device__ __forceinline__ void load_tile(uint8_t* dst, const T* src,
                                          int r0, int limit, int tid) {
  static_assert(sizeof(T) == 2, "a 16-bit element type");
  constexpr int CPR = D / 8;  // 16-byte chunks a row
  static_assert((R * CPR) % NT == 0, "tile chunks");
#pragma unroll
  for (int it = 0; it < R * CPR / NT; ++it) {
    const int i = it * NT + tid;
    const int r = i / CPR, c = i % CPR;
    const bool ok = r0 + r < limit;
    tc::cp_async16(dst + sw_offset<R>(r, c),
                   src + (ok ? (size_t)(r0 + r) * D + c * 8 : 0), ok);
  }
}

// rows [r0, r0 + R) of a [S, D] f32 array into R rows of pitch P floats
// (16-byte cp.async; the f32 kernels' padded tiles); rows at or past
// `limit` are zero-filled
template <int R, int D, int P, int NT>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int r0, int limit, int tid) {
  constexpr int CPR = D / 4;  // 16-byte chunks a row
  static_assert((R * CPR) % NT == 0, "tile chunks");
#pragma unroll
  for (int it = 0; it < R * CPR / NT; ++it) {
    const int i = it * NT + tid;
    const int r = i / CPR, c = i % CPR;
    const bool ok = r0 + r < limit;
    tc::cp_async16(dst + r * P + 4 * c,
                   src + (ok ? (size_t)(r0 + r) * D + 4 * c : 0), ok);
  }
}

__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// acc (+)= the [64 x 64] product of rows [a_row, a_row + 64) of the
// resident tile `a` (ROWS rows) with the streamed tile `b` (BS rows),
// contracting over D: both K-major, elements of T
template <int D, typename T>
__device__ __forceinline__ void product_ss(float (&acc)[32], const uint8_t* a,
                                           int a_row, const uint8_t* b) {
  using G = Tc<D>;
  const uint64_t da = sw128_desc(a + a_row * 128, 0);
  const uint64_t db = sw128_desc(b, 0);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t oa = (kk >> 2) * (G::ROWS * 128) + (kk & 3) * 32;
    const uint32_t ob = (kk >> 2) * (G::BS * 128) + (kk & 3) * 32;
    wgmma_ss<T>(acc, da + (oa >> 4), db + (ob >> 4), kk > 0);
  }
}

// acc[c] += A . B[:, col0 + 64 c ..] for the NB output blocks: A [64 x 64]
// as register fragments of T (4 k16 steps of 4 registers), B the streamed
// tile (BS = 64 rows, contracted over) read MN-major
template <int D, typename T>
__device__ __forceinline__ void product_rs(float (&acc)[Tc<D>::NB][32],
                                           const uint32_t (&a)[16],
                                           const uint8_t* b, int col0) {
  using G = Tc<D>;
  const uint64_t db = sw128_desc(b, G::BS * 128);
#pragma unroll
  for (int kk = 0; kk < G::BS / 16; ++kk) {
#pragma unroll
    for (int c = 0; c < G::NB; ++c) {
      const uint32_t ob = (col0 / 64 + c) * (G::BS * 128) + kk * 2048;
      wgmma_rs<T>(acc[c], a + 4 * kk, db + (ob >> 4));
    }
  }
}

// the accumulator as four k16 A fragments of T (rounded to nearest even)
template <typename T>
__device__ __forceinline__ void to_frags(const float (&x)[32],
                                         uint32_t (&a)[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) a[i] = pack2<T>(x[2 * i], x[2 * i + 1]);
}

// the epilogue: acc * scale as T into a swizzled [ROWS x DO] tile at `st`
// (this thread's two rows of each 8-column group)
template <int D, typename T>
__device__ __forceinline__ void stage_out(uint8_t* st,
                                          const float (&acc)[Tc<D>::NB][32],
                                          float scale, int row) {
  using G = Tc<D>;
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int c = 0; c < G::NB; ++c) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = 4 * j + 2 * h;
        *reinterpret_cast<uint32_t*>(
            st + sw_offset<G::ROWS>(row + 8 * h, c * 8 + j) +
            (lane % 4) * 4) = pack2<T>(acc[c][i] * scale,
                                       acc[c][i + 1] * scale);
      }
    }
  }
}

// 16-byte chunks of the staged [ROWS x DO] tile to rows [r0, min(r0 +
// ROWS, limit)) of a [S, D] array, columns [col0, col0 + DO)
template <int D, typename T>
__device__ __forceinline__ void store_out(T* dst, const uint8_t* st,
                                          int r0, int limit, int col0) {
  using G = Tc<D>;
  constexpr int CPR = G::DO / 8;
  for (int i = threadIdx.x; i < G::ROWS * CPR; i += G::NT) {
    const int r = i / CPR, c = i % CPR;
    if (r0 + r < limit)
      *reinterpret_cast<uint4*>(dst + (size_t)(r0 + r) * D + col0 + c * 8) =
          *reinterpret_cast<const uint4*>(st + sw_offset<G::ROWS>(r, c));
  }
}


}  // namespace flash_tc
