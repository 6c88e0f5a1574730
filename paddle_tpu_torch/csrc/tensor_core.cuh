// Shared device helpers of the tensor-core kernels (the fused 1x1 conv and
// the flash-attention kernels): cp.async copies into shared memory,
// ldmatrix and mma.sync m16n8k16 in bf16 or f16 (sm_80 style, one warp),
// the 3xTF32 split and mma.sync m16n8k8 tf32 (the f32 flash forward), and
// Hopper's warpgroup products wgmma.mma_async m64n64k16 (bf16 or f16
// operands, f32 accumulate; the element type a template parameter) and
// m64nNk8 (tf32, the f32 fused 1x1 conv) over 128-byte-swizzled
// shared-memory tiles.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tc {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// -- cp.async ---------------------------------------------------------------

// 16 bytes global -> shared; with pred false the 16 bytes are zero-filled
// and nothing is read
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  const int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(n));
}

// 4 bytes global -> shared, zero-filled when pred is false
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool pred) {
  const int n = pred ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// -- ldmatrix and mma.sync (one warp) ---------------------------------------

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// d += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// the same in f16 (mma_bf16's fragments, f32 accumulate)
__device__ __forceinline__ void mma_f16(float* d, const uint32_t* a,
                                        const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// mma_bf16 or mma_f16 by the 16-bit element type T
template <typename T>
__device__ __forceinline__ void mma16(float* d, const uint32_t* a,
                                      const uint32_t* b);
template <>
__device__ __forceinline__ void mma16<__nv_bfloat16>(float* d,
                                                     const uint32_t* a,
                                                     const uint32_t* b) {
  mma_bf16(d, a, b);
}
template <>
__device__ __forceinline__ void mma16<__half>(float* d, const uint32_t* a,
                                              const uint32_t* b) {
  mma_f16(d, a, b);
}

// -- 3xTF32: f32 products on the tensor cores --------------------------------
//
// mma.sync m16n8k8 with tf32 operands (10 mantissa bits), f32 accumulate.
// Fragments (g = lane / 4, t = lane % 4): A [16 x 8] row-major a0 (g, t),
// a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4); B [8 x 8] b0 (t, g),
// b1 (t + 4, g); C [16 x 8] c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t),
// c3 (g + 8, 2t + 1). An f32 operand x is split as x = hi + lo, hi =
// tf32(x), lo = tf32(x - hi); a.b ~ hi.hi + hi.lo + lo.hi, the dropped
// lo.lo being ~2^-22 of a.b: f32 accuracy from three TF32 products.

// x rounded to tf32 (round to nearest, ties away from zero, on 10
// mantissa bits), in a b32 with its 13 low bits zero: half of the dropped
// bits' range added to the magnitude, then dropped. For every finite x
// (and inf) this is what cvt.rna.tf32.f32 gives, in two integer
// instructions where cvt's SASS takes four (it also screens NaN).
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo with hi = tf32(x) and lo = tf32(x - hi). lo keeps its 13 low
// bits: the tensor core reads a tf32 operand's top 19 bits only, so adding
// half their range is the rounding
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = to_tf32(x);
  lo = __float_as_uint(x - __uint_as_float(hi)) + 0x1000u;
}

// d += a (16x8, row) * b (8x8, col), tf32 in, f32 accumulate
__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a,
                                         const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a * b in 3xTF32 from split operands, the two small terms first
__device__ __forceinline__ void mma_3xtf32(float* d, const uint32_t* ah,
                                           const uint32_t* al,
                                           const uint32_t* bh,
                                           const uint32_t* bl) {
  mma_tf32(d, al, bh);
  mma_tf32(d, ah, bl);
  mma_tf32(d, ah, bh);
}

// two f32 -> one register of two bf16 (round to nearest even), lo in the
// low half: the element order of an mma A fragment
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// the same in f16 (cvt.rn.f16x2.f32, round to nearest even): a value past
// f16's largest finite 65504 becomes inf, as the reference's astype makes
// it. No satfinite: saturating would hide the overflow a loss scaler
// exists to catch.
__device__ __forceinline__ uint32_t pack_f16(float lo, float hi) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// pack_bf16 or pack_f16 by the 16-bit element type T
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi);
template <>
__device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float lo, float hi) {
  return pack_bf16(lo, hi);
}
template <>
__device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
  return pack_f16(lo, hi);
}

// pack2's inverse: a register of two T, lo in the low half, as two f32
template <typename T>
__device__ __forceinline__ float2 unpack2(uint32_t v);
template <>
__device__ __forceinline__ float2 unpack2<__nv_bfloat16>(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v));
}
template <>
__device__ __forceinline__ float2 unpack2<__half>(uint32_t v) {
  return __half22float2(*reinterpret_cast<__half2*>(&v));
}

// -- wgmma (one warpgroup, sm_90a) ------------------------------------------
//
// Shared-memory tiles are 16-bit (bf16 or f16) [R rows x C cols] with C a
// multiple of 64,
// stored as C/64 column blocks of R rows x 128 bytes, each 1024-byte
// aligned, the 16-byte chunk c of row r at chunk c ^ (r % 8): the layout
// the 128-byte swizzle mode of wgmma (and TMA) reads. The same tile serves
// as a K-major operand (the product contracts over its columns, 16 at a
// time: the descriptor starts 32 bytes further per step inside a block)
// and as an MN-major one (it contracts over its rows: 16 rows = 2048 bytes
// a step; N = 64 columns = one block).
//
// Accumulator of m64n64 (32 f32 a thread, thread t of the warpgroup,
// w = t / 32, l = t % 32): d[i] holds row 16 w + l / 4 + 8 ((i / 2) % 2),
// column 8 (i / 4) + 2 (l % 4) + i % 2. Its columns 16 s .. 16 s + 15,
// packed as pack_bf16(d[8 s + 2 j], d[8 s + 2 j + 1]) for j < 4, are the
// register A fragment of a k16 step over them.

// byte offset of 16-byte chunk c (0 .. C/8) of row r in a swizzled tile of
// R rows
template <int R>
__device__ __forceinline__ int sw_offset(int r, int c) {
  return (c >> 3) * (R * 128) + r * 128 + (((c & 7) ^ (r & 7)) << 4);
}

// descriptor of a 128-byte-swizzled operand starting at `p`: leading
// byte offset `lbo` (bytes between 64-wide column blocks, read in MN-major
// mode only), stride byte offset 1024 (between groups of 8 rows)
__device__ __forceinline__ uint64_t sw128_desc(const void* p, uint32_t lbo) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous product's issue and wait
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// the 32 accumulator operands of an m64n64 product, and their names
#define TC_ACC32(d)                                                    \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),          \
      "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),      \
      "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), \
      "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), \
      "+f"(d[30]), "+f"(d[31])
#define TC_D32                                                         \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, " \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, " \
  "%28, %29, %30, %31"
// m64n64k16 for the element type TY ("bf16" or "f16"): both operands in
// shared memory (SS), or A from registers (RS)
#define TC_WGMMA_SS(TY)                                                \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"            \
               "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY \
               " {" TC_D32 "}, %32, %33, p, 1, 1, 0, 0;\n}\n"          \
               : TC_ACC32(d)                                           \
               : "l"(da), "l"(db), "r"(accumulate))
#define TC_WGMMA_RS(TY)                                                \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"            \
               "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY \
               " {" TC_D32 "}, {%32, %33, %34, %35}, %36, p, 1, 1, "   \
               "1;\n}\n"                                               \
               : TC_ACC32(d)                                           \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),  \
                 "r"(1))

// d (+)= A . B, m64n64k16, A [64 x 16] and B^T [64 x 16] both K-major in
// shared memory, elements of T (bf16 or f16), f32 accumulate;
// accumulate = 0 overwrites d
template <typename T>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate);
template <>
__device__ __forceinline__ void wgmma_ss<__nv_bfloat16>(float (&d)[32],
                                                        uint64_t da,
                                                        uint64_t db,
                                                        int accumulate) {
  TC_WGMMA_SS("bf16");
}
template <>
__device__ __forceinline__ void wgmma_ss<__half>(float (&d)[32], uint64_t da,
                                                 uint64_t db,
                                                 int accumulate) {
  TC_WGMMA_SS("f16");
}

// d += A . B, m64n64k16, A [64 x 16] from registers (four pairs of T, the
// fragment above), B [16 x 64] MN-major in shared memory (its rows are the
// contraction)
template <typename T>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t* a,
                                         uint64_t db);
template <>
__device__ __forceinline__ void wgmma_rs<__nv_bfloat16>(float (&d)[32],
                                                        const uint32_t* a,
                                                        uint64_t db) {
  TC_WGMMA_RS("bf16");
}
template <>
__device__ __forceinline__ void wgmma_rs<__half>(float (&d)[32],
                                                 const uint32_t* a,
                                                 uint64_t db) {
  TC_WGMMA_RS("f16");
}

#undef TC_WGMMA_SS
#undef TC_WGMMA_RS
#undef TC_D32
#undef TC_ACC32

// d += A . B, m64nNk8 in tf32 (N = 64 or 128): A [64 x 8] from registers,
// the m16n8k8 A fragment of each warp's 16 rows (g = lane / 4, t = lane %
// 4: a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)); B [8 x N]
// K-major in shared memory (a tf32 operand has no MN-major mode): N rows of
// 128 bytes in the 128-byte swizzle, 8 tf32 of each row, 32 bytes a k8 step
// further inside the row. The tensor core reads an operand's top 19 bits.
// d as in the bf16 products: d[i] holds row 16 w + l / 4 + 8 ((i / 2) % 2),
// column 8 (i / 4) + 2 (l % 4) + i % 2; accumulate = 0 overwrites d.
template <int N>
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[N / 2],
                                              const uint32_t (&a)[4],
                                              uint64_t db,
                                              int accumulate = 1);

template <>
__device__ __forceinline__ void wgmma_tf32_rs<64>(float (&d)[32],
                                                  const uint32_t (&a)[4],
                                                  uint64_t db,
                                                  int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_tf32_rs<128>(float (&d)[64],
                                                  const uint32_t (&a)[4],
                                                  uint64_t db,
                                                  int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

}  // namespace tc
