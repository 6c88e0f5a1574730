// Flash-attention backward for Hopper (sm_90a), CUDA C++ with plain C entries.
//
// Replaces the two Pallas TPU kernels of paddle_tpu/ops/pallas/
// flash_attention.py::_bwd_call: _dq_kernel (pallas_call at :365) and
// _dkv_kernel (:385). Same recompute split and math: nothing of the forward
// but o and the row logsumexp lse is kept, and each kernel rebuilds the
// probabilities tile by tile,
//     p  = exp(q.k * scale - lse)      (0 where causal / key length mask)
//     dp = dO.v, dropped by the forward's keep mask and scaled 1/(1-rate)
//     ds = p * (dp - delta),  delta = rowsum(dO * o)
//     dq = ds.K * scale,  dK = ds^T.Q * scale,  dV = P_drop^T.dO
// with ds and the dropped p rounded to the input dtype before their
// products, as the reference rounds them; bottom-right causal masking (key
// k visible to row r when k <= r + sk - sq), per-(batch*head) key lengths
// and the dropout mask of flash::dropout_keep (flash_common.cuh)
// regenerated bit for bit. A row with no visible key gets dq = 0; a key
// no row sees gets dk = dv = 0, written.
//
//   flash_attention_bwd_dq:  one block per (batch*head, tile of query rows);
//       it loops over the K/V tiles and also writes delta (the reference's
//       separate rowsum, folded in here) for the dk/dv kernel;
//   flash_attention_bwd_dkv: one block per (batch*head, tile of key rows);
//       it loops over the Q/dO tiles, with dK and dV in registers.
// Each output row is owned by one block, so neither kernel needs atomics
// and both are deterministic (two runs give bit-equal results), which is
// why the reference splits dq from dk/dv too.
//
// What bounds them on the H100, at GPT's training shape (bf16, B=8 H=16
// S=1024 D=64, causal): dq does 6 D FLOPs a visible (q, k) pair, 25.8
// GFLOP, and moves ~101 MB (q, k, v, o, dO, lse read, dq and delta
// written): bytes bound it, 0.0304 ms at 3.35 TB/s against 0.0261 ms of
// tensor-core time; dk/dv does 8 D, 34.4 GFLOP: operations bound it,
// 0.0348 ms at 989 TFLOP/s. Either way the tensor cores are the only road
// to the bound, and the rebuilt p (an exp and, with dropout, a dozen-op
// hash per pair, twice) is CUDA-core work beside them.
//
// bf16 (the training path, bf16 AMP): every product on the tensor cores,
// wgmma.mma_async m64n64k16 with bf16 operands and f32 accumulators
// (tensor_core.cuh; the tile machinery in flash_tc.cuh, shared with the
// forward). A block is two warpgroups (one at D=256), each owning 64 rows;
// tiles of 64 rows stream past them:
//   - dk/dv: the block's 128 keys (K, V) stay in shared memory and dK, dV
//     in registers; per streamed Q/dO tile each warpgroup computes
//     S^T = K.Q^T and dP^T = V.dO^T (both operands from shared memory),
//     then P^T, the dropped P^T and dS^T = P^T (dP^T_drop - delta)
//     element by element in the accumulators (row = key, column = query:
//     the keep mask takes q_pos from the column), converts them to bf16 in
//     place as the A fragments of dV += P^T_drop.dO and dK += dS^T.Q (A
//     from registers, B the streamed tile read MN-major), so P and dS never
//     touch shared memory;
//   - dq: the block's 128 query rows (Q, dO) stay in shared memory and dQ
//     in registers; per streamed K/V tile: S = Q.K^T, dP = dO.V^T, dS,
//     dQ += dS.K. delta is summed from o and dO while the first tiles load.
// Tiles live in shared memory in wgmma's 128-byte-swizzle layout (one
// layout read both K-major and MN-major, free of bank conflicts), filled
// by 16-byte cp.async copies (zero fill past the edge) through a ring of
// two stages, so the next tile loads under this tile's products. D = 256
// keeps 64-row tiles, one warpgroup a block and splits the output columns
// over two blocks (each recomputes S and dP), so dK and dV still fit in
// registers. Tiles wholly masked are never loaded (causal, key length);
// only diagonal and ragged tiles pay for the mask; causal grids launch the
// longest blocks first (dk/dv: key tile 0; dq: the last query tile).
// The scale multiplies dQ and dK once, at the end; the results are staged
// through shared memory as bf16 for 16-byte stores. What is left between
// these kernels and the bound (PERF.md section 6) is the per-pair CUDA-core
// work (the exp and the dropout hash, in both kernels) that the products
// wait on, with few warps to hide it: dk/dv holds 233 registers a thread,
// one block an SM; dq at D=64 fits two blocks an SM, which took it from
// 0.17 to 0.13 ms at GPT's shape. Running each warpgroup's second product
// under its first's arithmetic (wgmma.wait_group 1) did not help and
// spilled.
//
// f32 at D = 32 (DETR's head dim, whose training runs in f32) and 64: the
// tensor cores at the f32 bar, in 3xTF32, as the f32 forward runs them
// (mma.sync m16n8k8, tf32 in, f32 accumulate; every operand x split as hi
// = tf32(x), lo = tf32(x - hi), a product lo.hi + hi.lo + hi.hi;
// tensor_core.cuh). A block is 4 warps owning 64 rows, 16 a warp (dq:
// queries, with Q and dO in shared memory; dk/dv: keys, with K and V in
// shared memory and dK, dV in registers); tiles of 64 keys (K/V) or of 32
// queries (16 at D = 64; Q/dO with their lse and delta) stream through
// two cp.async stages into rows padded to D + 4 floats, where both
// fragment patterns below hit 32 distinct banks. Per tile a warp runs
//   - S = Q.K^T and dP = dO.V^T (dk/dv: S^T = K.Q^T, dP^T = V.dO^T),
//     contracting over D with the plain m16n8k8 fragments (A rows g,
//     columns t and t + 4; B rows 8 j + g), each operand split at its
//     fragment load;
//   - p, the keep mask and dS in the accumulators (softmax_grad, the bf16
//     kernels' code: the m16n8 accumulators of a warp's 8-column slices
//     lie as a warpgroup accumulator does in one warp);
//   - dQ += dS.K (dk/dv: dV += P_drop^T.dO, then dK += dS^T.Q) with the
//     accumulator in registers as the A fragment: a thread's columns 2t
//     and 2t + 1 of each slice become the fragment's columns t and t + 4
//     by reading the tile's rows 2t and 2t + 1 as the B fragment's rows t
//     and t + 4 (the f32 forward's P.V).
// Every 8-wide step of every product (its three mma.sync) is summed from
// zero and added to the running sum in f32: the tensor cores' f32
// accumulation truncates, and summed over a whole tile it put these
// kernels 1.3-2.5x further from float64 than the CUDA-core ones (see
// product_d below); the steps cost 20-26 %. Where 64-row dq blocks would
// put fewer than two blocks on each SM (DETR's decoder, 100 queries), a
// block owns 16 rows and its 4 warps split each key tile, their sums added
// in warp order at the end. No atomics (each output row has one owner), so
// a second call is bit-equal; tiles wholly masked are never loaded, warps
// past their own causal or key-length end skip a tile's products; causal
// grids launch the longest blocks first. A row with no visible key gets
// dq = 0, a key no row sees dk = dv = 0.
// Measured (chip_smoke.py phase flash-d32 and --compare-bwd, H100 80GB
// HBM3 at 700 W, held, DETR's shapes at detr-train's batch 4 x 8, dropout
// 0.1): the encoder (1050 x 1050) dq 0.2349 and dk/dv 0.2883 ms, 0.175 and
// 0.190 of their 3xTF32 bounds (dropout 0: 0.2040 and 0.2525), against the
// CUDA-core kernels' 0.7443 and 1.3812 in turns and SDPA's whole f32
// backward 0.9907; decoder-self (100 x 100) 0.0113 and 0.0188; decoder-
// cross (100 x 1050) 0.0352 and 0.0440 (0.0752 for dq with 64-row blocks).
// GPT's f32 shape (8 x 16 x 1024, D = 64, causal) 0.7349 and 0.8133
// against 2.3694 and 3.3540 and SDPA's 1.8119. From float64 (largest of
// dq, dk, dv, of max(1, |g|)): 6.3e-7 and 6.8e-7 at the encoder (dropout
// 0 and 0.1) and 1.57e-6 at GPT's f32 shape, where the CUDA-core kernels
// read 1.24e-6, 9.8e-7 and 3.43e-6 on the same inputs.
// D = 128 and 256 keep the CUDA-core kernels below (TPR = D/16 threads
// share a row, dot products reduced by shuffles, the streamed tile staged
// as f32 and read by broadcast): at D = 128 this design's dk/dv held 255
// registers with 228 bytes of spill stores and its dq one block an SM
// (198.5 KB of shared memory), 2.0529 + 1.0269 ms at GPT-1.3B's f32 shape
// against the CUDA-core 2.5855 + 3.5139 and SDPA's 1.7662; at D = 256 its
// dq block would need 400 KB. bf16 at D = 32 is refused
// (cudaErrorInvalidValue), as its wgmma tiles would need the 64-byte
// swizzle.
//
// ptxas (-Xptxas -v, sm_90a, CUDA 12 on the H100), registers a thread and
// spill stores (chip_smoke.py's build phase prints them for every
// instantiation):
//   bf16 dq    D=64: 128 (two blocks an SM), 0;  D=128: 237, 0
//   bf16 dk/dv D=64: 233, 0;                     D=128: 255, 0
//   bf16 dk/dv D=256: 255, 304 bytes (off the training paths, which run
//   D=64; dq D=256 is printed by the build phase)
//   f32 (3xTF32) dq D=32: 168 (141 with the key split), dk/dv D=32: 168,
//   three blocks an SM; dq D=64: 255 (195), dk/dv D=64: 224, two blocks an
//   SM; no spills (the build phase fails on any)
//   f32 (CUDA cores) dq 98-99, dk/dv 123, no spills

#include "flash_common.cuh"
#include "flash_tc.cuh"

namespace {

using bf16 = __nv_bfloat16;
using flash::load4;
using flash::store4;
using flash_tc::align1024;
using flash_tc::fence_async_smem;
using flash_tc::kLog2e;
using flash_tc::load_rows;
using flash_tc::load_tile;
using flash_tc::product_rs;
using flash_tc::product_ss;
using flash_tc::stage_out;
using flash_tc::store_out;
using flash_tc::Tc;
using flash_tc::to_frags;
using tc::fence_acc;

// -- p, dp and ds in the accumulators (every tensor-core kernel) ----------

// p, the dropped p and ds of one tile, in place in the accumulators s and
// dp of one warp (a bf16 kernel's m64n64 warpgroup accumulator, or the
// m16n8 accumulators of an f32 kernel's N / 4 8-column slices: the same
// layout a warp; the element of index i at row `row0 + 8 ((i / 2) % 2)`,
// column `col0 + 8 (i / 4) + i % 2`, both absolute, in the accumulator's
// own orientation). KT: rows are keys and columns queries
// (dk/dv), else the other way round (dq). lse2 (lse * log2 e) and delta
// come from `stat(h, e, j)`: the row's (dq) or the column's (dk/dv).
template <bool KT, bool MASK, bool DROP, int N, typename Stat>
__device__ __forceinline__ void softmax_grad(float (&s)[N], float (&dp)[N],
                                             int row0, int col0,
                                             float scale_log2, Stat stat,
                                             int sq, int sk, int kv_len,
                                             int causal, uint32_t mix,
                                             uint32_t thresh,
                                             float inv_keep) {
  const int offset = sk - sq;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int h = (i >> 1) & 1, e = i & 1, j = i >> 2;
    const int r = row0 + 8 * h, c = col0 + 8 * j + e;
    const int qpos = KT ? c : r, key = KT ? r : c;
    float lse2, dlt;
    stat(h, e, j, lse2, dlt);
    float p = exp2f(fmaf(s[i], scale_log2, -lse2));
    if (MASK &&
        !(key < kv_len && qpos < sq && (!causal || key <= qpos + offset)))
      p = 0.f;
    float pd = p, dpv = dp[i];
    if (DROP) {
      const bool keep = flash::dropout_keep(mix, qpos, key, sk, thresh);
      pd = keep ? p * inv_keep : 0.f;
      dpv = keep ? dpv * inv_keep : 0.f;
    }
    s[i] = pd;
    dp[i] = p * (dpv - dlt);
  }
}

template <bool KT, int N, typename Stat>
__device__ __forceinline__ void softmax_grad_any(
    bool mask, bool drop, float (&s)[N], float (&dp)[N], int row0,
    int col0, float scale_log2, Stat stat, int sq, int sk, int kv_len,
    int causal, uint32_t mix, uint32_t thresh, float inv_keep) {
  if (mask) {
    if (drop)
      softmax_grad<KT, true, true>(s, dp, row0, col0, scale_log2, stat, sq,
                                   sk, kv_len, causal, mix, thresh, inv_keep);
    else
      softmax_grad<KT, true, false>(s, dp, row0, col0, scale_log2, stat, sq,
                                    sk, kv_len, causal, mix, thresh,
                                    inv_keep);
  } else {
    if (drop)
      softmax_grad<KT, false, true>(s, dp, row0, col0, scale_log2, stat, sq,
                                    sk, kv_len, causal, mix, thresh,
                                    inv_keep);
    else
      softmax_grad<KT, false, false>(s, dp, row0, col0, scale_log2, stat,
                                     sq, sk, kv_len, causal, mix, thresh,
                                     inv_keep);
  }
}

// -- f32: tensor cores in 3xTF32 (mma.sync m16n8k8), D = 32 and 64 -------

// tile geometry of the f32 tensor-core kernels at head dim D
template <int D>
struct F32 {
  static constexpr int NW = 4;        // warps a block
  static constexpr int NT = NW * 32;  // threads a block
  static constexpr int ROWS = NW * 16;  // rows a block owns, 16 a warp
  // rows a streamed tile: 64 keys (dq); 32 queries at D=32 and 16 at D=64
  // (dk/dv, which holds two [16 x D] sums: with 64 queries its D=64 build
  // spilled 188 bytes and D=32's, at three blocks an SM, 92; with 32 D=64
  // spilled 12)
  static constexpr int BS = 64;
  static constexpr int KBS = D == 32 ? 32 : 16;
  static constexpr int NS = 2;        // cp.async stages
  // row pitch in floats, D + 4: a warp's fragment loads of both kinds hit
  // 32 distinct banks (rows g, columns t: bank 4 g + t; rows 2t and
  // 2t + 1, columns g: bank 8 t + g, and + 4)
  static constexpr int P = D + 4;
  static constexpr int OWN = ROWS * P;  // floats of an owned 64-row tile
  // dq: stages of a K and a V tile (dq_smem below)
  static constexpr int STAGE = 2 * BS * P;
  // dk/dv: two owned tiles (K, V), stages of a Q and a dO tile and their
  // rows' lse and delta
  static constexpr int KSTAGE = 2 * KBS * P + 2 * KBS;
  static constexpr int KSMEM = (2 * OWN + NS * KSTAGE) * 4;
  // blocks an SM: three at D=32 (dq 55.5 KB of shared memory a block,
  // dk/dv 36.5 KB), two at D=64
  static constexpr int BLOCKS = D == 32 ? 3 : 2;
  static_assert(BLOCKS * KSMEM <= 232448, "f32 dk/dv shared memory");
};

// bytes of the dq kernel's shared memory with each key tile split over KW
// warps: two owned tiles (Q, dO) of 64 / KW rows, lse and delta of those
// rows, and the stages
template <int D, int KW>
constexpr int dq_smem =
    (2 * (F32<D>::ROWS / KW) * (F32<D>::P + 1) + F32<D>::NS * F32<D>::STAGE) *
    4;

// The A fragment (rows g and g + 8 of a warp's 16) of contraction step kk
// over an owned tile in shared memory (x: the warp's first row), split
// into hi and lo: a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8,
// t + 4) of the dims 8 kk ..
template <int P>
__device__ __forceinline__ void a_frag(const float* x, int kk, int g, int t,
                                       uint32_t (&ah)[4], uint32_t (&al)[4]) {
  const float* r0 = x + g * P + 8 * kk + t;
  const float* r1 = r0 + 8 * P;
  tc::split_tf32(r0[0], ah[0], al[0]);
  tc::split_tf32(r1[0], ah[1], al[1]);
  tc::split_tf32(r0[4], ah[2], al[2]);
  tc::split_tf32(r1[4], ah[3], al[3]);
}

// The tensor cores' f32 accumulation truncates: each mma.sync adds its
// products to the accumulator rounded toward zero, a bias of up to an ulp
// of the sum a step. Run over a whole contraction (12-24 steps for S and
// dP, 24 a tile for dQ) it put dq, dk and dv at 4.1-6.0e-6 of max(1, |g|)
// from float64 at GPT's f32 shape, where the CUDA-core kernels read
// 1.5-3.8e-6 on the same inputs.
// So every 8-wide step's three products are summed from zero and added
// to the running sum in f32 (round to nearest), as #1 f32 and #11 f32 sum
// each tile or stage apart, only finer.

// s = X.Y^T over the D dims, in 3xTF32, each 8-dim step apart: X the
// warp's 16 rows of an owned tile (x: its first row), Y the 2N rows of a
// streamed tile, both of pitch P; s the m16n8 accumulators of the N / 4
// column slices (s[4 j + i]: row g + 8 (i / 2), column 8 j + 2 t + i %
// 2). Y's B fragment: b0 = Y[8 j + g][8 kk + t], b1 =
// Y[8 j + g][8 kk + t + 4].
template <int D, int N>
__device__ __forceinline__ void product_d(float (&s)[N], const float* x,
                                          const float* y, int g, int t) {
  constexpr int P = F32<D>::P;
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    uint32_t ah[4], al[4];
    a_frag<P>(x, kk, g, t, ah, al);
#pragma unroll
    for (int j = 0; j < N / 4; ++j) {
      const float* yr = y + (8 * j + g) * P + 8 * kk + t;
      uint32_t bh[2], bl[2];
      tc::split_tf32(yr[0], bh[0], bl[0]);
      tc::split_tf32(yr[4], bh[1], bl[1]);
      float u[4] = {0.f, 0.f, 0.f, 0.f};
      tc::mma_3xtf32(u, ah, al, bh, bl);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        s[4 * j + i] = kk == 0 ? u[i] : s[4 * j + i] + u[i];
    }
  }
}

// acc += X.Y over the 2N rows of a streamed tile, in 3xTF32, each 8-row
// step apart: X [16 x 2N] as the m16n8 accumulators of product_d, Y [2N x
// D] the tile (pitch P), acc the warp's [16 x D] running sum. The
// accumulator gives a thread columns 2t and 2t + 1 of each 8-slice, which
// become the A fragment's columns t and t + 4 by reading Y's rows 2t and
// 2t + 1 as the B fragment's rows t and t + 4 (the f32 forward's P.V).
template <int D, int N>
__device__ __forceinline__ void product_rows(float (&acc)[D / 8][4],
                                             const float (&x)[N],
                                             const float* y, int g, int t) {
  constexpr int P = F32<D>::P;
#pragma unroll
  for (int kk = 0; kk < N / 4; ++kk) {
    uint32_t ah[4], al[4];
    tc::split_tf32(x[4 * kk + 0], ah[0], al[0]);
    tc::split_tf32(x[4 * kk + 2], ah[1], al[1]);
    tc::split_tf32(x[4 * kk + 1], ah[2], al[2]);
    tc::split_tf32(x[4 * kk + 3], ah[3], al[3]);
    const float* y0 = y + (8 * kk + 2 * t) * P + g;
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      uint32_t bh[2], bl[2];
      tc::split_tf32(y0[8 * c], bh[0], bl[0]);
      tc::split_tf32(y0[P + 8 * c], bh[1], bl[1]);
      float u[4] = {0.f, 0.f, 0.f, 0.f};
      tc::mma_3xtf32(u, ah, al, bh, bl);
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[c][i] += u[i];
    }
  }
}

// rows r and r + 8 (h = 0, 1) of a warp's m16n8 accumulators, times
// `scale`, to a [S, D] array (float2 stores; rows at or past `limit` are
// not written)
template <int D>
__device__ __forceinline__ void store_acc(float* dst,
                                          const float (&acc)[D / 8][4],
                                          int r, int t, int limit,
                                          float scale) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (r + 8 * h >= limit) continue;
    float* row = dst + (size_t)(r + 8 * h) * D + 2 * t;
#pragma unroll
    for (int c = 0; c < D / 8; ++c)
      *reinterpret_cast<float2*>(row + 8 * c) =
          make_float2(acc[c][2 * h] * scale, acc[c][2 * h + 1] * scale);
  }
}

// dq: a block of 4 warps owns 64 query rows of one batch*head (KW = 1:
// 16 a warp) or 16 (KW = 4: each warp takes 16 keys of every tile, and the
// four partial sums are added in warp order at the end), with Q and dO in
// shared memory; K/V tiles of 64 keys stream through two cp.async stages.
// Per tile each warp computes S = Q.K^T and dP = dO.V^T over its keys,
// then p, the keep mask and dS in the accumulators (softmax_grad), and dQ
// += dS.K with dS in registers as the A fragment. KW = 4 is for calls with
// few query rows (DETR's decoder: 100), whose 64-row blocks would leave
// the card under-filled, each walking every key.
template <int D, int KW>
__global__ void __launch_bounds__(F32<D>::NT, F32<D>::BLOCKS)
flash_bwd_dq_f32_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ o,
                        const float* __restrict__ dout,
                        const float* __restrict__ lse,
                        const int* __restrict__ lens,
                        const int* __restrict__ seed, float* __restrict__ dq,
                        float* __restrict__ delta, int sq, int sk, int causal,
                        float sm_scale, uint32_t thresh, float keep_prob) {
  using G = F32<D>;
  constexpr int NS = G::NS, BS = G::BS, P = G::P;
  constexpr int ROWS = G::ROWS / KW;  // query rows a block
  constexpr int WK = BS / KW;         // keys of a tile a warp takes
  constexpr int TPR = G::NT / ROWS;   // threads a row for delta
  extern __shared__ __align__(16) float smem_f[];
  float* qs = smem_f;
  float* dos = qs + ROWS * P;
  float* lse_s = dos + ROWS * P;
  float* dl_s = lse_s + ROWS;
  float* stages = dl_s + ROWS;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int bh = blockIdx.x;
  // the longest blocks first: under the causal mask the last query tile
  // sees the most keys
  const int q0 = (gridDim.y - 1 - blockIdx.y) * ROWS;
  const int offset = sk - sq;
  const int kv_len = lens != nullptr ? min(lens[bh], sk) : sk;
  int kend = kv_len;  // keys past kend are masked for every row
  if (causal) kend = min(kend, min(q0 + ROWS, sq) - 1 + offset + 1);
  const int n_tiles = kend > 0 ? (kend + BS - 1) / BS : 0;
  const size_t q_base = (size_t)bh * sq * D;
  const size_t kv_base = (size_t)bh * sk * D;

  // keys at or past the key length load as zeros (masked either way)
  auto load_kv = [&](int tt) {
    float* st = stages + (tt % NS) * G::STAGE;
    load_rows<BS, D, P, G::NT>(st, k + kv_base, tt * BS, kv_len, tid);
    load_rows<BS, D, P, G::NT>(st + BS * P, v + kv_base, tt * BS, kv_len,
                               tid);
  };
  // group 0 holds Q, dO and tile 0
  load_rows<ROWS, D, P, G::NT>(qs, q + q_base, q0, sq, tid);
  load_rows<ROWS, D, P, G::NT>(dos, dout + q_base, q0, sq, tid);
  if (n_tiles > 0) load_kv(0);
  tc::cp_async_commit();

  // delta = rowsum(dO * o) of the block's rows in f32, and lse, while the
  // first tiles load: TPR neighbouring threads a row, D / TPR dims each
  {
    const int r = tid / TPR, row = q0 + r;
    float part = 0.f;
    if (row < sq) {
      const size_t at = q_base + (size_t)row * D + (tid % TPR) * (D / TPR);
#pragma unroll
      for (int c = 0; c < D / TPR / 4; ++c) {
        const float4 a = load4(o + at + 4 * c), b = load4(dout + at + 4 * c);
        part += b.x * a.x + b.y * a.y + b.z * a.z + b.w * a.w;
      }
    }
#pragma unroll
    for (int off = 1; off < TPR; off <<= 1)
      part += __shfl_xor_sync(0xffffffffu, part, off);
    if (tid % TPR == 0) {
      dl_s[r] = part;
      lse_s[r] = row < sq ? lse[(size_t)bh * sq + row] : 0.f;
      if (row < sq) delta[(size_t)bh * sq + row] = part;
    }
  }
  __syncthreads();

  // the warp's rows (wrow in the block tile) and its keys of each tile
  const int wrow = KW == 1 ? warp * 16 : 0;
  const int wkey = KW == 1 ? 0 : warp * WK;
  const int wq0 = q0 + wrow;
  int wkend = kv_len;  // the warp's own key end
  if (causal) wkend = min(wkend, min(wq0 + 15, sq - 1) + offset + 1);
  const bool live = wq0 < sq;
  float lse2[2], dlt[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    lse2[h] = lse_s[wrow + g + 8 * h] * kLog2e;
    dlt[h] = dl_s[wrow + g + 8 * h];
  }
  auto stat = [&](int h, int, int, float& l2, float& d) {
    l2 = lse2[h];
    d = dlt[h];
  };
  const float scale_log2 = sm_scale * kLog2e;
  const bool drop = seed != nullptr;
  const uint32_t mix = drop ? flash::dropout_mix(*seed, bh) : 0u;
  const float inv_keep = 1.f / keep_prob;

  float acc[D / 8][4];
#pragma unroll
  for (int c = 0; c < D / 8; ++c)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[c][i] = 0.f;

  for (int tt = 0; tt < n_tiles; ++tt) {
    // tile tt has landed, and every warp is done with tile tt - 1, whose
    // stage the load below refills
    tc::cp_async_wait<NS - 2>();
    __syncthreads();
    if (tt + NS - 1 < n_tiles) load_kv(tt + NS - 1);
    tc::cp_async_commit();
    const int key0 = tt * BS + wkey;
    if (!live || key0 >= wkend) continue;
    const float* ks = stages + (tt % NS) * G::STAGE + wkey * P;
    const float* vs = ks + BS * P;

    float s[WK / 2], dp[WK / 2];
    product_d<D>(s, qs + wrow * P, ks, g, t);
    product_d<D>(dp, dos + wrow * P, vs, g, t);
    const bool mask = key0 + WK > kv_len ||
                      (causal && key0 + WK - 1 > wq0 + offset);
    softmax_grad_any<false>(mask, drop, s, dp, wq0 + g, key0 + 2 * t,
                            scale_log2, stat, sq, sk, kv_len, causal, mix,
                            thresh, inv_keep);
    product_rows<D>(acc, dp, ks, g, t);
  }
  tc::cp_async_wait<0>();
  if constexpr (KW > 1) {
    // the warps' partial sums through shared memory (over the stages),
    // added in warp order
    __syncthreads();
    float* part = stages + warp * 16 * D;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int c = 0; c < D / 8; ++c)
        *reinterpret_cast<float2*>(part + (g + 8 * h) * D + 8 * c + 2 * t) =
            make_float2(acc[c][2 * h], acc[c][2 * h + 1]);
    __syncthreads();
    if (warp > 0) return;
#pragma unroll
    for (int w = 1; w < KW; ++w)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int c = 0; c < D / 8; ++c) {
          const float2 x = *reinterpret_cast<const float2*>(
              stages + (w * 16 + g + 8 * h) * D + 8 * c + 2 * t);
          acc[c][2 * h] += x.x;
          acc[c][2 * h + 1] += x.y;
        }
  }
  store_acc<D>(dq + q_base, acc, wq0 + g, t, sq, sm_scale);
}

// dk/dv: a block owns 64 keys (16 a warp) of one batch*head, with K and V
// in shared memory and dK, dV in registers; Q/dO tiles of 32 queries
// stream through two cp.async stages, with their lse and delta. Per tile
// each warp computes S^T = K.Q^T and dP^T = V.dO^T, then P^T, the dropped
// P^T and dS^T in the accumulators (rows keys, columns queries), and dV +=
// P_drop^T.dO and dK += dS^T.Q.
template <int D>
__global__ void __launch_bounds__(F32<D>::NT, F32<D>::BLOCKS)
flash_bwd_dkv_f32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         const int* __restrict__ lens,
                         const int* __restrict__ seed, float* __restrict__ dk,
                         float* __restrict__ dv, int sq, int sk, int causal,
                         float sm_scale, uint32_t thresh, float keep_prob) {
  using G = F32<D>;
  constexpr int NS = G::NS, BS = G::KBS, P = G::P;
  extern __shared__ __align__(16) float smem_f[];
  float* ks = smem_f;
  float* vs = ks + G::OWN;
  float* stages = vs + G::OWN;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int bh = blockIdx.x;
  // key tile 0 first: under the causal mask it sees the most rows
  const int key0 = blockIdx.y * G::ROWS;
  const int offset = sk - sq;
  const int kv_len = lens != nullptr ? min(lens[bh], sk) : sk;
  const size_t q_base = (size_t)bh * sq * D;
  const size_t kv_base = (size_t)bh * sk * D;
  const float* lse_bh = lse + (size_t)bh * sq;
  const float* dl_bh = delta + (size_t)bh * sq;

  // the query tiles that see a key of the block: from the first row that
  // sees key0 (causal), aligned down to a streamed tile; none when every
  // key of the block lies at or past the key length
  const int q_begin = (causal ? max(0, key0 - offset) : 0) / BS * BS;
  const int q_end = key0 < kv_len ? sq : 0;
  const int n_tiles = q_end > q_begin ? (q_end - q_begin + BS - 1) / BS : 0;

  auto load_q = [&](int tt) {
    float* st = stages + (tt % NS) * G::KSTAGE;
    const int q0 = q_begin + tt * BS;
    load_rows<BS, D, P, G::NT>(st, q + q_base, q0, sq, tid);
    load_rows<BS, D, P, G::NT>(st + BS * P, dout + q_base, q0, sq, tid);
    float* ls = st + 2 * BS * P;
    if (tid < BS) {
      const bool ok = q0 + tid < sq;
      tc::cp_async4(ls + tid, lse_bh + (ok ? q0 + tid : 0), ok);
      tc::cp_async4(ls + BS + tid, dl_bh + (ok ? q0 + tid : 0), ok);
    }
  };
  // group 0 holds K, V (keys at or past the key length as zeros) and
  // tile 0
  load_rows<G::ROWS, D, P, G::NT>(ks, k + kv_base, key0, kv_len, tid);
  load_rows<G::ROWS, D, P, G::NT>(vs, v + kv_base, key0, kv_len, tid);
  if (n_tiles > 0) load_q(0);
  tc::cp_async_commit();

  const int wrow = warp * 16;  // the warp's first key in the block tile
  const int wkey0 = key0 + wrow;
  const bool live = wkey0 < kv_len;
  const float scale_log2 = sm_scale * kLog2e;
  const bool drop = seed != nullptr;
  const uint32_t mix = drop ? flash::dropout_mix(*seed, bh) : 0u;
  const float inv_keep = 1.f / keep_prob;

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int c = 0; c < D / 8; ++c)
#pragma unroll
    for (int i = 0; i < 4; ++i) dk_acc[c][i] = dv_acc[c][i] = 0.f;

  for (int tt = 0; tt < n_tiles; ++tt) {
    tc::cp_async_wait<NS - 2>();
    __syncthreads();
    if (tt + NS - 1 < n_tiles) load_q(tt + NS - 1);
    tc::cp_async_commit();
    const int q0 = q_begin + tt * BS;
    if (!live || (causal && wkey0 > q0 + BS - 1 + offset)) continue;
    const float* qs = stages + (tt % NS) * G::KSTAGE;
    const float* dos = qs + BS * P;
    const float* ls = dos + BS * P;
    // lse2 and delta of this thread's query columns
    auto stat = [&](int, int e, int j, float& l2, float& d) {
      l2 = ls[8 * j + 2 * t + e] * kLog2e;
      d = ls[BS + 8 * j + 2 * t + e];
    };

    float s[BS / 2], dp[BS / 2];
    product_d<D>(s, ks + wrow * P, qs, g, t);
    product_d<D>(dp, vs + wrow * P, dos, g, t);
    const bool mask = wkey0 + 16 > kv_len || q0 + BS > sq ||
                      (causal && wkey0 + 15 > q0 + offset);
    softmax_grad_any<true>(mask, drop, s, dp, wkey0 + g, q0 + 2 * t,
                           scale_log2, stat, sq, sk, kv_len, causal, mix,
                           thresh, inv_keep);
    product_rows<D>(dv_acc, s, dos, g, t);
    product_rows<D>(dk_acc, dp, qs, g, t);
  }
  tc::cp_async_wait<0>();
  store_acc<D>(dk + kv_base, dk_acc, wkey0 + g, t, sk, sm_scale);
  store_acc<D>(dv + kv_base, dv_acc, wkey0 + g, t, sk, 1.f);
}

// -- f32 at D = 128 and 256: CUDA cores ------------------------------------

constexpr int kThreads = 256;
constexpr int kTileElems = 4096;

template <int D>
struct Geo {
  static constexpr int TPR = D / 16;             // threads per row
  static constexpr int ROWS = kThreads / TPR;    // rows per block
  static constexpr int BT = kTileElems / D;      // rows per staged tile
  static constexpr int CHUNKS = D / 4;           // float4 chunks per row
};

// sum over the TPR threads of a row (aligned groups of TPR lanes)
template <int TPR>
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 1; off < TPR; off <<= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// thread r of a row owns the float4 chunks c = i*TPR + r, i < 4
template <int D>
__device__ __forceinline__ void load_row(const float* row, int r,
                                         float out[16]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 x = load4(row + (i * Geo<D>::TPR + r) * 4);
    out[4 * i] = x.x;
    out[4 * i + 1] = x.y;
    out[4 * i + 2] = x.z;
    out[4 * i + 3] = x.w;
  }
}

template <int D>
__device__ __forceinline__ void store_row(float* row, int r,
                                          const float in[16], float scale) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    store4(row + (i * Geo<D>::TPR + r) * 4,
           make_float4(in[4 * i] * scale, in[4 * i + 1] * scale,
                       in[4 * i + 2] * scale, in[4 * i + 3] * scale));
  }
}

// this thread's part of a . srow, srow a row of a staged tile
template <int D>
__device__ __forceinline__ float dot_part(const float a[16], const float* srow,
                                          int r) {
  float part = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 x =
        *reinterpret_cast<const float4*>(srow + (i * Geo<D>::TPR + r) * 4);
    part += a[4 * i] * x.x + a[4 * i + 1] * x.y + a[4 * i + 2] * x.z +
            a[4 * i + 3] * x.w;
  }
  return part;
}

// acc += w * srow over this thread's dims
template <int D>
__device__ __forceinline__ void axpy(float acc[16], float w, const float* srow,
                                     int r) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 x =
        *reinterpret_cast<const float4*>(srow + (i * Geo<D>::TPR + r) * 4);
    acc[4 * i] += w * x.x;
    acc[4 * i + 1] += w * x.y;
    acc[4 * i + 2] += w * x.z;
    acc[4 * i + 3] += w * x.w;
  }
}

// stage rows [r0, r0 + BT) of a [S, D] array into shared memory; rows at or
// past `limit` become zeros
template <int D>
__device__ __forceinline__ void stage(float* dst, const float* src, int r0,
                                      int limit, int tid) {
  constexpr int CHUNKS = Geo<D>::CHUNKS;
#pragma unroll
  for (int c = tid; c < kTileElems / 4; c += kThreads) {
    const int row = c / CHUNKS;
    const int col = (c % CHUNKS) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + row < limit) x = load4(src + (size_t)(r0 + row) * D + col);
    store4(dst + row * D + col, x);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ o,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const int* __restrict__ lens, const int* __restrict__ seed,
                    float* __restrict__ dq, float* __restrict__ delta, int sq,
                    int sk, int causal, float sm_scale, uint32_t thresh,
                    float keep_prob) {
  using G = Geo<D>;
  __shared__ __align__(16) float ks[kTileElems];
  __shared__ __align__(16) float vs[kTileElems];

  const int bh = blockIdx.y;
  const int tid = threadIdx.x;
  const int r = tid % G::TPR;
  const int row = blockIdx.x * G::ROWS + tid / G::TPR;
  const bool row_ok = row < sq;
  const int offset = sk - sq;
  const int kv_len = lens != nullptr ? min(lens[bh], sk) : sk;
  int kend = kv_len;
  if (causal) {
    const int last_row = min((blockIdx.x + 1) * G::ROWS, sq) - 1;
    kend = min(kend, last_row + offset + 1);
  }
  const int row_limit = causal ? row + offset : sk;
  const bool drop = seed != nullptr;
  const uint32_t mix = drop ? flash::dropout_mix(*seed, bh) : 0u;
  const size_t q_base = (size_t)bh * sq * D;
  const size_t kv_base = (size_t)bh * sk * D;

  float qr[16], dor[16], acc[16];
  float dl = 0.f;
  if (row_ok) {
    float orow[16];
    load_row<D>(q + q_base + (size_t)row * D, r, qr);
    load_row<D>(dout + q_base + (size_t)row * D, r, dor);
    load_row<D>(o + q_base + (size_t)row * D, r, orow);
#pragma unroll
    for (int i = 0; i < 16; ++i) dl += dor[i] * orow[i];
  } else {
#pragma unroll
    for (int i = 0; i < 16; ++i) qr[i] = dor[i] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i] = 0.f;
  dl = row_sum<G::TPR>(dl);
  if (row_ok && r == 0) delta[(size_t)bh * sq + row] = dl;
  const float lrow = row_ok ? lse[(size_t)bh * sq + row] : 0.f;

  for (int k0 = 0; k0 < kend; k0 += G::BT) {
    __syncthreads();  // the previous tile is consumed
    stage<D>(ks, k + kv_base, k0, kv_len, tid);
    stage<D>(vs, v + kv_base, k0, kv_len, tid);
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < G::BT; ++j) {
      const int kpos = k0 + j;
      const float s =
          row_sum<G::TPR>(dot_part<D>(qr, ks + j * D, r)) * sm_scale;
      float dp = row_sum<G::TPR>(dot_part<D>(dor, vs + j * D, r));
      const bool ok = kpos < kv_len && kpos <= row_limit;
      const float p = ok ? expf(s - lrow) : 0.f;
      if (drop)
        dp = flash::dropout_keep(mix, row, kpos, sk, thresh) ? dp / keep_prob
                                                             : 0.f;
      axpy<D>(acc, p * (dp - dl), ks + j * D, r);
    }
  }
  if (row_ok) store_row<D>(dq + q_base + (size_t)row * D, r, acc, sm_scale);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     const int* __restrict__ lens,
                     const int* __restrict__ seed, float* __restrict__ dk,
                     float* __restrict__ dv, int sq, int sk, int causal,
                     float sm_scale, uint32_t thresh, float keep_prob) {
  using G = Geo<D>;
  __shared__ __align__(16) float qs[kTileElems];
  __shared__ __align__(16) float dos[kTileElems];
  __shared__ float ls[G::BT];
  __shared__ float dls[G::BT];

  const int bh = blockIdx.y;
  const int tid = threadIdx.x;
  const int r = tid % G::TPR;
  const int key0 = blockIdx.x * G::ROWS;
  const int key = key0 + tid / G::TPR;
  const int offset = sk - sq;
  const int kv_len = lens != nullptr ? min(lens[bh], sk) : sk;
  const bool key_live = key < kv_len;
  const bool drop = seed != nullptr;
  const uint32_t mix = drop ? flash::dropout_mix(*seed, bh) : 0u;
  const size_t q_base = (size_t)bh * sq * D;
  const size_t kv_base = (size_t)bh * sk * D;

  float kr[16], vr[16], dka[16], dva[16];
  if (key_live) {
    load_row<D>(k + kv_base + (size_t)key * D, r, kr);
    load_row<D>(v + kv_base + (size_t)key * D, r, vr);
  } else {
#pragma unroll
    for (int i = 0; i < 16; ++i) kr[i] = vr[i] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < 16; ++i) dka[i] = dva[i] = 0.f;

  // the first query row that sees any key of this block, tile-aligned;
  // a block whose keys all lie past the key length has no work
  int q_begin = causal ? max(0, key0 - offset) : 0;
  q_begin = (q_begin / G::BT) * G::BT;
  const int q_end = key0 < kv_len ? sq : 0;

  for (int q0 = q_begin; q0 < q_end; q0 += G::BT) {
    __syncthreads();  // the previous tile is consumed
    stage<D>(qs, q + q_base, q0, sq, tid);
    stage<D>(dos, dout + q_base, q0, sq, tid);
    if (tid < G::BT) {
      const int qp = q0 + tid;
      ls[tid] = qp < sq ? lse[(size_t)bh * sq + qp] : 0.f;
      dls[tid] = qp < sq ? delta[(size_t)bh * sq + qp] : 0.f;
    }
    __syncthreads();
#pragma unroll 2
    for (int i = 0; i < G::BT; ++i) {
      const int qpos = q0 + i;
      const float s =
          row_sum<G::TPR>(dot_part<D>(kr, qs + i * D, r)) * sm_scale;
      float dp = row_sum<G::TPR>(dot_part<D>(vr, dos + i * D, r));
      const bool ok =
          key_live && qpos < sq && (!causal || key <= qpos + offset);
      const float p = ok ? expf(s - ls[i]) : 0.f;
      float p_drop = p;
      if (drop) {
        const bool keep = flash::dropout_keep(mix, qpos, key, sk, thresh);
        p_drop = keep ? p / keep_prob : 0.f;
        dp = keep ? dp / keep_prob : 0.f;
      }
      axpy<D>(dva, p_drop, dos + i * D, r);
      axpy<D>(dka, p * (dp - dls[i]), qs + i * D, r);
    }
  }
  if (key < sk) {
    store_row<D>(dk + kv_base + (size_t)key * D, r, dka, sm_scale);
    store_row<D>(dv + kv_base + (size_t)key * D, r, dva, 1.f);
  }
}

// -- bf16: tensor cores (wgmma) ---------------------------------------------

template <int D>
__global__ void __launch_bounds__(Tc<D>::NT, Tc<D>::DQ_BLOCKS)
flash_bwd_dq_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, const bf16* __restrict__ o,
                       const bf16* __restrict__ dout,
                       const float* __restrict__ lse,
                       const int* __restrict__ lens,
                       const int* __restrict__ seed, bf16* __restrict__ dq,
                       float* __restrict__ delta, int sq, int sk, int causal,
                       float sm_scale, uint32_t thresh, float keep_prob) {
  using G = Tc<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint8_t* qs = smem;
  uint8_t* dos = smem + G::OWN;
  float* lse_s = reinterpret_cast<float*>(smem + 2 * G::OWN);
  float* dl_s = lse_s + G::ROWS;
  uint8_t* stages = smem + 2 * G::OWN + 1024;

  const int tid = threadIdx.x;
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int bh = blockIdx.x;
  // the longest blocks first: under the causal mask the last query tile
  // sees the most keys
  const int tile = gridDim.y / G::SPLIT - 1 - (int)blockIdx.y / G::SPLIT;
  const int col0 = ((int)blockIdx.y % G::SPLIT) * G::DO;
  const int q0 = tile * G::ROWS;
  const int offset = sk - sq;
  const int kv_len = lens != nullptr ? min(lens[bh], sk) : sk;
  int kend = kv_len;  // keys past kend are masked for every row
  if (causal) kend = min(kend, min(q0 + G::ROWS, sq) - 1 + offset + 1);
  const int n_tiles = kend > 0 ? (kend + G::BS - 1) / G::BS : 0;
  const size_t q_base = (size_t)bh * sq * D;
  const size_t kv_base = (size_t)bh * sk * D;

  auto load_kv = [&](int t) {
    uint8_t* st = stages + (t & 1) * G::STAGE;
    load_tile<G::BS, D, G::NT>(st, k + kv_base, t * G::BS, sk, tid);
    load_tile<G::BS, D, G::NT>(st + G::STREAM, v + kv_base, t * G::BS, sk,
                               tid);
  };
  load_tile<G::ROWS, D, G::NT>(qs, q + q_base, q0, sq, tid);
  load_tile<G::ROWS, D, G::NT>(dos, dout + q_base, q0, sq, tid);
  if (n_tiles > 0) load_kv(0);
  tc::cp_async_commit();

  // delta = rowsum(dO * o) in f32, and lse, of the block's rows, while the
  // first tiles load: every 16-byte chunk of o and dO is read at once (a
  // row's CPR chunks on CPR neighbouring lanes), then summed over the lanes
  {
    constexpr int CPR = D / 8;
    constexpr int IT = G::ROWS * CPR / G::NT;
    float part[IT];
#pragma unroll
    for (int it = 0; it < IT; ++it) {
      const int i = it * G::NT + tid, row = q0 + i / CPR;
      part[it] = 0.f;
      if (row < sq) {
        const size_t at = q_base + (size_t)row * D + (i % CPR) * 8;
        float ov[8], dov[8];
        flash::load_row<bf16, 8>(o + at, ov);
        flash::load_row<bf16, 8>(dout + at, dov);
#pragma unroll
        for (int e = 0; e < 8; ++e) part[it] += dov[e] * ov[e];
      }
    }
#pragma unroll
    for (int it = 0; it < IT; ++it) {
      float x = part[it];
#pragma unroll
      for (int off = 1; off < CPR; off <<= 1)
        x += __shfl_xor_sync(0xffffffffu, x, off);
      const int i = it * G::NT + tid, r = i / CPR, row = q0 + r;
      if (i % CPR == 0) {
        dl_s[r] = x;
        lse_s[r] = row < sq ? lse[(size_t)bh * sq + row] : 0.f;
        if (row < sq && col0 == 0) delta[(size_t)bh * sq + row] = x;
      }
    }
  }
  __syncthreads();

  // this thread's rows of the accumulators: row + 8 h, h < 2
  const int wrow = wg * 64;                // in the block tile
  const int row = wrow + warp * 16 + lane / 4;
  const int wq0 = q0 + wrow;               // first query of the warpgroup
  float lse2[2], dlt[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    lse2[h] = lse_s[row + 8 * h] * kLog2e;
    dlt[h] = dl_s[row + 8 * h];
  }
  auto stat = [&](int h, int, int, float& l2, float& d) {
    l2 = lse2[h];
    d = dlt[h];
  };
  int wkend = kv_len;  // the warpgroup's own key end
  if (causal) wkend = min(wkend, min(wq0 + 63, sq - 1) + offset + 1);
  const bool wg_live = wq0 < sq;
  const float scale_log2 = sm_scale * kLog2e;
  const bool drop = seed != nullptr;
  const uint32_t mix = drop ? flash::dropout_mix(*seed, bh) : 0u;
  const float inv_keep = 1.f / keep_prob;

  float acc[G::NB][32];
#pragma unroll
  for (int c = 0; c < G::NB; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[c][i] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) {
      load_kv(t + 1);
      tc::cp_async_commit();
      tc::cp_async_wait<1>();
    } else {
      tc::cp_async_wait<0>();
    }
    fence_async_smem();
    __syncthreads();
    const int key0 = t * G::BS;
    const uint8_t* kst = stages + (t & 1) * G::STAGE;
    if (wg_live && key0 < wkend) {
      float s[32], dp[32];
      tc::wgmma_fence();
      product_ss<D>(s, qs, wrow, kst);
      tc::wgmma_commit();
      product_ss<D>(dp, dos, wrow, kst + G::STREAM);
      tc::wgmma_commit();
      tc::wgmma_wait<0>();
      fence_acc(s);
      fence_acc(dp);
      const bool mask = key0 + G::BS > kv_len ||
                        (causal && key0 + G::BS - 1 > wq0 + offset);
      softmax_grad_any<false>(mask, drop, s, dp, q0 + row,
                              key0 + 2 * (lane % 4), scale_log2, stat, sq,
                              sk, kv_len, causal, mix, thresh, inv_keep);
      uint32_t ds[16];
      to_frags(dp, ds);
#pragma unroll
      for (int c = 0; c < G::NB; ++c) fence_acc(acc[c]);
      tc::wgmma_fence();
      product_rs<D>(acc, ds, kst, col0);
      tc::wgmma_commit();
      tc::wgmma_wait<0>();
#pragma unroll
      for (int c = 0; c < G::NB; ++c) fence_acc(acc[c]);
    }
    __syncthreads();  // the stage is consumed before it is refilled
  }

  tc::cp_async_wait<0>();
  __syncthreads();
  stage_out<D>(qs, acc, sm_scale, row);
  __syncthreads();
  store_out<D>(dq + q_base, qs, q0, sq, col0);
}

template <int D>
__global__ void __launch_bounds__(Tc<D>::NT, 1)
flash_bwd_dkv_tc_kernel(const bf16* __restrict__ q,
                        const bf16* __restrict__ k,
                        const bf16* __restrict__ v,
                        const bf16* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        const int* __restrict__ lens,
                        const int* __restrict__ seed, bf16* __restrict__ dk,
                        bf16* __restrict__ dv, int sq, int sk, int causal,
                        float sm_scale, uint32_t thresh, float keep_prob) {
  using G = Tc<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint8_t* ks = smem;
  uint8_t* vs = smem + G::OWN;
  uint8_t* stages = smem + 2 * G::OWN + 1024;

  const int tid = threadIdx.x;
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int bh = blockIdx.x;
  // key tile 0 first: under the causal mask it sees the most rows
  const int key0 = ((int)blockIdx.y / G::SPLIT) * G::ROWS;
  const int col0 = ((int)blockIdx.y % G::SPLIT) * G::DO;
  const int offset = sk - sq;
  const int kv_len = lens != nullptr ? min(lens[bh], sk) : sk;
  const size_t q_base = (size_t)bh * sq * D;
  const size_t kv_base = (size_t)bh * sk * D;
  const float* lse_bh = lse + (size_t)bh * sq;
  const float* dl_bh = delta + (size_t)bh * sq;

  // the query tiles that see a key of the block: from the first row that
  // sees key0 (causal), aligned down to a streamed tile; none when every
  // key of the block lies at or past the key length
  const int q_begin = (causal ? max(0, key0 - offset) : 0) / G::BS * G::BS;
  const int q_end = key0 < kv_len ? sq : 0;
  const int n_tiles =
      q_end > q_begin ? (q_end - q_begin + G::BS - 1) / G::BS : 0;

  auto load_q = [&](int t) {
    uint8_t* st = stages + (t & 1) * G::STAGE;
    const int q0 = q_begin + t * G::BS;
    load_tile<G::BS, D, G::NT>(st, q + q_base, q0, sq, tid);
    load_tile<G::BS, D, G::NT>(st + G::STREAM, dout + q_base, q0, sq, tid);
    float* ls = reinterpret_cast<float*>(st + 2 * G::STREAM);
    if (tid < G::BS) {
      const bool ok = q0 + tid < sq;
      tc::cp_async4(ls + tid, lse_bh + (ok ? q0 + tid : 0), ok);
      tc::cp_async4(ls + G::BS + tid, dl_bh + (ok ? q0 + tid : 0), ok);
    }
  };
  load_tile<G::ROWS, D, G::NT>(ks, k + kv_base, key0, sk, tid);
  load_tile<G::ROWS, D, G::NT>(vs, v + kv_base, key0, sk, tid);
  if (n_tiles > 0) load_q(0);
  tc::cp_async_commit();

  const int wrow = wg * 64;                // in the block tile
  const int row = wrow + warp * 16 + lane / 4;
  const int wkey0 = key0 + wrow;           // first key of the warpgroup
  const bool wg_live = wkey0 < kv_len;
  const float scale_log2 = sm_scale * kLog2e;
  const bool drop = seed != nullptr;
  const uint32_t mix = drop ? flash::dropout_mix(*seed, bh) : 0u;
  const float inv_keep = 1.f / keep_prob;

  float dk_acc[G::NB][32], dv_acc[G::NB][32];
#pragma unroll
  for (int c = 0; c < G::NB; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) dk_acc[c][i] = dv_acc[c][i] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) {
      load_q(t + 1);
      tc::cp_async_commit();
      tc::cp_async_wait<1>();
    } else {
      tc::cp_async_wait<0>();
    }
    fence_async_smem();
    __syncthreads();
    const int q0 = q_begin + t * G::BS;
    const uint8_t* st = stages + (t & 1) * G::STAGE;
    if (wg_live && (!causal || wkey0 <= q0 + G::BS - 1 + offset)) {
      const float* ls = reinterpret_cast<const float*>(st + 2 * G::STREAM);
      // lse2 and delta of this thread's 16 query columns
      const int cq = 2 * (lane % 4);
      auto stat = [&](int, int e, int j, float& l2, float& d) {
        l2 = ls[8 * j + cq + e] * kLog2e;
        d = ls[G::BS + 8 * j + cq + e];
      };
      float s[32], dp[32];
      tc::wgmma_fence();
      product_ss<D>(s, ks, wrow, st);
      tc::wgmma_commit();
      product_ss<D>(dp, vs, wrow, st + G::STREAM);
      tc::wgmma_commit();
      tc::wgmma_wait<0>();
      fence_acc(s);
      fence_acc(dp);
      const bool mask = wkey0 + 64 > kv_len || q0 + G::BS > sq ||
                        (causal && wkey0 + 63 > q0 + offset);
      softmax_grad_any<true>(mask, drop, s, dp, key0 + row, q0 + cq,
                             scale_log2, stat, sq, sk, kv_len, causal, mix,
                             thresh, inv_keep);
      uint32_t pa[16], dsa[16];
      to_frags(s, pa);
      to_frags(dp, dsa);
#pragma unroll
      for (int c = 0; c < G::NB; ++c) {
        fence_acc(dk_acc[c]);
        fence_acc(dv_acc[c]);
      }
      tc::wgmma_fence();
      product_rs<D>(dv_acc, pa, st + G::STREAM, col0);
      product_rs<D>(dk_acc, dsa, st, col0);
      tc::wgmma_commit();
      tc::wgmma_wait<0>();
#pragma unroll
      for (int c = 0; c < G::NB; ++c) {
        fence_acc(dk_acc[c]);
        fence_acc(dv_acc[c]);
      }
    }
    __syncthreads();  // the stage is consumed before it is refilled
  }

  tc::cp_async_wait<0>();
  __syncthreads();
  stage_out<D>(ks, dk_acc, sm_scale, row);
  stage_out<D>(vs, dv_acc, 1.f, row);
  __syncthreads();
  store_out<D>(dk + kv_base, ks, key0, sk, col0);
  store_out<D>(dv + kv_base, vs, key0, sk, col0);
}

// -- launch -----------------------------------------------------------------

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;
  const float* delta_in;
  const int* lens;
  const int* seed;
  void* out0;  // dq, or dk
  void* out1;  // unused, or dv
  float* delta_out;
  int bh, sq, sk, causal;
  float sm_scale;
  uint32_t thresh;
  float keep_prob;
  cudaStream_t stream;
};

// the f32 dq kernel at D = 32 and 64, each key tile split over its warps
// (KW = 4) or not
template <int D, int KW>
int launch_dq_tc_f32(const Args& a) {
  using G = F32<D>;
  constexpr int ROWS = G::ROWS / KW, SMEM = dq_smem<D, KW>;
  static_assert(G::BLOCKS * SMEM <= 232448, "f32 dq shared memory");
  const int tiles = (a.sq + ROWS - 1) / ROWS;
  if (tiles > 65535) return (int)cudaErrorInvalidValue;
  // above 48 KB of dynamic shared memory needs the opt-in, once
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_bwd_dq_f32_kernel<D, KW>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (attr != cudaSuccess) return (int)attr;
  flash_bwd_dq_f32_kernel<D, KW><<<dim3(a.bh, tiles), G::NT, SMEM,
                                   a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.o),
      static_cast<const float*>(a.dout), a.lse, a.lens, a.seed,
      static_cast<float*>(a.out0), a.delta_out, a.sq, a.sk, a.causal,
      a.sm_scale, a.thresh, a.keep_prob);
  return 0;
}

// the f32 kernels: the tensor cores (3xTF32) at D = 32 and 64, the CUDA
// cores at D = 128 and 256. dq splits each tile's keys over its warps when
// 64-row blocks would put fewer than two blocks on each of the H100's 132
// SMs (a shape's rule, so a call is repeated bit for bit)
template <int D>
int launch_dq_f32(const Args& a) {
  if constexpr (D <= 64) {
    const long long blocks =
        (long long)a.bh * ((a.sq + F32<D>::ROWS - 1) / F32<D>::ROWS);
    return blocks < 2 * 132 ? launch_dq_tc_f32<D, 4>(a)
                            : launch_dq_tc_f32<D, 1>(a);
  } else {
    dim3 grid((a.sq + Geo<D>::ROWS - 1) / Geo<D>::ROWS, a.bh);
    flash_bwd_dq_kernel<D><<<grid, kThreads, 0, a.stream>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<const float*>(a.o),
        static_cast<const float*>(a.dout), a.lse, a.lens, a.seed,
        static_cast<float*>(a.out0), a.delta_out, a.sq, a.sk, a.causal,
        a.sm_scale, a.thresh, a.keep_prob);
  }
  return 0;
}

template <int D>
int launch_dkv_f32(const Args& a) {
  if constexpr (D <= 64) {
    using G = F32<D>;
    const int tiles = (a.sk + G::ROWS - 1) / G::ROWS;
    if (tiles > 65535) return (int)cudaErrorInvalidValue;
    static const cudaError_t attr = cudaFuncSetAttribute(
        flash_bwd_dkv_f32_kernel<D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, G::KSMEM);
    if (attr != cudaSuccess) return (int)attr;
    flash_bwd_dkv_f32_kernel<D><<<dim3(a.bh, tiles), G::NT, G::KSMEM,
                                  a.stream>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
        a.lse, a.delta_in, a.lens, a.seed, static_cast<float*>(a.out0),
        static_cast<float*>(a.out1), a.sq, a.sk, a.causal, a.sm_scale,
        a.thresh, a.keep_prob);
  } else {
    dim3 grid((a.sk + Geo<D>::ROWS - 1) / Geo<D>::ROWS, a.bh);
    flash_bwd_dkv_kernel<D><<<grid, kThreads, 0, a.stream>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
        a.lse, a.delta_in, a.lens, a.seed, static_cast<float*>(a.out0),
        static_cast<float*>(a.out1), a.sq, a.sk, a.causal, a.sm_scale,
        a.thresh, a.keep_prob);
  }
  return 0;
}

// the grid of a bf16 kernel: (batch*head, tiles of `rows` rows x SPLIT)
template <int D>
bool tc_grid(int rows, int bh, dim3* grid) {
  const long long tiles =
      (long long)(rows + Tc<D>::ROWS - 1) / Tc<D>::ROWS * Tc<D>::SPLIT;
  *grid = dim3(bh, (unsigned)tiles);
  return tiles <= 65535;
}

template <int D>
int launch_dq_bf16(const Args& a) {
  using G = Tc<D>;
  dim3 grid;
  if (!tc_grid<D>(a.sq, a.bh, &grid)) return (int)cudaErrorInvalidValue;
  // above 48 KB of dynamic shared memory needs the opt-in, once
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_bwd_dq_tc_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
  if (attr != cudaSuccess) return (int)attr;
  flash_bwd_dq_tc_kernel<D><<<grid, G::NT, G::SMEM, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.o),
      static_cast<const bf16*>(a.dout), a.lse, a.lens, a.seed,
      static_cast<bf16*>(a.out0), a.delta_out, a.sq, a.sk, a.causal,
      a.sm_scale, a.thresh, a.keep_prob);
  return 0;
}

template <int D>
int launch_dkv_bf16(const Args& a) {
  using G = Tc<D>;
  dim3 grid;
  if (!tc_grid<D>(a.sk, a.bh, &grid)) return (int)cudaErrorInvalidValue;
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_bwd_dkv_tc_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
  if (attr != cudaSuccess) return (int)attr;
  flash_bwd_dkv_tc_kernel<D><<<grid, G::NT, G::SMEM, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout),
      a.lse, a.delta_in, a.lens, a.seed, static_cast<bf16*>(a.out0),
      static_cast<bf16*>(a.out1), a.sq, a.sk, a.causal, a.sm_scale,
      a.thresh, a.keep_prob);
  return 0;
}

template <bool DQ, int D>
int launch(const Args& a, int is_bf16) {
  if (is_bf16) return DQ ? launch_dq_bf16<D>(a) : launch_dkv_bf16<D>(a);
  return DQ ? launch_dq_f32<D>(a) : launch_dkv_f32<D>(a);
}

template <bool DQ>
int run(const Args& a, int d, int is_bf16) {
  if (a.bh <= 0 || a.sq <= 0 || a.sk <= 0 || a.bh > 65535)
    return (int)cudaErrorInvalidValue;
  int err;
  switch (d) {
    // head_dim 32 (DETR's): the f32 kernel only; bf16 tiles at 32 would
    // need wgmma's 64-byte swizzle
    case 32:
      if (is_bf16) return (int)cudaErrorInvalidValue;
      err = DQ ? launch_dq_f32<32>(a) : launch_dkv_f32<32>(a);
      break;
    case 64: err = launch<DQ, 64>(a, is_bf16); break;
    case 128: err = launch<DQ, 128>(a, is_bf16); break;
    case 256: err = launch<DQ, 256>(a, is_bf16); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err) return err;
  return (int)cudaGetLastError();
}

}  // namespace

// Common arguments: q, o, dout [bh, sq, d] and k, v [bh, sk, d] contiguous,
// all f32 (is_bf16 = 0) or all bf16 (is_bf16 = 1); lse [bh, sq] f32 from the
// forward; lens [bh] int32 or null; seed one int32 on the device, or null
// for no dropout; thresh = int(rate * 2^24), keep_prob = 1 - rate. Each
// launches on `stream` and returns cudaGetLastError() (0 on success).

// Writes dq [bh, sq, d] (input dtype) and delta [bh, sq] f32.
extern "C" int flash_attention_bwd_dq(const void* q, const void* k,
                                      const void* v, const void* o,
                                      const void* dout, const float* lse,
                                      const int* lens, const int* seed,
                                      void* dq, float* delta, int bh, int sq,
                                      int sk, int d, int causal,
                                      float sm_scale, unsigned thresh,
                                      float keep_prob, int is_bf16,
                                      void* stream) {
  const Args a{q, k, v, o, dout, lse, nullptr, lens, seed, dq, nullptr,
               delta, bh, sq, sk, causal, sm_scale, thresh, keep_prob,
               static_cast<cudaStream_t>(stream)};
  return run<true>(a, d, is_bf16);
}

// Reads delta [bh, sq] f32 as flash_attention_bwd_dq wrote it; writes dk and
// dv [bh, sk, d] (input dtype).
extern "C" int flash_attention_bwd_dkv(const void* q, const void* k,
                                       const void* v, const void* dout,
                                       const float* lse, const float* delta,
                                       const int* lens, const int* seed,
                                       void* dk, void* dv, int bh, int sq,
                                       int sk, int d, int causal,
                                       float sm_scale, unsigned thresh,
                                       float keep_prob, int is_bf16,
                                       void* stream) {
  const Args a{q, k, v, nullptr, dout, lse, delta, lens, seed, dk, dv,
               nullptr, bh, sq, sk, causal, sm_scale, thresh, keep_prob,
               static_cast<cudaStream_t>(stream)};
  return run<false>(a, d, is_bf16);
}
