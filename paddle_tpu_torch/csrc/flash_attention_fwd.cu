// Flash-attention forward for Hopper (sm_90a), CUDA C++ with a plain C entry.
//
// Replaces the Pallas TPU kernel paddle_tpu/ops/pallas/flash_attention.py
// (_fwd_kernel, launched by _fwd_call). Same function: online-softmax
// attention over q/k/v laid out [B*H, S, D], bottom-right causal masking
// (key k visible to query row r when k <= r + sk - sq), per-(batch*head)
// key lengths, f32 accumulation and attention dropout. Writes o
// [B*H, Sq, D] in the input dtype and the row logsumexp lse [B*H, Sq] f32.
// A row with no visible key gives o = 0 and lse = -1e30. Dropout follows
// the TPU kernel's order (flash-attn v2): the row sum l is taken over the
// undropped p, and the kept p, scaled by 1/(1-rate) and rounded to the
// input dtype as the reference rounds it, weighs V; the keep mask is
// flash::dropout_keep (flash_common.cuh), which the backward
// kernels regenerate bit for bit. Neither kernel uses atomics: a second
// forward is bit-equal to the first.
//
// What bounds it on the H100: attention does 4 D FLOPs a visible (q, k)
// pair over q, k, v read and o, lse written once. At GPT's training shape
// (bf16, B=8 H=16 S=1024 D=64, causal: 67.2 M visible pairs) that is 17.2
// GFLOP, 0.0174 ms at the 989 TFLOP/s bf16 tensor-core peak, against 67.6
// MB, 0.0202 ms at 3.35 TB/s: bytes bound it. At ERNIE's (B=32 H=12
// S=512 D=64, non-causal: 100.7 M pairs) 25.8 GFLOP, 0.0261 ms, against
// 50.5 MB, 0.0151 ms: operations bound it. Beside the products every pair
// costs CUDA-core work the products wait on: an exp (one ex2 on the SFUs),
// a max and a sum, and with dropout the keep mask's dozen-op hash.
//
// bf16 (the training path, bf16 AMP): every product on the tensor cores,
// wgmma.mma_async m64n64k16, bf16 in, f32 accumulate (tensor_core.cuh; the
// tile machinery in flash_tc.cuh, shared with the backward):
//   - a block is two consumer warpgroups (one at D=256), each owning 64
//     query rows, 128 rows a block; Q stays resident in shared memory in
//     the 128-byte-swizzle layout;
//   - K/V tiles of 64 keys stream past Q through a ring of KV_STAGES
//     cp.async stages (three; two at D=256), so the next two tiles load
//     under this tile's products, one barrier a tile;
//   - S = Q.K^T with both operands from shared memory (K-major); the
//     online softmax runs in the accumulator registers, where a row's 64
//     values sit on the 4 threads of a quad: the row max and sum take two
//     shuffles, the exp is one ex2 with the scale folded in by
//     log2(e);
//   - P never touches shared memory: exp(s - m_new) is dropped by the keep
//     mask, scaled by 1/(1 - rate), rounded to bf16 and packed in place as
//     the A fragment of O += P.V (A from registers, V read MN-major); the
//     row sum l takes the undropped p, kept as each thread's partial sum
//     and reduced over the quad once, at the end;
//   - tiles wholly masked (causal, key length) are never loaded; only
//     diagonal and ragged tiles pay for the mask (the softmax is
//     instantiated with and without mask and dropout); causal grids launch
//     the longest query tiles first;
//   - o is divided by l once, at the end, and staged through shared memory
//     (over the Q tile) for 16-byte stores; lse = m + log(l);
//   - D = 256 keeps 64-row tiles, one warpgroup a block, and splits the
//     output columns over two blocks (each recomputes S), as the backward
//     does, so O fits in registers; D = 64 fits two blocks an SM.
//
// f16 (float16 AMP training, under a GradScaler): the bf16 kernel itself,
// instantiated for __half (flash_fwd_tc_kernel<D, T>): the same tiles,
// swizzle and geometry (both types are 2 bytes), wgmma.mma_async
// m64n64k16.f32.f16.f16, and p packed to f16 (cvt.rn.f16x2.f32) before
// P.V and o on store, as the reference rounds them to its input dtype.
// The rounding does not saturate: a value past 65504 becomes inf, as the
// reference's astype gives, which the step's finite check then sees. The
// bound is the bf16 one (the same bytes, the same 989 TFLOP/s peak).
//
// f32 (the serving prefill; not the training path): the tensor cores at
// the f32 bar, in 3xTF32 (mma.sync m16n8k8, tf32 in, f32 accumulate;
// tensor_core.cuh). Every f32 operand x is split as hi = tf32(x), lo =
// tf32(x - hi) (round to nearest, ties away, on 10 mantissa bits: the
// rounding of cvt.rna.tf32.f32, done as two integer instructions where
// cvt's SASS takes four) and a product is lo.hi + hi.lo + hi.hi, the
// dropped lo.lo ~2^-22 of it: errors near 1e-6 against the f32 twin, where
// one TF32 product would miss the bar of 1e-4. The least time is then
// three times the visible work at 495 TFLOP/s, or the bytes: 0.0129 ms
// (operations) at the serving prefill (B=1 H=16 S=1024 D=64, causal, key
// length 921: 8.31 M visible pairs), 0.104 ms at GPT's f32 shape (67.2 M);
// on the CUDA cores the same work's bound was 0.0318 and 0.257 ms.
//   - a block is 4 warps owning 64 query rows, 16 a warp; K/V tiles of 64
//     keys (32 at D=256, so two stages fit) stream through two cp.async
//     stages (16-byte copies, zero fill past the edge) into rows padded
//     to D + 8 (K, Q) and D + 4 (V) floats, so the fragment loads below
//     hit distinct banks; the next tile loads under this tile's products;
//   - S = Q.K^T: the contraction is relabelled inside each 8-dim step (its
//     columns t and t + 4 are dims 2t and 2t + 1) so a thread's Q and K
//     fragments are one float2 load a row; Q is split once into hi and lo
//     registers at D=64, and at each fragment load from shared memory at
//     D >= 128; K is split at fragment load;
//   - the online softmax runs in the S accumulator with the bf16 kernel's
//     code (the m16n8 accumulators of a warp have the m64n64 accumulator's
//     per-warp layout);
//   - P stays in registers: the accumulator gives a thread keys 2t and
//     2t + 1 of each 8-key slice, which become the A fragment's columns t
//     and t + 4 by reading V's rows 2t and 2t + 1 as the B fragment's rows
//     t and t + 4; the dropped p is split (not rounded: the reference's
//     f32 path does not round it) like any operand, V split at fragment
//     load;
//   - wholly masked tiles are never loaded, causal grids launch the
//     longest query tiles first, no atomics (a second call is bit-equal);
//     o (float2 stores from the accumulator) = acc / l, lse = m + log(l);
//   - D = 32 (DETR: d_model 256 over 8 heads) is the same kernel: 64-key
//     tiles, Q split once into registers as at D=64, rows padded to 40
//     (K, Q) and 36 (V) floats, which hit the banks 72 and 68 do; 48 KB of
//     shared memory a block, three blocks an SM (159 registers). At DETR's
//     encoder (B*H = 64, 1050 x 1050, non-causal; 9.03 GFLOP, 0.0547 ms
//     bound in 3xTF32) it takes 0.2013 ms held, 0.27 of the bound, against
//     SDPA's 0.54 in f32. A build for two blocks an SM (167 registers)
//     still resides three and times the same; one for four is capped at
//     128 registers, spills 48 bytes and runs 1.06x slower. No bf16 D = 32:
//     the wgmma tiles' 128-byte rows would need the 64-byte swizzle. Each
//     key tile's P.V is summed apart from zero and added to the running
//     sum in f32 (PV_APART): with every tile's products accumulated in the
//     one tensor-core sum, o read 1.005e-5 of max(1, |o|) from float64 at
//     the encoder's shape, apart 1.109e-6 (the twin 1.705e-6, D = 64
//     4.33e-6), for 0.2034 against 0.2008 ms held in turns (1.3 %; H100
//     80GB HBM3 at 700 W, chip_smoke.py phase flash-d32 and
//     --compare-fwd).
// Measured (chip_smoke.py --compare-fwd, H100 80GB HBM3 at 700 W, held):
// 0.067 ms at the serving prefill against the CUDA-core kernel's 0.343
// and SDPA's 0.19; at GPT's f32 shape the HMMAs run at 162 TFLOP/s of
// TF32, 0.55 of what back-to-back mma.sync m16n8k8 reaches (~300 TFLOP/s,
// 0.6 of the TF32 peak). Each warp reads the whole K and V tile from
// shared memory (32 KB a 64-key tile at D=64, about the HMMAs' own time at
// 128 bytes a cycle), beside ~4 CUDA-core instructions a split element.
// Variants measured no faster (within 7 % at GPT's shape, up to 16 %
// slower elsewhere): Q split at each load at D=64 (fewer registers, still
// two blocks an SM), 32-key tiles at three stages and three blocks an SM,
// the three products of a tile ordered term by term across its slices,
// and K/V split once a block into hi and lo tiles in shared memory (a
// quarter of the split, twice the fragment loads).
//
// ptxas (-Xptxas -v, sm_90a, CUDA 12.8 on the H100), registers a thread
// and spill stores (chip_smoke.py's build phase prints them for every
// instantiation):
//   bf16 (wgmma) D=64: 128 (two blocks an SM), 0; D=128: 221, 0;
//   D=256: 254, 0
//   f32 (3xTF32) D=32: 159 (three blocks an SM), 0; D=64: 227 (two
//   blocks an SM), 0; D=128: 249, 0; D=256: 255, 24 bytes
// SASS (cuobjdump -sass of the built library; chip_smoke.py's build phase
// counts the straight-line blocks that run a tile's 32 exps a thread),
// bf16 D=64, over the 32 (q, k) pairs a thread owns in a tile:
//   no dropout: 117 instructions, 3.7 a pair (34 ex2, 76 float, 4
//     shuffles), in each of the two variants (masked and not);
//   dropout: 586 and 571 instructions in the two variants, 18.3 and 17.8
//     a pair, of which 391 integer (12.2 a pair: the keep mask's hash)
//     and 140 float.
// The f32 kernel's SASS (the build phase counts it and fails on fewer TF32
// HMMAs than FFMAs): HMMA.1688.F32.TF32 192 at D=32, 384 at D=64 (192
// for S, 192 for P.V, a 64-key tile), 768 at D=128 and D=256; FFMA 175 at
// D=32, 64 and 128, 111 at D=256, all the softmax's.
// So with dropout the hash is what the bf16 products wait on (0.1136
// against 0.0688 ms held at GPT's shape, PERF.md section 6). Running a
// warpgroup's next S product under this tile's softmax (wgmma.wait_group
// after both, three stages at every D) measured 5-13 % slower at two
// blocks an SM and 23-52 % slower at one: each product is waited for at
// once, and the four warpgroups an SM interleave one's products with
// another's softmax.
//
// A dense attention mask (flash::DenseMask: a bool keep-mask or an f32,
// bf16 or f16 bias read through its four strides) runs each kernel's
// DENSE instantiation, which the C entry picks when it is given a mask:
// the reference's dense path's function, not the TPU kernel's (which
// takes no mask). Each tile's scores are scaled and biased (or hidden at
// -inf) before the online softmax, whose max starts at -FLT_MAX and whose
// p subtracts first, so a bias of -3.4e38 adds as the reference adds it;
// no tile is skipped on the mask's account. A row with no visible key
// gives NaN o and lse, as the reference's softmax of a row of -inf. lse
// becomes a [2, bh, sq] pair (hi, lo; flash::two_sum), since a row biased
// whole sits at -3.4e38 and keeps its log-sum only in lo. The DENSE
// bf16/f16 kernel runs one block an SM at D = 64, where two spilled.
// Measured (chip_smoke.py phase masked-flash, H100 80GB HBM3 at 700 W):
// bf16 at ERNIE's fine-tune shape (32 x 12 x 128 x 128, D = 64, its
// padding mask, dropout 0.1) 0.0373 ms against 0.0220 unmasked, and
// at GPT's (8 x 16 x 1024, causal + left padding) 0.2030 against 0.0688:
// the per-element mask reads and address arithmetic are CUDA-core work
// the products wait on (PERF.md section 7).

#include "flash_common.cuh"
#include "flash_tc.cuh"

namespace {

using bf16 = __nv_bfloat16;
using flash::DenseMask;
using flash::kLowest;
using flash::kNegInf;
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

// -- the online softmax, in the accumulator of either kernel ----------------

// 2^x on the SFU (ex2.approx, flushing subnormal results to 0): exp2f's
// range handling around it is CUDA-core work the products would wait on
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The online softmax of one tile, in place in the accumulator s of one
// warpgroup (the element of index i at row `row0 + 8 h`, h = (i / 2) % 2,
// column `col0 + 8 (i / 4) + i % 2`, both absolute): m (the row max of the
// raw scores so far), l (this thread's part of the row sum) and the
// factor alpha that rescales O; s becomes the dropped p as the next
// product takes it. Masked scores are -inf, so their p is exactly 0, also
// in a row with no visible key yet (m stays at the finite -1e30). DENSE
// (a dense mask's kernels): the scores come scaled, biased and as low as
// -3.4e38, m starts at kLowest, and p = 2^((s - m) log2 e) subtracts
// first, where s log2 e would overflow.
template <bool MASK, bool DROP, bool DENSE, int N>
__device__ __forceinline__ void online_softmax(
    float (&s)[N], float (&m)[2], float (&l)[2], float (&alpha)[2],
    int row0, int col0, float scale_log2, int sq, int sk, int kv_len,
    int causal, uint32_t mix, uint32_t thresh, float inv_keep) {
  const int offset = sk - sq;
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int h = (i >> 1) & 1;
    if (MASK) {
      const int r = row0 + 8 * h, c = col0 + 8 * (i >> 2) + (i & 1);
      if (!(c < kv_len && (!causal || c <= r + offset)))
        s[i] = __uint_as_float(0xff800000u);  // -inf
    }
    mx[h] = fmaxf(mx[h], s[i]);
  }
  float mb[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    alpha[h] = ex2((m[h] - mx[h]) * scale_log2);
    m[h] = mx[h];
    mb[h] = mx[h] * scale_log2;
  }
  float ps[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int h = (i >> 1) & 1;
    const float p = DENSE ? ex2((s[i] - mx[h]) * scale_log2)
                          : ex2(fmaf(s[i], scale_log2, -mb[h]));
    ps[h] += p;  // the row sum takes the undropped p
    float pd = p;
    if (DROP) {
      const int r = row0 + 8 * h, c = col0 + 8 * (i >> 2) + (i & 1);
      pd = flash::dropout_keep(mix, r, c, sk, thresh) ? p * inv_keep : 0.f;
    }
    s[i] = pd;
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + ps[h];
}

template <bool MASK, bool DENSE, int N>
__device__ __forceinline__ void online_softmax_drop(
    bool drop, float (&s)[N], float (&m)[2], float (&l)[2],
    float (&alpha)[2], int row0, int col0, float scale_log2, int sq, int sk,
    int kv_len, int causal, uint32_t mix, uint32_t thresh, float inv_keep) {
  if (drop)
    online_softmax<MASK, true, DENSE>(s, m, l, alpha, row0, col0, scale_log2,
                                      sq, sk, kv_len, causal, mix, thresh,
                                      inv_keep);
  else
    online_softmax<MASK, false, DENSE>(s, m, l, alpha, row0, col0,
                                       scale_log2, sq, sk, kv_len, causal,
                                       mix, thresh, inv_keep);
}

// -- the dense mask (the DENSE instantiations) --------------------------------

// The dense mask on one tile of raw scores before its online softmax: they
// become the scaled scores plus a float mask's bias (the softmax then runs
// at scale 1), -inf where a bool mask is false. No tile is skipped on the
// mask's account: each is read and applied as it comes.
template <int N>
__device__ __forceinline__ void dense_mask(float (&s)[N], const DenseMask& dm,
                                           long long mbase, int row0,
                                           int col0, int sq, int sk,
                                           float sm_scale) {
  const uint32_t hidden = flash::mask_tile<false>(s, dm, mbase, row0, col0,
                                                  sq, sk, sm_scale);
#pragma unroll
  for (int i = 0; i < N; ++i)
    if ((hidden >> i) & 1u) s[i] = __uint_as_float(0xff800000u);  // -inf
}

// o's factor of a row with no visible key: 1 (o = 0, the TPU kernel's
// answer under kv_lens), NaN under a dense mask, as the reference's dense
// path gives (the softmax of a row of -inf)
template <bool DENSE>
__device__ __forceinline__ float empty_scale() {
  return DENSE ? __uint_as_float(0x7fc00000u) : 1.f;
}

// lse of row `at` from its max m (of the scaled scores) and sum l: m +
// log(l), or -1e30 with no visible key; under a dense mask hi and lo of
// flash::two_sum (lo into dm.lo), NaN and NaN with no visible key
template <bool DENSE>
__device__ __forceinline__ void store_lse(float* lse, const DenseMask& dm,
                                          size_t at, float m, float l) {
  if constexpr (DENSE) {
    float hi = __uint_as_float(0x7fc00000u), lo = hi;
    if (l != 0.f) flash::two_sum(m, logf(l), hi, lo);
    lse[at] = hi;
    dm.lo[at] = lo;
  } else {
    lse[at] = l == 0.f ? kNegInf : m + logf(l);
  }
}

// -- bf16 and f16: tensor cores (wgmma) -------------------------------------

// two blocks an SM at D = 64 cap a thread at 128 registers, where the
// DENSE kernel spilled 100 bytes: it runs one
template <bool DENSE, int D, typename T>
__global__ void __launch_bounds__(Tc<D>::NT, DENSE ? 1 : Tc<D>::FWD_BLOCKS)
flash_fwd_tc_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ lens,
                    T* __restrict__ o, float* __restrict__ lse, int sq,
                    int sk, int causal, float sm_scale,
                    const int* __restrict__ seed, uint32_t thresh,
                    float keep_prob, const DenseMask dm) {
  using G = Tc<D>;
  constexpr int NS = G::KV_STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint8_t* qs = smem;
  uint8_t* stages = smem + G::OWN;

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
    uint8_t* st = stages + (t % NS) * (2 * G::STREAM);
    load_tile<G::BS, D, G::NT>(st, k + kv_base, t * G::BS, sk, tid);
    load_tile<G::BS, D, G::NT>(st + G::STREAM, v + kv_base, t * G::BS, sk,
                               tid);
  };
  // group s < NS - 1 holds tile s (group 0 also Q): the ring runs NS - 1
  // tiles ahead of the products
  load_tile<G::ROWS, D, G::NT>(qs, q + q_base, q0, sq, tid);
#pragma unroll
  for (int s = 0; s < NS - 1; ++s) {
    if (s < n_tiles) load_kv(s);
    tc::cp_async_commit();
  }

  // this thread's rows of the accumulators: row + 8 h, h < 2
  const int wrow = wg * 64;                // in the block tile
  const int row = wrow + warp * 16 + lane / 4;
  const int wq0 = q0 + wrow;               // first query of the warpgroup
  int wkend = kv_len;  // the warpgroup's own key end
  if (causal) wkend = min(wkend, min(wq0 + 63, sq - 1) + offset + 1);
  const bool wg_live = wq0 < sq;
  // under a dense mask the softmax runs on the scaled (biased) scores
  const float mscale = DENSE ? 1.f : sm_scale;
  const float scale_log2 = mscale * kLog2e;
  const long long mbase = DENSE ? flash::mask_base(dm, bh) : 0;
  const bool drop = seed != nullptr;
  const uint32_t mix = drop ? flash::dropout_mix(*seed, bh) : 0u;
  const float inv_keep = 1.f / keep_prob;

  float acc[G::NB][32];
#pragma unroll
  for (int c = 0; c < G::NB; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[c][i] = 0.f;
  const float m0 = DENSE ? kLowest : kNegInf;
  float m[2] = {m0, m0}, l[2] = {0.f, 0.f};

  for (int t = 0; t < n_tiles; ++t) {
    // tile t has landed, and every warpgroup is done with tile t - 1,
    // whose stage the load below refills
    tc::cp_async_wait<NS - 2>();
    fence_async_smem();
    __syncthreads();
    if (t + NS - 1 < n_tiles) load_kv(t + NS - 1);
    tc::cp_async_commit();
    const int key0 = t * G::BS;
    const uint8_t* kst = stages + (t % NS) * (2 * G::STREAM);
    if (wg_live && key0 < wkend) {
      float s[32];
      tc::wgmma_fence();
      product_ss<D, T>(s, qs, wrow, kst);
      tc::wgmma_commit();
      tc::wgmma_wait<0>();
      fence_acc(s);
      const bool mask = key0 + G::BS > kv_len ||
                        (causal && key0 + G::BS - 1 > wq0 + offset);
      float alpha[2];
      const int row0 = q0 + row, col0_s = key0 + 2 * (lane % 4);
      if constexpr (DENSE) dense_mask(s, dm, mbase, row0, col0_s, sq, sk,
                                      sm_scale);
      if (mask)
        online_softmax_drop<true, DENSE>(drop, s, m, l, alpha, row0, col0_s,
                                         scale_log2, sq, sk, kv_len, causal,
                                         mix, thresh, inv_keep);
      else
        online_softmax_drop<false, DENSE>(drop, s, m, l, alpha, row0,
                                          col0_s, scale_log2, sq, sk, kv_len,
                                          causal, mix, thresh, inv_keep);
      uint32_t pf[16];
      to_frags<T>(s, pf);  // p rounded to T, as the reference rounds it
#pragma unroll
      for (int c = 0; c < G::NB; ++c) {
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[c][i] *= alpha[(i >> 1) & 1];
        fence_acc(acc[c]);
      }
      tc::wgmma_fence();
      product_rs<D, T>(acc, pf, kst + G::STREAM, col0);
      tc::wgmma_commit();
      tc::wgmma_wait<0>();
#pragma unroll
      for (int c = 0; c < G::NB; ++c) fence_acc(acc[c]);
    }
  }

  // the row sums over the quad; o = acc / l, lse = m + log(l) (a row with
  // no visible key: o = 0, lse = -1e30; under a dense mask both NaN)
  float inv_l[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    inv_l[h] = l[h] == 0.f ? empty_scale<DENSE>() : 1.f / l[h];
    const int r = q0 + row + 8 * h;
    if (lane % 4 == 0 && col0 == 0 && r < sq)
      store_lse<DENSE>(lse, dm, (size_t)bh * sq + r, m[h] * mscale, l[h]);
  }
#pragma unroll
  for (int c = 0; c < G::NB; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[c][i] *= inv_l[(i >> 1) & 1];
  tc::cp_async_wait<0>();
  __syncthreads();  // every product has read Q: its tile stages o
  stage_out<D, T>(qs, acc, 1.f, row);
  __syncthreads();
  store_out<D>(o + q_base, qs, q0, sq, col0);
}

// -- f32: tensor cores in 3xTF32 (mma.sync m16n8k8) ------------------------

// tile geometry of the f32 kernel at head dim D
template <int D>
struct F32 {
  static constexpr int NW = 4;                   // warps a block
  static constexpr int NT = NW * 32;             // threads a block
  static constexpr int ROWS = NW * 16;           // query rows a block
  static constexpr int BK = D == 256 ? 32 : 64;  // keys a streamed tile
  static constexpr int NS = 2;                   // cp.async stages
  // Q split once into registers (hi and lo fragments); at D >= 128 it is
  // split at each fragment load from shared memory instead
  static constexpr bool Q_REGS = D <= 64;
  // a tile's P.V summed apart (from zero) and added to the running sum in
  // f32: the tensor cores' f32 accumulation drops low bits, which over
  // DETR's 1050 keys put D = 32 at 1e-5 of max(1, |o|) from float64 when
  // every tile's products ran into the one sum (16 more registers)
  static constexpr bool PV_APART = D == 32;
  // row pitches in floats: a half-warp's float2 loads of Q or K (rows g,
  // columns 2t) and a warp's loads of V (rows 2t, columns g) each hit
  // distinct banks
  static constexpr int KP = D + 8;
  static constexpr int VP = D + 4;
  static constexpr int QS = ROWS * KP;  // floats of the Q tile
  static constexpr int KS = BK * KP;    // floats of a K tile
  static constexpr int STAGE = KS + BK * VP;
  static constexpr int SMEM = (QS + NS * STAGE) * 4;
  // blocks an SM: two at D=64; at D=32 (48 KB of shared memory a block)
  // three, where shared memory would hold four: four cap a thread at 128
  // registers and spill (1.06x slower at DETR's encoder), and that grid
  // (64 x 17 = 1088 blocks) fills 2.75 waves of 396 blocks at three
  // against 2.06 of 528 at four
  static constexpr int BLOCKS = D == 32 ? 3 : D == 64 ? 2 : 1;
  static_assert(BLOCKS * SMEM <= 232448, "f32 forward shared memory");
};

// The A fragment (rows g and g + 8 of a warp's 16) of contraction step kk
// over the Q tile in shared memory, split into hi and lo. The contraction
// is relabelled inside each step: its columns t and t + 4 are the dims
// 8 kk + 2t and 8 kk + 2t + 1, one float2 load a row (K's B fragment
// uses the same labels).
template <int D>
__device__ __forceinline__ void q_frag(const float* qrow, int kk, int t,
                                       uint32_t (&ah)[4], uint32_t (&al)[4]) {
  const float2 x0 =
      *reinterpret_cast<const float2*>(qrow + 8 * kk + 2 * t);
  const float2 x1 =
      *reinterpret_cast<const float2*>(qrow + 8 * F32<D>::KP + 8 * kk + 2 * t);
  tc::split_tf32(x0.x, ah[0], al[0]);
  tc::split_tf32(x1.x, ah[1], al[1]);
  tc::split_tf32(x0.y, ah[2], al[2]);
  tc::split_tf32(x1.y, ah[3], al[3]);
}

// A block owns 64 query rows (16 a warp) of one batch*head; K/V tiles of
// BK keys stream through NS cp.async stages; each warp computes S = Q.K^T
// and O += P.V for its rows with mma.sync m16n8k8 in 3xTF32, the online
// softmax in the S accumulator, and P kept in registers: the accumulator
// gives a thread keys 2t and 2t + 1 of each 8-key slice, which become the
// A fragment's columns t and t + 4 by reading V's rows 2t and 2t + 1 as
// the B fragment's rows t and t + 4.
template <bool DENSE, int D>
__global__ void __launch_bounds__(F32<D>::NT, F32<D>::BLOCKS)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const int* __restrict__ lens,
                     float* __restrict__ o, float* __restrict__ lse, int sq,
                     int sk, int causal, float sm_scale,
                     const int* __restrict__ seed, uint32_t thresh,
                     float keep_prob, const DenseMask dm) {
  using G = F32<D>;
  constexpr int NS = G::NS, BK = G::BK;
  constexpr int NJ = BK / 8;  // 8-key slices of a tile
  constexpr int ND = D / 8;   // 8-dim steps of S, 8-column blocks of O
  extern __shared__ __align__(16) float smem_f[];
  float* qs = smem_f;
  float* stages = smem_f + G::QS;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int bh = blockIdx.x;
  // the longest blocks first: under the causal mask the last query tile
  // sees the most keys
  const int q0 = (gridDim.y - 1 - blockIdx.y) * G::ROWS;
  const int offset = sk - sq;
  const int kv_len = lens != nullptr ? min(lens[bh], sk) : sk;
  int kend = kv_len;  // keys past kend are masked for every row
  if (causal) kend = min(kend, min(q0 + G::ROWS, sq) - 1 + offset + 1);
  const int n_tiles = kend > 0 ? (kend + BK - 1) / BK : 0;
  const size_t q_base = (size_t)bh * sq * D;
  const size_t kv_base = (size_t)bh * sk * D;

  auto load_kv = [&](int tt) {
    float* st = stages + (tt % NS) * G::STAGE;
    load_rows<BK, D, G::KP, G::NT>(st, k + kv_base, tt * BK, sk, tid);
    load_rows<BK, D, G::VP, G::NT>(st + G::KS, v + kv_base, tt * BK, sk,
                                   tid);
  };
  // group s < NS - 1 holds tile s (group 0 also Q)
  load_rows<G::ROWS, D, G::KP, G::NT>(qs, q + q_base, q0, sq, tid);
#pragma unroll
  for (int s = 0; s < NS - 1; ++s) {
    if (s < n_tiles) load_kv(s);
    tc::cp_async_commit();
  }

  const int wrow = warp * 16;  // the warp's first row in the block tile
  const int wq0 = q0 + wrow;
  int wkend = kv_len;  // the warp's own key end
  if (causal) wkend = min(wkend, min(wq0 + 15, sq - 1) + offset + 1);
  const bool live = wq0 < sq;
  const float* qrow = qs + (wrow + g) * G::KP;
  // under a dense mask the softmax runs on the scaled (biased) scores
  const float mscale = DENSE ? 1.f : sm_scale;
  const float scale_log2 = mscale * kLog2e;
  const long long mbase = DENSE ? flash::mask_base(dm, bh) : 0;
  const bool drop = seed != nullptr;
  const uint32_t mix = drop ? flash::dropout_mix(*seed, bh) : 0u;
  const float inv_keep = 1.f / keep_prob;

  uint32_t qh[G::Q_REGS ? ND : 1][4], ql[G::Q_REGS ? ND : 1][4];
  float acc[ND][4];
#pragma unroll
  for (int c = 0; c < ND; ++c)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[c][i] = 0.f;
  const float m0 = DENSE ? kLowest : kNegInf;
  float m[2] = {m0, m0}, l[2] = {0.f, 0.f};

  for (int tt = 0; tt < n_tiles; ++tt) {
    // tile tt has landed, and every warp is done with tile tt - 1, whose
    // stage the load below refills
    tc::cp_async_wait<NS - 2>();
    __syncthreads();
    if (tt + NS - 1 < n_tiles) load_kv(tt + NS - 1);
    tc::cp_async_commit();
    if constexpr (G::Q_REGS) {
      if (tt == 0) {
#pragma unroll
        for (int kk = 0; kk < ND; ++kk) q_frag<D>(qrow, kk, t, qh[kk], ql[kk]);
      }
    }
    const int key0 = tt * BK;
    if (!live || key0 >= wkend) continue;
    const float* ks = stages + (tt % NS) * G::STAGE;
    const float* vs = ks + G::KS;

    float s[NJ * 4];
#pragma unroll
    for (int i = 0; i < NJ * 4; ++i) s[i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < ND; ++kk) {
      uint32_t ah[4], al[4];
      if constexpr (G::Q_REGS) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          ah[i] = qh[kk][i];
          al[i] = ql[kk][i];
        }
      } else {
        q_frag<D>(qrow, kk, t, ah, al);
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float2 kx = *reinterpret_cast<const float2*>(
            ks + (8 * j + g) * G::KP + 8 * kk + 2 * t);
        uint32_t bh_[2], bl_[2];
        tc::split_tf32(kx.x, bh_[0], bl_[0]);
        tc::split_tf32(kx.y, bh_[1], bl_[1]);
        tc::mma_3xtf32(s + 4 * j, ah, al, bh_, bl_);
      }
    }

    const bool mask = key0 + BK > kv_len ||
                      (causal && key0 + BK - 1 > wq0 + offset);
    float alpha[2];
    const int row0 = wq0 + g, col0 = key0 + 2 * t;
    if constexpr (DENSE) dense_mask(s, dm, mbase, row0, col0, sq, sk,
                                    sm_scale);
    if (mask)
      online_softmax_drop<true, DENSE>(drop, s, m, l, alpha, row0, col0,
                                       scale_log2, sq, sk, kv_len, causal,
                                       mix, thresh, inv_keep);
    else
      online_softmax_drop<false, DENSE>(drop, s, m, l, alpha, row0, col0,
                                        scale_log2, sq, sk, kv_len, causal,
                                        mix, thresh, inv_keep);
    // the tile's P.V lands in pv (PV_APART), else in the rescaled acc
    float pv[G::PV_APART ? ND : 1][4];
#pragma unroll
    for (int c = 0; c < ND; ++c)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if constexpr (G::PV_APART)
          pv[c][i] = 0.f;
        else
          acc[c][i] *= alpha[i >> 1];
      }

    // O += P.V: the dropped p is not rounded (the reference's f32 path
    // does not round it) but split like any operand
#pragma unroll
    for (int kk = 0; kk < NJ; ++kk) {
      uint32_t ah[4], al[4];
      tc::split_tf32(s[4 * kk + 0], ah[0], al[0]);
      tc::split_tf32(s[4 * kk + 2], ah[1], al[1]);
      tc::split_tf32(s[4 * kk + 1], ah[2], al[2]);
      tc::split_tf32(s[4 * kk + 3], ah[3], al[3]);
      const float* v0 = vs + (8 * kk + 2 * t) * G::VP + g;
#pragma unroll
      for (int c = 0; c < ND; ++c) {
        uint32_t bh_[2], bl_[2];
        tc::split_tf32(v0[8 * c], bh_[0], bl_[0]);
        tc::split_tf32(v0[G::VP + 8 * c], bh_[1], bl_[1]);
        if constexpr (G::PV_APART)
          tc::mma_3xtf32(pv[c], ah, al, bh_, bl_);
        else
          tc::mma_3xtf32(acc[c], ah, al, bh_, bl_);
      }
    }
    if constexpr (G::PV_APART) {
      // a multiply and an add (no FFMA: the build phase reads the FFMAs
      // as CUDA-core product work against the TF32 HMMAs)
#pragma unroll
      for (int c = 0; c < ND; ++c)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          acc[c][i] = __fadd_rn(__fmul_rn(acc[c][i], alpha[i >> 1]),
                                pv[c][i]);
    }
  }
  tc::cp_async_wait<0>();

  // the row sums over the quad; o = acc / l, lse = m + log(l) (a row with
  // no visible key: o = 0, lse = -1e30; under a dense mask both NaN)
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    const float inv_l = l[h] == 0.f ? empty_scale<DENSE>() : 1.f / l[h];
    const int r = wq0 + g + 8 * h;
    if (r >= sq) continue;
    if (t == 0)
      store_lse<DENSE>(lse, dm, (size_t)bh * sq + r, m[h] * mscale, l[h]);
    float* orow = o + q_base + (size_t)r * D + 2 * t;
#pragma unroll
    for (int c = 0; c < ND; ++c)
      *reinterpret_cast<float2*>(orow + 8 * c) =
          make_float2(acc[c][2 * h] * inv_l, acc[c][2 * h + 1] * inv_l);
  }
}

// -- launch -----------------------------------------------------------------

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int* lens;
  void* o;
  float* lse;
  int bh, sq, sk, causal;
  float sm_scale;
  const int* seed;
  uint32_t thresh;
  float keep_prob;
  DenseMask dm;
  cudaStream_t stream;
};

template <bool DENSE, int D>
int launch_f32(const Args& a) {
  using G = F32<D>;
  const int tiles = (a.sq + G::ROWS - 1) / G::ROWS;
  if (tiles > 65535) return (int)cudaErrorInvalidValue;
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_f32_kernel<DENSE, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
  if (attr != cudaSuccess) return (int)attr;
  flash_fwd_f32_kernel<DENSE, D><<<dim3(a.bh, tiles), G::NT, G::SMEM,
                                   a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), a.lens, static_cast<float*>(a.o),
      a.lse, a.sq, a.sk, a.causal, a.sm_scale, a.seed, a.thresh,
      a.keep_prob, a.dm);
  return 0;
}

template <bool DENSE, int D, typename T>
int launch_tc(const Args& a) {
  using G = Tc<D>;
  const long long tiles =
      (long long)(a.sq + G::ROWS - 1) / G::ROWS * G::SPLIT;
  if (tiles > 65535) return (int)cudaErrorInvalidValue;
  // above 48 KB of dynamic shared memory needs the opt-in, once
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_tc_kernel<DENSE, D, T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, G::FWD_SMEM);
  if (attr != cudaSuccess) return (int)attr;
  flash_fwd_tc_kernel<DENSE, D, T><<<dim3(a.bh, (unsigned)tiles), G::NT,
                                     G::FWD_SMEM, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), a.lens, static_cast<T*>(a.o), a.lse,
      a.sq, a.sk, a.causal, a.sm_scale, a.seed, a.thresh, a.keep_prob,
      a.dm);
  return 0;
}

// dtype: 0 f32, 1 bf16, 2 f16
template <bool DENSE, int D>
int launch(const Args& a, int dtype) {
  switch (dtype) {
    case 0: return launch_f32<DENSE, D>(a);
    case 1: return launch_tc<DENSE, D, bf16>(a);
    case 2: return launch_tc<DENSE, D, __half>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <bool DENSE>
int run(const Args& a, int d, int dtype) {
  switch (d) {
    // head_dim 32 (DETR's): the f32 forward only
    case 32:
      return dtype ? (int)cudaErrorInvalidValue : launch_f32<DENSE, 32>(a);
    case 64: return launch<DENSE, 64>(a, dtype);
    case 128: return launch<DENSE, 128>(a, dtype);
    case 256: return launch<DENSE, 256>(a, dtype);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v, o: [bh, s, d] contiguous, f32 (dtype = 0), bf16 (dtype = 1) or
// f16 (dtype = 2); d is 64, 128 or 256, and also 32 in f32;
// lens: [bh] int32 or null; lse: [bh, sq] f32; seed: one int32 on the
// device, or null for no dropout; thresh = int(rate * 2^24) and
// keep_prob = 1 - rate; mask: the dense mask (flash::DenseMask: mask_kind
// 1 bool, 2 f32, 3 bf16, 4 f16; bh = b * heads + h; element strides msb,
// msh, msr, msc), or null: with one the DENSE kernels run and lse is [2,
// bh, sq], the log-sum-exp's hi and lo (flash::two_sum). Launches on
// `stream` and returns cudaGetLastError() (0 on success).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   const int* lens, void* o, float* lse, int bh,
                                   int sq, int sk, int d, int causal,
                                   float sm_scale, const int* seed,
                                   unsigned thresh, float keep_prob,
                                   int dtype, const void* mask, int mask_kind,
                                   int heads, long long msb, long long msh,
                                   long long msr, long long msc,
                                   void* stream) {
  if (bh <= 0 || sq <= 0 || sk <= 0 || bh > 65535) return (int)cudaErrorInvalidValue;
  const DenseMask dm{mask, msb, msh, msr, msc, heads, mask_kind,
                     lse + (size_t)bh * sq};
  if (mask != nullptr && !flash::mask_ok(dm)) return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, lens, o, lse, bh, sq, sk, causal, sm_scale, seed,
               thresh, keep_prob, dm, static_cast<cudaStream_t>(stream)};
  const int err = mask != nullptr ? run<true>(a, d, dtype)
                                  : run<false>(a, d, dtype);
  if (err) return err;
  return (int)cudaGetLastError();
}
