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
// f32 (serving prefill, not the training path): the CUDA cores, not TF32,
// which would break the f32 bar of 1e-4: 4 threads share a row, each
// owning D/4 of its dims in registers; K and V are staged tile by tile in
// shared memory (4096 values a tile) and read by all 64 rows of a block.
//
// ptxas (-Xptxas -v, sm_90a, CUDA 12.8 on the H100), registers a thread
// and spill stores (chip_smoke.py's build phase prints them for every
// instantiation):
//   bf16 (wgmma) D=64: 128 (two blocks an SM), 0; D=128: 221, 0;
//   D=256: 254, 0
//   f32 (CUDA cores) D=64: 218; D=128: 172; D=256: 243; no spills
// SASS (cuobjdump -sass of the built library; chip_smoke.py's build phase
// counts the straight-line blocks that run a tile's 32 exps a thread),
// bf16 D=64, over the 32 (q, k) pairs a thread owns in a tile:
//   no dropout: 117 instructions, 3.7 a pair (34 ex2, 76 float, 4
//     shuffles), in each of the two variants (masked and not);
//   dropout: 586 and 571 instructions in the two variants, 18.3 and 17.8
//     a pair, of which 391 integer (12.2 a pair: the keep mask's hash)
//     and 140 float.
// So with dropout the hash is what the products wait on (0.1136 against
// 0.0688 ms held at GPT's shape, PERF.md section 6). Running a
// warpgroup's next S product under this tile's softmax (wgmma.wait_group
// after both, three stages at every D) measured 5-13 % slower at two
// blocks an SM and 23-52 % slower at one: each product is waited for at
// once, and the four warpgroups an SM interleave one's products with
// another's softmax.

#include "flash_common.cuh"
#include "flash_tc.cuh"

namespace {

using bf16 = __nv_bfloat16;
using flash::kNegInf;
using flash::load4;
using flash::store4;

// -- f32: CUDA cores --------------------------------------------------------

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = kThreads / 4;
constexpr int kTileElems = 4096;

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const int* __restrict__ lens,
                 float* __restrict__ o, float* __restrict__ lse, int sq,
                 int sk, int causal, float sm_scale,
                 const int* __restrict__ seed, uint32_t thresh,
                 float keep_prob) {
  constexpr int BK = kTileElems / D;  // keys per tile
  constexpr int V4 = D / 16;          // float4 chunks of a row per thread
  constexpr int CHUNKS = D / 4;       // float4 chunks per row
  __shared__ __align__(16) float ks[kTileElems];
  __shared__ __align__(16) float vs[kTileElems];

  const int bh = blockIdx.y;
  const int tid = threadIdx.x;
  const int r = tid & 3;  // this thread's quarter of the row
  const int row = blockIdx.x * kRowsPerBlock + (tid >> 2);
  const bool row_ok = row < sq;
  const int offset = sk - sq;

  int kv_len = lens != nullptr ? min(lens[bh], sk) : sk;
  int kend = kv_len;
  if (causal) {
    const int last_row = min((blockIdx.x + 1) * kRowsPerBlock, sq) - 1;
    kend = min(kend, last_row + offset + 1);
  }
  // last key this row may see (inclusive)
  const int row_limit = causal ? row + offset : sk;
  const bool drop = seed != nullptr;
  const uint32_t mix = drop ? flash::dropout_mix(*seed, bh) : 0u;

  const size_t q_base = (size_t)bh * sq * D;
  const size_t kv_base = (size_t)bh * sk * D;

  // thread r owns float4 chunks c = 4*i + r: the 4 threads of a row read
  // 64 contiguous bytes of a shared-memory row, conflict-free
  float qr[4 * V4];
  float acc[4 * V4];
#pragma unroll
  for (int i = 0; i < V4; ++i) {
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row_ok) x = load4(q + q_base + (size_t)row * D + (4 * i + r) * 4);
    qr[4 * i + 0] = x.x * sm_scale;
    qr[4 * i + 1] = x.y * sm_scale;
    qr[4 * i + 2] = x.z * sm_scale;
    qr[4 * i + 3] = x.w * sm_scale;
    acc[4 * i + 0] = acc[4 * i + 1] = acc[4 * i + 2] = acc[4 * i + 3] = 0.f;
  }
  float m = kNegInf;
  float l = 0.f;

  for (int k0 = 0; k0 < kend; k0 += BK) {
    __syncthreads();  // the previous tile is consumed
#pragma unroll
    for (int j = 0; j < kTileElems / 4 / kThreads; ++j) {
      const int c = tid + j * kThreads;
      const int key = c / CHUNKS;
      const int col = (c % CHUNKS) * 4;
      const int kpos = k0 + key;
      float4 kx = make_float4(0.f, 0.f, 0.f, 0.f);
      float4 vx = kx;
      if (kpos < kv_len) {
        kx = load4(k + kv_base + (size_t)kpos * D + col);
        vx = load4(v + kv_base + (size_t)kpos * D + col);
      }
      store4(ks + key * D + col, kx);
      store4(vs + key * D + col, vx);
    }
    __syncthreads();

    float s[BK];
    float tile_max = kNegInf;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const float* kr = ks + j * D;
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < V4; ++i) {
        const float4 x = *reinterpret_cast<const float4*>(kr + (4 * i + r) * 4);
        part += qr[4 * i] * x.x + qr[4 * i + 1] * x.y + qr[4 * i + 2] * x.z +
                qr[4 * i + 3] * x.w;
      }
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      const int kpos = k0 + j;
      const bool ok = kpos < kv_len && kpos <= row_limit;
      s[j] = ok ? part : kNegInf;
      tile_max = fmaxf(tile_max, s[j]);
    }
    const float m_new = fmaxf(m, tile_max);
    const float alpha = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      // masked keys contribute exactly 0, also in a row with no key yet
      const float p = s[j] > 0.5f * kNegInf ? expf(s[j] - m_new) : 0.f;
      psum += p;  // the row sum takes the undropped p
      float p_drop = p;
      if (drop)
        p_drop = flash::dropout_keep(mix, row, k0 + j, sk, thresh)
                     ? p / keep_prob : 0.f;
      s[j] = p_drop;
    }
    l = l * alpha + psum;
#pragma unroll
    for (int i = 0; i < 4 * V4; ++i) acc[i] *= alpha;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const float* vr = vs + j * D;
      const float p = s[j];
#pragma unroll
      for (int i = 0; i < V4; ++i) {
        const float4 x = *reinterpret_cast<const float4*>(vr + (4 * i + r) * 4);
        acc[4 * i + 0] += p * x.x;
        acc[4 * i + 1] += p * x.y;
        acc[4 * i + 2] += p * x.z;
        acc[4 * i + 3] += p * x.w;
      }
    }
    m = m_new;
  }

  if (row_ok) {
    const float safe_l = l == 0.f ? 1.f : l;
#pragma unroll
    for (int i = 0; i < V4; ++i) {
      store4(o + q_base + (size_t)row * D + (4 * i + r) * 4,
             make_float4(acc[4 * i] / safe_l, acc[4 * i + 1] / safe_l,
                         acc[4 * i + 2] / safe_l, acc[4 * i + 3] / safe_l));
    }
    if (r == 0) lse[(size_t)bh * sq + row] = m + logf(safe_l);
  }
}

// -- bf16: tensor cores (wgmma) ---------------------------------------------

using flash_tc::align1024;
using flash_tc::fence_async_smem;
using flash_tc::kLog2e;
using flash_tc::load_tile;
using flash_tc::product_rs;
using flash_tc::product_ss;
using flash_tc::stage_out;
using flash_tc::store_out;
using flash_tc::Tc;
using flash_tc::to_frags;
using tc::fence_acc;

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
// in a row with no visible key yet (m stays at the finite -1e30).
template <bool MASK, bool DROP>
__device__ __forceinline__ void online_softmax(
    float (&s)[32], float (&m)[2], float (&l)[2], float (&alpha)[2],
    int row0, int col0, float scale_log2, int sq, int sk, int kv_len,
    int causal, uint32_t mix, uint32_t thresh, float inv_keep) {
  const int offset = sk - sq;
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int i = 0; i < 32; ++i) {
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
  for (int i = 0; i < 32; ++i) {
    const int h = (i >> 1) & 1;
    const float p = ex2(fmaf(s[i], scale_log2, -mb[h]));
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

template <bool MASK>
__device__ __forceinline__ void online_softmax_drop(
    bool drop, float (&s)[32], float (&m)[2], float (&l)[2],
    float (&alpha)[2], int row0, int col0, float scale_log2, int sq, int sk,
    int kv_len, int causal, uint32_t mix, uint32_t thresh, float inv_keep) {
  if (drop)
    online_softmax<MASK, true>(s, m, l, alpha, row0, col0, scale_log2, sq,
                               sk, kv_len, causal, mix, thresh, inv_keep);
  else
    online_softmax<MASK, false>(s, m, l, alpha, row0, col0, scale_log2, sq,
                                sk, kv_len, causal, mix, thresh, inv_keep);
}

template <int D>
__global__ void __launch_bounds__(Tc<D>::NT, Tc<D>::FWD_BLOCKS)
flash_fwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const int* __restrict__ lens,
                    bf16* __restrict__ o, float* __restrict__ lse, int sq,
                    int sk, int causal, float sm_scale,
                    const int* __restrict__ seed, uint32_t thresh,
                    float keep_prob) {
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
  const float scale_log2 = sm_scale * kLog2e;
  const bool drop = seed != nullptr;
  const uint32_t mix = drop ? flash::dropout_mix(*seed, bh) : 0u;
  const float inv_keep = 1.f / keep_prob;

  float acc[G::NB][32];
#pragma unroll
  for (int c = 0; c < G::NB; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[c][i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

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
      product_ss<D>(s, qs, wrow, kst);
      tc::wgmma_commit();
      tc::wgmma_wait<0>();
      fence_acc(s);
      const bool mask = key0 + G::BS > kv_len ||
                        (causal && key0 + G::BS - 1 > wq0 + offset);
      float alpha[2];
      const int row0 = q0 + row, col0_s = key0 + 2 * (lane % 4);
      if (mask)
        online_softmax_drop<true>(drop, s, m, l, alpha, row0, col0_s,
                                  scale_log2, sq, sk, kv_len, causal, mix,
                                  thresh, inv_keep);
      else
        online_softmax_drop<false>(drop, s, m, l, alpha, row0, col0_s,
                                   scale_log2, sq, sk, kv_len, causal, mix,
                                   thresh, inv_keep);
      uint32_t pf[16];
      to_frags(s, pf);  // p rounded to bf16, as the reference rounds it
#pragma unroll
      for (int c = 0; c < G::NB; ++c) {
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[c][i] *= alpha[(i >> 1) & 1];
        fence_acc(acc[c]);
      }
      tc::wgmma_fence();
      product_rs<D>(acc, pf, kst + G::STREAM, col0);
      tc::wgmma_commit();
      tc::wgmma_wait<0>();
#pragma unroll
      for (int c = 0; c < G::NB; ++c) fence_acc(acc[c]);
    }
  }

  // the row sums over the quad; o = acc / l, lse = m + log(l) (a row with
  // no visible key: o = 0, lse = -1e30)
  float inv_l[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    inv_l[h] = l[h] == 0.f ? 1.f : 1.f / l[h];
    const int r = q0 + row + 8 * h;
    if (lane % 4 == 0 && col0 == 0 && r < sq)
      lse[(size_t)bh * sq + r] =
          l[h] == 0.f ? kNegInf : m[h] * sm_scale + logf(l[h]);
  }
#pragma unroll
  for (int c = 0; c < G::NB; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[c][i] *= inv_l[(i >> 1) & 1];
  tc::cp_async_wait<0>();
  __syncthreads();  // every product has read Q: its tile stages o
  stage_out<D>(qs, acc, 1.f, row);
  __syncthreads();
  store_out<D>(o + q_base, qs, q0, sq, col0);
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
  cudaStream_t stream;
};

template <int D>
int launch_f32(const Args& a) {
  dim3 grid((a.sq + kRowsPerBlock - 1) / kRowsPerBlock, a.bh);
  flash_fwd_kernel<D><<<grid, kThreads, 0, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), a.lens, static_cast<float*>(a.o),
      a.lse, a.sq, a.sk, a.causal, a.sm_scale, a.seed, a.thresh,
      a.keep_prob);
  return 0;
}

template <int D>
int launch_bf16(const Args& a) {
  using G = Tc<D>;
  const long long tiles =
      (long long)(a.sq + G::ROWS - 1) / G::ROWS * G::SPLIT;
  if (tiles > 65535) return (int)cudaErrorInvalidValue;
  // above 48 KB of dynamic shared memory needs the opt-in, once
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      G::FWD_SMEM);
  if (attr != cudaSuccess) return (int)attr;
  flash_fwd_tc_kernel<D><<<dim3(a.bh, (unsigned)tiles), G::NT, G::FWD_SMEM,
                           a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), a.lens, static_cast<bf16*>(a.o), a.lse,
      a.sq, a.sk, a.causal, a.sm_scale, a.seed, a.thresh, a.keep_prob);
  return 0;
}

template <int D>
int launch(const Args& a, int is_bf16) {
  return is_bf16 ? launch_bf16<D>(a) : launch_f32<D>(a);
}

}  // namespace

// q, k, v, o: [bh, s, d] contiguous, f32 (is_bf16 = 0) or bf16 (is_bf16 = 1);
// lens: [bh] int32 or null; lse: [bh, sq] f32; seed: one int32 on the
// device, or null for no dropout; thresh = int(rate * 2^24) and
// keep_prob = 1 - rate. Launches on `stream` and returns cudaGetLastError()
// (0 on success).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   const int* lens, void* o, float* lse, int bh,
                                   int sq, int sk, int d, int causal,
                                   float sm_scale, const int* seed,
                                   unsigned thresh, float keep_prob,
                                   int is_bf16, void* stream) {
  if (bh <= 0 || sq <= 0 || sk <= 0 || bh > 65535) return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, lens, o, lse, bh, sq, sk, causal, sm_scale, seed,
               thresh, keep_prob, static_cast<cudaStream_t>(stream)};
  int err;
  switch (d) {
    case 64: err = launch<64>(a, is_bf16); break;
    case 128: err = launch<128>(a, is_bf16); break;
    case 256: err = launch<256>(a, is_bf16); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err) return err;
  return (int)cudaGetLastError();
}
