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
// kernels regenerate bit for bit.
//
// What bounds it on the H100: operations, at the rate it computes at.
// Attention does 4*Sq*Sk*D FLOPs per head (half that under the causal
// mask) over 4 S*D arrays read or written: at D=64, S=1024 ~256 FLOP per
// bf16 byte, near the bf16 tensor cores' ~295 FLOP/byte balance point and
// far above the CUDA cores' ~20. This first version does its arithmetic on
// the CUDA cores in f32 (the 67 TFLOP/s peak, not the 989 TFLOP/s bf16
// tensor-core peak); wgmma and TMA pipelining are later work. What the
// design does about the bound:
//   - one block per (batch*head, 64 query rows); 4 threads share a row,
//     each owning D/4 of its dims in registers (q and the f32 accumulator),
//     so the S x S score matrix never leaves registers;
//   - K and V are staged tile by tile in shared memory as f32 (a tile is
//     always 4096 values: 64 keys at D=64, 32 at D=128, 16 at D=256), read
//     once per block and reused by all 64 rows;
//   - tiles wholly above the causal diagonal or past the key length are
//     never loaded; the ragged last tile is masked in place, so any
//     sq, sk >= 1 work;
//   - the dropout hash is a dozen integer operations per score, done in
//     registers beside the exp; no mask ever reaches memory.

#include "flash_common.cuh"

namespace {

using flash::kNegInf;
using flash::load4;
using flash::store4;

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = kThreads / 4;
constexpr int kTileElems = 4096;

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const int* __restrict__ lens,
                 T* __restrict__ o, float* __restrict__ lse, int sq, int sk,
                 int causal, float sm_scale, const int* __restrict__ seed,
                 uint32_t thresh, float keep_prob) {
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
      s[j] = flash::round_to<T>(p_drop);  // as the reference rounds p
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

template <typename T, int D>
void launch(const Args& a) {
  dim3 grid((a.sq + kRowsPerBlock - 1) / kRowsPerBlock, a.bh);
  flash_fwd_kernel<T, D><<<grid, kThreads, 0, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), a.lens, static_cast<T*>(a.o), a.lse, a.sq,
      a.sk, a.causal, a.sm_scale, a.seed, a.thresh, a.keep_prob);
}

template <typename T>
int dispatch_d(int d, const Args& a) {
  switch (d) {
    case 64: launch<T, 64>(a); break;
    case 128: launch<T, 128>(a); break;
    case 256: launch<T, 256>(a); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return 0;
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
  const int err = is_bf16 ? dispatch_d<__nv_bfloat16>(d, a) : dispatch_d<float>(d, a);
  if (err) return err;
  return (int)cudaGetLastError();
}
