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
// no row sees gets dk = dv = 0.
//
//   flash_attention_bwd_dq:  one block per (batch*head, tile of query rows);
//       it loops over the K/V tiles and also writes delta (the reference's
//       separate rowsum, folded in here) for the dk/dv kernel;
//   flash_attention_bwd_dkv: one block per (batch*head, tile of key rows);
//       it loops over the Q/dO tiles, with dK and dV in registers.
// Each output row is owned by one block, so neither kernel needs atomics
// and both are deterministic, which is why the reference splits dq from
// dk/dv too.
//
// What bounds them on the H100: operations, at the rate they compute at.
// dq does 6*D FLOPs per visible (q, k) pair and dk/dv 8*D, against 6 S*D
// arrays read or written: in bf16 near the tensor cores' balance point,
// far above the CUDA cores'. This first version computes on the CUDA
// cores in f32 (67 TFLOP/s peak; the bf16 tensor cores' 989 TFLOP/s is
// later work with wgmma). What the design does about the bound:
//   - TPR = D/16 threads share a row, each owning 16 of its dims in
//     registers (q, dO and the dq sum; or k, v, dK and dV), so no thread
//     spills at any D and the dot products reduce over TPR lanes with
//     shuffles;
//   - the tile it loops over is staged in shared memory as f32 (4096
//     values per array: 64 rows at D=64, 32 at D=128, 16 at D=256) and
//     reused by all the block's rows, each row reading a whole shared row
//     that the warp's other rows read at the same moment (a broadcast);
//   - tiles that the causal mask or the key length rule out entirely are
//     never loaded.

#include "flash_common.cuh"

namespace {

using flash::load4;
using flash::store4;

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
template <typename T, int D>
__device__ __forceinline__ void load_row(const T* row, int r, float out[16]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 x = load4(row + (i * Geo<D>::TPR + r) * 4);
    out[4 * i] = x.x;
    out[4 * i + 1] = x.y;
    out[4 * i + 2] = x.z;
    out[4 * i + 3] = x.w;
  }
}

template <typename T, int D>
__device__ __forceinline__ void store_row(T* row, int r, const float in[16],
                                          float scale) {
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

// stage rows [r0, r0 + BT) of a [S, D] array into shared memory as f32;
// rows at or past `limit` become zeros
template <typename T, int D>
__device__ __forceinline__ void stage(float* dst, const T* src, int r0,
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

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ o,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const int* __restrict__ lens, const int* __restrict__ seed,
                    T* __restrict__ dq, float* __restrict__ delta, int sq,
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
    load_row<T, D>(q + q_base + (size_t)row * D, r, qr);
    load_row<T, D>(dout + q_base + (size_t)row * D, r, dor);
    load_row<T, D>(o + q_base + (size_t)row * D, r, orow);
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
    stage<T, D>(ks, k + kv_base, k0, kv_len, tid);
    stage<T, D>(vs, v + kv_base, k0, kv_len, tid);
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
      axpy<D>(acc, flash::round_to<T>(p * (dp - dl)), ks + j * D, r);
    }
  }
  if (row_ok) store_row<T, D>(dq + q_base + (size_t)row * D, r, acc, sm_scale);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     const int* __restrict__ lens,
                     const int* __restrict__ seed, T* __restrict__ dk,
                     T* __restrict__ dv, int sq, int sk, int causal,
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
    load_row<T, D>(k + kv_base + (size_t)key * D, r, kr);
    load_row<T, D>(v + kv_base + (size_t)key * D, r, vr);
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
    stage<T, D>(qs, q + q_base, q0, sq, tid);
    stage<T, D>(dos, dout + q_base, q0, sq, tid);
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
      axpy<D>(dva, flash::round_to<T>(p_drop), dos + i * D, r);
      axpy<D>(dka, flash::round_to<T>(p * (dp - dls[i])), qs + i * D, r);
    }
  }
  if (key < sk) {
    store_row<T, D>(dk + kv_base + (size_t)key * D, r, dka, sm_scale);
    store_row<T, D>(dv + kv_base + (size_t)key * D, r, dva, 1.f);
  }
}

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

template <typename T, int D>
void launch_dq(const Args& a) {
  dim3 grid((a.sq + Geo<D>::ROWS - 1) / Geo<D>::ROWS, a.bh);
  flash_bwd_dq_kernel<T, D><<<grid, kThreads, 0, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.o),
      static_cast<const T*>(a.dout), a.lse, a.lens, a.seed,
      static_cast<T*>(a.out0), a.delta_out, a.sq, a.sk, a.causal, a.sm_scale,
      a.thresh, a.keep_prob);
}

template <typename T, int D>
void launch_dkv(const Args& a) {
  dim3 grid((a.sk + Geo<D>::ROWS - 1) / Geo<D>::ROWS, a.bh);
  flash_bwd_dkv_kernel<T, D><<<grid, kThreads, 0, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta_in, a.lens, a.seed, static_cast<T*>(a.out0),
      static_cast<T*>(a.out1), a.sq, a.sk, a.causal, a.sm_scale, a.thresh,
      a.keep_prob);
}

template <bool DQ, typename T>
int dispatch_d(int d, const Args& a) {
  switch (d) {
    case 64: DQ ? launch_dq<T, 64>(a) : launch_dkv<T, 64>(a); break;
    case 128: DQ ? launch_dq<T, 128>(a) : launch_dkv<T, 128>(a); break;
    case 256: DQ ? launch_dq<T, 256>(a) : launch_dkv<T, 256>(a); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return 0;
}

template <bool DQ>
int run(const Args& a, int d, int is_bf16) {
  if (a.bh <= 0 || a.sq <= 0 || a.sk <= 0 || a.bh > 65535)
    return (int)cudaErrorInvalidValue;
  const int err = is_bf16 ? dispatch_d<DQ, __nv_bfloat16>(d, a)
                          : dispatch_d<DQ, float>(d, a);
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
