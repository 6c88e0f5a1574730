// One-pass Adam/AdamW update over a list of leaves for Hopper (sm_90a), CUDA
// C++ with a plain C entry.
//
// Replaces the Pallas TPU kernel paddle_tpu/ops/pallas/fused_adamw.py
// (fused_adamw_update / _kernel). Same function, in place on each parameter
// leaf: with g the gradient and s the global-norm clip's coefficient (1
// without a clip),
//     g  = g * s
//     g  = g + wd * p                    (coupled decay: Adam's L2)
//     m  = b1 * m + (1 - b1) * g
//     v  = b2 * v + (1 - b2) * g * g
//     step = lr * (m / bc1) / (sqrt(v / bc2) + eps)
//     step = step + lr * wd * p          (decoupled decay: AdamW)
//     p  = p - step
// A guarded step (TrainGuard) passes `skip`, a one-byte device flag that
// is set when the step's loss or a gradient was not finite: every block
// reads it first and returns without writing, so a skipped step leaves p,
// m and v as they were, bit for bit (the reference masks its kernel's
// result with jnp.where, paddle_tpu/hapi/engine.py:297-307, to the same
// effect). Unguarded launches pass null.
// p, m, v and g are f32. lr and the bias corrections bc1, bc2 change per
// step: the kernel reads them from a 3-value f32 array on the device, as the
// TPU kernel reads its SMEM operand, so a launch captured in a CUDA graph
// takes each replay's values; the betas and eps are the optimizer's; wd is
// the leaf's own. The TPU kernel's 512-lane
// flattening and its size % 4096 rule exist for Mosaic's tiling and are
// dropped.
//
// What bounds it on the H100: bytes. Each value reads p, m, v, g and
// writes p, m, v: 28 bytes for about 15 FLOPs, far below the card's
// balance point, so the floor is 28 B x every value of the launch at 3.35
// TB/s. Below it lies the launch: an optimizer step over a model's few
// hundred leaves, most of them biases and norm weights of a few hundred
// values, costs a launch each (and the host's time to issue it) when a
// leaf is a launch, while the whole set's bytes take a few ms at most.
// What the design does about it: one launch takes up to kMaxLeaves leaves.
// The leaf table (each leaf's pointers, length and wd, and the prefix of
// its chunks) travels in the launch's own parameter space as one
// __grid_constant__ struct, so no table is copied or allocated on the
// device and the host never waits. Each leaf is cut into chunks of kChunk
// values; block b takes chunk b, finds its leaf by a binary search of the
// prefix and streams the chunk once: 16-byte vector accesses where the
// leaf's four pointers are 16-byte aligned, then its ragged tail (or the
// whole chunk of an unaligned view) one value at a time. A chunk of 4096
// values is one pass of the unrolled loop: kUnroll float4 loads of each
// array in flight a thread, 256 threads x 4 x 4 x 16 bytes a block. A
// larger chunk gives a small leaf fewer blocks, each walking its chunk
// several times over: at 16384 values LeNet's 10 leaves took 0.0204 ms a
// launch against 0.0111 at 4096, and GPT-345M's set 3.3303 against
// 3.2628 (H100, chip_smoke.py --adamw-geometry).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;
// The launch geometry. A build may set other values to measure them
// (chip_smoke.py --adamw-geometry); the wrapper refuses a library whose
// geometry is not its own.
#ifndef FUSED_ADAMW_CHUNK
#define FUSED_ADAMW_CHUNK 4096
#endif
#ifndef FUSED_ADAMW_MAX_LEAVES
#define FUSED_ADAMW_MAX_LEAVES 512
#endif
constexpr long long kChunk = FUSED_ADAMW_CHUNK;  // values a block updates
// leaves a launch takes: the table fills most of the 32,764 bytes of
// kernel parameters CUDA 12.1 and later allow
constexpr int kMaxLeaves = FUSED_ADAMW_MAX_LEAVES;

struct Leaf {
  float* p;
  float* m;
  float* v;
  const float* g;
  long long n;
  float wd;
};

struct Table {
  const float* hyper;  // device [lr, bc1, bc2]
  float b1, omb1, b2, omb2, eps;
  int decoupled;
  int leaves;
  const float* scale;  // device scalar multiplying every g, or null
  const bool* skip;    // device flag: when set, no block writes; or null
  int first_chunk[kMaxLeaves + 1];  // leaf i owns chunks [first[i], first[i+1])
  Leaf leaf[kMaxLeaves];
};

static_assert(kChunk % (4 * kThreads) == 0, "a chunk is whole float4 rows");
static_assert(sizeof(Table) <= 32764,
              "the leaf table exceeds the kernel parameter limit");

// lr, bc1 and bc2 as the block read them from the table's device array
struct Step {
  float lr, bc1, bc2;
};

__device__ __forceinline__ void update(float& p, float& m, float& v, float g,
                                       float s, const Step& h, float wd,
                                       const Table& t) {
  const float lr = h.lr;
  g = g * s;
  if (wd != 0.f && !t.decoupled) g = g + wd * p;
  m = t.b1 * m + t.omb1 * g;
  v = t.b2 * v + t.omb2 * g * g;
  const float denom = sqrtf(v / h.bc2) + t.eps;
  float step = lr * (m / h.bc1) / denom;
  if (wd != 0.f && t.decoupled) step = step + lr * wd * p;
  p = p - step;
}

__device__ __forceinline__ void update4(float4& p, float4& m, float4& v,
                                        const float4 g, float s,
                                        const Step& h, float wd,
                                        const Table& t) {
  update(p.x, m.x, v.x, g.x, s, h, wd, t);
  update(p.y, m.y, v.y, g.y, s, h, wd, t);
  update(p.z, m.z, v.z, g.z, s, h, wd, t);
  update(p.w, m.w, v.w, g.w, s, h, wd, t);
}

__global__ void __launch_bounds__(kThreads)
adamw_kernel(const __grid_constant__ Table t) {
  if (t.skip != nullptr && *t.skip) return;
  const int chunk = blockIdx.x;
  // the last leaf whose first chunk is at or before this one
  int lo = 0, hi = t.leaves - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (t.first_chunk[mid] <= chunk) lo = mid; else hi = mid - 1;
  }
  const Leaf& L = t.leaf[lo];
  const long long begin = (long long)(chunk - t.first_chunk[lo]) * kChunk;
  const long long end = min(L.n, begin + kChunk);
  const float s = t.scale ? *t.scale : 1.f;
  const Step h{t.hyper[0], t.hyper[1], t.hyper[2]};
  const float wd = L.wd;
  float* __restrict__ p = L.p;
  float* __restrict__ m = L.m;
  float* __restrict__ v = L.v;
  const float* __restrict__ g = L.g;
  long long scalar_from = begin;
  const bool vec = ((reinterpret_cast<uintptr_t>(p) |
                     reinterpret_cast<uintptr_t>(m) |
                     reinterpret_cast<uintptr_t>(v) |
                     reinterpret_cast<uintptr_t>(g)) & 15) == 0;
  if (vec) {
    // begin is a multiple of 4: whole float4s up to the last one that fits
    const long long q0 = begin / 4, q1 = end / 4;
    float4* p4 = reinterpret_cast<float4*>(p);
    float4* m4 = reinterpret_cast<float4*>(m);
    float4* v4 = reinterpret_cast<float4*>(v);
    const float4* g4 = reinterpret_cast<const float4*>(g);
    long long i = q0 + threadIdx.x;
    for (; i + (kUnroll - 1) * kThreads < q1; i += kUnroll * kThreads) {
      float4 pp[kUnroll], mm[kUnroll], vv[kUnroll], gg[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long j = i + u * kThreads;
        pp[u] = p4[j];
        mm[u] = m4[j];
        vv[u] = v4[j];
        gg[u] = g4[j];
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long j = i + u * kThreads;
        update4(pp[u], mm[u], vv[u], gg[u], s, h, wd, t);
        p4[j] = pp[u];
        m4[j] = mm[u];
        v4[j] = vv[u];
      }
    }
    for (; i < q1; i += kThreads) {
      float4 pp = p4[i], mm = m4[i], vv = v4[i];
      update4(pp, mm, vv, g4[i], s, h, wd, t);
      p4[i] = pp;
      m4[i] = mm;
      v4[i] = vv;
    }
    scalar_from = 4 * q1;
  }
  for (long long i = scalar_from + threadIdx.x; i < end; i += kThreads) {
    float pp = p[i], mm = m[i], vv = v[i];
    update(pp, mm, vv, g[i], s, h, wd, t);
    p[i] = pp;
    m[i] = mm;
    v[i] = vv;
  }
}

}  // namespace

// The launch geometry the caller plans with: leaves a launch takes and
// values a chunk (one block) holds.
extern "C" int fused_adamw_max_leaves() { return kMaxLeaves; }
extern "C" int fused_adamw_chunk() { return (int)kChunk; }

// One launch over `leaves` (1..kMaxLeaves) leaves. ptrs: 4 x leaves device
// addresses, leaf-major (p, m, v, g of leaf 0, then of leaf 1, ...); n, wd:
// per leaf; first_chunk: leaves + 1 entries, the prefix sum of
// each leaf's ceil(n / kChunk) chunks from 0 (the grid is its last entry).
// All host arrays, read before this returns. hyper: the device f32 array
// [lr, bc1, bc2] the kernel reads. scale: a device f32 scalar multiplying
// every gradient, or null. skip: a one-byte device flag (a bool tensor)
// that, when set, makes the launch write nothing, or null. omb1 = 1 - beta1
// and omb2 = 1 - beta2 as the caller rounds them. Launches on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int fused_adamw_multi_update(
    int leaves, const long long* ptrs, const long long* n, const float* wd,
    const int* first_chunk, const float* hyper, float beta1,
    float omb1, float beta2, float omb2, float eps, int decoupled,
    const float* scale, const bool* skip, void* stream) {
  if (leaves < 1 || leaves > kMaxLeaves || first_chunk[0] != 0 ||
      first_chunk[leaves] <= 0 || hyper == nullptr)
    return (int)cudaErrorInvalidValue;
  Table t;
  t.hyper = hyper;
  t.b1 = beta1;
  t.omb1 = omb1;
  t.b2 = beta2;
  t.omb2 = omb2;
  t.eps = eps;
  t.decoupled = decoupled;
  t.scale = scale;
  t.skip = skip;
  t.leaves = leaves;
  for (int i = 0; i < leaves; ++i) {
    if (n[i] <= 0 || first_chunk[i + 1] - first_chunk[i] !=
                         (int)((n[i] + kChunk - 1) / kChunk))
      return (int)cudaErrorInvalidValue;
    t.leaf[i] = Leaf{reinterpret_cast<float*>(ptrs[4 * i]),
                     reinterpret_cast<float*>(ptrs[4 * i + 1]),
                     reinterpret_cast<float*>(ptrs[4 * i + 2]),
                     reinterpret_cast<const float*>(ptrs[4 * i + 3]), n[i],
                     wd[i]};
    t.first_chunk[i] = first_chunk[i];
  }
  t.first_chunk[leaves] = first_chunk[leaves];
  adamw_kernel<<<first_chunk[leaves], kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(t);
  return (int)cudaGetLastError();
}
