// One-pass Adam/AdamW update for Hopper (sm_90a), CUDA C++ with a plain C
// entry.
//
// Replaces the Pallas TPU kernel paddle_tpu/ops/pallas/fused_adamw.py
// (fused_adamw_update / _kernel). Same function, in place on one parameter
// leaf: with g the gradient,
//     g  = g + wd * p                    (coupled decay: Adam's L2)
//     m  = b1 * m + (1 - b1) * g
//     v  = b2 * v + (1 - b2) * g * g
//     step = lr * (m / bc1) / (sqrt(v / bc2) + eps)
//     step = step + lr * wd * p          (decoupled decay: AdamW)
//     p  = p - step
// p, m, v and g are f32. lr and the bias corrections bc1, bc2 change per
// step and come in as arguments; the betas, eps and wd are the optimizer's.
// The TPU kernel's 512-lane flattening and its size % 4096 rule exist for
// Mosaic's tiling and are dropped: a grid-stride loop covers any length.
//
// What bounds it on the H100: bytes. Each element reads p, m, v, g and
// writes p, m, v: 28 bytes for about 15 FLOPs, far below the card's
// balance point, so the floor is 28 B x n at 3.35 TB/s. What the design
// does about it: one pass, each value read and written once, 16-byte
// vector loads and stores (float4) when all four arrays are 16-byte
// aligned, and a grid of a few blocks per SM walking the leaf so that
// enough loads are in flight to keep the memory busy.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

struct Hyper {
  float lr, bc1, bc2, b1, omb1, b2, omb2, eps, wd;
  int decoupled;
};

__device__ __forceinline__ void update(float& p, float& m, float& v, float g,
                                       const Hyper& h) {
  if (h.wd != 0.f && !h.decoupled) g = g + h.wd * p;
  m = h.b1 * m + h.omb1 * g;
  v = h.b2 * v + h.omb2 * g * g;
  const float denom = sqrtf(v / h.bc2) + h.eps;
  float step = h.lr * (m / h.bc1) / denom;
  if (h.wd != 0.f && h.decoupled) step = step + h.lr * h.wd * p;
  p = p - step;
}

// vec: the first 4 * (n / 4) elements go as float4 (all pointers 16-byte
// aligned); the rest, or everything when vec is false, one at a time
__global__ void __launch_bounds__(kThreads)
adamw_kernel(float* __restrict__ p, float* __restrict__ m,
             float* __restrict__ v, const float* __restrict__ g, long long n,
             Hyper h, bool vec) {
  const long long stride = (long long)gridDim.x * kThreads;
  const long long tid = (long long)blockIdx.x * kThreads + threadIdx.x;
  long long done = 0;
  if (vec) {
    const long long n4 = n / 4;
    float4* p4 = reinterpret_cast<float4*>(p);
    float4* m4 = reinterpret_cast<float4*>(m);
    float4* v4 = reinterpret_cast<float4*>(v);
    const float4* g4 = reinterpret_cast<const float4*>(g);
    for (long long i = tid; i < n4; i += stride) {
      float4 pp = p4[i], mm = m4[i], vv = v4[i];
      const float4 gg = g4[i];
      update(pp.x, mm.x, vv.x, gg.x, h);
      update(pp.y, mm.y, vv.y, gg.y, h);
      update(pp.z, mm.z, vv.z, gg.z, h);
      update(pp.w, mm.w, vv.w, gg.w, h);
      p4[i] = pp;
      m4[i] = mm;
      v4[i] = vv;
    }
    done = 4 * n4;
  }
  for (long long i = done + tid; i < n; i += stride) {
    float pp = p[i], mm = m[i], vv = v[i];
    update(pp, mm, vv, g[i], h);
    p[i] = pp;
    m[i] = mm;
    v[i] = vv;
  }
}

}  // namespace

// p, m, v (updated in place) and g: n contiguous f32 values each, on the
// device. omb1 = 1 - beta1 and omb2 = 1 - beta2 as the caller rounds them.
// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int fused_adamw_update(float* p, float* m, float* v,
                                  const float* g, long long n, float lr,
                                  float bc1, float bc2, float beta1,
                                  float omb1, float beta2, float omb2,
                                  float eps, float wd, int decoupled,
                                  void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const Hyper h{lr, bc1, bc2, beta1, omb1, beta2, omb2, eps, wd, decoupled};
  const bool vec = ((reinterpret_cast<uintptr_t>(p) |
                     reinterpret_cast<uintptr_t>(m) |
                     reinterpret_cast<uintptr_t>(v) |
                     reinterpret_cast<uintptr_t>(g)) & 15) == 0;
  const long long work = vec ? (n + 3) / 4 : n;
  // 132 SMs x 8 blocks of 256 threads keep enough loads in flight
  const long long blocks = (work + kThreads - 1) / kThreads;
  const int grid = (int)(blocks < 132 * 8 ? blocks : 132 * 8);
  adamw_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      p, m, v, g, n, h, vec);
  return (int)cudaGetLastError();
}
