// Rederive (`wrt_rederive_uv`, `rederive_uv_kernel`): after a closest-hit
// leg, the exact t and barycentrics of each ray's winning triangle from
// its face id (unmasked Möller–Trumbore algebra, correctly rounded
// divides), one thread a ray, bit for bit the plain-torch twin
// `_rederive_uv_torch` of ops/cluster_trace.py run on the CPU
// (rederive.cuh).
//
// It replaces no Pallas kernel: in the JAX package rederive is XLA code
// (webgpu_raytracing_tpu/ops/cluster_pallas.py, `rederive_uv`). It was
// added because the eager twin on the card is 126 launches a leg (a
// gather, two crosses, four dots, three correctly rounded divides), each
// a pass over memory that the host has to enqueue: 6,048 launches of a
// 4K frame's 8,740. Every closest-hit route calls it (K1, K2n, K3, the
// sorted, binned and multipass legs, exact pairs' unflagged rays).
//
// It is bound by bytes: a hit reads its face (4 B), origin and direction
// (24 B) and a triangle row (36 B) and writes t, u and v (12 B); a miss
// reads its face and t (8 B) and writes 12 B. At most some 80 B a ray,
// 1.2 ms for the 49.8 M rays of a 4K frame's 48 legs at 3.35 TB/s; its
// some 120 f32 operations a hit take a tenth of that. One pass, every
// intermediate in registers, the triangle gathered on hit lanes alone.
// The three outputs are the rows of one (3, n) tensor: one allocation
// and one launch a call.
//
// Bit-exactness rests on detmath.cuh's rules and the library's
// --fmad=false.

#include "rederive.cuh"

namespace {

constexpr int kRederiveThreads = 256;

__global__ void __launch_bounds__(kRederiveThreads)
    rederive_uv_kernel(const float* __restrict__ o,
                       const float* __restrict__ d,
                       const float* __restrict__ t,
                       const int32_t* __restrict__ face,
                       const float* __restrict__ tri,
                       float* __restrict__ out, long long n) {
  const long long i = (long long)blockIdx.x * kRederiveThreads + threadIdx.x;
  if (i < n) wrt::rederive_lane(o, d, t, face, tri, out, n, i);
}

}  // namespace

// o, d (n, 3) f32, t (n,) f32, face (n,) int32 (-1 a miss) and tri (F, 9)
// f32 on the device → out (3, n) f32: t, u, v
extern "C" int wrt_rederive_uv(const float* o, const float* d,
                               const float* t, const int32_t* face,
                               const float* tri, float* out, long long n,
                               void* stream) {
  const long long blocks = (n + kRederiveThreads - 1) / kRederiveThreads;
  if (n < 0 || blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  rederive_uv_kernel<<<(unsigned)blocks, kRederiveThreads, 0,
                       (cudaStream_t)stream>>>(o, d, t, face, tri, out, n);
  return (int)cudaGetLastError();
}
