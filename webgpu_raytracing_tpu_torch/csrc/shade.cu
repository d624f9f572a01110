// Shading's per-lane work of one path segment (`wrt_shade_hit`,
// `wrt_shade_bounce`), one thread a lane, bit for bit the plain-torch
// twins of ops/integrator.py run on the CPU (shade.cuh).
//
// It replaces no Pallas kernel: in the JAX package shading is XLA code
// (webgpu_raytracing_tpu/ops/integrator.py). It was added because the
// eager twins on the card are some 780 launches a segment (the bounce
// direction's double-f32 sine and cosine alone are some 300 ops), each a
// pass over memory that the host has to enqueue. The light sampling of
// NEE and the env-NEE draws stay eager between the two kernels:
//
//   trace_closest -> wrt_shade_hit -> [direct_light, env-NEE]
//                 -> wrt_shade_bounce -> next segment
//
// A lane of `wrt_shade_hit` needs its hit (12 B), alive, color and
// throughput (25 B), the direction if it missed or else the deferred
// direction and weight (12 or 24 B), one pdf under env-IS past the first
// segment (4 B), and on hit lanes its face's material index, triangle and
// shading rows and partner code (4 + 36 + 12 flat or 48 Phong + 4 B; the
// material table is a few rows, cached); it writes 77 B (81). A lane of
// `wrt_shade_bounce` needs 45 B, the direction too if its path ends (12
// B) and under env-IS the old pdf if it did not hit (4 B), and writes
// 45 B (49).
// Both kernels are bound by bytes: the bounce direction's some 750 f32
// operations take a fraction of a lane's bytes' time at 3.35 TB/s (the
// peak counts fused multiply-adds, which --fmad=false cannot issue, so
// half of it is this kernel's ceiling). Shading type and env-IS are
// template parameters: one instance a configuration, no branch;
// `run_env` (whether this vertex drew an env-NEE sample) is an argument.
//
// Bit-exactness rests on detmath.cuh's rules, shade.cuh's, and the
// library's --fmad=false. Outputs go to fresh tensors; no input is
// written.

#include <cstring>

#include "shade.cuh"

namespace {

using wrt::ShadeBounceArgs;
using wrt::ShadeHitArgs;

constexpr int kShadeThreads = 256;

template <bool kPhong, bool kEnvMis>
__global__ void __launch_bounds__(kShadeThreads)
    shade_hit_kernel(ShadeHitArgs a, long long n) {
  const long long i = (long long)blockIdx.x * kShadeThreads + threadIdx.x;
  if (i < n) wrt::shade_hit_lane<kPhong, kEnvMis>(a, i);
}

template <bool kEnvIs>
__global__ void __launch_bounds__(kShadeThreads)
    shade_bounce_kernel(ShadeBounceArgs a, int run_env, long long n) {
  const long long i = (long long)blockIdx.x * kShadeThreads + threadIdx.x;
  if (i < n) wrt::shade_bounce_lane<kEnvIs>(a, run_env != 0, i);
}

bool grid_of(long long n, dim3* grid) {
  const long long blocks = (n + kShadeThreads - 1) / kShadeThreads;
  if (n < 0 || blocks > 0x7fffffffLL) return false;
  *grid = dim3((unsigned)blocks);
  return true;
}

}  // namespace

// `ptrs`: the device pointers of ShadeHitArgs in its order, in host memory
// (partner_code and excl_out null when the tables have no partner codes;
// env_mis_pdf, prev_bsdf_pdf and env_mis_pdf_out read only with env_mis)
extern "C" int wrt_shade_hit(const void* const* ptrs, int phong, int env_mis,
                             long long n, void* stream) {
  dim3 grid;
  if (!grid_of(n, &grid)) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  ShadeHitArgs a;
  std::memcpy(&a, ptrs, sizeof(a));
  const cudaStream_t s = (cudaStream_t)stream;
  if (phong && env_mis)
    shade_hit_kernel<true, true><<<grid, kShadeThreads, 0, s>>>(a, n);
  else if (phong)
    shade_hit_kernel<true, false><<<grid, kShadeThreads, 0, s>>>(a, n);
  else if (env_mis)
    shade_hit_kernel<false, true><<<grid, kShadeThreads, 0, s>>>(a, n);
  else
    shade_hit_kernel<false, false><<<grid, kShadeThreads, 0, s>>>(a, n);
  return (int)cudaGetLastError();
}

// `ptrs`: the device pointers of ShadeBounceArgs in its order, in host
// memory (prev_bsdf_pdf and its output used only with env_is)
extern "C" int wrt_shade_bounce(const void* const* ptrs, int env_is,
                                int run_env, long long n, void* stream) {
  dim3 grid;
  if (!grid_of(n, &grid)) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  ShadeBounceArgs a;
  std::memcpy(&a, ptrs, sizeof(a));
  const cudaStream_t s = (cudaStream_t)stream;
  if (env_is)
    shade_bounce_kernel<true><<<grid, kShadeThreads, 0, s>>>(a, run_env, n);
  else
    shade_bounce_kernel<false><<<grid, kShadeThreads, 0, s>>>(a, run_env, n);
  return (int)cudaGetLastError();
}
