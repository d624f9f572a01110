// A light sample of next-event estimation (`wrt_light_sample`,
// `wrt_light_add`), one thread a lane, bit for bit the plain-torch twins
// of ops/integrator.py run on the CPU (light.cuh). The two kernels lie on
// either side of the sample's shadow leg, which stays the any-hit trace:
//
//   wrt_light_sample -> trace_any -> wrt_light_add   (samples_per_point
//                                                      times, on the host)
//
// It replaces no Pallas kernel: in the JAX package the light sample is
// XLA code (webgpu_raytracing_tpu/ops/integrator.py, `direct_light`). It
// was added because the eager twins on the card are 199 launches a
// sample (the PCG draws on int64 words, the triangle sample, three table
// gathers, the offset point's selects, the cross product, the
// double-f32 divide and square root, the product), each a pass over
// memory that the host has to enqueue: 9,552 of a 4K NEE frame's 13,397.
//
// Both kernels are bound by bytes. A lane of `wrt_light_sample` reads its
// shading point and state (20 B) and writes the shadow ray's direction
// and t_max, the carried 1/pdf, squared distance and material, and the
// state (36 B); the light's table rows are one model's few faces, which
// stay in L2. A lane of `wrt_light_add` reads the shadow flag, the
// direction, the normal and the carry (37 B), the colour past the first
// sample (12 B), and writes the colour (12 B). Some 100-110 B a lane:
// 0.035 ms for a config #5 slab's 1,036,800 lanes at 3.35 TB/s; their
// some 200 f32 operations take a fraction of that. One pass a side, every
// intermediate in registers. The sample count and whether this is the
// last sample are arguments.
//
// Bit-exactness rests on detmath.cuh's rules, shade.cuh's, light.cuh's,
// and the library's --fmad=false. Outputs go to fresh tensors; no input
// is written.

#include <cstring>

#include "light.cuh"

namespace {

using wrt::LightAddArgs;
using wrt::LightSampleArgs;

constexpr int kLightThreads = 256;

__global__ void __launch_bounds__(kLightThreads)
    light_sample_kernel(LightSampleArgs a, long long n) {
  const long long i = (long long)blockIdx.x * kLightThreads + threadIdx.x;
  if (i < n) wrt::light_sample_lane(a, n, i);
}

__global__ void __launch_bounds__(kLightThreads)
    light_add_kernel(LightAddArgs a, int spp, int last, long long n) {
  const long long i = (long long)blockIdx.x * kLightThreads + threadIdx.x;
  if (i < n) wrt::light_add_lane(a, spp, last != 0, n, i);
}

bool grid_of(long long n, dim3* grid) {
  const long long blocks = (n + kLightThreads - 1) / kLightThreads;
  if (n < 0 || blocks > 0x7fffffffLL) return false;
  *grid = dim3((unsigned)blocks);
  return true;
}

}  // namespace

// `ptrs`: the device pointers of LightSampleArgs in its order, in host
// memory
extern "C" int wrt_light_sample(const void* const* ptrs, long long n,
                                void* stream) {
  dim3 grid;
  if (!grid_of(n, &grid)) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  LightSampleArgs a;
  std::memcpy(&a, ptrs, sizeof(a));
  light_sample_kernel<<<grid, kLightThreads, 0, (cudaStream_t)stream>>>(a,
                                                                         n);
  return (int)cudaGetLastError();
}

// `ptrs`: the device pointers of LightAddArgs in its order, in host memory
// (color null on the first sample); `last` divides the sum by `spp`
extern "C" int wrt_light_add(const void* const* ptrs, int spp, int last,
                             long long n, void* stream) {
  dim3 grid;
  if (!grid_of(n, &grid)) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  LightAddArgs a;
  std::memcpy(&a, ptrs, sizeof(a));
  light_add_kernel<<<grid, kLightThreads, 0, (cudaStream_t)stream>>>(
      a, spp, last, n);
  return (int)cudaGetLastError();
}
