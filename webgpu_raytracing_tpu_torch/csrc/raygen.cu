// Camera rays (`wrt_camera_rays`, `camera_rays_kernel`): the reference's
// cameraRay (render.ts:642-766) for every pixel sample, one thread a ray:
// the projection (pinhole, Panini, fisheye or orthographic), the thin
// lens's disc or square sample from the ray's PCG word, the focus, and the
// view transform into world space (raygen.cuh), bit for bit the plain-torch
// twin of ops/raygen.py run on the CPU, which the tests hold to the JAX
// package.
//
// It replaces no Pallas kernel: in the JAX package camera rays are XLA code
// (webgpu_raytracing_tpu/ops/raygen.py). It was added because the eager
// twin on the card is a chain of some 2,100 launches a call (the
// double-f32 sine and cosine alone are some 300 ops, Panini runs them
// three times), each a pass over memory that the host has to enqueue. A
// ray reads its position (8 B) and state word (8 B) and writes its origin,
// direction and state (32 B): 48 B, 14.9 us a 1,036,800-ray slab at
// 3.35 TB/s. Its f32 operations, as the twin counts them (2,021 a Panini
// ray with the circle lens, 893 a pinhole one), bound the Panini slab
// harder: 31.3 us at 67 TFLOP/s, a peak counted in fused multiply-adds
// that --fmad=false cannot issue. One thread a ray keeps every
// intermediate in registers, so the kernel moves those 48 B and nothing
// else; the view matrix (64 B) is read through the cache. Projection and
// lens are template parameters: one instance a configuration, no branch.
//
// Bit-exactness rests on detmath.cuh's rules and on the library's
// --fmad=false. The eager twin on the card divides by a Python float
// through its reciprocal, so its rays may differ from these (and the
// CPU's) in the last bit: the kernel is held to the CPU twin.

#include <cstring>

#include "raygen.cuh"

namespace {

using wrt::CameraArgs;
using wrt::kCircle;
using wrt::kFisheye;
using wrt::kOrtho;
using wrt::kPanini;
using wrt::kPerspective;
using wrt::kSquare;

constexpr int kRaygenThreads = 256;

template <int kProj, int kLens>
__global__ void __launch_bounds__(kRaygenThreads)
    camera_rays_kernel(const float* __restrict__ pos,
                       const float* __restrict__ view,
                       const long long* __restrict__ state_in, CameraArgs a,
                       float* __restrict__ o_out, float* __restrict__ d_out,
                       long long* __restrict__ state_out, long long n) {
  const long long i = (long long)blockIdx.x * kRaygenThreads + threadIdx.x;
  if (i >= n) return;
  uint32_t state = static_cast<uint32_t>(state_in[i]);
  const wrt::CameraRay ray = wrt::camera_ray<kProj, kLens>(
      pos[2 * i], pos[2 * i + 1], state, view, a);
  o_out[3 * i] = ray.o.x;
  o_out[3 * i + 1] = ray.o.y;
  o_out[3 * i + 2] = ray.o.z;
  d_out[3 * i] = ray.d.x;
  d_out[3 * i + 1] = ray.d.y;
  d_out[3 * i + 2] = ray.d.z;
  state_out[i] = state;
}

template <int kProj>
int launch_camera_rays(int lens, dim3 grid, cudaStream_t stream,
                       const float* pos, const float* view,
                       const long long* state, const CameraArgs& a,
                       float* o, float* d, long long* state_out,
                       long long n) {
  if (lens == kCircle)
    camera_rays_kernel<kProj, kCircle><<<grid, kRaygenThreads, 0, stream>>>(
        pos, view, state, a, o, d, state_out, n);
  else
    camera_rays_kernel<kProj, kSquare><<<grid, kRaygenThreads, 0, stream>>>(
        pos, view, state, a, o, d, state_out, n);
  return (int)cudaGetLastError();
}

}  // namespace

// pos (n, 2) f32, view (4, 4) f32 and state (n,) int64 words in [0, 2^32)
// on the device; `args` the 11 f32 scalars of CameraArgs in host memory →
// o and d (n, 3) f32 and the advanced state (n,) int64
extern "C" int wrt_camera_rays(const float* pos, const float* view,
                               const long long* state, int projection,
                               int lens, const float* args, float* o,
                               float* d, long long* state_out, long long n,
                               void* stream) {
  const long long blocks = (n + kRaygenThreads - 1) / kRaygenThreads;
  if (n < 0 || blocks > 0x7fffffffLL || projection < kFisheye ||
      projection > kOrtho || (lens != kCircle && lens != kSquare))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  CameraArgs a;
  std::memcpy(&a, args, sizeof(a));
  const dim3 grid((unsigned)blocks);
  const cudaStream_t s = (cudaStream_t)stream;
  switch (projection) {
    case kFisheye:
      return launch_camera_rays<kFisheye>(lens, grid, s, pos, view, state, a,
                                          o, d, state_out, n);
    case kPanini:
      return launch_camera_rays<kPanini>(lens, grid, s, pos, view, state, a,
                                         o, d, state_out, n);
    case kPerspective:
      return launch_camera_rays<kPerspective>(lens, grid, s, pos, view, state,
                                              a, o, d, state_out, n);
    default:
      return launch_camera_rays<kOrtho>(lens, grid, s, pos, view, state, a,
                                        o, d, state_out, n);
  }
}
