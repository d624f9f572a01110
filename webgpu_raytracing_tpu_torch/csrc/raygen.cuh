// One camera ray of the reference's cameraRay (render.ts:642-766), the
// arithmetic of ops/raygen.py's plain twin line for line: the kernel of
// raygen.cu runs it once a thread. It is made of detmath.cuh's device
// functions alone, so it also compiles as host C++ (tests compile it with
// g++ and hold it to the twin on the CPU).
#pragma once

#include <cstdint>

#include "detmath.cuh"

namespace wrt {

// RenderSettings.projection_type and .lens_shape
enum Projection { kFisheye = 0, kPanini = 1, kPerspective = 2, kOrtho = 3 };
enum Lens { kCircle = 0, kSquare = 1 };

// the f32 scalars of ops/raygen.camera_scalars, in its order
struct CameraArgs {
  float width, height, uv_div, pinhole_z, half_fov, half_panini_fov,
      panini_distance, pd_vc, coc, focus, fov_distance;
};

struct CameraRay {
  F3 o, d;
};

template <int kProj>
__device__ __forceinline__ F3 direction(float u, float v,
                                        const CameraArgs& a) {
  if (kProj == kPanini) {
    const float hx = (u * a.half_fov) * a.half_panini_fov;
    const float hy = (v * a.half_fov) * a.half_panini_fov;
    const F2 sc = det_sincos(hx);
    const float w = sc.x * a.panini_distance;
    const float m = det_sqrt(clamp_min(1.0f - w * w, 0.0f)) +
                    a.panini_distance * sc.y;
    const float x = sc.x * m;
    const float z = sc.y * m - a.panini_distance;
    const float y = det_tan(hy) * (z + a.pd_vc);
    return normalize(F3{x, y, -z});
  } else if (kProj == kPerspective) {
    return normalize(F3{u, v, a.pinhole_z});
  } else if (kProj == kFisheye) {
    const F2 x = det_sincos(u * a.half_fov);
    const F2 y = det_sincos(v * a.half_fov);
    return normalize(F3{-x.x, -y.x * x.y, y.y * x.y});
  } else {
    return F3{0.0f, 0.0f, -1.0f};
  }
}

// the world-space ray through pixel position (px, py); advances `state`
// by the lens's two draws. `view` is the 4x4 camera-to-world matrix, rows
// first.
template <int kProj, int kLens>
__device__ __forceinline__ CameraRay camera_ray(float px, float py,
                                                uint32_t& state,
                                                const float* view,
                                                const CameraArgs& a) {
  const float u = (2.0f * px - a.width) / a.uv_div;
  const float v = (2.0f * py - a.height) / a.uv_div;
  F3 d = direction<kProj>(u, v, a);

  // sampleLens (render.ts:740-747): always draws two numbers
  const F2 t = random_2(state);
  const F2 lens = kLens == kCircle ? sample_incircle(t) : sample_insquare(t);

  // thinLensRay (render.ts:695-702)
  F3 o{lens.x * a.coc, lens.y * a.coc, 0.0f};
  const float q = det_div(a.focus, d.z);
  d = normalize(F3{-d.x * q - o.x, -d.y * q - o.y, -d.z * q - o.z});
  if (kProj == kOrtho) {  // cameraRayPosition (render.ts:724-729)
    o = F3{o.x + u * a.fov_distance, o.y + v * a.fov_distance,
           o.z + 0.0f * a.fov_distance};
  }

  // ray_transform (render.ts:731-738)
  float oh[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float* m = view + 4 * j;
    oh[j] = ((o.x * m[0] + o.y * m[1]) + o.z * m[2]) + 1.0f * m[3];
  }
  d = normalize(F3{d.x, d.y, d.z * oh[3]});
  float dw[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const float* m = view + 4 * j;
    dw[j] = (d.x * m[0] + d.y * m[1]) + d.z * m[2];
  }
  return {F3{oh[0], oh[1], oh[2]}, F3{dw[0], dw[1], dw[2]}};
}

}  // namespace wrt
