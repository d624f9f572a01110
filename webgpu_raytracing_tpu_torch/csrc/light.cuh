// One lane of a light sample of next-event estimation, the arithmetic of
// the plain twins in ops/integrator.py (`_light_sample_torch`, which is
// `sample_lights` and `light_ray`, and `_light_add_torch`) line for line:
// the kernels of light.cu run it once a thread. Made of detmath.cuh's and
// shade.cuh's device functions alone, so it also compiles as host C++
// (tests compile it with g++ and hold it to the twins on the CPU).
//
// Rules beyond shade.cuh's:
//   - the light face is offset + u1 % count in int64, as the twin's
//     int64 words compute it (count > 0 by the scene's contract);
//   - 1/pdf's square root is det_sqrt, correctly rounded, as the twin's
//     (torch.sqrt on the CPU may be an ulp off);
//   - the light's material index travels as the int32 bits of a float
//     (the carry is one f32 tensor);
//   - the first sample's colour starts from +0, so a -0 contribution
//     comes out +0, as the twin's zeros + contribution.
#pragma once

#include <cstdint>

#include "detmath.cuh"
#include "shade.cuh"

namespace wrt {

// f32(1e-20): the twins' clamp of the squared distance
constexpr float kDistSqMin = 0x1.79ca1p-67f;

// The tensors of `light_sample`, in the order of its buffers
// (ops/integrator.py `_light_sample_buffers`): lane inputs, scene tables,
// then outputs. A lane is i in [0, n).
struct LightSampleArgs {
  const float* point;  // (n, 3) the shading points
  const int64_t* state;  // (n,) PCG words in [0, 2^32)
  const int32_t* model_face_offset;  // (M,): model 0 is the light
  const int32_t* model_face_count;  // (M,)
  const float* tri;  // (F, 9): p0, e1, e2
  const float* shade_normal;  // (F, 12): face normal, n0, n1, n2
  const int32_t* face_material;  // (F,)
  float* d_out;  // (n, 3) the shadow ray's direction
  float* t_max_out;  // (n,) the distance to the light point
  float* carry_out;  // (3, n): 1/pdf, d_sq, the material's int32 bits
  int64_t* state_out;  // (n,)
};

// The tensors of `light_add`, in the order of `_light_add_buffers`.
struct LightAddArgs {
  const uint8_t* shadowed;  // (n,) the shadow leg's answer
  const float* d;  // (n, 3) the shadow ray's direction
  const float* normal;  // (n, 3) the shading normal
  const float* carry;  // (3, n) light_sample's
  const float* color;  // (n, 3) the samples so far; null on the first
  const float* mat_emission;  // (K, 3)
  float* color_out;  // (n, 3)
};

// sampleLights → sampleModel(models[0]) → sampleFace (render.ts:849-869):
// random_1u then random_2 on every lane, unmasked; then the shadow ray
// from the shading point to the light point (ops/integrator.light_ray).
// The light's normal, which pointColor never reads, is not computed.
__device__ __forceinline__ void light_sample_lane(const LightSampleArgs& a,
                                                  long long n, long long i) {
  uint32_t s = static_cast<uint32_t>(a.state[i]);
  const long long count = a.model_face_count[0];
  const long long f = a.model_face_offset[0] +
                      static_cast<long long>(random_1u(s)) % count;
  const F2 t2 = random_2(s);
  const bool flip = t2.x + t2.y > 1.0f;  // rng.sample_intriangle
  const float u = flip ? 1.0f - t2.x : t2.x;
  const float v = flip ? 1.0f - t2.y : t2.y;
  const float* t = a.tri + 9 * f;
  const F3 lp = face_point_offset(t, a.shade_normal + 12 * f, u, v);
  // 1/pdf = |cross(e1, e2)| / 2 × face count (render.ts:862-869)
  const F3 cr = cross3(F3{t[3], t[4], t[5]}, F3{t[6], t[7], t[8]});
  const float inv_pdf =
      det_sqrt(dot3(cr, cr)) / 2.0f * static_cast<float>(count);

  const F3 p = load3(a.point, i);
  const F3 ds = {lp.x - p.x, lp.y - p.y, lp.z - p.z};
  const float d_sq = dot3(ds, ds);
  const float inv_d = det_div(1.0f, det_sqrt(clamp_min(d_sq, kDistSqMin)));
  store3(a.d_out, i, F3{ds.x * inv_d, ds.y * inv_d, ds.z * inv_d});
  a.t_max_out[i] = det_sqrt(clamp_min(d_sq, 0.0f));
  a.carry_out[i] = inv_pdf;
  a.carry_out[n + i] = d_sq;
  a.carry_out[2 * n + i] =
      float_of(static_cast<uint32_t>(a.face_material[f]));
  a.state_out[i] = s;
}

// pointColor's sum (render.ts:1143-1157): visibility × cosine × 1/pdf / r²
// times the light's emission, added to the colour; `last` divides by the
// `spp` samples
__device__ __forceinline__ void light_add_lane(const LightAddArgs& a,
                                               int spp, bool last,
                                               long long n, long long i) {
  const float vis = a.shadowed[i] != 0 ? 0.0f : 1.0f;
  const float cosine = clamp_min(dot3(load3(a.d, i), load3(a.normal, i)),
                                 0.0f);
  const long long m = static_cast<int32_t>(bits_of(a.carry[2 * n + i]));
  const F3 e = load3(a.mat_emission, m);
  const float contrib =
      vis * cosine * a.carry[i] / clamp_min(a.carry[n + i], kDistSqMin);
  F3 c = a.color != nullptr ? load3(a.color, i) : F3{0.0f, 0.0f, 0.0f};
  c = {c.x + e.x * contrib, c.y + e.y * contrib, c.z + e.z * contrib};
  if (last) {
    const float k = static_cast<float>(spp);
    c = {c.x / k, c.y / k, c.z / k};
  }
  store3(a.color_out, i, c);
}

}  // namespace wrt
