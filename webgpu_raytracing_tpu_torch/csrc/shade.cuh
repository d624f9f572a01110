// One lane of a path segment's shading, the arithmetic of the plain twins
// in ops/integrator.py (`_shade_hit_torch`, `_shade_bounce_torch`) line for
// line: the kernels of shade.cu run it once a thread. Made of
// detmath.cuh's device functions alone, so it also compiles as host C++
// (tests compile it with g++ and hold it to the twins on the CPU).
//
// Rules beyond detmath.cuh's:
//   - f32 -> i32 truncates, and NaN or out of range gives INT32_MIN, as the
//     CPU twin's conversion does (x86 cvttss2si);
//   - int32 adds wrap (done on uint32_t);
//   - the roulette's max propagates NaN, as torch.amax does;
//   - booleans are bytes of 0 or 1 (torch.bool).
#pragma once

#include <cstdint>
#include <cstring>

#include "detmath.cuh"

namespace wrt {

// The tensors of `shade_hit`, in the order of ops/integrator.py's
// `_HIT_FIELDS`: lane inputs, scene tables, then outputs. A lane is i in
// [0, n); rows of three floats are (n, 3) row-major.
struct ShadeHitArgs {
  const int32_t* face;  // the hit: -1 on a miss
  const float* u;
  const float* v;
  const uint8_t* alive;
  const float* d;  // (n, 3)
  const float* color;
  const float* throughput;
  const float* env_dir;
  const float* env_w;
  const float* env_mis_pdf;  // (n,); read with kEnvMis only
  const float* prev_bsdf_pdf;  // (n,); read with kEnvMis only
  const int32_t* face_material;  // (F,)
  const float* mat_emission;  // (K, 3)
  const float* mat_color;  // (K, 3)
  const float* tri;  // (F, 9): p0, e1, e2
  const float* shade_normal;  // (F, 12): face normal, n0, n1, n2
  const int32_t* partner_code;  // (F,) or null
  float* color_out;
  float* throughput_out;
  float* env_dir_out;
  float* env_w_out;
  float* env_mis_pdf_out;  // written with kEnvMis only
  float* n_out;
  float* new_o_out;
  int32_t* excl_out;  // written when partner_code is not null
  uint8_t* h_out;
};

// The tensors of `shade_bounce`, in the order of `_BOUNCE_FIELDS`.
struct ShadeBounceArgs {
  const int64_t* state;  // PCG words in [0, 2^32)
  const uint8_t* h;
  const float* n;  // (n, 3)
  const float* new_o;
  const float* throughput;
  const float* o;
  const float* d;
  const float* prev_bsdf_pdf;  // read with kEnvIs only
  int64_t* state_out;
  float* throughput_out;
  uint8_t* alive_out;
  float* o_out;
  float* d_out;
  float* prev_bsdf_pdf_out;  // written with kEnvIs only
};

__device__ __forceinline__ F3 load3(const float* p, long long i) {
  return {p[3 * i], p[3 * i + 1], p[3 * i + 2]};
}

__device__ __forceinline__ void store3(float* p, long long i, F3 v) {
  p[3 * i] = v.x;
  p[3 * i + 1] = v.y;
  p[3 * i + 2] = v.z;
}

__device__ __forceinline__ int32_t trunc_i32(float x) {
  return (x >= -0x1p+31f && x < 0x1p+31f) ? static_cast<int32_t>(x)
                                          : INT32_MIN;
}

__device__ __forceinline__ uint32_t bits_of(float x) {
  uint32_t b;
  memcpy(&b, &x, 4);
  return b;
}

__device__ __forceinline__ float float_of(uint32_t b) {
  float x;
  memcpy(&x, &b, 4);
  return x;
}

// offsetRay (render.ts:905-917) on one component, both of the reference's
// inverted selects kept: a component that is exactly -0 with a positive
// offset becomes a NaN origin
__device__ __forceinline__ float offset_1(float p, float n) {
  const int32_t of_i = trunc_i32(256.0f * n);
  const uint32_t step = p < 0.0f ? static_cast<uint32_t>(of_i)
                                 : 0u - static_cast<uint32_t>(of_i);
  const float p_int = float_of(bits_of(p) + step);
  const float p_float = p + 0x1p-16f * n;
  return fabsf(p) < 0x1p-5f ? p_int : p_float;
}

// facePointOffset (render.ts:883-889) of a face's rows: its point at
// (u, v), p0 + e1 u + e2 v, offset along its face normal
__device__ __forceinline__ F3 face_point_offset(const float* t,
                                                const float* sn, float u,
                                                float v) {
  const F3 p = {(t[0] + t[3] * u) + t[6] * v, (t[1] + t[4] * u) + t[7] * v,
                (t[2] + t[5] * u) + t[8] * v};
  return {offset_1(p.x, sn[0]), offset_1(p.y, sn[1]), offset_1(p.z, sn[2])};
}

// rng.sample_sphere (rng.ts:102-109)
__device__ __forceinline__ F3 sample_sphere(F2 t) {
  const float u = t.x * 2.0f - 1.0f;
  const float sin_theta = det_sqrt(clamp_min(1.0f - u * u, 0.0f));
  const F2 sc = det_sincos(0x1.921fb6p+2f * t.y);  // 2 pi
  return {sin_theta * sc.y, u, sin_theta * sc.x};
}

__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : (a < b ? b : a));
}

// the segment's hit: the deferred environment's bookkeeping, emission and
// albedo, the shading normal, the offset origin and the twin's exclusion
template <bool kPhong, bool kEnvMis>
__device__ __forceinline__ void shade_hit_lane(const ShadeHitArgs& a,
                                               long long i) {
  const int32_t face = a.face[i];
  const bool alive = a.alive[i] != 0;
  const bool found = face >= 0;
  const bool miss = alive && !found;
  const bool h = alive && found;
  const F3 thr = load3(a.throughput, i);

  store3(a.env_dir_out, i, miss ? load3(a.d, i) : load3(a.env_dir, i));
  store3(a.env_w_out, i, miss ? thr : load3(a.env_w, i));
  if (kEnvMis)
    a.env_mis_pdf_out[i] = miss ? a.prev_bsdf_pdf[i] : a.env_mis_pdf[i];

  const long long f = face < 0 ? 0 : face;
  F3 color = load3(a.color, i);
  F3 thr_out = thr;
  if (h) {
    const long long m = a.face_material[f];
    const F3 em = load3(a.mat_emission, m);
    const F3 al = load3(a.mat_color, m);
    color = {color.x + em.x * thr.x, color.y + em.y * thr.y,
             color.z + em.z * thr.z};
    thr_out = {thr.x * al.x, thr.y * al.y, thr.z * al.z};
  }
  store3(a.color_out, i, color);
  store3(a.throughput_out, i, thr_out);

  const float u = a.u[i];
  const float v = a.v[i];
  const float* sn = a.shade_normal + 12 * f;
  F3 n;
  if (kPhong) {  // faceNormal: not normalized (render.ts:891-900)
    const float w = (1.0f - u) - v;
    n = {(sn[3] * w + sn[6] * u) + sn[9] * v,
         (sn[4] * w + sn[7] * u) + sn[10] * v,
         (sn[5] * w + sn[8] * u) + sn[11] * v};
  } else {
    n = {sn[0], sn[1], sn[2]};
  }
  store3(a.n_out, i, n);

  store3(a.new_o_out, i, face_point_offset(a.tri + 9 * f, sn, u, v));

  if (a.partner_code != nullptr) a.excl_out[i] = h ? a.partner_code[f] : -1;
  a.h_out[i] = h;
}

// the segment's bounce: the cosine-weighted direction, the BSDF pdf that
// the deferred environment fetch weighs by, Russian roulette
// (render.ts:1201-1208), and the merges of the lane state
template <bool kEnvIs>
__device__ __forceinline__ void shade_bounce_lane(const ShadeBounceArgs& a,
                                                  bool run_env,
                                                  long long i) {
  const bool h = a.h[i] != 0;
  uint32_t state = static_cast<uint32_t>(a.state[i]);
  uint32_t s = state;
  const F2 t2 = random_2(s);
  if (h) state = s;
  F3 thr = load3(a.throughput, i);
  const float p = nan_max(nan_max(thr.x, thr.y), thr.z);
  s = state;
  const float r1 = random_1(s);
  if (h) state = s;
  const bool alive = h && r1 <= p;

  // the normal and the new direction matter only where the path goes on,
  // and on every hit lane for the BSDF pdf of env-IS
  const bool pdf = kEnvIs && run_env && h;
  F3 n = {0.0f, 0.0f, 0.0f}, new_d = n;
  if (alive || pdf) {
    n = load3(a.n, i);
    const F3 sph = sample_sphere(t2);
    new_d = normalize(F3{n.x + sph.x, n.y + sph.y, n.z + sph.z});
  }
  if (kEnvIs) {  // env_sample.bsdf_pdf
    a.prev_bsdf_pdf_out[i] =
        pdf ? clamp_min(dot3(new_d, normalize(n)), 0.0f) * 0x1.45f306p-2f
            : h ? -1.0f : a.prev_bsdf_pdf[i];
  }
  if (alive) {
    const float c = clamp_min(p, 0x1.79ca1p-67f);  // 1e-20
    thr = {thr.x / c, thr.y / c, thr.z / c};
  }
  a.state_out[i] = state;
  store3(a.throughput_out, i, thr);
  a.alive_out[i] = alive;
  store3(a.o_out, i, alive ? load3(a.new_o, i) : load3(a.o, i));
  store3(a.d_out, i, alive ? new_d : load3(a.d, i));
}

}  // namespace wrt
