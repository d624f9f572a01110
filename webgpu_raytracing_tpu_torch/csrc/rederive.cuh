// One ray of rederive (`wrt_rederive_uv`): the exact t, u and v of the
// winning triangle from its face alone, the arithmetic of the plain twin
// `_rederive_uv_torch` (ops/cluster_trace.py) line for line. Made of
// detmath.cuh's device functions alone, so it also compiles as host C++
// (tests compile it with g++ and hold it to the twin on the CPU).
#pragma once

#include <cstdint>

#include "detmath.cuh"

namespace wrt {

// f32(1e-30): the twin compares |det| with the Python float in f32
constexpr float kDetTiny = 0x1.4484cp-100f;

// o and d (n, 3), t and face (n,), tri (F, 9) rows of p0, e1, e2 →
// out (3, n): t, u, v. A hit reads its origin, direction and triangle; a
// miss (face < 0) only its t, which it keeps, with u = v = +0 (the twin
// computes row 0's algebra there and masks it away).
__device__ __forceinline__ void rederive_lane(
    const float* o, const float* d, const float* t, const int32_t* face,
    const float* tri, float* out, long long n, long long i) {
  const int32_t f = face[i];
  if (f < 0) {
    out[i] = t[i];
    out[n + i] = 0.0f;
    out[2 * n + i] = 0.0f;
    return;
  }
  const float* row = tri + 9LL * f;
  const F3 p0 = {row[0], row[1], row[2]};
  const F3 e1 = {row[3], row[4], row[5]};
  const F3 e2 = {row[6], row[7], row[8]};
  const F3 org = {o[3 * i], o[3 * i + 1], o[3 * i + 2]};
  const F3 dir = {d[3 * i], d[3 * i + 1], d[3 * i + 2]};
  const F3 h = cross3(dir, e2);
  const float det = dot3(e1, h);
  const F3 s = {org.x - p0.x, org.y - p0.y, org.z - p0.z};
  const float det_safe = fabsf(det) > kDetTiny ? det : 1.0f;
  const float u = det_div(dot3(s, h), det_safe);
  const F3 q = cross3(s, e1);
  const float v = det_div(dot3(dir, q), det_safe);
  out[i] = det_div(dot3(e2, q), det_safe);
  out[n + i] = u;
  out[2 * n + i] = v;
}

}  // namespace wrt
