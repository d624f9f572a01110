// Correctly rounded f32 helpers and the reference's PCG draws as device
// functions: ops/detmath.py, ops/strictf.py's dot and cross, and the
// parts of ops/rng.py that camera rays draw, op for op in the same order.
// Built with the library's --fmad=false (no product is contracted into its
// add) and without fast math (IEEE `/` and sqrtf), each line rounds as the
// eager plain-torch twin rounds it on the CPU, so a kernel made of them
// gives the twin's bits. Rules the twins impose:
//   - torch.round is rintf (ties to even);
//   - torch.clamp(x, min=e) keeps a NaN: `x < e ? e : x`, never fmaxf;
//   - Python-float operands are their f32 roundings (JAX's weak types);
//   - the RNG state word is a uint32_t (the twins mask an int64 word).
// The literals are the f32 roundings of ops/detmath.py's constants, in hex.
#pragma once

#include <cstdint>

namespace wrt {

struct DF {  // an unevaluated sum hi + lo (double-f32)
  float h, l;
};

struct F2 {
  float x, y;
};

struct F3 {
  float x, y, z;
};

// x * y == p + err exactly (Dekker, Veltkamp splitting by 4097)
__device__ __forceinline__ DF two_prod(float x, float y) {
  const float p = x * y;
  const float cx = 0x1.001p+12f * x;
  const float xh = cx - (cx - x);
  const float xl = x - xh;
  const float cy = 0x1.001p+12f * y;
  const float yh = cy - (cy - y);
  const float yl = y - yh;
  return {p, ((xh * yh - p) + xh * yl + xl * yh) + xl * yl};
}

// a + b == s + err exactly (Knuth)
__device__ __forceinline__ DF two_sum(float a, float b) {
  const float s = a + b;
  const float bb = s - a;
  return {s, (a - (s - bb)) + (b - bb)};
}

__device__ __forceinline__ DF df_add(DF a, DF b) {
  const DF s = two_sum(a.h, b.h);
  return two_sum(s.h, s.l + (a.l + b.l));
}

__device__ __forceinline__ DF df_mul(DF a, DF b) {
  const DF p = two_prod(a.h, b.h);
  return two_sum(p.h, p.l + (a.h * b.l + a.l * b.h));
}

__device__ __forceinline__ DF df_mul_f(DF a, float b) {
  const DF p = two_prod(a.h, b);
  return two_sum(p.h, p.l + a.l * b);
}

__device__ __forceinline__ float clamp_min(float x, float e) {
  return x < e ? e : x;
}

// num / den, correctly rounded (a no-op on the IEEE quotient, kept so the
// twin's op sequence, and its fallback off the finite range, is the same)
__device__ __forceinline__ float det_div(float num, float den) {
  const float q = num / den;
  const DF p = two_prod(q, den);
  const float r = (num - p.h) - p.l;
  const float res = q + r / den;
  return isfinite(res) ? res : q;
}

// sqrt(x), correctly rounded; zeros, infs and NaNs pass through
__device__ __forceinline__ float det_sqrt(float x) {
  const float s = sqrtf(x);
  const DF p = two_prod(s, s);
  const float r = (x - p.h) - p.l;
  const float res = s + r / (2.0f * s);
  return (s > 0.0f && isfinite(s)) ? res : s;
}

// strictf.sdot3: every product rounded, the adds left-associated
__device__ __forceinline__ float dot3(F3 a, F3 b) {
  return (a.x * b.x + a.y * b.y) + a.z * b.z;
}

// strictf.scross: every product rounded before its subtraction
__device__ __forceinline__ F3 cross3(F3 a, F3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
          a.x * b.y - a.y * b.x};
}

// v / max(|v|, 1e-20), the dot product left-associated
__device__ __forceinline__ F3 normalize(F3 v) {
  const float n = clamp_min(
      det_sqrt((v.x * v.x + v.y * v.y) + v.z * v.z), 0x1.79ca1p-67f);
  return {det_div(v.x, n), det_div(v.y, n), det_div(v.z, n)};
}

// the reduced-range double-f32 sine and cosine of x and its quadrant
struct SinCos {
  DF s, c;
  int q;
};

__device__ __forceinline__ SinCos sincos_core(float x) {
  const float n = rintf(x * 0x1.45f306p-1f);  // 2 / pi
  const DF e1 = two_prod(n, 0x1.921fb6p+0f);  // pi / 2, three parts
  DF r = df_add(two_sum(x, -e1.h), DF{-e1.l, 0.0f});
  const DF e2 = two_prod(n, -0x1.777a5cp-25f);
  r = df_add(r, DF{-e2.h, -e2.l});
  r = df_add(r, DF{-(n * -0x1.ee59dap-50f), 0.0f});

  const DF s = df_mul(r, r);
  const float sh = s.h;

  const float t_f =
      0x1.71de3ap-19f + sh * (-0x1.ae6456p-26f + sh * 0x1.612462p-33f);
  DF acc = df_add(DF{-0x1.a01a02p-13f, 0x1.7f97fap-39f}, df_mul_f(s, t_f));
  acc = df_add(DF{0x1.111112p-7f, -0x1.dddddep-32f}, df_mul(s, acc));
  acc = df_add(DF{-0x1.555556p-3f, 0x1.555556p-28f}, df_mul(s, acc));
  const DF t = df_mul(s, acc);
  const DF sin_r = df_mul(r, df_add(DF{1.0f, 0.0f}, t));

  const float c_f =
      -0x1.27e4fcp-22f + sh * (0x1.1eed8ep-29f + sh * -0x1.93974ap-37f);
  acc = df_add(DF{0x1.a01a02p-16f, -0x1.7f97fap-42f}, df_mul_f(s, c_f));
  acc = df_add(DF{-0x1.6c16c2p-10f, 0x1.27d27ep-35f}, df_mul(s, acc));
  acc = df_add(DF{0x1.555556p-5f, -0x1.555556p-30f}, df_mul(s, acc));
  acc = df_add(DF{-0.5f, 0.0f}, df_mul(s, acc));
  const DF cos_r = df_add(DF{1.0f, 0.0f}, df_mul(s, acc));

  return {sin_r, cos_r, static_cast<int>(n) & 3};
}

__device__ __forceinline__ F2 det_sincos(float x) {  // (sin x, cos x)
  const SinCos k = sincos_core(x);
  const float sr = k.s.h + k.s.l;
  const float cr = k.c.h + k.c.l;
  const bool odd = (k.q & 1) == 1;
  const float s = odd ? cr : sr;
  const float c = odd ? sr : cr;
  const bool neg_s = k.q == 2 || k.q == 3;
  const bool neg_c = k.q == 1 || k.q == 2;
  return {neg_s ? -s : s, neg_c ? -c : c};
}

// tan x: the double-f32 quotient of the unrounded sine and cosine
__device__ __forceinline__ float det_tan(float x) {
  const SinCos k = sincos_core(x);
  const bool odd = (k.q & 1) == 1;
  DF num = odd ? DF{-k.c.h, -k.c.l} : k.s;
  DF den = odd ? k.s : k.c;
  if (k.q == 2 || k.q == 3) {
    num = DF{-num.h, -num.l};
    den = DF{-den.h, -den.l};
  }
  const float q0 = num.h / den.h;
  const DF m = df_mul_f(den, q0);
  const DF rem = df_add(num, DF{-m.h, -m.l});
  const float q1 = (rem.h + rem.l) / den.h;
  return q0 + q1;
}

// the PCG hash (shaders/rng.ts:34-40); advances the state
__device__ __forceinline__ uint32_t random_1u(uint32_t& state) {
  const uint32_t old = state + 3639132858u;  // 747796405 + 2891336453
  const uint32_t word = ((old >> ((old >> 28) + 4)) ^ old) * 277803737u;
  state = (word >> 22) ^ word;
  return state;
}

__device__ __forceinline__ float random_1(uint32_t& state) {  // [0, 1]
  return static_cast<float>(random_1u(state)) / 0x1p+32f;
}

__device__ __forceinline__ F2 random_2(uint32_t& state) {  // x drawn first
  const float x = random_1(state);
  const float y = random_1(state);
  return {x, y};
}

// uniform in the unit disc (rng.ts:69-76)
__device__ __forceinline__ F2 sample_incircle(F2 t) {
  const F2 sc = det_sincos(t.x * 0x1.921fb6p+2f);  // 2 pi
  const float r = det_sqrt(t.y);
  return {sc.y * r, sc.x * r};
}

// uniform in [-1, 1]^2 (rng.ts:125-127)
__device__ __forceinline__ F2 sample_insquare(F2 t) {
  return {2.0f * t.x - 1.0f, 2.0f * t.y - 1.0f};
}

}  // namespace wrt
