// Closest-hit and any-hit cluster trace for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernels of webgpu_raytracing_tpu/ops/cluster_pallas.py
// in non-pairs mode: `_kernel_lockstep` (:1141; any-hit branch :1243) and
// the serial `_kernel` / `_kernel_one_tile` (:396, :436, the hbm=True
// streaming form; any-hit bound :576). Both compute, per ray, the closest
// triangle (closest-hit) or some blocking triangle (any-hit, shadow rays)
// among the clusters whose boxes the ray's 128-ray tile enters, walking
// clusters nearest entry first. One body, templated on kAnyHit, serves both
// entry points, so the slab test and Möller–Trumbore are written once.
//
// What is NOT carried over: the TPU kernels evaluate Möller–Trumbore as a
// bilinear-form matmul (ray matrix x cluster matrix B) because the MXU is
// the TPU's abundant unit, split f32 into bf16 hi/lo because Mosaic has no
// f32 MXU mode, and batch tiles (lockstep, gang, tiles_per_step) to hide
// serial round latency. Here each thread is one ray and computes exact
// sequential f32 Möller–Trumbore, the reference's own arithmetic.
//
// What bounds it on an H100: f32 ALU work per triangle test (about 40 flops
// and one IEEE divide per accepted candidate) and L2 reads of the triangle
// rows `tri` (F x 9 f32; about 1.6 MB for the 44k-triangle stress scene,
// well inside the 50 MB L2). The design keeps those reads shared: all 128
// threads of a block walk the same per-tile cluster order (sorted outside
// the kernel, as `_kernel_sched` does), so at a given step every lane that
// tests a cluster loads the same triangle row and a warp's load is one
// broadcast transaction. Each thread stops at the first cluster whose
// tile-minimum entry distance is not below its own best t (no later
// cluster can win), and skips clusters its own slab test rejects.
//
// Contract (matches the plain twin `_trace_closest_torch` in
// ops/cluster_cuda.py bit for bit; build with --fmad=false, no fast math):
//   * det < eps2 culls; u >= 0, u <= det, v >= 0, u + v <= det;
//     t = t_num / det (IEEE-rounded); t > 0;
//   * a candidate replaces the best when t < best, or t == best with a
//     smaller code (cid * S + slot); the best starts at (t_max, -1);
//   * the slot whose code equals the ray's exclusion code is skipped;
//   * inactive rays arrive with t_max = 0 and return (0, -1); misses
//     return (t_max, -1); NaN origins fail every compare and miss.
//
// Any-hit contract (`wrt_trace_any`, JAX `trace_any_clustered` semantics;
// twin `_trace_any_torch`): the ray returns at the FIRST valid slot in walk
// order (cluster order, then slot order) with 0 < t < t_max, writing its
// code, else -1. The bound is the exact `t < t_max` of the clustered oracle,
// not the Pallas kernel's truncated packed key, which blurs t ~ t_max: that
// is where a shadow ray aimed at a light meets the light's own face.

#include <cuda_runtime.h>

namespace {

// NaN-propagating min/max, as torch.minimum / torch.maximum
__device__ __forceinline__ float min_nan(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fminf(a, b);
}
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}

template <bool kAnyHit>
__global__ void trace_kernel(
    const float* __restrict__ o, const float* __restrict__ d,
    const float* __restrict__ inv_d, const float* __restrict__ t_max,
    const int* __restrict__ excl, const float* __restrict__ snear,
    const int* __restrict__ order, int n_cols,
    const float* __restrict__ box, const int* __restrict__ face_id, int slots,
    const float* __restrict__ tri, float eps2, float* __restrict__ t_out,
    int* __restrict__ code_out) {
  // any-hit: t_out is unused (may be null) and best stays t_max
  const long long tile = blockIdx.x;
  const long long ray = tile * blockDim.x + threadIdx.x;

  const float ox = o[3 * ray], oy = o[3 * ray + 1], oz = o[3 * ray + 2];
  const float dx = d[3 * ray], dy = d[3 * ray + 1], dz = d[3 * ray + 2];
  const float ix = inv_d[3 * ray], iy = inv_d[3 * ray + 1],
              iz = inv_d[3 * ray + 2];
  const int ex = excl[ray];
  float best = t_max[ray];
  int best_code = -1;

  const float* srow = snear + tile * n_cols;
  const int* orow = order + tile * n_cols;
  for (int k = 0; k < n_cols; ++k) {
    // tile distances are minima over the tile's rays and sorted: once one
    // is not below this ray's best, no later cluster can improve it
    if (srow[k] >= best) break;
    const int cid = orow[k];
    const float* bx = box + 6 * cid;
    float a = (bx[0] - ox) * ix, b = (bx[3] - ox) * ix;
    float near_t = min_nan(a, b), far_t = max_nan(a, b);
    a = (bx[1] - oy) * iy;
    b = (bx[4] - oy) * iy;
    near_t = max_nan(near_t, min_nan(a, b));
    far_t = min_nan(far_t, max_nan(a, b));
    a = (bx[2] - oz) * iz;
    b = (bx[5] - oz) * iz;
    near_t = max_nan(near_t, min_nan(a, b));
    far_t = min_nan(far_t, max_nan(a, b));
    if (!((near_t < far_t) && (far_t > 0.0f) && (near_t < best))) continue;

    const int* fids = face_id + (long long)cid * slots;
    for (int s = 0; s < slots; ++s) {
      const int f = fids[s];
      if (f < 0) break;  // occupied slots come first
      const int code = cid * slots + s;
      if (code == ex) continue;
      const float* tr = tri + 9LL * f;
      const float p0x = tr[0], p0y = tr[1], p0z = tr[2];
      const float e1x = tr[3], e1y = tr[4], e1z = tr[5];
      const float e2x = tr[6], e2y = tr[7], e2z = tr[8];
      // h = d x e2 ; det = e1 . h   (strict products, left-to-right sums)
      const float hx = dy * e2z - dz * e2y;
      const float hy = dz * e2x - dx * e2z;
      const float hz = dx * e2y - dy * e2x;
      const float det = (e1x * hx + e1y * hy) + e1z * hz;
      if (det < eps2) continue;
      const float sx = ox - p0x, sy = oy - p0y, sz = oz - p0z;
      const float u = (sx * hx + sy * hy) + sz * hz;
      // q = s x e1
      const float qx = sy * e1z - sz * e1y;
      const float qy = sz * e1x - sx * e1z;
      const float qz = sx * e1y - sy * e1x;
      const float v = (dx * qx + dy * qy) + dz * qz;
      const float tn = (e2x * qx + e2y * qy) + e2z * qz;
      if (!(u >= 0.0f && u <= det && v >= 0.0f && u + v <= det)) continue;
      const float t = __fdiv_rn(tn, det);
      if (!(t > 0.0f)) continue;
      if constexpr (kAnyHit) {
        if (t < best) {
          code_out[ray] = code;
          return;
        }
      } else if (t < best || (t == best && code < best_code)) {
        best = t;
        best_code = code;
      }
    }
  }
  if constexpr (!kAnyHit) t_out[ray] = best;
  code_out[ray] = best_code;
}

}  // namespace

extern "C" int wrt_trace_closest(
    const float* o, const float* d, const float* inv_d, const float* t_max,
    const int* excl, const float* snear, const int* order, int n_cols,
    const float* box, const int* face_id, int slots, const float* tri,
    float eps2, float* t_out, int* code_out, int n_tiles, int tile,
    void* stream) {
  if (n_tiles > 0) {
    trace_kernel<false><<<n_tiles, tile, 0, (cudaStream_t)stream>>>(
        o, d, inv_d, t_max, excl, snear, order, n_cols, box, face_id, slots,
        tri, eps2, t_out, code_out);
  }
  return (int)cudaGetLastError();
}

extern "C" int wrt_trace_any(
    const float* o, const float* d, const float* inv_d, const float* t_max,
    const int* excl, const float* snear, const int* order, int n_cols,
    const float* box, const int* face_id, int slots, const float* tri,
    float eps2, int* code_out, int n_tiles, int tile, void* stream) {
  if (n_tiles > 0) {
    trace_kernel<true><<<n_tiles, tile, 0, (cudaStream_t)stream>>>(
        o, d, inv_d, t_max, excl, snear, order, n_cols, box, face_id, slots,
        tri, eps2, nullptr, code_out);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* wrt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
