// Closest-hit and any-hit cluster traces for NVIDIA Hopper (sm_90a):
// single-level (K1) and two-level (K3).
//
// K1 (`trace_kernel`) replaces the TPU kernels of
// webgpu_raytracing_tpu/ops/cluster_pallas.py in non-pairs mode:
// `_kernel_lockstep` (:1141; any-hit branch :1243) and the serial `_kernel`
// / `_kernel_one_tile` (:396, :436, the hbm=True streaming form; any-hit
// bound :576). Both compute, per ray, the closest triangle (closest-hit) or
// some blocking triangle (any-hit, shadow rays) among the clusters whose
// boxes the ray's 128-ray tile enters, walking clusters nearest entry first.
//
// K3 (`trace_two_level_kernel`) replaces `_kernel_two_level` (:1379, called
// at :1772), the large-scene form (BASELINE config #5): the tile walks
// SUPERclusters nearest entry first (their tile entry distances are computed
// outside the kernel), and for each super the kernel slab-tests the G child
// cluster boxes itself, takes the tile minimum per child and walks the
// children nearest first. Per-tile box work is O(C2 + supers visited x G)
// instead of O(C): on the 1M-triangle scene 227 supers instead of 14,528
// clusters.
//
// One slab test and one slot loop (`slab`, `test_cluster`) serve all four
// entry points, each templated on kAnyHit, so the arithmetic is written once.
//
// What is NOT carried over: the TPU kernels evaluate Möller–Trumbore as a
// bilinear-form matmul (ray matrix x cluster matrix B) because the MXU is
// the TPU's abundant unit, split f32 into bf16 hi/lo because Mosaic has no
// f32 MXU mode, batch tiles (lockstep, gang, tiles_per_step) to hide serial
// round latency, double-buffer each child's B by DMA, and keep the best hit
// as a packed (t | slot) key whose truncated low bits blur the prune bound
// and the child order. Here each thread is one ray and computes exact
// sequential f32 Möller–Trumbore, the reference's own arithmetic, on the
// triangle rows `tri`; minima and orders are exact floats.
//
// What bounds them on an H100: f32 ALU work per triangle test (about 50
// operations and one IEEE divide per candidate) and per box test (about 27),
// and L2 reads of the triangle rows `tri` (F x 9 f32: 1.6 MB for the 44k
// stress scene, 36 MB for the 1M one, inside the 50 MB L2). K1 keeps the
// reads shared: all threads of a block walk the same per-tile cluster order
// (sorted outside the kernel, as `_kernel_sched` does), so at a given step
// every lane that tests a cluster loads the same row and a warp's load is
// one broadcast transaction. K3 adds, per super a block visits, G slab tests
// per thread and four block barriers; it stages the G child boxes in shared
// memory once per block (1.5 KB at G = 64), reduces each child's minimum
// within the warp (`__reduce_min_sync`) and then across the four warps with
// one shared atomic each, so the child cull reads no device memory beyond
// that staging. Each thread stops at the first cluster (K3: child, and at
// the super level, super) whose tile-minimum entry distance is not below its
// own best t, and skips clusters its own slab test rejects.
//
// Contract (matches the plain twins `_trace_closest_torch` and
// `_walk_two_level_torch` in ops/cluster_cuda.py bit for bit; build with
// --fmad=false, no fast math):
//   * det < eps2 culls; u >= 0, u <= det, v >= 0, u + v <= det;
//     t = t_num / det (IEEE-rounded); t > 0;
//   * a candidate replaces the best when t < best, or t == best with a
//     smaller code (cid * S + slot); the best starts at (t_max, -1);
//   * the slot whose code equals the ray's exclusion code is skipped;
//   * inactive rays arrive with t_max = 0 and return (0, -1); misses
//     return (t_max, -1); NaN origins fail every compare and miss.
// The closest-hit result is the lexicographic minimum of (t, code) over all
// valid slots and both stop rules are conservative, so K1 and K3 return the
// same faces on the same rays and tables.
//
// Any-hit contract (`wrt_trace_any`, `wrt_trace_any_two_level`, JAX
// `trace_any_clustered` semantics): the ray stops at the FIRST valid slot in
// walk order (cluster order, then slot order) with 0 < t < t_max, returning
// its code, else -1. The bound is the exact `t < t_max` of the clustered
// oracle, not the Pallas kernel's truncated packed key, which blurs t ~
// t_max: that is where a shadow ray aimed at a light meets the light's own
// face. Flags do not depend on the walk; codes do.
//
// K3's child minima (JAX's formula): a ray contributes max(near, 0) for a
// child when near < far, near < t_max and far > 0, else F32_MAX; every
// thread contributes, finished or not, so the minima do not depend on walk
// progress. -0 is made +0 before the minimum is taken on the float's bits
// (exact for non-negative floats). Children are ranked by (minimum, index).
// Children without faces (the pads of the last super, inverted-empty boxes
// that a symmetric slab test does not reject) keep F32_MAX and are never
// visited.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxGroup = 128;
constexpr unsigned kF32MaxBits = 0x7f7fffffu;

// NaN-propagating min/max, as torch.minimum / torch.maximum
__device__ __forceinline__ float min_nan(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fminf(a, b);
}
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}

struct Ray {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz;
};

__device__ __forceinline__ Ray load_ray(const float* o, const float* d,
                                        const float* inv_d, long long ray) {
  return Ray{o[3 * ray],     o[3 * ray + 1],     o[3 * ray + 2],
             d[3 * ray],     d[3 * ray + 1],     d[3 * ray + 2],
             inv_d[3 * ray], inv_d[3 * ray + 1], inv_d[3 * ray + 2]};
}

// Slab test of one ray against one box (min.xyz, max.xyz) → (near, far),
// in the twin's axis order.
__device__ __forceinline__ void slab(const float* bx, const Ray& r,
                                     float& near_t, float& far_t) {
  float a = (bx[0] - r.ox) * r.ix, b = (bx[3] - r.ox) * r.ix;
  near_t = min_nan(a, b);
  far_t = max_nan(a, b);
  a = (bx[1] - r.oy) * r.iy;
  b = (bx[4] - r.oy) * r.iy;
  near_t = max_nan(near_t, min_nan(a, b));
  far_t = min_nan(far_t, max_nan(a, b));
  a = (bx[2] - r.oz) * r.iz;
  b = (bx[5] - r.oz) * r.iz;
  near_t = max_nan(near_t, min_nan(a, b));
  far_t = min_nan(far_t, max_nan(a, b));
}

// The occupied slots of cluster `cid`, in slot order, under the contract
// above. Closest-hit: updates (best, best_code), returns false. Any-hit:
// returns true at the first valid slot with t < best, its code in best_code.
template <bool kAnyHit>
__device__ __forceinline__ bool test_cluster(
    int cid, const Ray& r, int ex, const int* __restrict__ face_id,
    int slots, const float* __restrict__ tri, float eps2, float& best,
    int& best_code) {
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
    const float hx = r.dy * e2z - r.dz * e2y;
    const float hy = r.dz * e2x - r.dx * e2z;
    const float hz = r.dx * e2y - r.dy * e2x;
    const float det = (e1x * hx + e1y * hy) + e1z * hz;
    if (det < eps2) continue;
    const float sx = r.ox - p0x, sy = r.oy - p0y, sz = r.oz - p0z;
    const float u = (sx * hx + sy * hy) + sz * hz;
    // q = s x e1
    const float qx = sy * e1z - sz * e1y;
    const float qy = sz * e1x - sx * e1z;
    const float qz = sx * e1y - sy * e1x;
    const float v = (r.dx * qx + r.dy * qy) + r.dz * qz;
    const float tn = (e2x * qx + e2y * qy) + e2z * qz;
    if (!(u >= 0.0f && u <= det && v >= 0.0f && u + v <= det)) continue;
    const float t = __fdiv_rn(tn, det);
    if (!(t > 0.0f)) continue;
    if constexpr (kAnyHit) {
      if (t < best) {
        best_code = code;
        return true;
      }
    } else if (t < best || (t == best && code < best_code)) {
      best = t;
      best_code = code;
    }
  }
  return false;
}

// K1: one block per tile, one thread per ray, over the tile's cluster order.
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
  const Ray r = load_ray(o, d, inv_d, ray);
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
    float near_t, far_t;
    slab(box + 6 * cid, r, near_t, far_t);
    if (!((near_t < far_t) && (far_t > 0.0f) && (near_t < best))) continue;
    if (test_cluster<kAnyHit>(cid, r, ex, face_id, slots, tri, eps2, best,
                              best_code))
      break;
  }
  if constexpr (!kAnyHit) t_out[ray] = best;
  code_out[ray] = best_code;
}

// K3: one block per tile, one thread per ray, over the tile's SUPER order;
// the children of each super are culled, ranked and walked in the block.
// Every __syncthreads is reached by the whole block: the outer loop's exit
// is block-uniform (__syncthreads_or), and a finished thread stays in the
// loop to contribute to the child minima.
template <bool kAnyHit>
__global__ void trace_two_level_kernel(
    const float* __restrict__ o, const float* __restrict__ d,
    const float* __restrict__ inv_d, const float* __restrict__ t_max,
    const int* __restrict__ excl, const float* __restrict__ snear,
    const int* __restrict__ order, int n_cols,
    const float* __restrict__ box, const int* __restrict__ face_id, int slots,
    const float* __restrict__ tri, float eps2, int group,
    float* __restrict__ t_out, int* __restrict__ code_out) {
  __shared__ float s_box[6 * kMaxGroup];  // the super's child boxes
  __shared__ int s_full[kMaxGroup];       // child holds faces
  __shared__ unsigned s_cmin[kMaxGroup];  // tile-minimum entry, float bits
  __shared__ int s_rank[kMaxGroup];       // child index at each walk step

  const int tid = threadIdx.x;
  const long long tile = blockIdx.x;
  const long long ray = tile * blockDim.x + tid;
  const Ray r = load_ray(o, d, inv_d, ray);
  const int ex = excl[ray];
  const float tmax = t_max[ray];
  float best = tmax;
  int best_code = -1;
  bool found = false;  // any-hit: done at the first valid hit

  const float* srow = snear + tile * n_cols;
  const int* orow = order + tile * n_cols;
  for (int k = 0; k < n_cols; ++k) {
    // as K1's stop rule, per ray; the block goes on while any ray is live
    const bool live = !(srow[k] >= best) && !found;
    if (!__syncthreads_or(live)) break;
    const int c0 = orow[k] * group;
    if (tid < group) {
      const float* bx = box + 6LL * (c0 + tid);
      for (int q = 0; q < 6; ++q) s_box[6 * tid + q] = bx[q];
      s_full[tid] = face_id[(long long)(c0 + tid) * slots] >= 0;
      s_cmin[tid] = kF32MaxBits;
    }
    __syncthreads();
    for (int j = 0; j < group; ++j) {
      if (!s_full[j]) continue;  // block-uniform
      float near_t, far_t;
      slab(s_box + 6 * j, r, near_t, far_t);
      unsigned v = kF32MaxBits;
      if ((near_t < far_t) && (near_t < tmax) && (far_t > 0.0f))
        v = __float_as_uint(fmaxf(near_t, 0.0f) + 0.0f);  // -0 → +0
      v = __reduce_min_sync(0xffffffffu, v);
      if ((tid & 31) == 0) atomicMin(&s_cmin[j], v);
    }
    __syncthreads();
    if (tid < group) {
      const float mine = __uint_as_float(s_cmin[tid]);
      int pos = 0;
      for (int j = 0; j < group; ++j) {
        const float other = __uint_as_float(s_cmin[j]);
        pos += (other < mine) || (other == mine && j < tid);
      }
      s_rank[pos] = tid;
    }
    __syncthreads();
    if (live) {
      for (int q = 0; q < group; ++q) {
        const int j = s_rank[q];
        if (__uint_as_float(s_cmin[j]) >= best) break;
        float near_t, far_t;
        slab(s_box + 6 * j, r, near_t, far_t);
        if (!((near_t < far_t) && (far_t > 0.0f) && (near_t < best)))
          continue;
        if (test_cluster<kAnyHit>(c0 + j, r, ex, face_id, slots, tri, eps2,
                                  best, best_code)) {
          found = true;
          break;
        }
      }
    }
    // the next iteration's __syncthreads_or orders this walk's shared reads
    // before the next staging
  }
  if constexpr (!kAnyHit) t_out[ray] = best;
  code_out[ray] = best_code;
}

template <bool kAnyHit>
int launch_two_level(const float* o, const float* d, const float* inv_d,
                     const float* t_max, const int* excl, const float* snear,
                     const int* order, int n_cols, const float* box,
                     const int* face_id, int slots, const float* tri,
                     float eps2, int group, float* t_out, int* code_out,
                     int n_tiles, int tile, void* stream) {
  if (group < 1 || group > kMaxGroup || group > tile || tile % 32 != 0)
    return (int)cudaErrorInvalidValue;
  if (n_tiles > 0) {
    trace_two_level_kernel<kAnyHit>
        <<<n_tiles, tile, 0, (cudaStream_t)stream>>>(
            o, d, inv_d, t_max, excl, snear, order, n_cols, box, face_id,
            slots, tri, eps2, group, t_out, code_out);
  }
  return (int)cudaGetLastError();
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

extern "C" int wrt_trace_closest_two_level(
    const float* o, const float* d, const float* inv_d, const float* t_max,
    const int* excl, const float* snear, const int* order, int n_cols,
    const float* box, const int* face_id, int slots, const float* tri,
    float eps2, int group, float* t_out, int* code_out, int n_tiles,
    int tile, void* stream) {
  return launch_two_level<false>(o, d, inv_d, t_max, excl, snear, order,
                                 n_cols, box, face_id, slots, tri, eps2,
                                 group, t_out, code_out, n_tiles, tile,
                                 stream);
}

extern "C" int wrt_trace_any_two_level(
    const float* o, const float* d, const float* inv_d, const float* t_max,
    const int* excl, const float* snear, const int* order, int n_cols,
    const float* box, const int* face_id, int slots, const float* tri,
    float eps2, int group, int* code_out, int n_tiles, int tile,
    void* stream) {
  return launch_two_level<true>(o, d, inv_d, t_max, excl, snear, order,
                                n_cols, box, face_id, slots, tri, eps2, group,
                                nullptr, code_out, n_tiles, tile, stream);
}

extern "C" const char* wrt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
