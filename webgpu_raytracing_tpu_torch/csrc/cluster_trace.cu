// Closest-hit, any-hit and exact-pairs cluster traces for NVIDIA Hopper
// (sm_90a): single-level (K1, K2p) and two-level (K3, K3p).
//
// K1 (`trace_kernel<Exact>`) replaces the TPU kernels of
// webgpu_raytracing_tpu/ops/cluster_pallas.py in non-pairs mode:
// `_kernel_lockstep` (:1141; any-hit branch :1243) and the serial `_kernel`
// / `_kernel_one_tile` (:396, :436, the hbm=True streaming form; any-hit
// bound :576). Both compute, per ray, the closest triangle (closest-hit) or
// some blocking triangle (any-hit, shadow rays) among the clusters whose
// boxes the ray's 128-ray tile enters, walking clusters nearest entry first.
//
// K3 (`trace_two_level_kernel<Exact>`) replaces `_kernel_two_level` (:1379,
// called at :1772), the large-scene form (BASELINE config #5): the tile
// walks SUPERclusters nearest entry first (their tile entry distances are
// computed outside the kernel), and for each super the kernel slab-tests the
// G child cluster boxes itself, takes the tile minimum per child and walks
// the children nearest first. Per-tile box work is O(C2 + supers visited x
// G) instead of O(C): on the 1M-triangle scene 227 supers instead of 14,528
// clusters.
//
// K2p and K3p (`trace_kernel<Pairs>`, `trace_two_level_kernel<Pairs>`)
// replace the same two kernels with `pairs=True` (`_round_pick`'s pairs
// branch :236-270 and :335-373, `_amb_flag` :376, the robust-anchored bound
// :582-590 and :1443-1458, outputs :835-838 and :1566-1569): the exact-pairs
// trace behind RenderSettings.exact_pairs. They walk exactly as K1 and K3
// do, but rank candidates on estimates, the bilinear form A·B of the ray
// matrix A = [o | o x d | d | 1] and the cluster matrix `mat_b`, and carry
// three candidates and an ambiguity flag out for the exact adjudication
// (ops/adjudicate.py).
//
// One slab test serves all six entry points, and each level has one walk,
// templated on the search (`Exact<kAnyHit>` or `Pairs`), so the walks and
// the arithmetic are written once.
//
// What is NOT carried over: the TPU kernels evaluate Möller–Trumbore as a
// bilinear-form matmul (ray matrix x cluster matrix B) because the MXU is
// the TPU's abundant unit, split f32 into bf16 hi/lo because Mosaic has no
// f32 MXU mode, batch tiles (lockstep, gang, tiles_per_step) to hide serial
// round latency, double-buffer each child's B by DMA, and keep the best hit
// as a packed (t | slot) key whose truncated low bits blur the prune bound
// and the child order. Here each thread is one ray. K1 and K3 compute exact
// sequential f32 Möller–Trumbore, the reference's own arithmetic, on the
// triangle rows `tri`; K2p and K3p compute A·B in f32 on the CUDA cores, one
// slot at a time; minima and orders are exact floats.
//
// What bounds them on an H100: f32 ALU work per triangle test (K1/K3: about
// 50 operations and one IEEE divide per candidate; K2p/K3p: about 95, the
// estimates and their magnitudes) and per box test (about 27), and L2 reads
// of the triangle rows `tri` (F x 9 f32: 1.6 MB for the 44k stress scene,
// 36 MB for the 1M one, inside the 50 MB L2) or of `mat_b`'s 19 nonzero
// entries per slot (K2p/K3p: 76 B per face, 3.4 MB and 76 MB). K1 keeps the
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
// own bound, and skips clusters its own slab test rejects.
//
// Contract of K1 and K3 (matches the plain twins `_trace_closest_torch` and
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
// Pairs contract (`wrt_trace_pairs`, `wrt_trace_pairs_two_level`; matches
// `_walk_pairs_torch` and `_walk_pairs_two_level_torch` bit for bit):
//   * estimates: det, t_num, u_num, v_num of slot s are A·B over the
//     structurally nonzero rows of B (pack_cluster_tables): det over rows
//     6, 7, 8 of column s; t_num over rows 0, 1, 2, 9 of column S + s; u_num
//     over rows 3..8 of column 2S + s; v_num over rows 3..8 of column 3S + s.
//     Each is a sum of strict products added left to right in that row
//     order; the magnitudes |A|·|B| are the same sums of |a||b|;
//   * with m_x = magnitude_x x margin: margin-valid when det >= eps2 (not
//     margined), u >= -m_u, u <= det + m_u, v >= -m_v and
//     u + v <= (det + m_u) + m_v, and t = t_num / det (IEEE) > 0; robust when
//     margin-valid and det >= eps2 + m_d, u >= m_u, u <= det - m_u, v >= m_v,
//     u + v <= (det - m_u) - m_v and t_num >= m_t; the exclusion code masks
//     both sets. The margin is an argument (ops/cluster_cuda.py MARGIN,
//     2^-20): the TPU's 2^-14 covers its bf16 hi/lo error with 2x safety,
//     and on these f32 estimates it lets impostors crowd the carried pairs
//     of small triangles (see MARGIN);
//   * carried per ray: (t1, c1), (t2, c2), the two smallest margin-valid
//     (t, code) pairs in lexicographic order, and (t3, c3), the smallest
//     robust pair; all start at (t_max, -1) and take a candidate on a strict
//     <. This is `_round_pick`'s merge on exact pairs, where the TPU merges
//     packed keys whose low mantissa bits are truncated;
//   * bound: the robust t3 widened by 2^9 ulps on its bits (unsigned, capped
//     at F32_MAX). It replaces K1's and K3's best t in every stop rule
//     (cluster, super and child) and in the per-ray skip: a bound on t1
//     would let a margin-limbo impostor (a bounce ray's own source face)
//     stop the walk before the true winner's cluster;
//   * out: t1, c1, c2, c3 and amb = (c3 != c1) | (c2 >= 0 and the bits of t2
//     and t1 less than 2 x 2^9 apart), `_amb_flag` without its slot-bit
//     term, which has no counterpart: t is not truncated here.
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
constexpr unsigned kBoundUlps = 1u << 9;      // (cluster_pallas.py:566)
constexpr long long kAmbBand = 2 * (1 << 9);  // (cluster_pallas.py:389)

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

// What every walk reads besides its search's own inputs.
struct Walk {
  const float* inv_d;
  const float* t_max;
  const int* excl;
  const float* snear;  // (n_tiles, n_cols) sorted tile entry distances
  const int* order;    // (n_tiles, n_cols) box of each entry
  int n_cols;
  const float* box;    // (C, 6) cluster boxes
  const int* face_id;  // (C, slots)
  int slots;
  float eps2;
  int group;           // two-level: G children per super; 0: single-level
};

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

// K1 / K3 inputs and outputs beyond the walk's
struct ExactIn {
  const float* o;
  const float* d;
  const float* tri;  // (F, 9) p0, e1, e2
  float* t_out;      // closest-hit only
  int* code_out;
};

// The exact search of K1 and K3 (contracts above). Closest-hit: the best
// (t, code). Any-hit: done at the first valid slot with t < t_max.
template <bool kAnyHit>
struct Exact {
  using In = ExactIn;
  Ray r;
  int ex;
  float best;
  int best_code;

  __device__ Exact(const In& in, const Walk& w, long long ray)
      : r{in.o[3 * ray],      in.o[3 * ray + 1],      in.o[3 * ray + 2],
          in.d[3 * ray],      in.d[3 * ray + 1],      in.d[3 * ray + 2],
          w.inv_d[3 * ray],   w.inv_d[3 * ray + 1],   w.inv_d[3 * ray + 2]},
        ex(w.excl[ray]), best(w.t_max[ray]), best_code(-1) {}

  // stop and skip bound: the best t (any-hit: t_max)
  __device__ __forceinline__ float bound() const { return best; }

  // The occupied slots of cluster `cid`, in slot order. Returns true when
  // the ray is done (any-hit: its first valid hit, code in best_code).
  __device__ __forceinline__ bool test(int cid, const In& in, const Walk& w) {
    const int* fids = w.face_id + (long long)cid * w.slots;
    for (int s = 0; s < w.slots; ++s) {
      const int f = fids[s];
      if (f < 0) break;  // occupied slots come first
      const int code = cid * w.slots + s;
      if (code == ex) continue;
      const float* tr = in.tri + 9LL * f;
      const float p0x = tr[0], p0y = tr[1], p0z = tr[2];
      const float e1x = tr[3], e1y = tr[4], e1z = tr[5];
      const float e2x = tr[6], e2y = tr[7], e2z = tr[8];
      // h = d x e2 ; det = e1 . h   (strict products, left-to-right sums)
      const float hx = r.dy * e2z - r.dz * e2y;
      const float hy = r.dz * e2x - r.dx * e2z;
      const float hz = r.dx * e2y - r.dy * e2x;
      const float det = (e1x * hx + e1y * hy) + e1z * hz;
      if (det < w.eps2) continue;
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

  __device__ __forceinline__ void store(const In& in, long long ray) const {
    if constexpr (!kAnyHit) in.t_out[ray] = best;
    in.code_out[ray] = best_code;
  }
};

// K2p / K3p inputs and outputs beyond the walk's
struct PairsIn {
  const float* a;      // (R, 10) ray matrix [o | o x d | d | 1]
  const float* mat_b;  // (C, 10, 4 * slots)
  float margin;        // relative validity margin (MARGIN, 2^-20)
  float* t_out;        // t1
  int* c1_out;
  int* c2_out;
  int* c3_out;
  int* amb_out;
};

__device__ __forceinline__ bool lex_less(float t, int c, float tb, int cb) {
  return t < tb || (t == tb && c < cb);
}

// The exact-pairs search of K2p and K3p (pairs contract above).
struct Pairs {
  using In = PairsIn;
  Ray r;
  float av[10], aa[10];  // the ray's row of A and |A|
  int ex;
  float t1, t2, t3;
  int c1, c2, c3;

  __device__ Pairs(const In& in, const Walk& w, long long ray)
      : ex(w.excl[ray]), c1(-1), c2(-1), c3(-1) {
#pragma unroll
    for (int k = 0; k < 10; ++k) {
      av[k] = in.a[10 * ray + k];
      aa[k] = fabsf(av[k]);
    }
    r = Ray{av[0], av[1], av[2], av[6], av[7], av[8],
            w.inv_d[3 * ray], w.inv_d[3 * ray + 1], w.inv_d[3 * ray + 2]};
    t1 = t2 = t3 = w.t_max[ray];
  }

  // stop and skip bound: t3 + 2^9 ulps, capped at F32_MAX
  __device__ __forceinline__ float bound() const {
    return __uint_as_float(min(__float_as_uint(t3) + kBoundUlps, kF32MaxBits));
  }

  __device__ __forceinline__ bool test(int cid, const In& in, const Walk& w) {
    const int* fids = w.face_id + (long long)cid * w.slots;
    const int n4 = 4 * w.slots;  // a row of B
    const float* b = in.mat_b + (long long)cid * 10 * n4;
    for (int s = 0; s < w.slots; ++s) {
      if (fids[s] < 0) break;  // occupied slots come first
      const int code = cid * w.slots + s;
      if (code == ex) continue;
      const float* bd = b + s;            // det:   rows 6, 7, 8
      const float* bt = bd + w.slots;     // t_num: rows 0, 1, 2, 9
      const float* bu = bt + w.slots;     // u_num: rows 3..8
      const float* bv = bu + w.slots;     // v_num: rows 3..8
      const float det =
          (av[6] * bd[6 * n4] + av[7] * bd[7 * n4]) + av[8] * bd[8 * n4];
      if (!(det >= w.eps2)) continue;
      const float tn = ((av[0] * bt[0] + av[1] * bt[n4]) + av[2] * bt[2 * n4]) +
                       av[9] * bt[9 * n4];
      float u = av[3] * bu[3 * n4], v = av[3] * bv[3 * n4];
      float mu = aa[3] * fabsf(bu[3 * n4]), mv = aa[3] * fabsf(bv[3 * n4]);
#pragma unroll
      for (int k = 4; k < 9; ++k) {
        u = u + av[k] * bu[k * n4];
        v = v + av[k] * bv[k * n4];
        mu = mu + aa[k] * fabsf(bu[k * n4]);
        mv = mv + aa[k] * fabsf(bv[k * n4]);
      }
      const float md = (aa[6] * fabsf(bd[6 * n4]) + aa[7] * fabsf(bd[7 * n4])) +
                       aa[8] * fabsf(bd[8 * n4]);
      const float mt = ((aa[0] * fabsf(bt[0]) + aa[1] * fabsf(bt[n4])) +
                        aa[2] * fabsf(bt[2 * n4])) +
                       aa[9] * fabsf(bt[9 * n4]);
      const float m_d = md * in.margin, m_t = mt * in.margin;
      const float m_u = mu * in.margin, m_v = mv * in.margin;
      const float uv = u + v;
      if (!(u >= -m_u && u <= det + m_u && v >= -m_v &&
            uv <= (det + m_u) + m_v))
        continue;
      const float t = __fdiv_rn(tn, det);
      if (!(t > 0.0f)) continue;
      if (lex_less(t, code, t1, c1)) {
        t2 = t1;
        c2 = c1;
        t1 = t;
        c1 = code;
      } else if (lex_less(t, code, t2, c2)) {
        t2 = t;
        c2 = code;
      }
      const bool robust = det >= w.eps2 + m_d && u >= m_u && u <= det - m_u &&
                          v >= m_v && uv <= (det - m_u) - m_v && tn >= m_t;
      if (robust && lex_less(t, code, t3, c3)) {
        t3 = t;
        c3 = code;
      }
    }
    return false;
  }

  __device__ __forceinline__ void store(const In& in, long long ray) const {
    in.t_out[ray] = t1;
    in.c1_out[ray] = c1;
    in.c2_out[ray] = c2;
    in.c3_out[ray] = c3;
    const long long gap =
        (long long)__float_as_int(t2) - (long long)__float_as_int(t1);
    in.amb_out[ray] = (c3 != c1) || (c2 >= 0 && gap < kAmbBand);
  }
};

// K1 / K2p: one block per tile, one thread per ray, over the tile's cluster
// order.
template <class Search>
__global__ void trace_kernel(typename Search::In in, Walk w) {
  const long long tile = blockIdx.x;
  const long long ray = tile * blockDim.x + threadIdx.x;
  Search s(in, w, ray);
  const float* srow = w.snear + tile * w.n_cols;
  const int* orow = w.order + tile * w.n_cols;
  for (int k = 0; k < w.n_cols; ++k) {
    // tile distances are minima over the tile's rays and sorted: once one
    // is not below this ray's bound, no later cluster can improve it
    if (srow[k] >= s.bound()) break;
    const int cid = orow[k];
    float near_t, far_t;
    slab(w.box + 6 * cid, s.r, near_t, far_t);
    if (!((near_t < far_t) && (far_t > 0.0f) && (near_t < s.bound())))
      continue;
    if (s.test(cid, in, w)) break;
  }
  s.store(in, ray);
}

// K3 / K3p: one block per tile, one thread per ray, over the tile's SUPER
// order; the children of each super are culled, ranked and walked in the
// block. Every __syncthreads is reached by the whole block: the outer loop's
// exit is block-uniform (__syncthreads_or), and a finished thread stays in
// the loop to contribute to the child minima.
template <class Search>
__global__ void trace_two_level_kernel(typename Search::In in, Walk w) {
  __shared__ float s_box[6 * kMaxGroup];  // the super's child boxes
  __shared__ int s_full[kMaxGroup];       // child holds faces
  __shared__ unsigned s_cmin[kMaxGroup];  // tile-minimum entry, float bits
  __shared__ int s_rank[kMaxGroup];       // child index at each walk step

  const int tid = threadIdx.x;
  const int group = w.group;
  const long long tile = blockIdx.x;
  const long long ray = tile * blockDim.x + tid;
  Search s(in, w, ray);
  const float tmax = w.t_max[ray];
  bool found = false;  // any-hit: done at the first valid hit

  const float* srow = w.snear + tile * w.n_cols;
  const int* orow = w.order + tile * w.n_cols;
  for (int k = 0; k < w.n_cols; ++k) {
    // as K1's stop rule, per ray; the block goes on while any ray is live
    const bool live = !(srow[k] >= s.bound()) && !found;
    if (!__syncthreads_or(live)) break;
    const int c0 = orow[k] * group;
    if (tid < group) {
      const float* bx = w.box + 6LL * (c0 + tid);
      for (int q = 0; q < 6; ++q) s_box[6 * tid + q] = bx[q];
      s_full[tid] = w.face_id[(long long)(c0 + tid) * w.slots] >= 0;
      s_cmin[tid] = kF32MaxBits;
    }
    __syncthreads();
    for (int j = 0; j < group; ++j) {
      if (!s_full[j]) continue;  // block-uniform
      float near_t, far_t;
      slab(s_box + 6 * j, s.r, near_t, far_t);
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
        if (__uint_as_float(s_cmin[j]) >= s.bound()) break;
        float near_t, far_t;
        slab(s_box + 6 * j, s.r, near_t, far_t);
        if (!((near_t < far_t) && (far_t > 0.0f) && (near_t < s.bound())))
          continue;
        if (s.test(c0 + j, in, w)) {
          found = true;
          break;
        }
      }
    }
    // the next iteration's __syncthreads_or orders this walk's shared reads
    // before the next staging
  }
  s.store(in, ray);
}

template <class Search>
int launch(const typename Search::In& in, const Walk& w, int n_tiles,
           int tile, void* stream) {
  if (w.group) {
    if (w.group < 1 || w.group > kMaxGroup || w.group > tile || tile % 32 != 0)
      return (int)cudaErrorInvalidValue;
    if (n_tiles > 0)
      trace_two_level_kernel<Search>
          <<<n_tiles, tile, 0, (cudaStream_t)stream>>>(in, w);
  } else if (n_tiles > 0) {
    trace_kernel<Search><<<n_tiles, tile, 0, (cudaStream_t)stream>>>(in, w);
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
  return launch<Exact<false>>(
      ExactIn{o, d, tri, t_out, code_out},
      Walk{inv_d, t_max, excl, snear, order, n_cols, box, face_id, slots,
           eps2, 0},
      n_tiles, tile, stream);
}

extern "C" int wrt_trace_any(
    const float* o, const float* d, const float* inv_d, const float* t_max,
    const int* excl, const float* snear, const int* order, int n_cols,
    const float* box, const int* face_id, int slots, const float* tri,
    float eps2, int* code_out, int n_tiles, int tile, void* stream) {
  return launch<Exact<true>>(
      ExactIn{o, d, tri, nullptr, code_out},
      Walk{inv_d, t_max, excl, snear, order, n_cols, box, face_id, slots,
           eps2, 0},
      n_tiles, tile, stream);
}

extern "C" int wrt_trace_closest_two_level(
    const float* o, const float* d, const float* inv_d, const float* t_max,
    const int* excl, const float* snear, const int* order, int n_cols,
    const float* box, const int* face_id, int slots, const float* tri,
    float eps2, int group, float* t_out, int* code_out, int n_tiles,
    int tile, void* stream) {
  if (group < 1) return (int)cudaErrorInvalidValue;
  return launch<Exact<false>>(
      ExactIn{o, d, tri, t_out, code_out},
      Walk{inv_d, t_max, excl, snear, order, n_cols, box, face_id, slots,
           eps2, group},
      n_tiles, tile, stream);
}

extern "C" int wrt_trace_any_two_level(
    const float* o, const float* d, const float* inv_d, const float* t_max,
    const int* excl, const float* snear, const int* order, int n_cols,
    const float* box, const int* face_id, int slots, const float* tri,
    float eps2, int group, int* code_out, int n_tiles, int tile,
    void* stream) {
  if (group < 1) return (int)cudaErrorInvalidValue;
  return launch<Exact<true>>(
      ExactIn{o, d, tri, nullptr, code_out},
      Walk{inv_d, t_max, excl, snear, order, n_cols, box, face_id, slots,
           eps2, group},
      n_tiles, tile, stream);
}

extern "C" int wrt_trace_pairs(
    const float* a, const float* inv_d, const float* t_max, const int* excl,
    const float* snear, const int* order, int n_cols, const float* box,
    const int* face_id, int slots, const float* mat_b, float eps2,
    float margin, float* t_out, int* c1_out, int* c2_out, int* c3_out,
    int* amb_out, int n_tiles, int tile, void* stream) {
  return launch<Pairs>(
      PairsIn{a, mat_b, margin, t_out, c1_out, c2_out, c3_out, amb_out},
      Walk{inv_d, t_max, excl, snear, order, n_cols, box, face_id, slots,
           eps2, 0},
      n_tiles, tile, stream);
}

extern "C" int wrt_trace_pairs_two_level(
    const float* a, const float* inv_d, const float* t_max, const int* excl,
    const float* snear, const int* order, int n_cols, const float* box,
    const int* face_id, int slots, const float* mat_b, float eps2,
    float margin, int group, float* t_out, int* c1_out, int* c2_out,
    int* c3_out, int* amb_out, int n_tiles, int tile, void* stream) {
  if (group < 1) return (int)cudaErrorInvalidValue;
  return launch<Pairs>(
      PairsIn{a, mat_b, margin, t_out, c1_out, c2_out, c3_out, amb_out},
      Walk{inv_d, t_max, excl, snear, order, n_cols, box, face_id, slots,
           eps2, group},
      n_tiles, tile, stream);
}

extern "C" const char* wrt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
