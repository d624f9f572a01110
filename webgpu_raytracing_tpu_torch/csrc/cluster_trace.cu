// Closest-hit, any-hit and exact-pairs cluster traces for NVIDIA Hopper
// (sm_90a): single-level (K1, K2p, and the tile-scheduling forms K5, K2n,
// K2pl) and two-level (K3, K3p); and the binned pass K4.
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
// The tile-scheduling kernels answer one question in three ways: who orders
// a tile's clusters, and how many are tested between two looks at the stop
// bound. All return K1's (pairs: K2p's) results bit for bit.
//
// K5 (`wrt_trace_sched`, `trace_staged_kernel<Exact<false>>` not pipelined)
// replaces `_kernel_sched` (:841, called at :1932; RenderSettings
// .trace_sched): closest-hit, not pairs, over the order sorted outside, in
// rounds of jblk = 1, 2, 4 or 8 clusters with ONE look at the bound per
// round. The block copies the round's triangle rows into shared memory and
// every thread tests them from there: what K1 reads per cluster through L2
// broadcasts, K5 reads per round from shared memory, with jblk times fewer
// barriers than a round per cluster would need. A round runs past the bound
// on purpose; its extra candidates lose the (t, code) merge. A round that
// would run past the end of the order is cut short (the TPU kernel clamps
// and re-tests the last cluster, :912-915, to the same effect).
//
// K2n (`wrt_trace_near_{closest,any,pairs}`, `trace_near_kernel`) replaces
// `_kernel_one_tile` with `in_near=True` (:469-490; the dispatcher's
// `kernel_near`, RenderSettings.kernel_near here): the block computes the
// tile's entry distance into every cluster box itself, ranks the entered
// clusters, and walks them; the plain-torch pass over R x C ray-box pairs
// and the (tiles, C) sort outside the kernel (ops/cluster_cuda.py
// prepare_tiles) are not run at all. At most kMaxNearClusters boxes, 12
// bytes of shared memory each; single-level tables only.
//
// K2pl (`wrt_trace_pipelined_{closest,any,pairs}`, `trace_staged_kernel`
// pipelined; also K2n's walk with its `pipelined` flag) replaces
// `_kernel_one_tile` with `pipelined=True` (:600-722;
// RenderSettings.pipeline_rounds), and follows the double-buffered DMA of its
// streaming form (:731-748): the next cluster is chosen with the bound as it
// stood before the current round and fetched with cp.async into the other
// half of a double buffer while the current one is tested. As in the
// pipelined TPU kernel, a round fetched on a stale bound is applied only if
// the fresh bound still admits it (`pending_n`, :683), so one fetch per tile
// may be wasted and no result changes.
//
// K4 (`wrt_trace_binned`, `trace_binned_kernel`) replaces `_kernel_binned`
// (:953, called from `trace_binned_pass` at :1106; RenderSettings.binned_sort
// and .binned_any_sort): one block per 128-ray block of a ray stream sorted
// by each ray's nearest cluster. The block reads its two schedule entries
// (s0, s1; -1 = skip) and every thread tests s0's slots, then s1's on top of
// the best it carries, by K1's own gate and slot test (`walk_plain` over a
// two-entry order with no entry distances, so the walk never stops early).
// No loop over a shortlist, no bound from the tile: the rays that need more
// than these two clusters are the caller's survivors (ops/ray_sort.py).
// What is not carried over from the TPU kernel: its blocks_per_step grid
// folding, the bf16 split of the matmul, and the packed (t | slot) key that
// rides its output refs between the two rounds. A K4 leg reads each ray once
// (52 bytes in and out) and tests one or two clusters per ray, so at the
// slice's shapes its bound is the slot tests' f32 operations.
//
// The drain hooks (JAX `t_start`, `cap`, `return_stop` of
// `trace_closest_clustered_pallas`, :1613-1645, and the carried best of the
// multipass and binned traces): `Walk::cap` > 0 makes K1 walk only the first
// `cap` entries of each tile's order, and `Walk::stop_out` receives, per ray,
// the bits of the first entry distance its tile did not walk (0x7FFFFFFF when
// the order is exhausted or the next entry is the F32_MAX sentinel): a ray
// whose best t is not above it is finished. `Walk::t_start` (K2n only; for
// an order sorted outside the mask is applied there) leaves a ray's entry
// into a box out of the tile minimum when it lies below the ray's t_start.
// `Walk::code0` starts a closest-hit search from (t_max, code0) instead of
// (t_max, -1): a later pass that carries an earlier pass's best (t, code) in
// keeps K1's tie rule, the lower code at equal t.
//
// One slab test serves every entry point, and the walks (each thread on its
// own from the tables; the block in staged rounds; the two-level one) are
// templated on the search (`Exact<kAnyHit>` or `Pairs`) and, single-level,
// on the source of the order, so the walks and the arithmetic are written
// once.
//
// What is NOT carried over: the TPU kernels evaluate Möller–Trumbore as a
// bilinear-form matmul (ray matrix x cluster matrix B) because the MXU is
// the TPU's abundant unit, split f32 into bf16 hi/lo because Mosaic has no
// f32 MXU mode, batch tiles (lockstep, gang, tiles_per_step) to hide serial
// round latency, double-buffer each child's B by DMA, and keep the best hit
// as a packed (t | slot) key whose truncated low bits blur the prune bound
// and the child order; `_kernel_sched` reads its schedule from SMEM scalars
// to spare the vector-to-scalar drain, and K2n's TPU form re-runs a masked
// minimum over all C keys per round. Here each thread is one ray, an order
// is a sorted list (K2n: ranked once, in the block), and a round's bound is
// a register. K1 and K3 compute exact
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

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxGroup = 128;
constexpr int kMaxJblk = 8;                 // K5: clusters per block of rounds
constexpr int kMaxNearClusters = 4096;      // K2n: boxes a tile may rank
constexpr size_t kMaxSharedBytes = 232448;  // a block's opt-in limit, sm_90
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
  // the drain hooks (header); all absent when zero
  const float* t_start;  // (R,) K2n: entries below it are left out
  const int* code0;      // (R,) closest-hit: the code carried in beside t_max
  int cap;               // K1: walk at most this many entries of the order
  int* stop_out;         // (R,) K1: bits of the first entry not walked
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

// One 4-byte word global → shared: a plain copy, or a cp.async that the
// caller commits and waits for.
__device__ __forceinline__ void copy4(float* dst, const float* src,
                                      bool async) {
  if (async)
    __pipeline_memcpy_async(dst, src, 4);
  else
    *dst = *src;
}

// The structurally nonzero entries of a slot's mat_b columns, flattened in
// PAIRS_ROWS order (ops/cluster_cuda.py): term k lies in row pairs_row(k) of
// column block pairs_blk(k).
__device__ __forceinline__ int pairs_row(int k) {
  return k < 3 ? 6 + k : k < 7 ? (k == 6 ? 9 : k - 3) : k < 13 ? k - 4 : k - 10;
}
__device__ __forceinline__ int pairs_blk(int k) {
  return k < 3 ? 0 : k < 7 ? 1 : k < 13 ? 2 : 3;
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
        ex(w.excl[ray]), best(w.t_max[ray]),
        best_code(!kAnyHit && w.code0 ? w.code0[ray] : -1) {}

  // stop and skip bound: the best t (any-hit: t_max)
  __device__ __forceinline__ float bound() const { return best; }

  static constexpr int kRowWords = 9;  // staged words per slot: a tri row

  // The occupied slots of a cluster, in slot order: ids `fids`, triangle
  // rows `rows` indexed by face id (the table) or, staged, by slot. Returns
  // true when the ray is done (any-hit: its first valid hit, code in
  // best_code).
  template <bool kStaged>
  __device__ __forceinline__ bool scan(int cid, const int* fids,
                                       const float* rows, const Walk& w) {
    for (int s = 0; s < w.slots; ++s) {
      const int f = fids[s];
      if (f < 0) break;  // occupied slots come first
      const int code = cid * w.slots + s;
      if (code == ex) continue;
      const float* tr = rows + 9LL * (kStaged ? s : f);
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

  // cluster `cid` from the tables
  __device__ __forceinline__ bool test(int cid, const In& in, const Walk& w) {
    return scan<false>(cid, w.face_id + (long long)cid * w.slots, in.tri, w);
  }

  // cluster `cid` from a staged copy (stage)
  __device__ __forceinline__ bool test_staged(int cid, const int* fids,
                                              const float* rows, const In&,
                                              const Walk& w) {
    return scan<true>(cid, fids, rows, w);
  }

  // The block copies cluster `cid` into shared memory: its face ids and,
  // per occupied slot, the triangle row.
  __device__ __forceinline__ static void stage(int cid, int* fids,
                                               float* rows, const In& in,
                                               const Walk& w, bool async) {
    const int* src = w.face_id + (long long)cid * w.slots;
    for (int s = threadIdx.x; s < w.slots; s += blockDim.x) {
      const int f = src[s];
      fids[s] = f;
      if (f < 0) continue;
      const float* tr = in.tri + 9LL * f;
#pragma unroll
      for (int q = 0; q < 9; ++q) copy4(rows + 9 * s + q, tr + q, async);
    }
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

  static constexpr int kRowWords = 19;  // staged words per slot: B's terms

  // The occupied slots of a cluster, in slot order. `rows` is the cluster's
  // block of mat_b (10 rows of 4 * slots) or, staged, its 19 structurally
  // nonzero rows of `slots` entries in pairs_row / pairs_blk order.
  template <bool kStaged>
  __device__ __forceinline__ bool scan(int cid, const int* fids,
                                       const float* rows, const In& in,
                                       const Walk& w) {
    const int n4 = 4 * w.slots;  // a row of B
    for (int s = 0; s < w.slots; ++s) {
      if (fids[s] < 0) break;  // occupied slots come first
      const int code = cid * w.slots + s;
      if (code == ex) continue;
      // term k of PAIRS_ROWS: det 0..2, t_num 3..6, u_num 7..12, v_num 13..18
      auto b = [&](int k) -> float {
        return kStaged ? rows[k * w.slots + s]
                       : rows[pairs_row(k) * n4 + pairs_blk(k) * w.slots + s];
      };
      const float bd0 = b(0), bd1 = b(1), bd2 = b(2);
      const float det = (av[6] * bd0 + av[7] * bd1) + av[8] * bd2;
      if (!(det >= w.eps2)) continue;
      const float bt0 = b(3), bt1 = b(4), bt2 = b(5), bt3 = b(6);
      const float tn =
          ((av[0] * bt0 + av[1] * bt1) + av[2] * bt2) + av[9] * bt3;
      float bu = b(7), bv = b(13);
      float u = av[3] * bu, v = av[3] * bv;
      float mu = aa[3] * fabsf(bu), mv = aa[3] * fabsf(bv);
#pragma unroll
      for (int k = 4; k < 9; ++k) {
        bu = b(4 + k);
        bv = b(10 + k);
        u = u + av[k] * bu;
        v = v + av[k] * bv;
        mu = mu + aa[k] * fabsf(bu);
        mv = mv + aa[k] * fabsf(bv);
      }
      const float md =
          (aa[6] * fabsf(bd0) + aa[7] * fabsf(bd1)) + aa[8] * fabsf(bd2);
      const float mt = ((aa[0] * fabsf(bt0) + aa[1] * fabsf(bt1)) +
                        aa[2] * fabsf(bt2)) +
                       aa[9] * fabsf(bt3);
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

  __device__ __forceinline__ bool test(int cid, const In& in, const Walk& w) {
    return scan<false>(cid, w.face_id + (long long)cid * w.slots,
                       in.mat_b + (long long)cid * 10 * 4 * w.slots, in, w);
  }

  __device__ __forceinline__ bool test_staged(int cid, const int* fids,
                                              const float* rows, const In& in,
                                              const Walk& w) {
    return scan<true>(cid, fids, rows, in, w);
  }

  // The block copies cluster `cid` into shared memory: its face ids and the
  // 19 structurally nonzero rows of its block of mat_b.
  __device__ __forceinline__ static void stage(int cid, int* fids,
                                               float* rows, const In& in,
                                               const Walk& w, bool async) {
    const int* src = w.face_id + (long long)cid * w.slots;
    const int n4 = 4 * w.slots;
    const float* bm = in.mat_b + (long long)cid * 10 * n4;
    for (int s = threadIdx.x; s < w.slots; s += blockDim.x) {
      const int f = src[s];
      fids[s] = f;
      if (f < 0) continue;
      for (int k = 0; k < kRowWords; ++k)
        copy4(rows + k * w.slots + s,
              bm + pairs_row(k) * n4 + pairs_blk(k) * w.slots + s, async);
    }
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

// A tile's cluster order: the entry distance and the cluster of each step,
// ascending. Sorted outside the kernel (rows of snear / order) ...
struct GlobalOrder {
  const float* snear;
  const int* order;
  int n;
  __device__ __forceinline__ float near(int k) const { return snear[k]; }
  __device__ __forceinline__ int cid(int k) const { return order[k]; }
};

// ... or ranked by the block itself (K2n): `dist` holds every cluster's tile
// minimum as float bits, `ord` the n clusters some ray of the tile enters.
struct SharedOrder {
  const unsigned* dist;
  const int* ord;
  int n;
  __device__ __forceinline__ float near(int k) const {
    return __uint_as_float(dist[ord[k]]);
  }
  __device__ __forceinline__ int cid(int k) const { return ord[k]; }
};

// ... or (K4) the block's two schedule entries, with no entry distances: -1
// is below every bound, so the walk never stops on one.
struct SchedOrder {
  int c0, c1, n;
  __device__ __forceinline__ float near(int) const { return -1.0f; }
  __device__ __forceinline__ int cid(int k) const { return k == 0 ? c0 : c1; }
};

// The walk of K1, K2p, K2n and K4: each thread on its own, clusters read from
// the tables.
template <class Search, class Order>
__device__ __forceinline__ void walk_plain(Search& s, const Order& ord,
                                           const typename Search::In& in,
                                           const Walk& w) {
  for (int k = 0; k < ord.n; ++k) {
    // tile distances are minima over the tile's rays and sorted: once one
    // is not below this ray's bound, no later cluster can improve it
    if (ord.near(k) >= s.bound()) break;
    const int cid = ord.cid(k);
    float near_t, far_t;
    slab(w.box + 6 * cid, s.r, near_t, far_t);
    if (!((near_t < far_t) && (far_t > 0.0f) && (near_t < s.bound())))
      continue;
    if (s.test(cid, in, w)) break;
  }
}

// The walk of K5 and K2pl: the block runs the order in rounds of up to
// `jblk` clusters, which it first copies into shared memory (`smem`: per
// cluster the face ids, then Search::kRowWords words per slot; two such
// buffers when `pipelined`).
//
// A thread votes for a round when the round's first entry distance is below
// its bound, and the block runs the round while any thread votes.
//
// Not pipelined (K5): vote, copy, barrier, test. A thread tests the round's
// clusters only if it voted, against the bound of its vote: the bound is
// looked at once per round, not once per cluster, so within a round a thread
// may test clusters that a fresher bound would have skipped. Their
// candidates lose the (t, code) merge, so the results are K1's.
//
// Pipelined (K2pl): the vote for the NEXT round is taken before this round
// is tested, with the bound as it stands then, and the next round's clusters
// are fetched with cp.async into the other buffer while this round is
// tested. So a tile may fetch one round more than K1 would walk. A thread
// tests a fetched round against its bound as it stands when the round's turn
// comes, which is K1's rule: a round that was fetched on a stale vote is
// dropped, not merged. (The pairs search could not merge it: a candidate
// beyond the bound can still enter the second carried slot.)
//
// An any-hit thread that has its hit neither votes nor tests again. Every
// barrier is reached by the whole block: the loop's exit is the
// block-uniform vote, and a finished thread stays in the loop.
template <class Search, class Order>
__device__ __forceinline__ void walk_staged(Search& s, const Order& ord,
                                            const typename Search::In& in,
                                            const Walk& w, int jblk,
                                            bool pipelined, float* smem) {
  const int per = w.slots * (1 + Search::kRowWords);  // words per cluster
  float* buf[2] = {smem, smem + (pipelined ? jblk * per : 0)};
  auto stage = [&](int j, float* dst) {
    const int nb = min(jblk, ord.n - j);
    for (int jj = 0; jj < nb; ++jj)
      Search::stage(ord.cid(j + jj), (int*)(dst + jj * per),
                    dst + jj * per + w.slots, in, w, pipelined);
    if (pipelined) __pipeline_commit();
  };
  bool found = false;  // any-hit: done at the first valid hit
  float rb = s.bound();
  bool live = ord.n > 0 && !(ord.near(0) >= rb);
  bool go = __syncthreads_or(live);
  if (go && pipelined) stage(0, buf[0]);
  int j = 0, cur = 0;
  while (go) {
    const int nb = min(jblk, ord.n - j);
    const int jn = j + nb;
    if (pipelined)
      __pipeline_wait_prior(0);
    else
      stage(j, buf[0]);
    __syncthreads();  // the round's copy is whole; the last round is tested
    float rb_n = rb;
    bool live_n = false, go_n = false;
    if (pipelined) {
      rb_n = s.bound();
      live_n = !found && jn < ord.n && !(ord.near(jn) >= rb_n);
      go_n = __syncthreads_or(live_n);
      if (go_n) stage(jn, buf[cur ^ 1]);
    }
    const float tb = pipelined ? rb_n : rb;  // the bound this round tests by
    if (live && !found) {
      const float* base = buf[cur];
      for (int jj = 0; jj < nb; ++jj) {
        if (ord.near(j + jj) >= tb) break;
        const int cid = ord.cid(j + jj);
        float near_t, far_t;
        slab(w.box + 6 * cid, s.r, near_t, far_t);
        if (!((near_t < far_t) && (far_t > 0.0f) && (near_t < tb))) continue;
        if (s.test_staged(cid, (const int*)(base + jj * per),
                          base + jj * per + w.slots, in, w)) {
          found = true;
          break;
        }
      }
    }
    if (!pipelined) {
      rb_n = s.bound();
      live_n = !found && jn < ord.n && !(ord.near(jn) >= rb_n);
      go_n = __syncthreads_or(live_n);  // also: this round is tested
    }
    j = jn;
    rb = rb_n;
    live = live_n;
    go = go_n;
    if (pipelined) cur ^= 1;
  }
}

// K1 / K2p: one block per tile, one thread per ray, over the tile's cluster
// order.
template <class Search>
__global__ void trace_kernel(typename Search::In in, Walk w) {
  const long long tile = blockIdx.x;
  const long long ray = tile * blockDim.x + threadIdx.x;
  Search s(in, w, ray);
  const float* srow = w.snear + tile * w.n_cols;
  const int n = (w.cap > 0 && w.cap < w.n_cols) ? w.cap : w.n_cols;
  walk_plain(s, GlobalOrder{srow, w.order + tile * w.n_cols, n}, in, w);
  s.store(in, ray);
  if (w.stop_out) {
    // the first entry distance the tile did not walk (-0 made +0), as bits
    int stop = 0x7fffffff;
    if (n < w.n_cols && srow[n] < __uint_as_float(kF32MaxBits))
      stop = __float_as_int(srow[n] + 0.0f);
    w.stop_out[ray] = stop;
  }
}

// K4: one block per 128-ray block of the sorted stream, one thread per ray,
// over the block's schedule entries (s0, s1), -1 entries left out.
template <class Search>
__global__ void trace_binned_kernel(typename Search::In in, Walk w,
                                    const int* sched) {
  const long long blk = blockIdx.x;
  const long long ray = blk * blockDim.x + threadIdx.x;
  Search s(in, w, ray);
  int s0 = sched[2 * blk], s1 = sched[2 * blk + 1];
  if (s0 < 0) {
    s0 = s1;
    s1 = -1;
  }
  walk_plain(s, SchedOrder{s0, s1, (s0 >= 0) + (s1 >= 0)}, in, w);
  s.store(in, ray);
}

// K5 / K2pl: as K1, over the same order, in staged rounds (walk_staged).
template <class Search>
__global__ void trace_staged_kernel(typename Search::In in, Walk w, int jblk,
                                    int pipelined) {
  extern __shared__ float smem[];
  const long long tile = blockIdx.x;
  const long long ray = tile * blockDim.x + threadIdx.x;
  Search s(in, w, ray);
  walk_staged(s, GlobalOrder{w.snear + tile * w.n_cols,
                             w.order + tile * w.n_cols, w.n_cols}, in, w,
              jblk, pipelined != 0, smem);
  s.store(in, ray);
}

// K2n: the block computes its tile's entry distance into every cluster box
// (w.n_cols boxes; w.snear and w.order are not read), ranks the clusters
// that some ray enters by (distance, cluster), the order a stable ascending
// sort gives, and walks them as K1 does or, `pipelined`, as K2pl does.
//
// Distances (tile_nears_fused, ops/cluster_trace.py): a ray contributes
// max(near, 0) for a box when near < far, near < t_max and far > 0, else
// F32_MAX; -0 is made +0 and the minimum is taken on the float's bits, within
// the warp and then across warps with one shared atomic each. Clusters that
// no ray enters keep F32_MAX and are left out of the order: no bound exceeds
// F32_MAX, so no walk would reach them. With `Walk::t_start` a ray's entry
// below its own t_start is left out of the minimum. Shared memory: 12 bytes per cluster
// (distance, candidate list, order) before the staging buffers.
template <class Search>
__global__ void trace_near_kernel(typename Search::In in, Walk w,
                                  int pipelined) {
  extern __shared__ float smem[];
  __shared__ int s_n;
  const int n_boxes = w.n_cols;
  unsigned* s_dist = (unsigned*)smem;
  int* s_cand = (int*)smem + n_boxes;
  int* s_ord = s_cand + n_boxes;
  const int tid = threadIdx.x;
  const long long ray = (long long)blockIdx.x * blockDim.x + tid;
  Search s(in, w, ray);
  const float tmax = w.t_max[ray];
  const bool masked = w.t_start != nullptr;  // block-uniform
  const float ts = masked ? w.t_start[ray] : 0.0f;

  for (int c = tid; c < n_boxes; c += blockDim.x) s_dist[c] = kF32MaxBits;
  if (tid == 0) s_n = 0;
  __syncthreads();
  for (int c = 0; c < n_boxes; ++c) {
    float near_t, far_t;
    slab(w.box + 6 * c, s.r, near_t, far_t);
    unsigned v = kF32MaxBits;
    if ((near_t < far_t) && (near_t < tmax) && (far_t > 0.0f)) {
      const float entry = fmaxf(near_t, 0.0f) + 0.0f;  // -0 → +0
      // t_start: an entry below it was run by an earlier pass (NaN: all)
      if (!masked || entry >= ts) v = __float_as_uint(entry);
    }
    v = __reduce_min_sync(0xffffffffu, v);
    if ((tid & 31) == 0 && v != kF32MaxBits) atomicMin(&s_dist[c], v);
  }
  __syncthreads();
  for (int c = tid; c < n_boxes; c += blockDim.x)
    if (s_dist[c] != kF32MaxBits) s_cand[atomicAdd(&s_n, 1)] = c;
  __syncthreads();
  const int n = s_n;
  for (int i = tid; i < n; i += blockDim.x) {
    const int c = s_cand[i];
    const unsigned mine = s_dist[c];  // non-negative floats order as bits
    int pos = 0;
    for (int q = 0; q < n; ++q) {
      const int cq = s_cand[q];
      const unsigned other = s_dist[cq];
      pos += (other < mine) || (other == mine && cq < c);
    }
    s_ord[pos] = c;
  }
  __syncthreads();
  const SharedOrder ord{s_dist, s_ord, n};
  if (pipelined)
    walk_staged(s, ord, in, w, 1, true, smem + 3 * n_boxes);
  else
    walk_plain(s, ord, in, w);
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

// Dynamic shared memory of a launch, beside up to kStaticShared bytes of the
// kernel's own: refuse above the card's limit, opt in above 48 KB.
constexpr size_t kStaticShared = 1024;
template <class Kernel>
int reserve_shared(Kernel kernel, size_t bytes) {
  if (bytes + kStaticShared > kMaxSharedBytes)
    return (int)cudaErrorInvalidValue;
  if (bytes + kStaticShared <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <class Search>
size_t staged_bytes(const Walk& w, int jblk, bool pipelined) {
  return (size_t)(pipelined ? 2 : 1) * jblk * w.slots *
         (1 + Search::kRowWords) * sizeof(float);
}

// K5 (jblk clusters a round, not pipelined) and K2pl (1, pipelined)
template <class Search>
int launch_staged(const typename Search::In& in, const Walk& w, int n_tiles,
                  int tile, int jblk, int pipelined, void* stream) {
  if (jblk < 1 || jblk > kMaxJblk) return (int)cudaErrorInvalidValue;
  const size_t bytes = staged_bytes<Search>(w, jblk, pipelined != 0);
  const int err = reserve_shared(trace_staged_kernel<Search>, bytes);
  if (err) return err;
  if (n_tiles > 0)
    trace_staged_kernel<Search><<<n_tiles, tile, bytes, (cudaStream_t)stream>>>(
        in, w, jblk, pipelined);
  return (int)cudaGetLastError();
}

// K2n; w.n_cols is the number of cluster boxes
template <class Search>
int launch_near(const typename Search::In& in, const Walk& w, int n_tiles,
                int tile, int pipelined, void* stream) {
  if (w.n_cols < 1 || w.n_cols > kMaxNearClusters || tile % 32 != 0)
    return (int)cudaErrorInvalidValue;
  const size_t bytes =
      12 * (size_t)w.n_cols +
      (pipelined ? staged_bytes<Search>(w, 1, true) : (size_t)0);
  const int err = reserve_shared(trace_near_kernel<Search>, bytes);
  if (err) return err;
  if (n_tiles > 0)
    trace_near_kernel<Search><<<n_tiles, tile, bytes, (cudaStream_t)stream>>>(
        in, w, pipelined);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int wrt_trace_closest(
    const float* o, const float* d, const float* inv_d, const float* t_max,
    const int* excl, const float* snear, const int* order, int n_cols,
    const float* box, const int* face_id, int slots, const float* tri,
    float eps2, const int* code0, int cap, int* stop_out, float* t_out,
    int* code_out, int n_tiles, int tile, void* stream) {
  if (cap < 0) return (int)cudaErrorInvalidValue;
  return launch<Exact<false>>(
      ExactIn{o, d, tri, t_out, code_out},
      Walk{inv_d, t_max, excl, snear, order, n_cols, box, face_id, slots,
           eps2, 0, nullptr, code0, cap, stop_out},
      n_tiles, tile, stream);
}

// K4: `sched` is (n_blocks, 2) cluster ids, -1 = skip
extern "C" int wrt_trace_binned(
    const float* o, const float* d, const float* inv_d, const float* t_max,
    const int* excl, const int* sched, const float* box, const int* face_id,
    int slots, const float* tri, float eps2, const int* code0, float* t_out,
    int* code_out, int n_blocks, int tile, void* stream) {
  if (n_blocks > 0)
    trace_binned_kernel<Exact<false>>
        <<<n_blocks, tile, 0, (cudaStream_t)stream>>>(
            ExactIn{o, d, tri, t_out, code_out},
            Walk{inv_d, t_max, excl, nullptr, nullptr, 0, box, face_id, slots,
                 eps2, 0, nullptr, code0, 0, nullptr},
            sched);
  return (int)cudaGetLastError();
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

extern "C" int wrt_trace_sched(
    const float* o, const float* d, const float* inv_d, const float* t_max,
    const int* excl, const float* snear, const int* order, int n_cols,
    const float* box, const int* face_id, int slots, const float* tri,
    float eps2, int jblk, float* t_out, int* code_out, int n_tiles, int tile,
    void* stream) {
  return launch_staged<Exact<false>>(
      ExactIn{o, d, tri, t_out, code_out},
      Walk{inv_d, t_max, excl, snear, order, n_cols, box, face_id, slots,
           eps2, 0},
      n_tiles, tile, jblk, 0, stream);
}

extern "C" int wrt_trace_pipelined_closest(
    const float* o, const float* d, const float* inv_d, const float* t_max,
    const int* excl, const float* snear, const int* order, int n_cols,
    const float* box, const int* face_id, int slots, const float* tri,
    float eps2, const int* code0, float* t_out, int* code_out, int n_tiles,
    int tile, void* stream) {
  return launch_staged<Exact<false>>(
      ExactIn{o, d, tri, t_out, code_out},
      Walk{inv_d, t_max, excl, snear, order, n_cols, box, face_id, slots,
           eps2, 0, nullptr, code0, 0, nullptr},
      n_tiles, tile, 1, 1, stream);
}

extern "C" int wrt_trace_pipelined_any(
    const float* o, const float* d, const float* inv_d, const float* t_max,
    const int* excl, const float* snear, const int* order, int n_cols,
    const float* box, const int* face_id, int slots, const float* tri,
    float eps2, int* code_out, int n_tiles, int tile, void* stream) {
  return launch_staged<Exact<true>>(
      ExactIn{o, d, tri, nullptr, code_out},
      Walk{inv_d, t_max, excl, snear, order, n_cols, box, face_id, slots,
           eps2, 0},
      n_tiles, tile, 1, 1, stream);
}

extern "C" int wrt_trace_pipelined_pairs(
    const float* a, const float* inv_d, const float* t_max, const int* excl,
    const float* snear, const int* order, int n_cols, const float* box,
    const int* face_id, int slots, const float* mat_b, float eps2,
    float margin, float* t_out, int* c1_out, int* c2_out, int* c3_out,
    int* amb_out, int n_tiles, int tile, void* stream) {
  return launch_staged<Pairs>(
      PairsIn{a, mat_b, margin, t_out, c1_out, c2_out, c3_out, amb_out},
      Walk{inv_d, t_max, excl, snear, order, n_cols, box, face_id, slots,
           eps2, 0},
      n_tiles, tile, 1, 1, stream);
}

extern "C" int wrt_trace_near_closest(
    const float* o, const float* d, const float* inv_d, const float* t_max,
    const int* excl, int n_boxes, const float* box, const int* face_id,
    int slots, const float* tri, float eps2, int pipelined,
    const float* t_start, const int* code0, float* t_out, int* code_out,
    int n_tiles, int tile, void* stream) {
  return launch_near<Exact<false>>(
      ExactIn{o, d, tri, t_out, code_out},
      Walk{inv_d, t_max, excl, nullptr, nullptr, n_boxes, box, face_id, slots,
           eps2, 0, t_start, code0, 0, nullptr},
      n_tiles, tile, pipelined, stream);
}

extern "C" int wrt_trace_near_any(
    const float* o, const float* d, const float* inv_d, const float* t_max,
    const int* excl, int n_boxes, const float* box, const int* face_id,
    int slots, const float* tri, float eps2, int pipelined,
    const float* t_start, int* code_out, int n_tiles, int tile,
    void* stream) {
  return launch_near<Exact<true>>(
      ExactIn{o, d, tri, nullptr, code_out},
      Walk{inv_d, t_max, excl, nullptr, nullptr, n_boxes, box, face_id, slots,
           eps2, 0, t_start, nullptr, 0, nullptr},
      n_tiles, tile, pipelined, stream);
}

extern "C" int wrt_trace_near_pairs(
    const float* a, const float* inv_d, const float* t_max, const int* excl,
    int n_boxes, const float* box, const int* face_id, int slots,
    const float* mat_b, float eps2, float margin, int pipelined, float* t_out,
    int* c1_out, int* c2_out, int* c3_out, int* amb_out, int n_tiles,
    int tile, void* stream) {
  return launch_near<Pairs>(
      PairsIn{a, mat_b, margin, t_out, c1_out, c2_out, c3_out, amb_out},
      Walk{inv_d, t_max, excl, nullptr, nullptr, n_boxes, box, face_id, slots,
           eps2, 0},
      n_tiles, tile, pipelined, stream);
}

extern "C" const char* wrt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
