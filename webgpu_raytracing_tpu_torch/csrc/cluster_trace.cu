// Closest-hit, any-hit and exact-pairs cluster traces for NVIDIA Hopper
// (sm_90a): single-level (K1, K2p, and the tile-scheduling forms K5, K2n,
// K2pl) and two-level (K3, K3p, with the super order from outside or made
// in the kernel); and the binned pass K4.
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
// walks SUPERclusters nearest entry first, and for each super the kernel
// slab-tests the G child cluster boxes itself, takes the tile minimum per
// child and walks the children nearest first. Per-tile box work is O(C2 +
// supers visited x G) instead of O(C): on the 1M-triangle scene 227 supers
// instead of 14,528 clusters. The super order comes sorted from outside the
// kernel (`wrt_trace_{closest,any,pairs}_two_level`) or, as K2n orders its
// clusters, from the kernel's own first half over the super boxes
// (`wrt_trace_near_{closest,any,pairs}_two_level`; RenderSettings.kernel_near
// on two-level tables, which the JAX dispatcher turns off, :1717: a limit of
// its VMEM residency, not of the function). Both return the same results
// bit for bit.
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
// the warps test them from there, sharing their slot scans as K1 does: what
// K1 reads per cluster through L2, K5 reads per round from shared memory,
// with jblk times fewer barriers than a round per cluster would need. A
// round runs past the bound on purpose; its extra candidates lose the (t,
// code) merge. A round that would run past the end of the order is cut
// short (the TPU kernel clamps and re-tests the last cluster, :912-915, to
// the same effect).
//
// K2n (`wrt_trace_near_{closest,any,pairs}`, `trace_near_kernel`) replaces
// `_kernel_one_tile` with `in_near=True` (:469-490; the dispatcher's
// `kernel_near`, RenderSettings.kernel_near here, the port's default): the
// block computes the tile's entry distance into every cluster box itself,
// orders the entered clusters, and walks them; the plain-torch pass over R x
// C ray-box pairs and the (tiles, C) sort outside the kernel
// (ops/cluster_cuda.py prepare_tiles) are not run at all. Its first half
// (`tile_order`, described where it stands) is written for this card: boxes
// on the lanes, rays in shared memory grouped by sign octant, no shuffle,
// atomic or barrier per ray-box pair, and a bitonic sort of 64-bit keys. At
// most kMaxNearClusters boxes, 8 bytes of shared memory each (for the next
// power of two) beside 16 KB of ray and box stages; tiles of at most
// kMaxTile rays.
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
// and .binned_any_sort): per 128-ray block of a ray stream sorted by each
// ray's nearest cluster, two schedule entries (s0, s1; -1 = skip), and every
// ray tests s0's slots, then s1's on top of the best it carries, by K1's own
// gate and slot test, with no order and no stop rule. No loop over a
// shortlist, no bound from the tile: the rays that need more than these two
// clusters are the caller's survivors (ops/ray_sort.py). A block stages its
// two clusters into shared memory first (described where it stands): a
// cluster scanned from the tables costs every slot a chain of two dependent
// loads (the face id, then the row it names).
// What is not carried over from the TPU kernel: its blocks_per_step grid
// folding, the bf16 split of the matmul, and the packed (t | slot) key that
// rides its output refs between the two rounds. A K4 leg reads each ray once
// (52 bytes in and out) and tests one or two clusters per ray, so at the
// slice's shapes its bound is those bytes or the slot tests' f32 operations,
// about equal.
//
// The ray sort's coherence key (`wrt_top_keys`, `top_keys_kernel`) has no
// Pallas body: the JAX package computes it as XLA code. It is the R x C slab
// test of the sort's rays against the boxes reduced to each ray's n nearest
// entered boxes in registers (described where it stands).
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
// One slab test serves every entry point, and the walks (over the tables;
// in the block's staged rounds; the two-level one) are templated on the
// search (`Exact<kAnyHit>` or `Pairs`) and, single-level, on the source of
// the order, so the walks and the arithmetic are written once; K4 scans its
// staged clusters with the same slot test. Every walk but K4's keeps a warp
// in step over the order and lets its lanes share their slot scans
// (`coop_test`), for all three searches: K1, K2p and K2n (`walk_coop`) and
// K3 / K3p (`walk_two_level`) over the tables; K5, K2pl and K2n's
// pipelined walk (`walk_staged`) over the round's rows in shared memory,
// where a lane's slots lie in distinct banks (described there). Within one
// cluster no search depends on the order of its slot tests: the closest-hit
// result is a (t, code) minimum; the any-hit ray stops at the valid slot of
// the lowest code (a slot's validity does not change while its cluster is
// scanned); the pairs' carried candidates are a top two and a minimum of
// a set of distinct (t, code) pairs. So the results stay the sequential
// scan's. What does depend on order is which clusters a ray
// tests, and the warp in step keeps that sequence per lane exactly.
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
// is a sorted list (K2n, K3's supers: sorted once, in the block), and a
// round's bound is a register. K1 and K3 compute exact
// sequential f32 Möller–Trumbore, the reference's own arithmetic, on the
// triangle rows `tri`; K2p and K3p compute A·B in f32 on the CUDA cores, one
// slot at a time; minima and orders are exact floats.
//
// What bounds them on an H100: f32 ALU work per triangle test (K1/K3: about
// 50 operations and one IEEE divide per candidate; K2p/K3p: about 35 for
// the 90 % of the slots past the det cull that u's margined gate rejects,
// up to 95 with every estimate and magnitude) and per box test (about 27),
// and L2 reads of the triangle rows `tri` (F x 9 f32: 1.6 MB for the 44k
// stress scene, 36 MB for the 1M one, inside the 50 MB L2) or of `mat_b`'s
// 19 nonzero entries per slot (K2p/K3p: 76 B per face, 3.4 MB and 76 MB).
// K1 keeps the reads shared: all threads of a block walk the same per-tile
// cluster order (sorted outside the kernel, as `_kernel_sched` does), so at
// a given step the lanes that test a cluster load the same row (the serial
// scan: one broadcast transaction) or the rows of neighbouring slots of it
// (a shared scan). K2n and K3 are bound by
// instruction count: without FMA (--fmad=false) a ray-box pair of the
// first half is about 25
// instructions (12 subtracts and multiplies, 4 NaN-propagating min / max, 3
// compares, 3 integer min / max and selects, and its share of the ray
// read), 1.33 G pairs a 1080p leg over 643 clusters; K3 adds, per super a
// block visits, G T slab tests of the child cull (T / G x fewer per thread:
// every thread takes a child and a part of the rays), a 64-key sort by one
// warp and three block barriers (the vote, the minima, the order); the
// child boxes go to shared memory once per visit (1.5 KB at G = 64) for the
// walk's per-ray tests. Each thread stops at the first cluster (K3: child,
// and at the super level, super) whose tile-minimum entry distance is not
// below its own bound, and skips clusters its own slab test rejects. On a
// bounce leg the rays of a tile go apart, and a thread that scans a
// cluster's 128 slots alone holds its warp for 31 lanes that skip that
// cluster: there the shared scan (`coop_test`) does in 4 tests a lane what
// took 128. The pairs slot test (`pairs_scan`) computes each estimate and
// each magnitude only where a gate or the robust test still needs it: a
// slot whose exact u and v lie inside the triangle is margin-valid whatever
// its magnitudes, and a slot that cannot enter the carried pairs needs no
// robust test.
//
// Occupancy (blocks of 128 threads; nvcc -Xptxas -v, sm_90a,
// tools/torch_sass.py): K2n 56 registers any-hit, 64 closest-hit (the
// shared scan's second ray) and pairs (772 bytes spilled; 548 before its
// pipelined walk shared its scans), and 24 KB of shared memory at 643
// clusters, so 9 blocks an SM (any-hit) or 8, by registers (at
// kMaxNearClusters 48 KB: 4, by shared memory); K2n's pipelined walk, in
// the kernel without a minimum, 64 (pairs 116, no spill); K3 56 registers
// (pairs 64) and 8.9 KB static (pairs over the outside order 21 KB: the
// rays' stage), + 8 KB dynamic with its own super order at 227 supers
// (pairs 14 KB), so 9 blocks an SM (pairs 8), by registers. K1 56
// registers (before its shared scans 40), any-hit 48 (39), K2p 64 with 76
// bytes spilled (71) and 12 KB of dynamic shared memory (the rays' stage),
// so 9, 10 and 8 blocks an SM; K5 and K2pl closest-hit 63 (56), any-hit 56
// (48), pairs 96 (92) with 12 KB beside the rounds' buffers (5 KB a
// cluster, 10 KB for pairs, two of them when pipelined), so 8, 9 and 5
// blocks, by registers.
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
// child when near < far, near < t_max and far > 0, else F32_MAX; every ray of
// the tile contributes, finished or not (the rays are read from the block's
// stage, not from the threads that own them), so the minima do not depend
// on walk progress. -0 is made +0 before the minimum is taken on the
// float's bits (exact for non-negative floats). Children are ordered by
// (minimum, index). Children without faces (the pads of the last super,
// inverted-empty boxes that a symmetric slab test does not reject) keep
// F32_MAX and are never visited.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxGroup = 128;
constexpr int kMaxJblk = 8;                 // K5: clusters per block of rounds
constexpr int kMaxNearClusters = 4096;      // K2n, K3: boxes a tile may order
constexpr int kMaxTile = 128;               // K2n, K3: rays of a block
// first half: the most boxes a thread tests per ray read, ordering clusters
// (K2n) and supers (K3); each costs 7 registers and 24 bytes of stage a ray
constexpr int kNearRows = 4;
constexpr int kSuperRows = 2;
constexpr int kOctWords = 16 + 8 * (kMaxTile / 32);  // octant starts, counts
constexpr size_t kMaxSharedBytes = 232448;  // a block's opt-in limit, sm_90
constexpr unsigned kF32MaxBits = 0x7f7fffffu;
// K2n, K3, K1 and K2p: the blocks of kMaxTile threads an SM must hold at
// once (`Search::kMinBlocks`, the kernels' __launch_bounds__; which staged
// kernels take it is said where they stand), i.e. registers a thread:
// any-hit 9 (56), pairs 8 (64); closest-hit sets none (0: the compiler's
// choice, 64 in K2n and 56 in K3 and K1). Left to the compiler, K2n's
// pairs take about 90 (5 blocks): bounce legs 8-9 % faster, primary legs
// 7-10 % slower; any-hit 64: within 4 % either way (PERF.md §6).
constexpr int kMinBlocksAny = 9;
constexpr int kMinBlocksPairs = 8;
// K4: the words of a staged triangle row, read as three 16-byte words (4-12
// % faster on the slice's legs than 9 words read one by one; PERF.md §6)
constexpr int kK4RowWords = 12;
constexpr unsigned kBoundUlps = 1u << 9;      // (cluster_pallas.py:566)
constexpr long long kAmbBand = 2 * (1 << 9);  // (cluster_pallas.py:389)

typedef unsigned long long u64;

// NaN-propagating min/max, as torch.minimum / torch.maximum: one FMNMX.NAN
// each (PTX min.NaN / max.NaN, sm_80 and later) instead of two compares and
// a select around fminf / fmaxf. A ray along an axis makes 0 x inf = NaN in
// the slab products, and that NaN must reach `near < far`.
__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
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
  const float* super_box;  // (n_cols, 6) K3 ordering its supers itself
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

// A cluster as a slot scan reads it: its face ids and its rows. From the
// tables (`table`: triangle rows by face id, or the cluster's block of
// mat_b), or from a round staged in shared memory (`stage`, rows by slot).
struct Slots {
  const int* fids;
  const float* rows;
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

  // another thread's search, to take a share of its scan (`coop_test`)
  __device__ Exact(const Ray& r, int ex, float best, int best_code)
      : r(r), ex(ex), best(best), best_code(best_code) {}

  __device__ __forceinline__ static float3 origin(const In& in,
                                                   long long ray) {
    return make_float3(in.o[3 * ray], in.o[3 * ray + 1], in.o[3 * ray + 2]);
  }

  // stop and skip bound: the best t (any-hit: t_max)
  __device__ __forceinline__ float bound() const { return best; }

  static constexpr int kRowWords = 9;  // staged words per slot: a tri row
  static constexpr int kMinBlocks = kAnyHit ? kMinBlocksAny : 0;
  static constexpr int kMinBlocksStaged = kMinBlocks;  // K5, K2pl

  // The search of the walks with the warp in step (made by `coop`): this
  // one, its ray sent to the warp by shuffle where the warp shares a slot
  // scan; it stages nothing (kRayVecs float4 a ray).
  static constexpr int kRayVecs = 0;
  __device__ __forceinline__ static Exact coop(const In& in, const Walk& w,
                                               long long ray, float4*) {
    return Exact(in, w, ray);
  }
  __device__ __forceinline__ const Ray& ray() const { return r; }

  // cluster `cid` in the tables: face ids, triangle rows by face id
  __device__ __forceinline__ static Slots table(int cid, const In& in,
                                                const Walk& w) {
    return Slots{w.face_id + (long long)cid * w.slots, in.tri};
  }

  // The occupied slots of a cluster, in slot order: ids `fids`, triangle
  // rows `rows` indexed by face id (the table) or, staged, by slot. Returns
  // true when the ray is done (any-hit: its first valid hit, code in
  // best_code). kStride > 1: only the slots first, first + kStride, ...
  // kRowWords: the words of a staged row (12: a row padded to three
  // 16-byte words at 16-byte addresses, read as such; K4)
  template <bool kStaged, int kStride = 1, int kRowWords = 9>
  __device__ __forceinline__ bool scan(int cid, const int* fids,
                                       const float* rows, const Walk& w,
                                       int first = 0) {
    for (int s = first; s < w.slots; s += kStride) {
      const int f = fids[s];
      if (f < 0) break;  // occupied slots come first
      const int code = cid * w.slots + s;
      if (code == ex) continue;
      const float* tr = rows + (kStaged ? (long long)kRowWords * s : 9LL * f);
      float p0x, p0y, p0z, e1x, e1y, e1z, e2x, e2y, e2z;
      if constexpr (kStaged && kRowWords == 12) {
        const float4 a = ((const float4*)tr)[0], b = ((const float4*)tr)[1];
        const float4 c = ((const float4*)tr)[2];
        p0x = a.x, p0y = a.y, p0z = a.z, e1x = a.w, e1y = b.x, e1z = b.y;
        e2x = b.z, e2y = b.w, e2z = c.x;
      } else {
        p0x = tr[0], p0y = tr[1], p0z = tr[2];
        e1x = tr[3], e1y = tr[4], e1z = tr[5];
        e2x = tr[6], e2y = tr[7], e2z = tr[8];
      }
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

// One ray's carried pairs (pairs contract): (t1, c1) and (t2, c2), the two
// smallest margin-valid (t, code) pairs in lexicographic order, and (t3,
// c3), the smallest robust pair; all start at (t_max, -1). A candidate at
// t >= t_max never enters: it is not below the sentinel.
struct PairsBest {
  float t1, t2, t3;
  int c1, c2, c3;

  __device__ explicit PairsBest(float t_max)
      : t1(t_max), t2(t_max), t3(t_max), c1(-1), c2(-1), c3(-1) {}

  // a margin-valid candidate below (t2, c2) into the top two
  __device__ __forceinline__ void take2(float t, int code) {
    if (lex_less(t, code, t1, c1)) {
      t2 = t1;
      c2 = c1;
      t1 = t;
      c1 = code;
    } else {
      t2 = t;
      c2 = code;
    }
  }

  // Another set's pairs (u1, d1) <= (u2, d2) and (u3, d3), none of them in
  // this set: the top two of both sets and the smaller robust pair. Neither
  // result depends on which set came first.
  __device__ __forceinline__ void merge(float u1, int d1, float u2, int d2,
                                        float u3, int d3) {
    if (lex_less(u1, d1, t1, c1)) {
      if (lex_less(u2, d2, t1, c1)) {
        t2 = u2;
        c2 = d2;
      } else {
        t2 = t1;
        c2 = c1;
      }
      t1 = u1;
      c1 = d1;
    } else if (lex_less(u1, d1, t2, c2)) {
      t2 = u1;
      c2 = d1;
    }
    if (lex_less(u3, d3, t3, c3)) {
      t3 = u3;
      c3 = d3;
    }
  }

  // t1, c1, c2, c3 and the flag (pairs contract)
  __device__ __forceinline__ void store(const PairsIn& in,
                                        long long ray) const {
    in.t_out[ray] = t1;
    in.c1_out[ray] = c1;
    in.c2_out[ray] = c2;
    in.c3_out[ray] = c3;
    const long long gap =
        (long long)__float_as_int(t2) - (long long)__float_as_int(t1);
    in.amb_out[ray] = (c3 != c1) || (c2 >= 0 && gap < kAmbBand);
  }
};

// A load that the compiler may not merge with an earlier one of the same
// word (generic address: global or shared memory). The pairs slot test reads
// a term of B again where a later step needs it, so that the first reading
// need not hold a register through the steps between.
__device__ __forceinline__ float load_again(const float* p) {
  float v;
  asm volatile("ld.f32 %0, [%1];" : "=f"(v) : "l"(p));
  return v;
}

// The pairs slot test of a ray's row `a` of A against the occupied slots of
// cluster `cid`, in slot order (kStride > 1: only the slots first, first +
// kStride, ...), merged into `st`. `rows` is the cluster's block of mat_b
// (10 rows of 4 * slots) or, staged, its 19 structurally nonzero rows of
// `slots` entries in pairs_row / pairs_blk order.
//
// The outputs depend on a slot only through its gates, its t and, where it
// can still enter the robust pair, its robust test, so the work is ordered
// by what those need; every value is computed by the contract's own
// expression, so the outputs are those of the full test bit for bit:
//   * a gate whose estimate lies inside the exact triangle (u in [0, det],
//     v >= 0, u + v <= det) holds whatever the magnitudes are: each margin
//     m >= 0 only widens its bound, and rounding is monotone (det + m >=
//     det). A NaN magnitude comes only with a NaN estimate, which fails
//     the exact test and takes the margined one. Otherwise the gate needs
//     its magnitudes, computed then and kept;
//   * t_num, its divide and t > 0 come only past every gate;
//   * a valid slot that is not below (t2, c2) and not below (t3, c3)
//     changes nothing and takes no robust test; the robust test alone
//     needs the magnitudes of det and t_num.
template <bool kStaged, int kStride = 1>
__device__ __forceinline__ void pairs_scan(const float (&a)[10], int ex,
                                           PairsBest& st, int cid,
                                           const int* fids, const float* rows,
                                           const PairsIn& in, const Walk& w,
                                           int first = 0) {
  const int n4 = 4 * w.slots;  // a row of B
  for (int s = first; s < w.slots; s += kStride) {
    if (fids[s] < 0) break;  // occupied slots come first
    const int code = cid * w.slots + s;
    if (code == ex) continue;
    // term k of PAIRS_ROWS: det 0..2, t_num 3..6, u_num 7..12, v_num 13..18
    auto at = [&](int k) {
      return rows + (kStaged ? k * w.slots + s
                             : pairs_row(k) * n4 + pairs_blk(k) * w.slots + s);
    };
    auto b = [&](int k) -> float { return *at(k); };
    auto b2 = [&](int k) -> float { return load_again(at(k)); };
    // the magnitudes |A|·|B| of u_num (k0 = 7) and v_num (k0 = 13),
    // margined; `again`: past the step that read the terms
    auto margin_of = [&](int k0, bool again) {
      auto t = [&](int k) { return fabsf(again ? b2(k) : b(k)); };
      float m = fabsf(a[3]) * t(k0);
#pragma unroll
      for (int k = 4; k < 9; ++k) m = m + fabsf(a[k]) * t(k0 - 3 + k);
      return m * in.margin;
    };
    const float det = (a[6] * b(0) + a[7] * b(1)) + a[8] * b(2);
    if (!(det >= w.eps2)) continue;
    float u = a[3] * b(7);
#pragma unroll
    for (int k = 4; k < 9; ++k) u = u + a[k] * b(4 + k);
    float m_u = -1.0f, m_v = -1.0f;  // < 0: not computed yet
    if (!(u >= 0.0f && u <= det)) {
      m_u = margin_of(7, false);
      if (!(u >= -m_u && u <= det + m_u)) continue;
    }
    float v = a[3] * b(13);
#pragma unroll
    for (int k = 4; k < 9; ++k) v = v + a[k] * b(10 + k);
    if (!(v >= 0.0f)) {
      m_v = margin_of(13, false);
      if (!(v >= -m_v)) continue;
    }
    const float uv = u + v;
    if (!(uv <= det)) {
      if (m_u < 0.0f) m_u = margin_of(7, true);
      if (m_v < 0.0f) m_v = margin_of(13, false);
      if (!(uv <= (det + m_u) + m_v)) continue;
    }
    const float tn = ((a[0] * b(3) + a[1] * b(4)) + a[2] * b(5)) + a[9] * b(6);
    const float t = __fdiv_rn(tn, det);
    if (!(t > 0.0f)) continue;
    const bool in2 = lex_less(t, code, st.t2, st.c2);
    const bool in3 = lex_less(t, code, st.t3, st.c3);
    if (in2) st.take2(t, code);
    if (!in3) continue;
    // the robust test, on few slots: u, v and their magnitudes are read and
    // computed again (the same expressions, so the same values) rather than
    // held in registers through the divide
    float u2 = a[3] * b2(7), v2 = a[3] * b2(13);
#pragma unroll
    for (int k = 4; k < 9; ++k) {
      u2 = u2 + a[k] * b2(4 + k);
      v2 = v2 + a[k] * b2(10 + k);
    }
    const float mu = margin_of(7, true), mv = margin_of(13, true);
    const float m_d =
        ((fabsf(a[6]) * fabsf(b2(0)) + fabsf(a[7]) * fabsf(b2(1))) +
         fabsf(a[8]) * fabsf(b2(2))) *
        in.margin;
    const float m_t =
        (((fabsf(a[0]) * fabsf(b2(3)) + fabsf(a[1]) * fabsf(b2(4))) +
          fabsf(a[2]) * fabsf(b2(5))) +
         fabsf(a[9]) * fabsf(b2(6))) *
        in.margin;
    if (det >= w.eps2 + m_d && u2 >= mu && u2 <= det - mu && v2 >= mv &&
        u2 + v2 <= (det - mu) - mv && tn >= m_t) {
      st.t3 = t;
      st.c3 = code;
    }
  }
}

struct PairsStaged;

// The exact-pairs search of K2p, K3p and K2n (pairs contract above), as
// the kernels name it; every walk runs it in the form `coop` makes,
// PairsStaged.
struct Pairs {
  using In = PairsIn;

  __device__ __forceinline__ static float3 origin(const In& in,
                                                   long long ray) {
    return make_float3(in.a[10 * ray], in.a[10 * ray + 1],
                       in.a[10 * ray + 2]);
  }

  static constexpr int kRowWords = 19;  // staged words per slot: B's terms
  static constexpr int kMinBlocks = kMinBlocksPairs;
  static constexpr int kMinBlocksStaged = 0;  // K2pl: the compiler's choice
  static constexpr int kRayVecs = 6;  // the ray's stage, float4 (PairsStaged)
  __device__ __forceinline__ static PairsStaged coop(const In& in,
                                                     const Walk& w,
                                                     long long ray,
                                                     float4* stage);

  // The block copies cluster `cid` into shared memory: its face ids and the
  // 19 structurally nonzero rows of its block of mat_b, term by term.
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
};

// The pairs search of every walk: the ray lives in the tile's stage in
// shared memory, Pairs::kRayVecs float4 a ray, and not in registers:
// [a0..a3] [a4..a7] [a8, a9, t_max, exclusion code] [t1, c1, t2, c2] [t3,
// c3, -, -] [inv_d, -]. Every lane of a warp reads any lane's row of A from
// there (`coop_test`), and a lane's registers hold only the scan it runs.
// With the pairs held in registers through the walk (only the rows staged),
// K2n spilled 816 bytes at 64 registers (548 this way), and its primary
// pairs leg took 2.386 ms against 2.289 (tools/torch_near_legs.py, PERF.md
// §6).
struct PairsStaged {
  using In = PairsIn;
  float4* p;  // this ray's stage

  __device__ __forceinline__ PairsBest best() const {
    PairsBest b(0.0f);
    const float4 x = p[3], y = p[4];
    b.t1 = x.x;
    b.c1 = __float_as_int(x.y);
    b.t2 = x.z;
    b.c2 = __float_as_int(x.w);
    b.t3 = y.x;
    b.c3 = __float_as_int(y.y);
    return b;
  }
  __device__ __forceinline__ void keep(const PairsBest& b) const {
    p[3] = make_float4(b.t1, __int_as_float(b.c1), b.t2, __int_as_float(b.c2));
    p[4] = make_float4(b.t3, __int_as_float(b.c3), 0.0f, 0.0f);
  }
  // a staged ray's row of A and exclusion code (of this ray, or another's)
  __device__ __forceinline__ static void row(const float4* q, float (&a)[10],
                                             int& ex) {
    const float4 x = q[0], y = q[1], z = q[2];
    a[0] = x.x;
    a[1] = x.y;
    a[2] = x.z;
    a[3] = x.w;
    a[4] = y.x;
    a[5] = y.y;
    a[6] = y.z;
    a[7] = y.w;
    a[8] = z.x;
    a[9] = z.y;
    ex = __float_as_int(z.w);
  }

  __device__ __forceinline__ Ray ray() const {
    const float4 o = p[0], i = p[5];
    return Ray{o.x, o.y, o.z, 0.0f, 0.0f, 0.0f, i.x, i.y, i.z};
  }
  __device__ __forceinline__ float bound() const {
    return __uint_as_float(
        min(__float_as_uint(p[4].x) + kBoundUlps, kF32MaxBits));
  }
  __device__ __forceinline__ void store(const In& in, long long ray) const {
    best().store(in, ray);
  }

  // cluster `cid` in the tables: face ids, its block of mat_b
  __device__ __forceinline__ static Slots table(int cid, const In& in,
                                                const Walk& w) {
    return Slots{w.face_id + (long long)cid * w.slots,
                 in.mat_b + (long long)cid * 10 * 4 * w.slots};
  }

  // the staged walk (`walk_staged`): a cluster staged by the block
  static constexpr int kRowWords = Pairs::kRowWords;
  __device__ __forceinline__ static void stage(int cid, int* fids,
                                               float* rows, const In& in,
                                               const Walk& w, bool async) {
    Pairs::stage(cid, fids, rows, in, w, async);
  }
};

__device__ __forceinline__ PairsStaged Pairs::coop(const In& in,
                                                   const Walk& w,
                                                   long long ray,
                                                   float4* stage) {
  const float* a = in.a + 10 * ray;
  const float t_max = w.t_max[ray];
  stage[0] = make_float4(a[0], a[1], a[2], a[3]);
  stage[1] = make_float4(a[4], a[5], a[6], a[7]);
  stage[2] = make_float4(a[8], a[9], t_max, __int_as_float(w.excl[ray]));
  const PairsStaged s{stage};
  s.keep(PairsBest(t_max));
  stage[5] = make_float4(w.inv_d[3 * ray], w.inv_d[3 * ray + 1],
                         w.inv_d[3 * ray + 2], 0.0f);
  return s;
}

// A tile's cluster order: the entry distance and the cluster of each step,
// ascending. Sorted outside the kernel (rows of snear / order) ...
struct GlobalOrder {
  const float* snear;
  const int* order;
  int n;
  __device__ __forceinline__ float near(int k) const { return snear[k]; }
  __device__ __forceinline__ int cid(int k) const { return order[k]; }
};

// ... or ordered by the block itself (K2n; K3's supers; `tile_order`): the n
// boxes some ray of the tile enters as sorted keys in shared memory, the
// tile's entry distance (float bits) above the box index.
struct SharedOrder {
  const u64* key;
  int n;
  __device__ __forceinline__ float near(int k) const {
    return __uint_as_float((unsigned)(key[k] >> 32));
  }
  __device__ __forceinline__ int cid(int k) const {
    return (int)(unsigned)key[k];
  }
};

// Slot scans shared by a warp (every walk but K4's), one `coop_test` per
// search, over a cluster in the tables or staged in shared memory. A
// thread that scans a cluster on its own runs up to `slots` slot tests in
// sequence while the lanes of its warp whose rays skip that cluster wait
// for it: on a bounce leg, where a tile's rays go apart, most of a warp's
// instruction slots are such waits. Here the lanes that `want`
// cluster `cid` (they passed the bound and their own slab test) are taken
// one at a time: the lane's ray goes to the whole warp, every lane tests the
// slots lane, lane + 32, ... (face ids and rows read side by side), and the
// lanes' results are merged by the rule of the search, which does not depend
// on the order of the tests (header), and go back to the lane:
//   * closest-hit: the ray, exclusion code and best (t, code) by shuffle;
//     each lane starts from that best, and a butterfly takes the (t, code)
//     lexicographic minimum;
//   * any-hit: the ray, exclusion code and t_max by shuffle; a lane stops
//     at its first valid slot, which is its valid slot of the lowest code,
//     and one warp reduction (redux.sync) takes the lowest code of the
//     lanes, unsigned, so that -1 (none) is the largest; a code found ends
//     the lane's walk. Lanes test slots past the first valid one of the
//     cluster, which the sequential scan never reaches: work of the kernel,
//     not of its function (ops/cluster_cuda.py `walk_stats`);
//   * pairs: the ray's row of A, t_max and exclusion code from the tile's
//     stage in shared memory (`PairsStaged`): three broadcast 16-byte
//     loads, where a shuffle takes twelve instructions and keeps the row
//     in the owner's registers for the whole walk (measured 0-2 % slower
//     on every leg). Each lane keeps a top two and a robust minimum of its
//     own slots from the sentinel (t_max, -1), so that the carried pairs
//     enter the merge once; a butterfly merges the lanes' sets (not run
//     when no lane has a candidate, as on most clusters), and the result
//     merges once into the lane's carried pairs.
// When many lanes want the cluster (primary rays) the sequential scan is
// cheaper, every load a broadcast: kCoopSerial lanes or more take it
// (closest-hit and any-hit: 24; any-hit at 16, 20 and 24 is within 2 % on
// every leg, with no sign common to the legs), kCoopSerialPairs for pairs
// (12: 3-8 % faster than 24 on every pairs leg, 8 and 4 no better; a pairs
// slot test is about twice a triangle test, so sharing pays with more lanes
// wanting; tools/torch_near_legs.py --variant, PERF.md §6). All 32 lanes
// call this together. Returns true where the calling lane's ray is done
// (any-hit: it has its hit).
constexpr int kCoopSerial = 24;
constexpr int kCoopSerialPairs = 12;
constexpr unsigned kFull = 0xffffffffu;

// `cl`: the cluster from the tables or (kStaged) from a staged round
template <bool kStaged>
__device__ __forceinline__ bool coop_test(Exact<false>& s, bool want, int cid,
                                          const Slots& cl, const ExactIn&,
                                          const Walk& w, const float4*) {
  unsigned mask = __ballot_sync(kFull, want);
  if (__popc(mask) >= kCoopSerial) {
    if (want) s.scan<kStaged>(cid, cl.fids, cl.rows, w);
    return false;
  }
  const int lane = threadIdx.x & 31;
  while (mask) {
    const int src = __ffs(mask) - 1;
    mask &= mask - 1;
    auto from = [&](auto x) { return __shfl_sync(kFull, x, src); };
    Exact<false> c(Ray{from(s.r.ox), from(s.r.oy), from(s.r.oz), from(s.r.dx),
                       from(s.r.dy), from(s.r.dz), 0.0f, 0.0f, 0.0f},
                   from(s.ex), from(s.best), from(s.best_code));
    c.scan<kStaged, 32>(cid, cl.fids, cl.rows, w, lane);
    float best = c.best;
    int best_code = c.best_code;
#pragma unroll
    for (int off = 16; off >= 1; off >>= 1) {
      const float ot = __shfl_xor_sync(kFull, best, off);
      const int oc = __shfl_xor_sync(kFull, best_code, off);
      if (ot < best || (ot == best && oc < best_code)) {
        best = ot;
        best_code = oc;
      }
    }
    if (lane == src) {
      s.best = best;
      s.best_code = best_code;
    }
  }
  return false;
}

template <bool kStaged>
__device__ __forceinline__ bool coop_test(Exact<true>& s, bool want, int cid,
                                          const Slots& cl, const ExactIn&,
                                          const Walk& w, const float4*) {
  unsigned mask = __ballot_sync(kFull, want);
  if (__popc(mask) >= kCoopSerial)
    return want && s.scan<kStaged>(cid, cl.fids, cl.rows, w);
  const int lane = threadIdx.x & 31;
  bool done = false;
  while (mask) {
    const int src = __ffs(mask) - 1;
    mask &= mask - 1;
    auto from = [&](auto x) { return __shfl_sync(kFull, x, src); };
    Exact<true> c(Ray{from(s.r.ox), from(s.r.oy), from(s.r.oz), from(s.r.dx),
                      from(s.r.dy), from(s.r.dz), 0.0f, 0.0f, 0.0f},
                  from(s.ex), from(s.best), -1);
    c.scan<kStaged, 32>(cid, cl.fids, cl.rows, w, lane);
    const unsigned code = __reduce_min_sync(kFull, (unsigned)c.best_code);
    if (lane == src && code != ~0u) {
      s.best_code = (int)code;
      done = true;
    }
  }
  return done;
}

// `stage`: the tile's staged rays (PairsStaged)
template <bool kStaged>
__device__ __forceinline__ bool coop_test(PairsStaged& s, bool want, int cid,
                                          const Slots& cl, const PairsIn& in,
                                          const Walk& w,
                                          const float4* stage) {
  unsigned mask = __ballot_sync(kFull, want);
  const int lane = threadIdx.x & 31;
  float a[10];
  int ex;
  if (__popc(mask) >= kCoopSerialPairs) {
    if (want) {
      PairsBest st = s.best();
      PairsStaged::row(s.p, a, ex);
      pairs_scan<kStaged>(a, ex, st, cid, cl.fids, cl.rows, in, w);
      s.keep(st);
    }
    return false;
  }
  while (mask) {
    const int src = __ffs(mask) - 1;
    mask &= mask - 1;
    const float4* q = stage + Pairs::kRayVecs * (threadIdx.x - lane + src);
    PairsStaged::row(q, a, ex);
    PairsBest lane_best(q[2].z);  // from the sentinel (t_max, -1)
    pairs_scan<kStaged, 32>(a, ex, lane_best, cid, cl.fids, cl.rows, in, w,
                            lane);
    PairsBest& b = lane_best;
    if (__any_sync(kFull, b.c1 >= 0)) {
#pragma unroll
      for (int off = 16; off >= 1; off >>= 1)
        b.merge(__shfl_xor_sync(kFull, b.t1, off),
                __shfl_xor_sync(kFull, b.c1, off),
                __shfl_xor_sync(kFull, b.t2, off),
                __shfl_xor_sync(kFull, b.c2, off),
                __shfl_xor_sync(kFull, b.t3, off),
                __shfl_xor_sync(kFull, b.c3, off));
      if (lane == src) {
        PairsBest st = s.best();
        st.merge(b.t1, b.c1, b.t2, b.c2, b.t3, b.c3);
        s.keep(st);
      }
    }
  }
  return false;
}

// The walk of K1, K2p and K2n (and, over a super's children, of K3):
// the warp in step over the order, so that its lanes can share their slot
// scans (`coop_test`) over the tables (`Search::table`). A thread that
// walked alone would leave at the first entry not below its bound (any-hit:
// also at its hit); the entries ascend and the bound only falls, so testing
// that rule entry by entry leaves out the same clusters, and the warp leaves
// when no lane is left. `s` is the search's
// form for these walks (`coop`), `stage` the tile's rays as it stages them.
template <class Search, class Order>
__device__ __forceinline__ void walk_coop(Search& s, const Order& ord,
                                          const typename Search::In& in,
                                          const Walk& w, const float4* stage) {
  bool done = false;  // any-hit: the ray has its hit
  for (int k = 0; k < ord.n; ++k) {
    const bool alive = !done && !(ord.near(k) >= s.bound());
    if (!__any_sync(kFull, alive)) break;
    const int cid = ord.cid(k);
    bool want = alive;
    if (want) {
      float near_t, far_t;
      slab(w.box + 6 * cid, s.ray(), near_t, far_t);
      want = (near_t < far_t) && (far_t > 0.0f) && (near_t < s.bound());
    }
    if (coop_test<false>(s, want, cid, Search::table(cid, in, w), in, w,
                         stage))
      done = true;
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
// Within a round the warp goes over the entries in step, as `walk_coop`
// does, and shares its slot scans over the staged rows (`coop_test`): a
// lane keeps its own sequence of entries (it leaves at the first entry not
// below the bound it tests by, and at its any-hit hit), and the warp leaves
// the round when no lane is left. A lane reads slots lane, lane + 32, ...
// of the round's buffer: a triangle row is 9 words and a face id 1, so 32
// consecutive slots lie in 32 different banks (9 is odd); the pairs rows
// are staged term by term, so the lanes read 32 consecutive words. No
// padding is needed. The serial scan (many lanes want the cluster) reads
// one address a step for the whole warp: a broadcast.
//
// An any-hit thread that has its hit neither votes nor tests again. Every
// barrier is reached by the whole block: the loop's exit is the
// block-uniform vote, and a finished thread stays in the loop. `stage`: the
// search's staged rays, written before the call (the first vote is the
// barrier before they are read).
template <class Search, class Order>
__device__ __forceinline__ void walk_staged(Search& s, const Order& ord,
                                            const typename Search::In& in,
                                            const Walk& w, int jblk,
                                            bool pipelined, float* smem,
                                            const float4* stage) {
  const int per = w.slots * (1 + Search::kRowWords);  // words per cluster
  float* buf[2] = {smem, smem + (pipelined ? jblk * per : 0)};
  auto fetch = [&](int j, float* dst) {
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
  if (go && pipelined) fetch(0, buf[0]);
  int j = 0, cur = 0;
  while (go) {
    const int nb = min(jblk, ord.n - j);
    const int jn = j + nb;
    if (pipelined)
      __pipeline_wait_prior(0);
    else
      fetch(j, buf[0]);
    __syncthreads();  // the round's copy is whole; the last round is tested
    float rb_n = rb;
    bool live_n = false, go_n = false;
    if (pipelined) {
      rb_n = s.bound();
      live_n = !found && jn < ord.n && !(ord.near(jn) >= rb_n);
      go_n = __syncthreads_or(live_n);
      if (go_n) fetch(jn, buf[cur ^ 1]);
    }
    const float tb = pipelined ? rb_n : rb;  // the bound this round tests by
    const float* base = buf[cur];
    bool on = live && !found;
    for (int jj = 0; jj < nb; ++jj) {
      on = on && !(ord.near(j + jj) >= tb);
      if (!__any_sync(kFull, on)) break;
      const int cid = ord.cid(j + jj);
      bool want = on;
      if (want) {
        float near_t, far_t;
        slab(w.box + 6 * cid, s.ray(), near_t, far_t);
        want = (near_t < far_t) && (far_t > 0.0f) && (near_t < tb);
      }
      const float* c = base + jj * per;
      if (coop_test<true>(s, want, cid, Slots{(const int*)c, c + w.slots},
                          in, w, stage)) {
        found = true;
        on = false;
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
// order, the warps in step (`walk_coop`). The search's staged rays (pairs:
// Search::kRayVecs float4 a ray) are the block's dynamic shared memory.
template <class Search>
__device__ __forceinline__ void trace_outside(const typename Search::In& in,
                                              const Walk& w) {
  extern __shared__ __align__(16) float smem[];
  const long long tile = blockIdx.x;
  const long long ray = tile * blockDim.x + threadIdx.x;
  float4* stage = (float4*)smem;
  auto s = Search::coop(in, w, ray, stage + Search::kRayVecs * threadIdx.x);
  if constexpr (Search::kRayVecs > 0) __syncthreads();
  const float* srow = w.snear + tile * w.n_cols;
  const int n = (w.cap > 0 && w.cap < w.n_cols) ? w.cap : w.n_cols;
  walk_coop(s, GlobalOrder{srow, w.order + tile * w.n_cols, n}, in, w, stage);
  s.store(in, ray);
  if (w.stop_out) {
    // the first entry distance the tile did not walk (-0 made +0), as bits
    int stop = 0x7fffffff;
    if (n < w.n_cols && srow[n] < __uint_as_float(kF32MaxBits))
      stop = __float_as_int(srow[n] + 0.0f);
    w.stop_out[ray] = stop;
  }
}

// K4: one CTA per `tile`-ray block of the sorted stream, one thread per ray.
// The CTA stages the clusters of the block's two schedule entries (-1: none)
// into shared memory: per entry the cluster's face ids and, per occupied
// slot, its triangle row in kK4RowWords words, copied by cp.async. While the
// copies fly, each thread reads its ray and slab-tests the two cluster
// boxes; then one wait and one barrier, and every ray tests s0, then s1, as
// the twin does: K1's gate, then the slot scan from shared memory by the
// thread alone. Every lane of a warp reads the same slot, a broadcast (a scan
// shared by the warp, `coop_test`, measured no faster: the lanes want the
// same clusters). A CTA of several blocks that staged the distinct clusters
// of their entries once (consecutive blocks share their s0) measured slower
// at 4 and 8 blocks and even at 2. A block with no entry (the dead lanes and
// keyless rays at the back of the stream) copies nothing and writes (t_max,
// code0 or -1).
__global__ void trace_binned_kernel(ExactIn in, Walk w, const int* sched) {
  extern __shared__ __align__(16) float smem[];
  const long long blk = blockIdx.x;
  const long long ray = blk * blockDim.x + threadIdx.x;
  const int cids[2] = {sched[2 * blk], sched[2 * blk + 1]};
  if (cids[0] < 0 && cids[1] < 0) {
    in.t_out[ray] = w.t_max[ray];
    in.code_out[ray] = w.code0 ? w.code0[ray] : -1;
    return;
  }
  // per entry the face ids (padded to 16 bytes), then kK4RowWords words a
  // slot
  const int fid_words = (w.slots + 3) & ~3;
  const int per = fid_words + kK4RowWords * w.slots;
  for (int i = threadIdx.x; i < 2 * w.slots; i += blockDim.x) {
    const int e = i >= w.slots, slot = i - e * w.slots;
    const int cid = e ? cids[1] : cids[0];  // no local-memory array
    if (cid < 0) continue;
    float* buf = smem + e * per;
    const int f = w.face_id[(long long)cid * w.slots + slot];
    ((int*)buf)[slot] = f;
    if (f < 0) continue;
    const float* tr = in.tri + 9LL * f;
#pragma unroll
    for (int q = 0; q < 9; ++q)
      copy4(buf + fid_words + kK4RowWords * slot + q, tr + q, true);
  }
  __pipeline_commit();
  Exact<false> s(in, w, ray);
  float near_t[2], far_t[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    near_t[e] = far_t[e] = 0.0f;
    if (cids[e] >= 0) slab(w.box + 6 * cids[e], s.r, near_t[e], far_t[e]);
  }
  __pipeline_wait_prior(0);
  __syncthreads();  // both buffers are whole
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    if (cids[e] < 0) continue;
    const bool want = (near_t[e] < far_t[e]) && (far_t[e] > 0.0f) &&
                      (near_t[e] < s.bound());
    const float* c = smem + e * per;
    if (want)
      s.scan<true, 1, kK4RowWords>(cids[e], (const int*)c, c + fid_words, w);
  }
  s.store(in, ray);
}

// K5 / K2pl: as K1, over the same order, in staged rounds (walk_staged).
// Dynamic shared memory: the search's staged rays (as K1's), then the
// rounds' buffers.
template <class Search>
__device__ __forceinline__ void trace_staged(const typename Search::In& in,
                                             const Walk& w, int jblk,
                                             int pipelined) {
  extern __shared__ __align__(16) float smem[];
  const long long tile = blockIdx.x;
  const long long ray = tile * blockDim.x + threadIdx.x;
  float4* stage = (float4*)smem;
  auto s = Search::coop(in, w, ray, stage + Search::kRayVecs * threadIdx.x);
  walk_staged(s, GlobalOrder{w.snear + tile * w.n_cols,
                             w.order + tile * w.n_cols, w.n_cols}, in, w,
              jblk, pipelined != 0,
              (float*)(stage + Search::kRayVecs * blockDim.x), stage);
  s.store(in, ray);
}

// ---------------------------------------------------------------------------
// The first half of K2n and K3: a tile orders its own boxes (`tile_order`),
// and K3's child cull takes the same pass.
//
// What it computes is `tile_nears_fused` + a stable ascending sort
// (ops/cluster_cuda.py `_near_order`): per box the minimum over the tile's
// rays of the ray's entry value, max(near, 0) + 0 where near < far, near <
// t_max, far > 0 and the entry is not below the ray's t_start, else F32_MAX;
// then the entered boxes by (distance, box index) ascending. Non-negative
// floats order as their bits and a minimum of exact values does not depend
// on the order it is taken in, so distances and order are those of the twin
// bit for bit.
//
// BOXES ON THE LANES, RAYS IN SHARED MEMORY. The block stages its rays once,
// 32 bytes each: (o, t_max) and (inv_d, t_start or 0), so a thread reads a
// ray as two broadcast 16-byte loads. A thread owns the boxes tid, tid + T,
// ...: it keeps up to kNearRows (4; K3's supers: kSuperRows, 2) of them at a
// time in registers with their running minima (the rows are cut into the
// fewest groups of at most that many, as even as they go: the slice's 5
// rows are 3 + 2) and loops over the rays, so one ray read serves several
// slab tests, and per ray-box pair
// there is one slab test and one integer minimum: no shuffle, no atomic and
// no barrier inside the pass. The rays are staged grouped by the sign octant
// of inv_d (`stage_rays`), so which corner of a box is the near one is
// decided once per run of rays and not once per pair: 12 subtracts and
// multiplies, 4 NaN-propagating min / max and 6 compare, select and integer
// min / max instructions a pair, where the plain slab test (`slab`) takes 6
// min / max more. The boxes of a group of rows come in as one coalesced
// 16-byte cp.async copy into a 12 KB stage (K3: 6 KB), from which each
// thread takes its own. More rows a thread (5 and 6 were measured) make the
// pass itself faster and the kernel slower: the walk that follows loses a
// block an SM to the registers and the stage.
//
// THE ORDER BY A SORT. After each group a warp compacts its entered boxes
// with ballots (one shared atomicAdd per warp and group) into 64-bit keys,
// distance bits << 32 | box, which are distinct, so any correct sort gives
// the stable order. `block_sort` is a bitonic network over the next power of
// two P >= 64 of the entered count, padded with ~0: every 64-key segment is
// held two keys a lane in registers by one warp, which runs all compare
// distances j <= 32 there (j = 32 inside the lane, j < 32 by __shfl_xor),
// so only the distances j >= 64 go through shared memory between block
// barriers. P = 1024 takes 10 + 4 barriers in place of the 55 of a plain
// block bitonic; P = 64 (a tile that enters up to 64 boxes; K3's children)
// is one warp and no barrier inside the sort.
//
// Shared memory: 8 bytes a box (the keys, for the next power of two of the
// box count, at least 64) + 32 T (rays) + 24 kNearRows T (box stage): 24 KB
// at the slice's 643 clusters and T = 128, 48 KB at kMaxNearClusters; K3
// ordering 227 supers: 2 KB of keys and a 6 KB stage beside its static 9 KB.
// ---------------------------------------------------------------------------

// The tile's rays in shared memory, and where each octant's rays start.
struct RayStage {
  float4* ray;  // (2 T)
  int* oct;     // (kOctWords) starts of the 8 octants and the end; counts
};

// The tile's rays as the box passes read them, GROUPED BY SIGN OCTANT of
// inv_d (bit a set where inv_d[a] < 0; NaN and -0 count as "up"): rows 2i
// and 2i + 1 of the ray in place i, the rays of octant k in places
// oct[k] .. oct[k + 1] - 1. A minimum over the tile's rays does not
// depend on their order, so the passes may take them octant by octant with
// the octant's code chosen once per group of rays, not once per ray. A
// counting sort: per warp and octant one ballot, the counts in oct[16..],
// one block barrier, and every thread sums the counts before its own.
// The caller needs a block barrier before the stage is read.
template <class Search>
__device__ __forceinline__ void stage_rays(const RayStage& rs,
                                           const typename Search::In& in,
                                           const Walk& w, long long ray) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;
  const float3 o = Search::origin(in, ray);
  const float4 p = make_float4(o.x, o.y, o.z, w.t_max[ray]);
  const float4 q =
      make_float4(w.inv_d[3 * ray], w.inv_d[3 * ray + 1], w.inv_d[3 * ray + 2],
                  w.t_start ? w.t_start[ray] : 0.0f);
  const int oct = (q.x < 0.0f) | ((q.y < 0.0f) << 1) | ((q.z < 0.0f) << 2);
  int* s_cnt = rs.oct + 16;  // [octant][warp]
  unsigned mine = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const unsigned bal = __ballot_sync(0xffffffffu, oct == k);
    if (lane == k) s_cnt[k * n_warps + warp] = __popc(bal);
    if (oct == k) mine = bal;
  }
  __syncthreads();
  int pos = __popc(mine & ((1u << lane) - 1u));
  for (int i = 0; i < oct * n_warps + warp; ++i) pos += s_cnt[i];
  if (tid <= 8) {
    int start = 0;
    for (int i = 0; i < tid * n_warps; ++i) start += s_cnt[i];
    rs.oct[tid] = start;
  }
  rs.ray[2 * pos] = p;
  rs.ray[2 * pos + 1] = q;
}

// max(near, 0) with -0 made +0, on the float's bits: a negative float, -0
// included, is a negative integer. (A NaN fails the compares that follow.)
__device__ __forceinline__ float entry_of(float near_t) {
  return __int_as_float(max(__float_as_int(near_t), 0));
}

// One ray of the pass against kB boxes in registers. A box comes with each
// axis sorted (bx[a] <= bx[3 + a], `sorted_box`), so along an axis the ray
// goes up (inv_d >= 0, kN false) its products satisfy (lo - o) inv_d <= (hi -
// o) inv_d by the monotonicity of rounding, and along one it goes down the
// reverse: the per-axis min and max of the slab test are known from the
// ray's sign octant and are not computed. The values are those of `slab`
// on the same ray and box (a sorted axis gives the same two products): any
// NaN product (0 x inf for a ray along an axis; a NaN origin) sits in `near`
// or `far` and the NaN-propagating combine carries it into `near < far`.
template <int kB, bool kNx, bool kNy, bool kNz>
__device__ __forceinline__ void box_pass_ray(const float4& p, const float4& q,
                                             const float (&bx)[kB][6],
                                             unsigned (&m)[kB]) {
#pragma unroll
  for (int b = 0; b < kB; ++b) {
    const float nx = (bx[b][kNx ? 3 : 0] - p.x) * q.x;
    const float fx = (bx[b][kNx ? 0 : 3] - p.x) * q.x;
    const float ny = (bx[b][kNy ? 4 : 1] - p.y) * q.y;
    const float fy = (bx[b][kNy ? 1 : 4] - p.y) * q.y;
    const float nz = (bx[b][kNz ? 5 : 2] - p.z) * q.z;
    const float fz = (bx[b][kNz ? 2 : 5] - p.z) * q.z;
    const float near_t = max_nan(max_nan(nx, ny), nz);
    const float far_t = min_nan(min_nan(fx, fy), fz);
    const float entry = entry_of(near_t);
    // near < far and far > 0, as one compare: max(near, 0) < far
    if ((entry < far_t) && (near_t < p.w) && (entry >= q.w))
      m[b] = min(m[b], __float_as_uint(entry));
  }
}

// The pass: the rays in places [r0, r1) of the stage against kB boxes in
// registers; m[b] is box b's running minimum as float bits. The rays come
// octant by octant (stage_rays), so the octant's code is picked once per
// run of rays and the loop over a run is straight-line: two 16-byte
// broadcast reads and kB slab tests. An entry >= 0 is never below a t_start
// of 0, and never "not below" a NaN one.
template <int kB, bool kNx, bool kNy, bool kNz>
__device__ __forceinline__ void box_pass_run(const float4* s_ray, int r0,
                                             int r1,
                                             const float (&bx)[kB][6],
                                             unsigned (&m)[kB]) {
  for (int i = r0; i < r1; ++i)
    box_pass_ray<kB, kNx, kNy, kNz>(s_ray[2 * i], s_ray[2 * i + 1], bx, m);
}
template <int kB>
__device__ __forceinline__ void box_pass(const RayStage& rs, int r0, int r1,
                                         const float (&bx)[kB][6],
                                         unsigned (&m)[kB]) {
  const float4* sr = rs.ray;
#pragma unroll 1
  for (int oct = 0; oct < 8; ++oct) {
    const int lo = max(r0, rs.oct[oct]), hi = min(r1, rs.oct[oct + 1]);
    switch (oct) {
      case 0: box_pass_run<kB, false, false, false>(sr, lo, hi, bx, m); break;
      case 1: box_pass_run<kB, true, false, false>(sr, lo, hi, bx, m); break;
      case 2: box_pass_run<kB, false, true, false>(sr, lo, hi, bx, m); break;
      case 3: box_pass_run<kB, true, true, false>(sr, lo, hi, bx, m); break;
      case 4: box_pass_run<kB, false, false, true>(sr, lo, hi, bx, m); break;
      case 5: box_pass_run<kB, true, false, true>(sr, lo, hi, bx, m); break;
      case 6: box_pass_run<kB, false, true, true>(sr, lo, hi, bx, m); break;
      default: box_pass_run<kB, true, true, true>(sr, lo, hi, bx, m); break;
    }
  }
}

// A box for the pass: each axis sorted, NaN kept (an inverted-empty pad box
// slab-tests like the box between its swapped corners, as in `slab`).
__device__ __forceinline__ void sorted_box(const float* src, float (&bx)[6]) {
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float lo = src[a], hi = src[3 + a];
    bx[a] = min_nan(lo, hi);
    bx[3 + a] = max_nan(lo, hi);
  }
}

// One group of kB rows of boxes: boxes first .. first + count - 1 of `box`
// through the stage into registers, the pass over all the tile's rays, and
// the entered ones appended to `s_key` as keys (in no order).
template <int kB>
__device__ __forceinline__ void order_rows(const float* box, int first,
                                           int count, const RayStage& rs,
                                           float* s_stage, u64* s_key,
                                           int* s_n) {
  const int tid = threadIdx.x, T = blockDim.x;
  const float* src = box + 6LL * first;  // 16-byte aligned: T % 32 == 0
  const int words = 6 * count, vecs = words >> 2;
  for (int v = tid; v < vecs; v += T)
    __pipeline_memcpy_async(s_stage + 4 * v, src + 4 * v, 16);
  for (int q = 4 * vecs + tid; q < words; q += T)
    __pipeline_memcpy_async(s_stage + q, src + q, 4);
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();  // the stage is whole (and, first group: the rays)
  float bx[kB][6];
  unsigned m[kB];
#pragma unroll
  for (int b = 0; b < kB; ++b) {
    const int idx = tid + b * T;
    sorted_box(s_stage + 6 * (idx < count ? idx : 0), bx[b]);
    m[b] = kF32MaxBits;
  }
  __syncthreads();  // the stage is read: the next group may overwrite it
  box_pass<kB>(rs, 0, T, bx, m);
  unsigned bal[kB];
  int total = 0;
#pragma unroll
  for (int b = 0; b < kB; ++b) {
    const bool entered = tid + b * T < count && m[b] != kF32MaxBits;
    bal[b] = __ballot_sync(0xffffffffu, entered);
    total += __popc(bal[b]);
  }
  const int lane = tid & 31;
  int base = 0;
  if (lane == 0 && total) base = atomicAdd(s_n, total);
  base = __shfl_sync(0xffffffffu, base, 0);
#pragma unroll
  for (int b = 0; b < kB; ++b) {
    if ((bal[b] >> lane) & 1u)
      s_key[base + __popc(bal[b] & ((1u << lane) - 1u))] =
          ((u64)m[b] << 32) | (unsigned)(first + tid + b * T);
    base += __popc(bal[b]);
  }
}

// `count` <= T boxes, each split over T / count parts of the tile's rays:
// thread tid takes box tid % count (`load(box, bx)` fetches it and says
// whether it is to be tested) over the rays of part tid / count, and leaves
// its minimum in s_part[tid]. The minimum of box c is then the least of
// s_part[c + p * count] over the parts p (`merged`), after a block barrier.
template <class Load>
__device__ __forceinline__ void split_pass(int count, const RayStage& rs,
                                           unsigned* s_part, Load load) {
  const int tid = threadIdx.x, T = blockDim.x;
  const int parts = T / count, per = (T + parts - 1) / parts;
  if (tid < parts * count) {
    const int part = tid / count;
    float bx[1][6];
    unsigned m[1] = {kF32MaxBits};
    if (load(tid % count, part, bx[0]))
      box_pass<1>(rs, part * per, min(T, (part + 1) * per), bx, m);
    s_part[tid] = m[0];
  }
}
__device__ __forceinline__ unsigned merged(const unsigned* s_part, int count,
                                           int box) {
  unsigned v = s_part[box];
  for (int i = box + count; i + count - box <= (int)blockDim.x; i += count)
    v = min(v, s_part[i]);
  return v;
}

// The boxes left after the whole rows, when they fill at most half a row
// (the slice's 643 clusters leave 3): a row of their own would keep most
// threads on boxes that are not there, so each is split over several
// threads (`split_pass`) and the minima are merged where the keys are made.
__device__ __forceinline__ void order_tail(const float* box, int first,
                                           int count, const RayStage& rs,
                                           float* s_stage, u64* s_key,
                                           int* s_n) {
  const int tid = threadIdx.x, T = blockDim.x;
  const float* src = box + 6LL * first;
  for (int q = tid; q < 6 * count; q += T) s_stage[q] = src[q];
  unsigned* s_part = (unsigned*)(s_stage + 3 * T);  // past count <= T / 2 boxes
  __syncthreads();
  split_pass(count, rs, s_part, [&](int c, int, float (&bx)[6]) {
    sorted_box(s_stage + 6 * c, bx);
    return true;
  });
  __syncthreads();
  const unsigned v = tid < count ? merged(s_part, count, tid) : kF32MaxBits;
  const unsigned bal = __ballot_sync(0xffffffffu, v != kF32MaxBits);
  const int lane = tid & 31;
  int base = 0;
  if (lane == 0 && bal) base = atomicAdd(s_n, __popc(bal));
  base = __shfl_sync(0xffffffffu, base, 0);
  if ((bal >> lane) & 1u)
    s_key[base + __popc(bal & ((1u << lane) - 1u))] =
        ((u64)v << 32) | (unsigned)(first + tid);
  __syncthreads();  // the stage and the parts are read
}

// Step k of the bitonic network on one 64-key segment (keys base .. base +
// 63, base a multiple of 64) held two a lane, `a` = key base + lane and `b`
// = key base + 32 + lane: the compare distances j = min(k / 2, 32) .. 1.
// Key i goes up (takes the minimum at the lower index) when (i & k) == 0.
__device__ __forceinline__ void bitonic_tail64(u64& a, u64& b, int k,
                                               int base) {
  const int lane = threadIdx.x & 31;
  const bool up_a = ((base + lane) & k) == 0;
  const bool up_b = ((base + 32 + lane) & k) == 0;
  int j = k >> 1;
  if (j >= 32) {  // j = 32: the pair lies in this lane, and up_a == up_b
    if ((a > b) == up_a) {
      const u64 t = a;
      a = b;
      b = t;
    }
    j = 16;
  }
  for (; j >= 1; j >>= 1) {
    const u64 oa = __shfl_xor_sync(0xffffffffu, a, j);
    const u64 ob = __shfl_xor_sync(0xffffffffu, b, j);
    const bool low = (lane & j) == 0;
    a = (low == up_a) ? min(a, oa) : max(a, oa);
    b = (low == up_b) ? min(b, ob) : max(b, ob);
  }
}

// Sort key[0 .. P) ascending, P a power of two >= 64, whole block. The
// initial keys are init(i) (which may read `key` itself); ends with a block
// barrier. P = 64: warp 0 alone, in registers.
template <class Init>
__device__ __forceinline__ void block_sort(u64* key, int P, Init init) {
  const int tid = threadIdx.x, T = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, n_warps = T >> 5;
  for (int seg = warp; seg < (P >> 6); seg += n_warps) {
    const int base = seg << 6;
    u64 a = init(base + lane), b = init(base + 32 + lane);
    for (int k = 2; k <= 64; k <<= 1) bitonic_tail64(a, b, k, base);
    key[base + lane] = a;
    key[base + 32 + lane] = b;
  }
  for (int k = 128; k <= P; k <<= 1) {
    for (int j = k >> 1; j >= 64; j >>= 1) {
      __syncthreads();
      for (int t = tid; t < (P >> 1); t += T) {
        const int i = ((t & ~(j - 1)) << 1) | (t & (j - 1));
        const u64 x = key[i], y = key[i + j];
        if ((x > y) == ((i & k) == 0)) {
          key[i] = y;
          key[i + j] = x;
        }
      }
    }
    __syncthreads();
    for (int seg = warp; seg < (P >> 6); seg += n_warps) {
      const int base = seg << 6;
      u64 a = key[base + lane], b = key[base + 32 + lane];
      bitonic_tail64(a, b, k, base);
      key[base + lane] = a;
      key[base + 32 + lane] = b;
    }
  }
  __syncthreads();
}

// Keys a tile of n_boxes boxes may need: the next power of two, at least 64.
__host__ __device__ inline int key_capacity(int n_boxes) {
  int p = 64;
  while (p < n_boxes) p <<= 1;
  return p;
}

// A group of kB rows for `order_rows`, compiled only where kB <= kRows.
struct OrderGroup {
  const float* box;
  int first, count;
  const RayStage& rs;
  float* s_stage;
  u64* s_key;
  int* s_n;
  template <int kB, int kRows>
  __device__ __forceinline__ void run() const {
    if constexpr (kB <= kRows)
      order_rows<kB>(box, first, count, rs, s_stage, s_key, s_n);
  }
};

// The first half: the tile orders `n_boxes` boxes, a thread holding at most
// kRows of them at a time. Leaves the entered boxes
// as sorted keys in s_key and returns their number. The ray stage must be
// written (stage_rays) by every thread before the call; no barrier is needed
// between.
template <int kRows>
__device__ __forceinline__ int tile_order(const float* box, int n_boxes,
                                          const RayStage& rs, float* s_stage,
                                          u64* s_key, int* s_n) {
  static_assert(kRows >= 1 && kRows <= 6, "groups of one to six rows");
  const int tid = threadIdx.x, T = blockDim.x;
  if (tid == 0) *s_n = 0;
  const int tail = n_boxes % T <= T / 2 ? n_boxes % T : 0;
  const int whole = n_boxes - tail;  // boxes taken a row of T at a time
  const int rows = (whole + T - 1) / T;
  const int groups = (rows + kRows - 1) / kRows;
  for (int g = 0, row = 0; g < groups; ++g) {
    const int take = (rows - row + groups - g - 1) / (groups - g);
    const int first = row * T, count = min(take * T, whole - first);
    const OrderGroup grp{box, first, count, rs, s_stage, s_key, s_n};
    switch (take) {
      case 1: grp.run<1, kRows>(); break;
      case 2: grp.run<2, kRows>(); break;
      case 3: grp.run<3, kRows>(); break;
      case 4: grp.run<4, kRows>(); break;
      case 5: grp.run<5, kRows>(); break;
      default: grp.run<6, kRows>(); break;
    }
    row += take;
  }
  if (tail) order_tail(box, whole, tail, rs, s_stage, s_key, s_n);
  __syncthreads();
  const int n = *s_n;
  const int P = key_capacity(n);
  for (int i = n + tid; i < P; i += T) s_key[i] = ~0ull;
  __syncthreads();
  block_sort(s_key, P, [&](int i) { return s_key[i]; });
  return n;
}

// Dynamic shared memory of the first half for a tile of `tile` rays over
// n_boxes boxes: keys, then (K2n: the rays, then) the box stage, which the
// walk's search then takes for its rays (coop_vecs float4 a ray).
__host__ __device__ inline size_t order_bytes(int n_boxes, int tile,
                                              bool rays, int coop_vecs) {
  const size_t stage = 24 * (size_t)(rays ? kNearRows : kSuperRows) * tile;
  const size_t coop = 16 * (size_t)coop_vecs * tile;
  return 8 * (size_t)key_capacity(n_boxes) + (rays ? 32 * (size_t)tile : 0) +
         (stage > coop ? stage : coop);
}

// K2n: the block orders its tile's cluster boxes itself (`tile_order` over
// the w.n_cols boxes of w.box; w.snear and w.order are not read) and walks
// them as K1 does or, `pipelined`, as K2pl does. Clusters that no ray enters
// keep F32_MAX and are left out of the order: no bound exceeds F32_MAX, so no
// walk would reach them. With `Walk::t_start` a ray's entry below its own
// t_start is left out of the minimum. The search (`Search::coop`) is made
// only after the first half, and the box stage, free then, holds what it
// stages of its rays (Search::kRayVecs float4 a ray: pairs, all 96 bytes of
// it). Not pipelined, the warps walk in step and share their slot scans
// (`walk_coop`).
template <class Search>
__device__ __forceinline__ void trace_near(const typename Search::In& in,
                                           const Walk& w, int pipelined) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int s_n;
  __shared__ int s_oct[kOctWords];
  const int n_boxes = w.n_cols;
  u64* s_key = (u64*)smem;
  const RayStage rs{(float4*)(s_key + key_capacity(n_boxes)), s_oct};
  float* s_stage = (float*)(rs.ray + 2 * blockDim.x);
  float* s_walk = s_stage + 6 * kNearRows * blockDim.x;
  const long long ray = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  stage_rays<Search>(rs, in, w, ray);
  const int n =
      tile_order<kNearRows>(w.box, n_boxes, rs, s_stage, s_key, &s_n);
  float4* stage = (float4*)s_stage;  // free after the first half
  auto s = Search::coop(in, w, ray, stage + Search::kRayVecs * threadIdx.x);
  if constexpr (Search::kRayVecs > 0) __syncthreads();
  const SharedOrder ord{s_key, n};
  if (pipelined)
    walk_staged(s, ord, in, w, 1, true, s_walk, stage);
  else
    walk_coop(s, ord, in, w, stage);
  s.store(in, ray);
}

// Where K3's time goes: built with -DWRT_K3_CLOCKS (tools/torch_k3_split.py
// does), thread 0 of every block adds the clock64() ticks between the walk's
// block barriers to these sums; a build without the flag has none of it.
#ifdef WRT_K3_CLOCKS
enum { kClkOrder, kClkVote, kClkCull, kClkRank, kClkWalk, kClkSupers, kClkN };
__device__ u64 g_k3_clocks[kClkN];
#define K3_CLOCK_START() long long k3_t0 = clock64()
#define K3_CLOCK(slot)                                    \
  if (threadIdx.x == 0) {                                 \
    const long long k3_t1 = clock64();                    \
    atomicAdd(&g_k3_clocks[slot], (u64)(k3_t1 - k3_t0));  \
    k3_t0 = k3_t1;                                        \
  }
#define K3_COUNT(slot) \
  if (threadIdx.x == 0) atomicAdd(&g_k3_clocks[slot], (u64)1)
#else
#define K3_CLOCK_START()
#define K3_CLOCK(slot)
#define K3_COUNT(slot)
#endif

// What K3's walk keeps in shared memory besides the order.
struct TwoLevelShared {
  RayStage rays;   // the tile's rays (stage_rays)
  float* box;      // (6 G) the super's child boxes
  unsigned* part;  // (T) child minima by part of the tile's rays
  u64* ckey;       // (max(64, G')) the children in walk order, as keys
};

// The walk of K3 / K3p over the tile's SUPER order; the children of each
// super are culled, ordered and walked in the block. Every __syncthreads is
// reached by the whole block: the outer loop's exit is block-uniform
// (__syncthreads_or), and a finished thread stays in the loop to take its
// share of the child minima.
//
// The child cull is the first half's pass at N = G (`split_pass`): thread
// tid owns child tid % G and the rays of part tid / G of the tile (T / G
// parts: two at G = 64, T = 128, so all four warps work), writes its part's
// minimum to shared memory, and the parts are merged where the keys are
// made (two and four children a thread over a quarter and an eighth of the
// rays were measured: the pass is shorter and the leg 8 % and 40 % longer,
// by the registers the search holds meanwhile); the order is
// `block_sort` at 64 keys (128 above G = 64): one warp, in registers. Three
// block barriers per visited super: the vote, the minima, the order.
template <class Search, class Order>
__device__ __forceinline__ void walk_two_level(Search& s, const Order& ord,
                                               const typename Search::In& in,
                                               const Walk& w,
                                               const TwoLevelShared& sh,
                                               const float4* stage) {
  const int group = w.group;
  const int P = key_capacity(group);
  bool found = false;  // any-hit: done at the first valid hit
  K3_CLOCK_START();
  for (int k = 0; k < ord.n; ++k) {
    // as K1's stop rule, per ray; the block goes on while any ray is live.
    // The barrier also orders the last super's walk (and the first time the
    // ray stage) before this super's writes.
    const bool live = !(ord.near(k) >= s.bound()) && !found;
    if (!__syncthreads_or(live)) break;
    K3_CLOCK(kClkVote);
    K3_COUNT(kClkSupers);
    const int c0 = ord.cid(k) * group;
    split_pass(group, sh.rays, sh.part, [&](int child, int part,
                                           float (&bx)[6]) {
      const float* src = w.box + 6LL * (c0 + child);
      if (part == 0) {  // the walk reads the box as it is in the tables
#pragma unroll
        for (int q = 0; q < 6; ++q) sh.box[6 * child + q] = src[q];
      }
      sorted_box(src, bx);
      // children without faces keep F32_MAX
      return w.face_id[(long long)(c0 + child) * w.slots] >= 0;
    });
    __syncthreads();
    K3_CLOCK(kClkCull);
    block_sort(sh.ckey, P, [&](int i) -> u64 {
      if (i >= group) return ~0ull;
      return ((u64)merged(sh.part, group, i) << 32) | (unsigned)i;
    });
    K3_CLOCK(kClkRank);
    // the warp in step over the children, sharing slot scans (walk_coop)
    for (int q = 0; q < group; ++q) {
      const u64 key = sh.ckey[q];
      const bool alive = live && !found &&
                         !(__uint_as_float((unsigned)(key >> 32)) >= s.bound());
      if (!__any_sync(kFull, alive)) break;
      const int j = (int)(unsigned)key;
      bool want = alive;
      if (want) {
        float near_t, far_t;
        slab(sh.box + 6 * j, s.ray(), near_t, far_t);
        want = (near_t < far_t) && (far_t > 0.0f) && (near_t < s.bound());
      }
      if (coop_test<false>(s, want, c0 + j, Search::table(c0 + j, in, w), in,
                           w, stage))
        found = true;
    }
    K3_CLOCK(kClkWalk);  // thread 0's own walk; the rest waits in the vote
  }
}

// K3 / K3p: one block per tile, one thread per ray. The super order comes
// sorted from outside (rows of w.snear / w.order), or, kNearOrder, the block
// orders the w.n_cols boxes of w.super_box itself (`tile_order`), exactly as
// K2n orders clusters: w.snear and w.order are not read.
template <class Search, bool kNearOrder>
__device__ __forceinline__ void trace_two_level(const typename Search::In& in,
                                                const Walk& w) {
  extern __shared__ __align__(16) float smem[];  // kNearOrder: keys, stage
  __shared__ float4 s_ray[2 * kMaxTile];
  __shared__ float s_box[6 * kMaxGroup];
  __shared__ unsigned s_part[kMaxTile];
  __shared__ u64 s_ckey[kMaxGroup];
  __shared__ int s_n;
  __shared__ int s_oct[kOctWords];
  // what the search stages of its rays (kNearOrder: in the box stage)
  constexpr int kCoopVecs = kNearOrder ? 0 : Search::kRayVecs * kMaxTile;
  __shared__ float4 s_coop[kCoopVecs ? kCoopVecs : 1];
  const TwoLevelShared sh{RayStage{s_ray, s_oct}, s_box, s_part, s_ckey};
  const long long tile = blockIdx.x;
  const long long ray = tile * blockDim.x + threadIdx.x;
  stage_rays<Search>(sh.rays, in, w, ray);
  // the search's stage is read after the walk's first block barrier
  if constexpr (kNearOrder) {
    u64* s_key = (u64*)smem;
    float* s_stage = (float*)(s_key + key_capacity(w.n_cols));
    auto first_half = [&] {
      K3_CLOCK_START();
      const int n = tile_order<kSuperRows>(w.super_box, w.n_cols, sh.rays,
                                           s_stage, s_key, &s_n);
      K3_CLOCK(kClkOrder);
      return n;
    };
    // a search that stages its rays takes the box stage after the first
    // half; one that stages nothing is made before it
    int n = 0;
    if constexpr (Search::kRayVecs > 0) n = first_half();
    float4* stage = (float4*)s_stage;
    auto s = Search::coop(in, w, ray, stage + Search::kRayVecs * threadIdx.x);
    if constexpr (Search::kRayVecs == 0) n = first_half();
    walk_two_level(s, SharedOrder{s_key, n}, in, w, sh, stage);
    s.store(in, ray);
  } else {
    auto s = Search::coop(in, w, ray, s_coop + Search::kRayVecs * threadIdx.x);
    walk_two_level(s, GlobalOrder{w.snear + tile * w.n_cols,
                                  w.order + tile * w.n_cols, w.n_cols},
                   in, w, sh, s_coop);
    s.store(in, ray);
  }
}

// The kernels of K2n and K3, as many blocks an SM as their search asks
// (Search::kMinBlocks), or as the compiler chooses (0)
template <class Search>
__global__ void __launch_bounds__(kMaxTile)
    trace_near_kernel(typename Search::In in, Walk w, int pipelined) {
  trace_near<Search>(in, w, pipelined);
}
template <class Search>
__global__ void __launch_bounds__(kMaxTile, Search::kMinBlocks)
    trace_near_kernel_min(typename Search::In in, Walk w, int pipelined) {
  trace_near<Search>(in, w, pipelined);
}
template <class Search, bool kNearOrder>
__global__ void __launch_bounds__(kMaxTile)
    trace_two_level_kernel(typename Search::In in, Walk w) {
  trace_two_level<Search, kNearOrder>(in, w);
}
template <class Search, bool kNearOrder>
__global__ void __launch_bounds__(kMaxTile, Search::kMinBlocks)
    trace_two_level_kernel_min(typename Search::In in, Walk w) {
  trace_two_level<Search, kNearOrder>(in, w);
}
// K2n's pipelined walk takes the kernel without a minimum (below)
template <class Search>
auto near_kernel(int pipelined) {
  if constexpr (Search::kMinBlocks > 0)
    if (!pipelined) return trace_near_kernel_min<Search>;
  return trace_near_kernel<Search>;
}
template <class Search, bool kNearOrder>
auto two_level_kernel() {
  if constexpr (Search::kMinBlocks > 0)
    return trace_two_level_kernel_min<Search, kNearOrder>;
  else
    return trace_two_level_kernel<Search, kNearOrder>;
}

// The kernels of K1 / K2p and of K5 / K2pl, in the same two forms. K1
// any-hit and K2p take their search's Search::kMinBlocks (K2p at 64
// registers, 76 bytes spilled, 6-9 % faster on every slice leg than at the
// compiler's 80; K1 any-hit within 2 %), and so does K2pl any-hit
// (Search::kMinBlocksStaged, 2-5 % faster).
// Closest-hit and K2pl's pairs keep the compiler's choice: capped, K2pl's
// pairs spill and lose 7-10 % on bounce legs, and K5 and K2pl closest-hit
// under launch bounds took 72 registers for 63 and lost 3-7 %. K2n's
// pipelined walk takes K2n's kernel without a minimum: capped at 64, its
// pairs spilled 648 bytes and lost 8-38 % (tools/torch_near_legs.py
// --variant, PERF.md §6).
template <class Search>
__global__ void trace_kernel(typename Search::In in, Walk w) {
  trace_outside<Search>(in, w);
}
template <class Search>
__global__ void __launch_bounds__(kMaxTile, Search::kMinBlocks)
    trace_kernel_min(typename Search::In in, Walk w) {
  trace_outside<Search>(in, w);
}
template <class Search>
__global__ void trace_staged_kernel(typename Search::In in, Walk w, int jblk,
                                    int pipelined) {
  trace_staged<Search>(in, w, jblk, pipelined);
}
template <class Search>
__global__ void __launch_bounds__(kMaxTile, Search::kMinBlocksStaged)
    trace_staged_kernel_min(typename Search::In in, Walk w, int jblk,
                            int pipelined) {
  trace_staged<Search>(in, w, jblk, pipelined);
}
template <class Search>
auto outside_kernel() {
  if constexpr (Search::kMinBlocks > 0)
    return trace_kernel_min<Search>;
  else
    return trace_kernel<Search>;
}
template <class Search>
auto staged_kernel() {
  if constexpr (Search::kMinBlocksStaged > 0)
    return trace_staged_kernel_min<Search>;
  else
    return trace_staged_kernel<Search>;
}

// Dynamic shared memory of a launch, beside the kernel's own static bytes:
// refuse above the card's limit, opt in above 48 KB.
template <class Kernel>
int reserve_shared(Kernel kernel, size_t bytes) {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return (int)err;
  const size_t total = bytes + attr.sharedSizeBytes;
  if (total > kMaxSharedBytes) return (int)cudaErrorInvalidValue;
  if (total <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// What K1 / K2p, K5 and K2pl stage of their rays (pairs: PairsStaged)
template <class Search>
size_t ray_stage_bytes(int tile) {
  return (size_t)16 * Search::kRayVecs * tile;
}

// K1 / K2p, or (w.group > 0) K3 / K3p with the super order from outside or
// (w.super_box) made in the kernel
template <class Search>
int launch(const typename Search::In& in, const Walk& w, int n_tiles,
           int tile, void* stream) {
  if (w.group) {
    if (w.group < 1 || w.group > kMaxGroup || w.group > tile ||
        tile % 32 != 0 || tile > kMaxTile)
      return (int)cudaErrorInvalidValue;
    if (w.super_box) {
      if (w.n_cols < 1 || w.n_cols > kMaxNearClusters ||
          (size_t)w.super_box % 16)  // the stage's 16-byte copies
        return (int)cudaErrorInvalidValue;
      const size_t bytes =
          order_bytes(w.n_cols, tile, false, Search::kRayVecs);
      const auto kernel = two_level_kernel<Search, true>();
      const int err = reserve_shared(kernel, bytes);
      if (err) return err;
      if (n_tiles > 0)
        kernel<<<n_tiles, tile, bytes, (cudaStream_t)stream>>>(in, w);
    } else if (n_tiles > 0) {
      two_level_kernel<Search, false>()
          <<<n_tiles, tile, 0, (cudaStream_t)stream>>>(in, w);
    }
  } else {
    // the warps walk in step: whole warps, at most kMaxTile rays
    if (tile % 32 != 0 || tile < 32 || tile > kMaxTile)
      return (int)cudaErrorInvalidValue;
    const size_t bytes = ray_stage_bytes<Search>(tile);
    const auto kernel = outside_kernel<Search>();
    const int err = reserve_shared(kernel, bytes);
    if (err) return err;
    if (n_tiles > 0)
      kernel<<<n_tiles, tile, bytes, (cudaStream_t)stream>>>(in, w);
  }
  return (int)cudaGetLastError();
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
  if (jblk < 1 || jblk > kMaxJblk || tile % 32 != 0 || tile < 32 ||
      tile > kMaxTile)
    return (int)cudaErrorInvalidValue;
  const size_t bytes = ray_stage_bytes<Search>(tile) +
                       staged_bytes<Search>(w, jblk, pipelined != 0);
  const auto kernel = staged_kernel<Search>();
  const int err = reserve_shared(kernel, bytes);
  if (err) return err;
  if (n_tiles > 0)
    kernel<<<n_tiles, tile, bytes, (cudaStream_t)stream>>>(in, w, jblk,
                                                           pipelined);
  return (int)cudaGetLastError();
}

// K2n; w.n_cols is the number of cluster boxes
template <class Search>
int launch_near(const typename Search::In& in, const Walk& w, int n_tiles,
                int tile, int pipelined, void* stream) {
  if (w.n_cols < 1 || w.n_cols > kMaxNearClusters || tile % 32 != 0 ||
      tile < 32 || tile > kMaxTile ||
      (size_t)w.box % 16)  // the stage's 16-byte copies
    return (int)cudaErrorInvalidValue;
  const size_t bytes =
      order_bytes(w.n_cols, tile, true, Search::kRayVecs) +
      (pipelined ? staged_bytes<Search>(w, 1, true) : (size_t)0);
  const auto kernel = near_kernel<Search>(pipelined);
  const int err = reserve_shared(kernel, bytes);
  if (err) return err;
  if (n_tiles > 0)
    kernel<<<n_tiles, tile, bytes, (cudaStream_t)stream>>>(in, w, pipelined);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The ray sort's coherence key (`wrt_top_keys`, `top_keys_kernel`): per ray
// the n (2 or 3) smallest packed keys over the C boxes (the clusters, or the
// supers of two-level tables), exactly `_top_keys_torch` (ops/cluster_cuda.py,
// the body of ops/ray_sort.py `_top_keys`), which is the XLA code of
// webgpu_raytracing_tpu/ops/ray_sort.py `nearest_cluster_key` (:37),
// `nearest_cluster_key_fused` (:143) and `nearest_cluster_keys2` (:183); no
// Pallas kernel. A box's key is its entry distance where the ray's slab test
// admits it (near < far, near < t_max, far > 0; max(near, 0) with -0 made
// +0), F32_MAX where not or, given t_start, where the entry lies below it,
// its low mantissa bits (`kmask`) replaced by the box id. Keys are unique by
// their id bits, so the n smallest kept in registers by insertion are the
// n masked minima of the twin, miss keys and the int32 maximum (fewer than n
// boxes) included.
//
// The twin makes (chunk, C) temporaries and 2-3 passes over them; here one
// thread holds one ray and its n keys, and the block stages the boxes in
// chunks of kKeyChunk, two float4s a box, that the lanes read together. The
// work is R x C slab tests, about 25 f32 operations a ray-box pair
// (ops/cluster_cuda.py BOX_TEST_OPS), so the kernel is bound by instruction
// issue and the shared-memory reads of the boxes, as K2n's first half is.
// Two things keep the pair at the slab test: a box that is not entered has a
// miss key, and every miss key of a box past the first n is above the n keys
// a ray holds once it has taken the first n boxes' keys (each below F32_MAX's
// bits with id < n), so past them only an entered box can insert, and its
// key is made only then.
//
// The chunk (kKeyChunk boxes) is staged eight times, once per sign octant
// of inv_d, each box as its near corner and its far corner (axes sorted, as
// K2n's first half sorts them, so that an inverted pad box tests like the
// box between its swapped corners, as in `slab`), so that a ray reads the
// corners of its own octant and needs no per-axis min and max. The octants'
// copies lie 16 bytes apart in the banks, so the eight addresses of a warp's
// read fall in distinct banks. Measured 3-10 % faster on every slice leg
// than `slab` over one copy of the chunk read as a broadcast (PERF.md §6).
constexpr int kKeyThreads = 256;
constexpr int kKeyChunk = 128;
constexpr int kKeyOctStride = 2 * kKeyChunk + 1;  // float4s an octant's copy
constexpr int kI32Max = 0x7fffffff;

// x into the ascending keys k, given x < k[kN - 1]; constant indices only,
// so that k stays in registers
template <int kN>
__device__ __forceinline__ void key_insert(int (&k)[kN], int x) {
#pragma unroll
  for (int i = kN - 1; i > 0; --i)
    if (x < k[i]) k[i] = x < k[i - 1] ? k[i - 1] : x;
  if (x < k[0]) k[0] = x;
}

template <int kN, bool kTStart>
__global__ void __launch_bounds__(kKeyThreads)
    top_keys_kernel(const float* o, const float* inv_d, const float* t_max,
                    const float* t_start, const float* box, int n_boxes,
                    int kmask, int* keys, long long n_rays) {
  __shared__ float4 s_box[8 * kKeyOctStride];
  const long long ray = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  // the tail block's spare threads take the last ray and join the barriers
  const long long q = ray < n_rays ? ray : n_rays - 1;
  const Ray r{o[3 * q],     o[3 * q + 1],     o[3 * q + 2],
              0.0f,         0.0f,             0.0f,
              inv_d[3 * q], inv_d[3 * q + 1], inv_d[3 * q + 2]};
  const float tm = t_max[q];
  const float ts = kTStart ? t_start[q] : 0.0f;
  int k[kN];
#pragma unroll
  for (int i = 0; i < kN; ++i) k[i] = kI32Max;
  // the first kN boxes, every key (misses too), from the tables
  const int head = min(kN, n_boxes);
  for (int c = 0; c < head; ++c) {
    float near_t, far_t;
    slab(box + 6 * c, r, near_t, far_t);
    float e = __uint_as_float(kF32MaxBits);
    if ((near_t < far_t) && (near_t < tm) && (far_t > 0.0f))
      e = entry_of(near_t);
    if (kTStart && !(e >= ts)) e = __uint_as_float(kF32MaxBits);
    const int key = (__float_as_int(e) & ~kmask) | c;
    if (key < k[kN - 1]) key_insert<kN>(k, key);
  }
  const int oct = (r.ix < 0.0f) | ((r.iy < 0.0f) << 1) | ((r.iz < 0.0f) << 2);
  const float4* sb = s_box + oct * kKeyOctStride;
  for (int base = 0; base < n_boxes; base += kKeyChunk) {
    const int m = min(kKeyChunk, n_boxes - base);
    __syncthreads();  // the last chunk is read
    for (int i = threadIdx.x; i < 8 * m; i += blockDim.x) {
      const int v = i / m, j = i - v * m;
      float bx[6];
      sorted_box(box + 6LL * (base + j), bx);
      const int nx = v & 1 ? 3 : 0, ny = v & 2 ? 4 : 1, nz = v & 4 ? 5 : 2;
      s_box[v * kKeyOctStride + 2 * j] =
          make_float4(bx[nx], bx[ny], bx[nz], 0.0f);
      s_box[v * kKeyOctStride + 2 * j + 1] = make_float4(
          bx[(nx + 3) % 6], bx[(ny + 3) % 6], bx[(nz + 3) % 6], 0.0f);
    }
    __syncthreads();  // the chunk is whole
#pragma unroll 4
    for (int j = max(head - base, 0); j < m; ++j) {
      // the near and the far corner of each axis: the per-axis min and max
      // of `slab`, by the monotonicity of rounding (K2n's `box_pass_ray`)
      const float4 nc = sb[2 * j], fc = sb[2 * j + 1];
      const float near_t =
          max_nan(max_nan((nc.x - r.ox) * r.ix, (nc.y - r.oy) * r.iy),
                  (nc.z - r.oz) * r.iz);
      const float far_t =
          min_nan(min_nan((fc.x - r.ox) * r.ix, (fc.y - r.oy) * r.iy),
                  (fc.z - r.oz) * r.iz);
      // near < far and near < t_max as one compare (a NaN far or t_max
      // fails it, as it fails both)
      if ((near_t < min_nan(far_t, tm)) && (far_t > 0.0f)) {
        const float e = entry_of(near_t);
        if (kTStart && !(e >= ts)) continue;
        const int key = (__float_as_int(e) & ~kmask) | (base + j);
        if (key < k[kN - 1]) key_insert<kN>(k, key);
      }
    }
  }
  if (ray < n_rays) {
#pragma unroll
    for (int i = 0; i < kN; ++i) keys[i * n_rays + ray] = k[i];
  }
}

template <int kN>
int launch_top_keys(const float* o, const float* inv_d, const float* t_max,
                    const float* t_start, const float* box, int n_boxes,
                    int kmask, int* keys, long long n_rays, void* stream) {
  const long long blocks = (n_rays + kKeyThreads - 1) / kKeyThreads;
  if (blocks > 0) {
    if (t_start)
      top_keys_kernel<kN, true>
          <<<(unsigned)blocks, kKeyThreads, 0, (cudaStream_t)stream>>>(
              o, inv_d, t_max, t_start, box, n_boxes, kmask, keys, n_rays);
    else
      top_keys_kernel<kN, false>
          <<<(unsigned)blocks, kKeyThreads, 0, (cudaStream_t)stream>>>(
              o, inv_d, t_max, t_start, box, n_boxes, kmask, keys, n_rays);
  }
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
  if (tile < 1 || tile > 1024 || slots < 1) return (int)cudaErrorInvalidValue;
  const size_t bytes =
      sizeof(float) * 2 * (size_t)(((slots + 3) & ~3) + kK4RowWords * slots);
  const int err = reserve_shared(trace_binned_kernel, bytes);
  if (err) return err;
  if (n_blocks > 0)
    trace_binned_kernel<<<n_blocks, tile, bytes, (cudaStream_t)stream>>>(
        ExactIn{o, d, tri, t_out, code_out},
        Walk{inv_d, t_max, excl, nullptr, nullptr, 0, box, face_id, slots,
             eps2, 0, nullptr, code0, 0, nullptr},
        sched);
  return (int)cudaGetLastError();
}

// The coherence key: n (2 or 3) int32 keys per ray into keys (n, n_rays);
// t_start may be null
extern "C" int wrt_top_keys(const float* o, const float* inv_d,
                            const float* t_max, const float* t_start,
                            const float* box, int n_boxes, int kmask, int n,
                            int* keys, long long n_rays, void* stream) {
  if (n_boxes < 1 || n_rays < 0) return (int)cudaErrorInvalidValue;
  if (n == 2)
    return launch_top_keys<2>(o, inv_d, t_max, t_start, box, n_boxes, kmask,
                              keys, n_rays, stream);
  if (n == 3)
    return launch_top_keys<3>(o, inv_d, t_max, t_start, box, n_boxes, kmask,
                              keys, n_rays, stream);
  return (int)cudaErrorInvalidValue;
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

// K3 / K3p ordering their supers themselves: `super_box` (n_supers, 6) in
// place of snear, order, n_cols
extern "C" int wrt_trace_near_closest_two_level(
    const float* o, const float* d, const float* inv_d, const float* t_max,
    const int* excl, int n_supers, const float* super_box, const float* box,
    const int* face_id, int slots, const float* tri, float eps2, int group,
    float* t_out, int* code_out, int n_tiles, int tile, void* stream) {
  if (group < 1 || !super_box) return (int)cudaErrorInvalidValue;
  return launch<Exact<false>>(
      ExactIn{o, d, tri, t_out, code_out},
      Walk{inv_d, t_max, excl, nullptr, nullptr, n_supers, box, face_id,
           slots, eps2, group, nullptr, nullptr, 0, nullptr, super_box},
      n_tiles, tile, stream);
}

extern "C" int wrt_trace_near_any_two_level(
    const float* o, const float* d, const float* inv_d, const float* t_max,
    const int* excl, int n_supers, const float* super_box, const float* box,
    const int* face_id, int slots, const float* tri, float eps2, int group,
    int* code_out, int n_tiles, int tile, void* stream) {
  if (group < 1 || !super_box) return (int)cudaErrorInvalidValue;
  return launch<Exact<true>>(
      ExactIn{o, d, tri, nullptr, code_out},
      Walk{inv_d, t_max, excl, nullptr, nullptr, n_supers, box, face_id,
           slots, eps2, group, nullptr, nullptr, 0, nullptr, super_box},
      n_tiles, tile, stream);
}

extern "C" int wrt_trace_near_pairs_two_level(
    const float* a, const float* inv_d, const float* t_max, const int* excl,
    int n_supers, const float* super_box, const float* box,
    const int* face_id, int slots, const float* mat_b, float eps2,
    float margin, int group, float* t_out, int* c1_out, int* c2_out,
    int* c3_out, int* amb_out, int n_tiles, int tile, void* stream) {
  if (group < 1 || !super_box) return (int)cudaErrorInvalidValue;
  return launch<Pairs>(
      PairsIn{a, mat_b, margin, t_out, c1_out, c2_out, c3_out, amb_out},
      Walk{inv_d, t_max, excl, nullptr, nullptr, n_supers, box, face_id,
           slots, eps2, group, nullptr, nullptr, 0, nullptr, super_box},
      n_tiles, tile, stream);
}

#ifdef WRT_K3_CLOCKS
// read the sums (order, vote, cull, rank, walk ticks; supers visited) into
// `out` (6 words) and, `reset`, zero them
extern "C" int wrt_k3_clocks(unsigned long long* out, int reset) {
  cudaError_t err = cudaDeviceSynchronize();
  if (err == cudaSuccess)
    err = cudaMemcpyFromSymbol(out, g_k3_clocks, sizeof(u64) * kClkN);
  if (err == cudaSuccess && reset) {
    const u64 zero[kClkN] = {};
    err = cudaMemcpyToSymbol(g_k3_clocks, zero, sizeof(zero));
  }
  return (int)err;
}
#endif

extern "C" const char* wrt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
