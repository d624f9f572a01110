"""PyTorch port: the warp-shared any-hit and pairs slot scans of K2n's and
K3's walks, and the pairs slot test that computes only what its outputs
need (csrc/cluster_trace.cu ``coop_test``, ``PairsBest``, ``pairs_scan``).

The kernels cannot run here, so numpy models of them, step for step, are
held to the scan of one thread (the twins' contract):

* any-hit: lane l of a warp scans the slots l, l + 32, ... of the source
  lane's ray and stops at its first valid slot; one warp reduction takes
  the lowest code, unsigned (-1, none, is the largest);
* pairs: each lane keeps a top two of margin-valid (t, code) pairs and a
  robust minimum of its own slots from the sentinel (t_max, -1), skipping
  a slot that is below neither (t2, c2) nor (t3, c3); a butterfly merges
  the lanes' sets (skipped when no lane has a candidate), and the result
  merges once into the carried pairs;
* the pairs slot test: every estimate and magnitude computed for every
  slot past the det cull (the twin's expression order, f32 step by step)
  against the kernel's order, which takes a gate's magnitudes only when
  its estimate lies outside the exact triangle, t_num and the divide only
  past every gate, and the robust test only where the slot can still
  enter (t3, c3); on random estimates, on estimates in the margin band and
  on the boundaries u = 0, u = det, u + v = det and det = eps2.

The twins' count of the shared any-hit scans' slot tests
(``cluster_cuda._lane_tests``, ``_shared_scans``) is held to the same lane
model."""

import numpy as np
import pytest
import torch

from webgpu_raytracing_tpu_torch.ops import cluster_cuda as cc
from webgpu_raytracing_tpu_torch.ops.cluster_trace import EPS2

torch.set_num_threads(1)

F = np.float32
MARGIN = F(cc.MARGIN)
EPS = F(EPS2)
F32_MAX = F(np.finfo(np.float32).max)
SLOT_COUNTS = [5, 32, 100, 128]


def _lex(t, c, tb, cb):
    return bool(t < tb or (t == tb and c < cb))


# --- (a) any-hit -------------------------------------------------------------


def _any_scan(fid, t, code, ex, t_max, first=0, stride=1):
    """``Exact<true>::scan``: the slots first, first + stride, ... in
    order; occupied slots come first; the exclusion code is skipped; the
    first slot with 0 < t < t_max ends the scan with its code."""
    for s in range(first, len(fid), stride):
        if fid[s] < 0:
            break
        if code[s] == ex:
            continue
        if t[s] > 0 and t[s] < t_max:  # NaN fails both
            return int(code[s])
    return -1


def _any_shared(fid, t, code, ex, t_max):
    """``coop_test`` for any-hit: 32 strided lane scans, then
    ``__reduce_min_sync`` on the codes as unsigned."""
    lanes = [np.uint32(_any_scan(fid, t, code, ex, t_max, lane, 32)
                       & 0xFFFFFFFF) for lane in range(32)]
    low = min(lanes)
    return -1 if low == np.uint32(0xFFFFFFFF) else int(low)


def _cluster(rng, slots, trial):
    """A cluster's occupied prefix, slot t values (equal ones, t_max
    itself, above it, NaN, 0 and negative among them), codes and an
    exclusion code that is one of its slots in a third of the trials."""
    n_occ = slots if trial % 4 == 0 else int(rng.integers(1, slots + 1))
    fid = np.where(np.arange(slots) < n_occ, 1, -1)
    t_max = F(2.0) if trial % 2 else F32_MAX
    above = F(3.0) if trial % 2 else F(np.inf)
    t = rng.choice(np.array([0.5, 1.0, 1.0, 1.5, t_max, above, np.nan, 0.0,
                             -1.0], F), slots)
    code = 9 * slots + np.arange(slots)
    ex = int(code[rng.integers(0, slots)]) if trial % 3 == 0 else -1
    return fid, t, code, ex, t_max


@pytest.mark.parametrize("slots", SLOT_COUNTS)
def test_shared_anyhit_scan_model_equals_sequential(slots):
    """The warp's strided scans and a minimum of codes return the
    sequential scan's first valid slot: with equal t on several slots,
    t == t_max, t above t_max, NaN t, the exclusion code inside the
    cluster, empty tail slots and clusters with no valid slot."""
    rng = np.random.default_rng(slots)
    found = 0
    for trial in range(60):
        fid, t, code, ex, t_max = _cluster(rng, slots, trial)
        if trial % 5 == 1:  # no valid slot at all
            t = np.where(rng.uniform(size=slots) < 0.5, t_max, F(np.nan))
        want = _any_scan(fid, t, code, ex, t_max)
        assert _any_shared(fid, t, code, ex, t_max) == want
        found += want >= 0
    assert 10 < found < 60


# --- (b) pairs ---------------------------------------------------------------


class _Best:
    """``PairsBest``: (t1, c1) <= (t2, c2), the two smallest margin-valid
    pairs, and (t3, c3), the smallest robust pair, from (t_max, -1)."""

    def __init__(self, t_max):
        self.t1 = self.t2 = self.t3 = F(t_max)
        self.c1 = self.c2 = self.c3 = -1

    def state(self):
        return (self.t1, self.c1, self.t2, self.c2, self.t3, self.c3)

    def insert(self, t, c, robust):
        """The sequential scan's merge: ``_round_pick`` on exact pairs."""
        if _lex(t, c, self.t1, self.c1):
            self.t2, self.c2, self.t1, self.c1 = self.t1, self.c1, t, c
        elif _lex(t, c, self.t2, self.c2):
            self.t2, self.c2 = t, c
        if robust and _lex(t, c, self.t3, self.c3):
            self.t3, self.c3 = t, c

    def insert_kernel(self, t, c, robust_of):
        """``pairs_scan``'s merge: a slot below neither (t2, c2) nor
        (t3, c3) changes nothing and is not tested for robustness
        (``robust_of`` is not called)."""
        in2 = _lex(t, c, self.t2, self.c2)
        in3 = _lex(t, c, self.t3, self.c3)
        if in2:  # take2
            if _lex(t, c, self.t1, self.c1):
                self.t2, self.c2, self.t1, self.c1 = self.t1, self.c1, t, c
            else:
                self.t2, self.c2 = t, c
        if in3 and robust_of():
            self.t3, self.c3 = t, c

    def merge(self, u1, d1, u2, d2, u3, d3):
        """``PairsBest::merge``: another set's top two and robust pair."""
        if _lex(u1, d1, self.t1, self.c1):
            if _lex(u2, d2, self.t1, self.c1):
                self.t2, self.c2 = u2, d2
            else:
                self.t2, self.c2 = self.t1, self.c1
            self.t1, self.c1 = u1, d1
        elif _lex(u1, d1, self.t2, self.c2):
            self.t2, self.c2 = u1, d1
        if _lex(u3, d3, self.t3, self.c3):
            self.t3, self.c3 = u3, d3

    def amb(self):
        gap = (int(np.array(self.t2, F).view(np.int32))
               - int(np.array(self.t1, F).view(np.int32)))
        return int(self.c3 != self.c1 or (self.c2 >= 0 and gap < cc.AMB_BAND))


def _pairs_scan(best, fid, t, code, valid, robust, ex, kernel, first=0,
                stride=1):
    """A scan over the slots first, first + stride, ...: ``valid`` is the
    margin gates, ``robust`` the robust test; t > 0 is the scan's own."""
    for s in range(first, len(fid), stride):
        if fid[s] < 0:
            break
        if code[s] == ex or not valid[s] or not t[s] > 0:
            continue
        if kernel:
            best.insert_kernel(t[s], int(code[s]), lambda: bool(robust[s]))
        else:
            best.insert(t[s], int(code[s]), bool(robust[s]))


def _pairs_shared(carried, t_max, fid, t, code, valid, robust, ex):
    """``coop_test`` for pairs: lanes from the sentinel, a butterfly of
    ``merge`` (not run when no lane has a candidate), one merge into the
    carried pairs."""
    lanes = []
    for lane in range(32):
        q = _Best(t_max)
        _pairs_scan(q, fid, t, code, valid, robust, ex, True, lane, 32)
        lanes.append(q)
    if any(q.c1 >= 0 for q in lanes):
        off = 16
        while off >= 1:
            before = [q.state() for q in lanes]
            for lane, q in enumerate(lanes):
                q.merge(*before[lane ^ off])
            off >>= 1
        assert len({q.state() for q in lanes}) == 1
        carried.merge(*lanes[0].state())
    else:
        assert all(q.c3 < 0 for q in lanes)


@pytest.mark.parametrize("slots", SLOT_COUNTS)
@pytest.mark.parametrize("carried", ["sentinel", "lower_codes",
                                     "higher_codes"])
def test_shared_pairs_merge_model_equals_sequential(slots, carried):
    """Per-lane top two and robust minimum, the butterfly and one merge
    into the carried pairs give the sequential scan's (t1, c1), (t2, c2),
    (t3, c3) and flag: with equal t on several slots, carried pairs at a
    t some slot has (from a cluster of lower or of higher codes), t ==
    t_max, t above t_max, NaN t, the exclusion code inside the cluster,
    empty tail slots and clusters with no valid slot."""
    rng = np.random.default_rng(100 * slots + len(carried))
    entered = 0
    for trial in range(60):
        fid, t, code, ex, t_max = _cluster(rng, slots, trial)
        valid = rng.uniform(size=slots) < (0.0 if trial % 7 == 3 else 0.4)
        robust = valid & (rng.uniform(size=slots) < 0.6)
        seq = _Best(t_max)
        if carried != "sentinel":  # a cluster walked before this one
            prev = code + (-slots * 5 if carried == "lower_codes" else
                           slots * 5)
            pv = rng.uniform(size=slots) < 0.3
            _pairs_scan(seq, fid, t, prev, pv, pv & (rng.uniform(
                size=slots) < 0.5), -1, False)
        shared = _Best(t_max)
        shared.t1, shared.c1, shared.t2, shared.c2, shared.t3, shared.c3 = (
            seq.state())
        kern = _Best(t_max)
        kern.t1, kern.c1, kern.t2, kern.c2, kern.t3, kern.c3 = seq.state()
        _pairs_scan(seq, fid, t, code, valid, robust, ex, False)
        _pairs_scan(kern, fid, t, code, valid, robust, ex, True)
        _pairs_shared(shared, t_max, fid, t, code, valid, robust, ex)
        want = seq.state() + (seq.amb(),)
        assert kern.state() + (kern.amb(),) == want
        assert shared.state() + (shared.amb(),) == want
        entered += seq.c1 >= 0
    assert entered > 10


# --- (c) the pairs slot test -------------------------------------------------


def _estimates(a, b):
    """det, t_num, u, v and the four magnitudes, f32 step by step in
    PAIRS_ROWS order: b holds a slot's 19 terms."""
    def dot(rows, terms, mag=False):
        x = None
        for r, k in zip(rows, terms):
            p = (np.abs(a[r]) * np.abs(b[k])) if mag else a[r] * b[k]
            x = p if x is None else F(x + p)
        return F(x)

    rows = {"det": ((6, 7, 8), (0, 1, 2)), "tn": ((0, 1, 2, 9), (3, 4, 5, 6)),
            "u": ((3, 4, 5, 6, 7, 8), range(7, 13)),
            "v": ((3, 4, 5, 6, 7, 8), range(13, 19))}
    est = {k: dot(*r) for k, r in rows.items()}
    mag = {k: F(dot(*r, mag=True) * MARGIN) for k, r in rows.items()}
    return est, mag


def _slot_full(a, b):
    """The twin's slot test: every estimate and magnitude → (past the
    cull, valid, robust, t)."""
    e, m = _estimates(a, b)
    det, tn, u, v = e["det"], e["tn"], e["u"], e["v"]
    m_d, m_t, m_u, m_v = m["det"], m["tn"], m["u"], m["v"]
    past = bool(det >= EPS)
    uv = F(u + v)
    t = F(tn / det)
    valid = past and bool(
        u >= -m_u and u <= F(det + m_u) and v >= -m_v
        and uv <= F(F(det + m_u) + m_v) and t > 0)
    robust = valid and bool(
        det >= F(EPS + m_d) and u >= m_u and u <= F(det - m_u) and v >= m_v
        and uv <= F(F(det - m_u) - m_v) and tn >= m_t)
    return past, valid, robust, t


def _slot_kernel(a, b, best, code):
    """``pairs_scan``'s order for one slot, merged into ``best`` → the
    steps it took (to count them) and whether it was valid."""
    e, m = _estimates(a, b)  # each value is read only where the step is
    det, u = e["det"], e["u"]
    steps = []
    if not det >= EPS:
        return steps, False
    m_u = m_v = None
    if not (u >= 0 and u <= det):
        m_u = m["u"]
        steps.append("margined_u")
        if not (u >= -m_u and u <= F(det + m_u)):
            return steps, False
    v = e["v"]
    steps.append("u_pass")
    if not v >= 0:
        m_v = m["v"]
        steps.append("margined_v")
        if not v >= -m_v:
            return steps, False
    steps.append("v_pass")
    uv = F(u + v)
    if not uv <= det:
        m_u, m_v = m["u"], m["v"]
        steps.append("margined_uv")
        if not uv <= F(F(det + m_u) + m_v):
            return steps, False
    steps.append("gate_pass")
    tn = e["tn"]
    t = F(tn / det)
    if not t > 0:
        return steps, False

    def robust():
        steps.append("robust_test")
        mu, mv, m_d, m_t = m["u"], m["v"], m["det"], m["tn"]
        return bool(det >= F(EPS + m_d) and u >= mu and u <= F(det - mu)
                    and v >= mv and uv <= F(F(det - mu) - mv) and tn >= m_t)

    best.insert_kernel(t, code, robust)
    return steps, True


def _rows(rng, n, kind):
    """n slots' (a row of A, the 19 terms of B) of one ``kind``."""
    out = []
    for _ in range(n):
        a = rng.normal(size=10).astype(F)
        b = rng.normal(size=19).astype(F)
        if kind == "band":  # u and v cancel to within their margins
            for lo in (7, 13):
                part = F(0)
                for r, k in zip(range(3, 8), range(lo, lo + 5)):
                    part = F(part + a[r] * b[k])
                b[lo + 5] = F(-part / a[8]) * F(1 + rng.uniform(-1e-6, 1e-6))
            b[3:7] = np.abs(b[3:7]) * np.sign(a[[0, 1, 2, 9]])
        elif kind == "boundary":  # small integers: the sums are exact
            a = rng.integers(-3, 4, 10).astype(F)
            a[8] = F(1)
            b = rng.integers(-4, 5, 19).astype(F)
            det = F(F(a[6] * b[0] + a[7] * b[1]) + a[8] * b[2])
            if det < EPS:
                b[2] = F(b[2] - det + 3)
                det = F(F(a[6] * b[0] + a[7] * b[1]) + a[8] * b[2])
            pick = rng.integers(0, 4)
            u_part = F(0)
            for r, k in zip(range(3, 8), range(7, 12)):
                u_part = F(u_part + a[r] * b[k])
            if pick == 0:  # u = 0
                b[7:13] = F(0)
            elif pick == 1:  # u = det
                b[12] = F(det - u_part)
            u = F(0)
            for r, k in zip(range(3, 9), range(7, 13)):
                u = F(u + a[r] * b[k])
            if pick in (2, 1):  # u + v = det
                v_part = F(0)
                for r, k in zip(range(3, 8), range(13, 18)):
                    v_part = F(v_part + a[r] * b[k])
                b[18] = F(F(det - u) - v_part)
            if pick == 3:  # det = eps2
                a[6:8] = F(0)
                b[2] = EPS
        out.append((a, b))
    return out


@pytest.mark.parametrize("kind", ["random", "band", "boundary"])
def test_pairs_slot_test_skips_only_what_its_outputs_do_not_need(kind):
    """The kernel's order of the pairs slot test gives every slot the full
    test's validity and the scan the full test's (t1, c1, c2, c3, amb),
    from the sentinel and from carried pairs; the twin's count of the
    steps (``_count_pairs_work``) is the steps the model took."""
    rng = np.random.default_rng(["random", "band", "boundary"].index(kind))
    n_valid = n_robust = 0
    counted = {}
    steps_taken = {}
    with np.errstate(all="ignore"):
        for trial in range(40):
            slots = SLOT_COUNTS[trial % 4]
            rows = _rows(rng, slots, kind)
            full = [_slot_full(a, b) for a, b in rows]
            t_max = F32_MAX if trial % 2 else F(rng.uniform(1.0, 5.0))
            seq, kern = _Best(t_max), _Best(t_max)
            if trial % 3 == 1:  # carried pairs below some of this cluster's
                ts = sorted(f[3] for f in full if f[1] and 0 < f[3] < t_max)
                if ts:
                    for x in (seq, kern):
                        x.t1, x.c1 = ts[len(ts) // 2], 3
                        x.t2, x.c2 = ts[-1], 4
                        x.t3, x.c3 = ts[-1], 4
            for s, ((a, b), (past, valid, robust, t)) in enumerate(
                    zip(rows, full)):
                code = 1000 + s
                if valid and t < t_max:
                    seq.insert(t, code, robust)
                    n_valid += 1
                    n_robust += robust
                steps, k_valid = _slot_kernel(a, b, kern, code)
                assert k_valid == valid
                for step in steps:
                    steps_taken[step] = steps_taken.get(step, 0) + 1
            assert kern.state() + (kern.amb(),) == seq.state() + (seq.amb(),)
            # the twin's counts of the same slots, from the same sentinel
            a_t = torch.from_numpy(np.stack([a for a, _ in rows]))
            b_t = torch.from_numpy(np.stack([b for _, b in rows]))
            _count_like_twin(a_t, b_t, counted)
    assert n_valid > 0 and (kind != "random" or n_robust > 0)
    for key in ("margined_u", "u_pass", "margined_v", "v_pass",
                "margined_uv", "gate_pass"):
        assert counted.get(f"pairs_{key}", 0) == steps_taken.get(key, 0), key


def _count_like_twin(a, b, counted):
    """``_count_pairs_work`` on the estimates ``_test_clusters_pairs``
    computes for these slots (one ray per slot)."""
    est, mag = [], []
    j = 0
    for rows in cc.PAIRS_ROWS:
        e = m = None
        for row in rows:
            pe = a[:, row] * b[:, j]
            pm = a[:, row].abs() * b[:, j].abs()
            e = pe if e is None else e + pe
            m = pm if m is None else m + pm
            j += 1
        est.append(e)
        mag.append(m)
    det, t_num, u, v = est
    _, _, m_u, m_v = (x * cc.MARGIN for x in mag)
    past = det >= EPS2
    uv = u + v
    valid = (past & (u >= -m_u) & (u <= det + m_u) & (v >= -m_v)
             & (uv <= (det + m_u) + m_v) & (t_num / det > 0.0))
    cc._count_pairs_work(counted, past, det, u, v, uv, m_u, m_v, valid,
                         torch.zeros_like(valid))


# --- (d) the twins' count of the shared any-hit scans -------------------------


@pytest.mark.parametrize("slots", SLOT_COUNTS)
def test_lane_tests_count_the_shared_anyhit_scan(slots):
    """``_lane_tests`` marks the slots the 32 strided lane scans test (a
    lane stops after its first valid slot), and ``_shared_scans`` picks
    the warps below the serial threshold."""
    rng = np.random.default_rng(7 * slots)
    m = 50
    ok = rng.uniform(size=(m, slots)) < 0.05
    present = rng.uniform(size=(m, slots)) < 0.9
    ok &= present
    got = cc._lane_tests(torch.from_numpy(ok), torch.from_numpy(present),
                         torch.arange(slots, dtype=torch.int32)).numpy()
    for i in range(m):
        want = np.zeros(slots, bool)
        for lane in range(32):
            for s in range(lane, slots, 32):
                want[s] = present[i, s]
                if ok[i, s]:
                    break
        np.testing.assert_array_equal(got[i], want)
        first = np.flatnonzero(ok[i])
        seq = present[i] & (np.arange(slots) <= (first[0] if first.size
                                                  else slots))
        assert (got[i] >= seq).all()  # the shared scan tests a superset
    rays = torch.tensor([0, 1, 2, 33, 64, 65] + list(range(96, 96 + 30)))
    shared = cc._shared_scans(rays, 24).tolist()
    assert shared == [True] * 6 + [False] * 30
