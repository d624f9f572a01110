"""PyTorch port: the walks over an order sorted outside the kernel (K1 and
its capped form K1c, K2p, K5, K2pl), whose warps go in step and share
their slot scans, on scattered, bounce-like rays.

The kernels' plain-torch twins run here (CPU tensors); the CUDA kernels are
held against the twins on the card in tests/test_torch_cuda.py. A shared
scan changes which slot tests a kernel runs, never its results, so:

* the closest-hit and any-hit twins return the same outputs bit for bit
  whether they count the shared scans (``coop=True``, what the kernels do)
  or the scans of one thread each (``coop=False``), and every walk returns
  K1's (pairs: K2p's) outputs;
* ``walk_stats(kernel=True)`` counts exactly the sequential scan's slot
  tests for closest-hit and pairs, and at least that many for any-hit,
  whose lanes test slots past the cluster's first valid one.

Against the Pallas kernels under the interpreter the tolerances are
tests/test_torch_sched.py's: hit masks (any-hit: blocked flags) equal,
faces equal on at least 99.5 % of hits (bf16 knife edges), and t, u, v
bit-equal where faces agree."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_sched import _check, _same, fine_tables, scenes  # noqa: F401

from webgpu_raytracing_tpu.config import F32_MAX
from webgpu_raytracing_tpu.ops.cluster_pallas import (
    trace_closest_clustered_pallas,
)
from webgpu_raytracing_tpu_torch.ops import cluster_cuda as cc
from webgpu_raytracing_tpu_torch.ops.cluster_trace import rederive_uv
from webgpu_raytracing_tpu_torch.ops.integrator import face_point_offset

torch.set_num_threads(1)

# walk → (prepare_tiles keywords, the JAX dispatcher's keywords for the
# same kernel); K1c is K1 capped at 2 entries with its stop, then drained
WALKS = {
    "K1": (dict(), dict(pipeline_rounds=False)),
    "K1c": (dict(cap=2, return_stop=True), dict(pipeline_rounds=False)),
    "K5x1": (dict(sched_rounds=1), dict(sched_rounds=1, tiles_per_step=2)),
    "K5x4": (dict(sched_rounds=4), dict(sched_rounds=4, tiles_per_step=2)),
    "K5x8": (dict(sched_rounds=8), dict(sched_rounds=8, tiles_per_step=2)),
    "K2pl": (dict(pipelined=True),
             dict(pipeline_rounds=True, tiles_per_step=1, lockstep=False)),
}
SEARCHES = ("closest", "any", "pairs")
# what K1c and K5 take: the closest-hit search alone
TAKES = {"K1c": ("closest",), "K5x1": ("closest",), "K5x4": ("closest",),
         "K5x8": ("closest",)}
SELECT = {"closest": cc.trace_closest_args, "any": cc.trace_any_args,
          "pairs": cc.trace_pairs_args}


@pytest.fixture(scope="module")
def bounce_rays(scenes, fine_tables):
    """1000 rays leaving random points of random faces (the integrator's
    offset origin, the source face's exclusion code) into the hemisphere
    of the face normal, so that the rays of a tile go apart as on a bounce
    leg; t_max F32_MAX or finite, 10 % inactive, a padded tail."""
    tt = scenes[1]
    assert torch.equal(fine_tables.tri, tt.tri)  # the same faces, S = 8
    rng = np.random.default_rng(61)
    n = 1000
    n_faces = tt.tri.shape[0]
    face = torch.from_numpy(rng.integers(0, n_faces, n))
    uv = rng.uniform(0.05, 0.95, (n, 2)).astype(np.float32)
    uv[:, 1] *= 1.0 - uv[:, 0]
    u, v = torch.from_numpy(uv[:, 0]), torch.from_numpy(uv[:, 1])
    o = face_point_offset(tt.tri[face], tt.shade_normal[face], u, v)
    nrm = tt.shade_normal[face][:, 0:3].numpy()
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d = d + nrm / np.linalg.norm(nrm, axis=1, keepdims=True)
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    tmax = np.where(rng.uniform(size=n) < 0.5, F32_MAX,
                    rng.uniform(0.5, 6.0, n)).astype(np.float32)
    active = rng.uniform(size=n) > 0.1
    excl = tt.clusters.partner_code[face].to(torch.int32)
    return (o.contiguous(), torch.from_numpy(d), torch.from_numpy(tmax),
            torch.from_numpy(active), excl)


def _jax(jt, rays, search, jkw):
    o, d, tmax, active, excl = (x.numpy() for x in rays)
    return trace_closest_clustered_pallas(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmax), jt,
        jnp.asarray(active), tile=128, interpret=True,
        any_hit=search == "any", exact_pairs=search == "pairs",
        excl_code=jnp.asarray(excl), **jkw)


def _walk_outputs(args, search, **kw):
    """The twin's outputs and its stats for a prepare_tiles dict."""
    stats = {}
    out = SELECT[search](args)[1](**args, stats=stats, **kw)
    return out, stats


@pytest.mark.parametrize("walk", sorted(WALKS))
@pytest.mark.parametrize("search", SEARCHES)
def test_outside_walk_shared_scans(scenes, fine_tables, bounce_rays, search,
                                   walk):
    """One search through one walk over the order sorted outside, on the
    bounce-like rays of the port's clusters of 8 (rounds of 8 stay whole):
    the twin's outputs with and without the shared scans' counts, K1's
    (K2p's) outputs, the slot tests the kernel runs, and the faces of the
    dispatcher against the Pallas kernel with the same walk. A walk that
    does not take a search raises."""
    jt, _ = scenes
    kw, jkw = WALKS[walk]
    o, d, tmax, active, excl = bounce_rays
    pairs = search == "pairs"
    if search not in TAKES.get(walk, SEARCHES):
        with pytest.raises(ValueError):
            args = cc.prepare_tiles(o, d, tmax, fine_tables, active, excl,
                                    pairs=pairs, **kw)
            SELECT[search](args)[0](**args)
        return
    args = cc.prepare_tiles(o, d, tmax, fine_tables, active, excl,
                            pairs=pairs, **kw)
    ref = cc.prepare_tiles(o, d, tmax, fine_tables, active, excl,
                           pairs=pairs)
    want, seq = _walk_outputs(ref, search)
    got, stats = _walk_outputs(args, search)
    work = cc.walk_stats(stats, args["face_id"], search == "any", pairs,
                         kernel=True)
    need = cc.walk_stats(stats, args["face_id"], search == "any", pairs)
    if pairs:
        _same(got, want)
        assert "kernel_slot_tests" not in stats
        assert work == need
    else:
        alone, alone_stats = _walk_outputs(args, search, coop=False)
        _same(got, alone)
        assert "kernel_slot_tests" not in alone_stats
        if walk == "K1c":
            n = o.shape[0]
            t, code, stop = (x[:n] for x in got)
            want = tuple(x[:n] for x in want)
            surv = t.view(torch.int32) > stop
            # the cap cut real work, and only survivors changed
            assert bool((code != want[1]).any())
            assert not bool(((code != want[1]) & ~surv).any())
            drained = cc.prepare_tiles(
                o, d, torch.where(surv, t, torch.zeros_like(t)),
                fine_tables, None, excl, t_start=stop.view(torch.float32),
                start_code=code)
            t2, c2 = (x[:n] for x in cc.trace_closest_tiles.twin(**drained))
            got = (torch.where(surv, t2, t), torch.where(surv, c2, code))
        _same(got, want)
        assert work["slot_tests"] >= need["slot_tests"]
        if search == "closest":
            assert work == need
        else:  # lanes test past the first valid slot of a shared scan
            assert stats["kernel_slot_tests"] > stats["slot_tests"]
    if walk in ("K1", "K5x1", "K2pl"):  # K1's (K2p's) counts, bit for bit
        seq_work = cc.walk_stats(seq, ref["face_id"], search == "any", pairs)
        assert need["slot_tests"] == seq_work["slot_tests"]
    n = o.shape[0]
    code = (got if search == "any" else got[1])[:n]
    assert int((code >= 0).sum()) > 50
    # the faces against the Pallas kernel with the same walk
    ref_j = _jax(jt, bounce_rays, search, jkw)
    if search == "any":
        flags = cc.trace_any_clustered_cuda(
            o, d, tmax, fine_tables, active, excl, pipelined=walk == "K2pl")
        np.testing.assert_array_equal(flags.numpy(),
                                      np.asarray(ref_j.face) >= 0)
        return
    face = cc.code_to_face(code, fine_tables.clusters.face_id)
    hit = rederive_uv(o, d, got[0][:n], face, fine_tables)
    if pairs:
        hit = cc.trace_closest_clustered_cuda(
            o, d, tmax, fine_tables, active, excl, exact_pairs=True, **kw)
    _check(jt, o.numpy(), d.numpy(), hit, ref_j)
