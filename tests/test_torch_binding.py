"""PyTorch port: the one binding of the CUDA kernels (``ops/_build.py``
``Kernel``, ``check_args``, ``launch``), case by case over every kernel
entry: camera rays, both shading steps, a trace wrapper of each launcher
(the exact search, pairs, K3 ordering its supers, K4), the ray sort's
key, rederive and both steps of a light sample.

* On CPU tensors an entry is its plain twin: the twin's bits, no launch
  counted.
* A ``meta`` tensor raises the kernel's own "no ... kernel" message.
* The launch refuses a wrong dtype or shape with the argument's name, and
  CPU tensors that pass the checks, before it loads the library."""

import numpy as np
import pytest
import torch
from test_torch_shade import _lanes, _tables

from webgpu_raytracing_tpu_torch.camera import Camera
from webgpu_raytracing_tpu_torch.config import F32_MAX, RenderSettings
from webgpu_raytracing_tpu_torch.config import ShadingType
from webgpu_raytracing_tpu_torch.models import test_models as tm
from webgpu_raytracing_tpu_torch.models.scene import scene_from_facesets
from webgpu_raytracing_tpu_torch.ops import cluster_cuda as cc
from webgpu_raytracing_tpu_torch.ops import integrator as ti
from webgpu_raytracing_tpu_torch.ops import rng
from webgpu_raytracing_tpu_torch.ops.intersect import safe_inv_dir
from webgpu_raytracing_tpu_torch.ops.raygen import camera_rays

torch.set_num_threads(1)


def _scene():
    return scene_from_facesets(
        [
            ("light", tm.uv_sphere((0, 3, -4), 0.5, material_idx=1, lat=4,
                                   lon=6)),
            ("sphere", tm.uv_sphere((0, 0, -4), 1.0, lat=10, lon=14)),
            ("plane", tm.ground_plane(-1.5, 8.0)),
            ("cube", tm.unit_cube_model()),
        ],
        np.array([[0.8, 0.4, 0.3], [0, 0, 0]], np.float32),
        np.array([[0, 0, 0], [6, 6, 6]], np.float32),
    )


def _rays(r=256, seed=4):
    g = np.random.default_rng(seed)
    o = torch.from_numpy(g.uniform(-2, 2, (r, 3)).astype(np.float32))
    d = torch.from_numpy(g.normal(size=(r, 3)).astype(np.float32))
    return o, d / d.norm(dim=1, keepdim=True), torch.full((r,), F32_MAX)


def _camera(projection):
    w, h = 12, 10
    g = np.random.default_rng(20 + projection)
    pos = torch.from_numpy(
        g.uniform(0, 1, (h * w, 2)).astype(np.float32)
        + np.stack(np.meshgrid(np.arange(w), np.arange(h)), -1).reshape(
            -1, 2).astype(np.float32))
    st = RenderSettings(width=w, height=h, projection_type=projection,
                        lens_shape=projection % 2, circle_of_confusion=0.05,
                        fov_orientation=2)
    cam = Camera()
    cam.rotate(np.array([0.2, -0.4], np.float32))
    cam.move(np.array([0.3, -0.1, 0.2], np.float32))
    kw = dict(pos=pos, view=torch.from_numpy(cam.view_matrix()),
              state=rng.seed_state(2**32 - 77, torch.arange(w * h)),
              settings=st)
    return camera_rays, kw, [("state", kw["state"].int()),
                             ("view", kw["view"][:3])]


def _shade(step):
    gen = np.random.default_rng(11)
    tables = _tables(gen, True)
    x = _lanes(gen, 100, tables.tri.shape[0])
    if step == "hit":
        kw = dict(hit=x["hit"], alive=x["alive"], d=x["d"], color=x["color"],
                  throughput=x["throughput"], env_dir=x["env_dir"],
                  env_w=x["env_w"], env_mis_pdf=x["env_mis_pdf"],
                  prev_bsdf_pdf=x["prev_bsdf_pdf"], tables=tables,
                  shading=ShadingType.PHONG, env_mis=True)
        return ti.shade_hit, kw, [("alive", x["alive"].to(torch.uint8)),
                                  ("throughput", x["throughput"][:-1])]
    kw = dict(state=x["state"], h=x["alive"], n=x["d"], new_o=x["o"],
              throughput=x["throughput"], o=x["o"], d=x["d"],
              prev_bsdf_pdf=x["prev_bsdf_pdf"], env_is=True, run_env=True)
    return ti.shade_bounce, kw, [("state", x["state"].to(torch.int32)),
                                 ("n", x["d"][:, :2])]


def _trace(kind):
    o, d, tm_ = _rays()
    scene = _scene()
    tables = scene.tables("cpu", cluster_size=16)
    if kind == "closest":
        args = cc.prepare_tiles(o, d, tm_, tables)
        return cc.trace_closest_tiles, args, [
            ("excl", args["excl"].long()), ("d", args["d"][:, :2])]
    if kind == "pairs":
        args = cc.prepare_tiles(o, d, tm_, tables, pairs=True)
        return cc.trace_pairs_tiles, args, [
            ("excl", args["excl"].long()), ("mat_b", args["mat_b"][:, :9])]
    if kind == "near_two_level":
        two = scene.tables("cpu", cluster_size=16, group_size=4)
        args = cc.prepare_tiles(o, d, tm_, two, near="kernel")
        assert args.variant == "near_two_level"
        return cc.trace_near_closest_two_level_tiles, args, [
            ("super_box", args["super_box"].double()),
            ("tri", args["tri"][:, :8])]
    if kind == "binned":
        sched = torch.tensor([[0, 3], [5, -1]], dtype=torch.int32)
        args = cc.binned_args(o, d, tm_, tables, sched)
        return cc.trace_binned_tiles, args, [
            ("sched", sched.long()), ("sched", sched[:1])]
    args = dict(o=o, inv_d=safe_inv_dir(d), t_max=tm_,
                boxes=tables.clusters.sort_box, n=3)
    return cc.top_keys_tiles, args, [
        ("boxes", args["boxes"].double()), ("t_max", tm_[:-1])]


def _rederive(_):
    o, d, tm_ = _rays()
    tables = _scene().tables("cpu", cluster_size=16)
    face = torch.from_numpy(np.random.default_rng(6).integers(
        -1, tables.tri.shape[0], o.shape[0]).astype(np.int32))
    kw = dict(o=o, d=d, t=tm_, face=face, tables=tables)
    return cc.rederive_uv, kw, [("face", face.long()), ("o", o[:, :2])]


def _light(step):
    from test_torch_light import light_lanes, light_tables

    gen = np.random.default_rng(12)
    tables = light_tables(gen, (0, 20))
    point, normal, state, shadowed = light_lanes(gen, 100, tables,
                                                 ShadingType.PHONG)
    if step == "sample":
        kw = dict(point=point, state=state, tables=tables)
        return ti.light_sample, kw, [("state", state.to(torch.int32)),
                                     ("point", point[:, :2])]
    ray = ti.light_sample.twin(point, state, tables)
    kw = dict(shadowed=shadowed, d=ray.d, normal=normal, carry=ray.carry,
              color=torch.ones_like(ray.d), tables=tables, spp=2, last=True)
    return ti.light_add, kw, [("shadowed", shadowed.to(torch.uint8)),
                              ("carry", ray.carry.t())]


CASES = {
    **{f"camera_rays_{p}": (_camera, p) for p in range(4)},
    "shade_hit": (_shade, "hit"),
    "shade_bounce": (_shade, "bounce"),
    "trace_closest_tiles": (_trace, "closest"),
    "trace_pairs_tiles": (_trace, "pairs"),
    "trace_near_closest_two_level_tiles": (_trace, "near_two_level"),
    "trace_binned_tiles": (_trace, "binned"),
    "top_keys_tiles": (_trace, "keys"),
    "rederive_uv": (_rederive, None),
    "light_sample": (_light, "sample"),
    "light_add": (_light, "add"),
}


def _same_bits(got, want):
    if isinstance(want, tuple):
        assert type(got) is type(want) and len(got) == len(want)
        for g, w in zip(got, want):
            _same_bits(g, w)
    elif want is None:
        assert got is None
    else:
        assert got.dtype == want.dtype and got.shape == want.shape
        if want.dtype == torch.float32:
            got, want = got.view(torch.int32), want.view(torch.int32)
        assert torch.equal(got, want)


def _to_meta(x):
    if isinstance(x, torch.Tensor):
        return x.to("meta")
    if isinstance(x, tuple) and all(isinstance(v, torch.Tensor) for v in x):
        return type(x)(*(v.to("meta") for v in x))
    return x


@pytest.mark.parametrize("case", list(CASES))
def test_kernel_binding_dispatches_and_checks_on_cpu(case):
    make, which = CASES[case]
    kernel, kw, bad = make(which)
    label = kernel.label
    before = kernel.launches
    _same_bits(kernel(**kw), kernel.twin(**kw))
    assert kernel.launches == before

    with pytest.raises(ValueError, match=f"no {label} kernel for device "
                                         "meta"):
        kernel(**{k: _to_meta(v) for k, v in kw.items()})
    for name, value in bad:
        with pytest.raises(ValueError, match=f"{label} kernel: {name} must"):
            kernel.launch(**{**kw, name: value})
    with pytest.raises(ValueError, match="CUDA tensors, not cpu"):
        kernel.launch(**kw)
    assert kernel.launches == before
