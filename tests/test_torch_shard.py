"""PyTorch port: row-sharded rendering (parallel/shard.py) against the
single-device frame, bit for bit (tests/test_render.py:153-245 on the
port).

The shards are devices of one process; here they are the CPU, two or four
times over, which runs the same code as a list of CUDA devices would, but
for ``torch.cuda.device``. Two cases: a plain frame, and three frames with
reprojection every 2nd frame, jitter 0.5, the hit predictor and a moving
camera, where ``prev_image`` must match too. And the JAX module's two
refusals."""

import numpy as np
import pytest
import torch

from webgpu_raytracing_tpu_torch.camera import Camera
from webgpu_raytracing_tpu_torch.config import RenderSettings as TSettings
from webgpu_raytracing_tpu_torch.models import test_models as tm
from webgpu_raytracing_tpu_torch.models.scene import scene_from_facesets
from webgpu_raytracing_tpu_torch.ops.reproject import reprojection_frustum
from webgpu_raytracing_tpu_torch.parallel.shard import (
    make_mesh,
    render_sharded,
    sharded_render_frame,
)
from webgpu_raytracing_tpu_torch.renderer import (
    FrameBuffers,
    FrameInputs,
    render_frame,
)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def tables():
    return scene_from_facesets(
        [
            ("light", tm.uv_sphere((0, 3, -4), 0.5, material_idx=1, lat=4,
                                   lon=6)),
            ("sphere", tm.uv_sphere((0, 0, -4), 1.0, lat=6, lon=8)),
            ("plane", tm.ground_plane(-1.5, 8.0)),
        ],
        np.array([[0.8, 0.4, 0.3], [0, 0, 0]], np.float32),
        np.array([[0, 0, 0], [6, 6, 6]], np.float32),
    ).tables("cpu")


ENV = np.zeros((1, 1, 3), np.float32)


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_matches_single_device(tables, n):
    st = TSettings(width=16, height=16, bounces_depth=3, sample_count=1,
                   next_event_estimation=True)
    single, rays = render_frame(
        FrameBuffers.create(16, 16, "cpu"), tables, torch.as_tensor(ENV),
        FrameInputs.simple(np.eye(4), 1, 0, "cpu"), st)
    sharded, s_rays = render_sharded(tables, ENV, st, n_frames=1,
                                     mesh=["cpu"] * n)
    for k in ("image", "geo_face", "geo_position", "geo_object"):
        a, b = getattr(single, k).numpy(), getattr(sharded, k).numpy()
        np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32),
                                      err_msg=k)
    assert s_rays == float(rays) > 0


def test_sharded_reprojection_matches_single_device(tables):
    """Reprojection, jitter and the quad predictor read the whole prev
    buffers with global pixel coordinates: three frames over 2 shards, the
    camera moving between frames, equal the single-device run across the
    updatePrev rotations."""
    st = TSettings(width=16, height=16, sample_count=1, bounces_depth=3,
                   reprojection_rate=2, jitter_strength=0.5,
                   use_hit_predictor=True)
    cam = Camera()
    views, prev = [], np.eye(4, dtype=np.float32)
    for k in range(3):
        views.append((cam.view_matrix(), prev))
        if k % st.reprojection_rate == 0:  # updatePrev fires
            prev = cam.view_matrix()
        cam.move(np.array([0.05, 0.0, -0.1], np.float32))

    def mk_inputs(k):
        view, prev_view = views[k]
        return FrameInputs(
            view=torch.as_tensor(np.asarray(view, np.float32)),
            seed=(7 + k * 2654435761) % (2**32),
            counter=k,
            jitter=torch.tensor([0.21, -0.34]),
            frustum=torch.as_tensor(reprojection_frustum(
                prev_view, st.width, st.height, st.fov)),
            prev_origin=torch.as_tensor(
                np.asarray(prev_view[:3, 3], np.float32)),
        )

    bufs = FrameBuffers.create(st.width, st.height, "cpu")
    env = torch.as_tensor(ENV)
    frame_counter = 0
    for k in range(3):
        update_prev = frame_counter % st.reprojection_rate == 0
        frame_counter = (frame_counter + 1) % st.reprojection_rate
        bufs, _ = render_frame(bufs, tables, env, mk_inputs(k), st)
        if update_prev:
            bufs = bufs.rotated()
    sharded, rays = render_sharded(tables, ENV, st, n_frames=3,
                                   mesh=["cpu", "cpu"], inputs_fn=mk_inputs)
    for k in ("image", "prev_image", "geo_face", "prev_geo_face"):
        a, b = getattr(bufs, k).numpy(), getattr(sharded, k).numpy()
        np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32),
                                      err_msg=k)
    assert rays > 0
    assert float(sharded.prev_image[..., 3].sum()) > 0  # rotated


def test_sharded_refusals():
    """The JAX module's two ValueErrors, and a mesh of cards that are not
    there."""
    with pytest.raises(ValueError, match="geometry_buffer_scale"):
        sharded_render_frame(["cpu", "cpu"], TSettings(
            width=16, height=16, geometry_buffer_scale=0.5))
    with pytest.raises(ValueError, match="divide evenly"):
        sharded_render_frame(["cpu"] * 4, TSettings(width=16, height=18))
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="CUDA devices"):
            make_mesh()
    with pytest.raises(ValueError, match="CUDA devices"):
        make_mesh(torch.cuda.device_count() + 1)
