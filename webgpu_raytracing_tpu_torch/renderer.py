"""Render orchestration: progressive accumulation + per-frame step
(counterpart of ``webgpu_raytracing_tpu/renderer.py``; the reference's
renderFrame, render.ts:1651-1710).

The accumulation image is an explicit ``(H, W, 4)`` tensor — rgb sum in
``[..., :3]``, sample count in ``[..., 3]`` — the reference image-buffer
layout. Every tensor lives on the device given to :class:`Renderer`; a
frame is :func:`render_frame` on that device (or
:func:`render_frame_slabs`, in horizontal slabs, for ``frame_slabs`` >
1), and seeds are drawn on the host exactly as the JAX package draws
them, so both packages render the same frames from the same
``base_seed``.

The per-pixel features are the JAX package's: temporal reprojection every
``reprojection_rate`` frames (ops/reproject.py), the quad hit predictor
that bounds each primary ray's ``t_max`` (ops/predictor.py), a G-buffer of
fewer rows than the image (``geometry_buffer_scale``), a render size other
than the canvas (``resolution_scale``, resized in :func:`blit`) and the
BVH wireframe overlay (``debug_bvh``, ops/wireframe.py).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .camera import Camera
from .config import F32_MAX, BlitView, RenderSettings, check_supported
from .models.scene import Scene, SceneTables
from .ops import rng
from .ops.env_sample import EnvDistribution
from .ops.integrator import face_point_offset, path_trace, trace_direct
from .ops.predictor import predict_hit_dist, quad_faces
from .ops.raygen import camera_rays, camera_scalars
from .ops.reproject import reproject, reprojection_frustum
from .ops.tonemap import apply as tonemap_apply
from .ops.tonemap import gamma as tonemap_gamma
from .ops.wireframe import overlay_wireframe, rasterize_bvh_wireframe
from .utils import timing
from .utils.timing import span


@dataclasses.dataclass(frozen=True)
class FrameBuffers:
    """Persistent frame state (the reference's storage buffers,
    render.ts:122-159): accumulation image, G-buffer, and the previous-
    frame snapshots."""

    image: torch.Tensor  # (H, W, 4) f32: rgb sum, sample count
    geo_position: torch.Tensor  # (GH, W, 3) f32
    geo_face: torch.Tensor  # (GH, W) i32
    geo_object: torch.Tensor  # (GH, W) i32
    prev_image: torch.Tensor  # (H, W, 4) f32, whole even in slabs
    prev_geo_position: torch.Tensor  # (GH, W, 3) f32, whole
    prev_geo_face: torch.Tensor  # (GH, W) i32, whole

    @staticmethod
    def create(width: int, height: int, device,
               geo_height: Optional[int] = None) -> "FrameBuffers":
        """``geo_height`` (GH) mirrors the reference's geometryBufferScale
        allocation (render.ts:141-144): the G-buffer may have fewer rows
        than the image; the rows past it read as "no data"."""
        gh = height if geo_height is None else geo_height

        def z(*shape):
            return torch.zeros(shape, dtype=torch.float32, device=device)

        def m1(*shape):
            return torch.full(shape, -1, dtype=torch.int32, device=device)

        return FrameBuffers(
            image=z(height, width, 4),
            geo_position=z(gh, width, 3),
            geo_face=m1(gh, width),
            geo_object=torch.zeros(
                (gh, width), dtype=torch.int32, device=device
            ),
            prev_image=z(height, width, 4),
            prev_geo_position=z(gh, width, 3),
            prev_geo_face=m1(gh, width),
        )

    def rotated(self) -> "FrameBuffers":
        """Prev-buffer rotation (the updatePrev copies, render.ts:1694-1699)."""
        return dataclasses.replace(
            self,
            prev_image=self.image.clone(),
            prev_geo_position=self.geo_position.clone(),
            prev_geo_face=self.geo_face.clone(),
        )


@dataclasses.dataclass(frozen=True)
class FrameInputs:
    """Per-frame values (the reference's uniforms, render.ts:57-106,
    1658-1665); ``frustum`` and ``prev_origin`` are read only with
    reprojection on."""

    view: torch.Tensor  # (4, 4) f32, on the render device
    seed: int  # 32-bit frame seed
    counter: int  # frames accumulated so far (0 clears)
    jitter: torch.Tensor  # (2,) f32, on the render device
    # (4, 3) f32 reprojection frustum of the previous view
    frustum: Optional[torch.Tensor] = None
    # (3,) f32 translation column of the previous view
    prev_origin: Optional[torch.Tensor] = None

    @staticmethod
    def simple(view, seed: int, counter: int, device) -> "FrameInputs":
        """A static camera's inputs: no jitter, zero frustum and previous
        origin (JAX ``FrameInputs.simple``)."""
        return FrameInputs(
            view=torch.as_tensor(np.asarray(view, np.float32), device=device),
            seed=int(seed),
            counter=int(counter),
            jitter=torch.zeros((2,), dtype=torch.float32, device=device),
            frustum=torch.zeros((4, 3), dtype=torch.float32, device=device),
            prev_origin=torch.zeros((3,), dtype=torch.float32, device=device),
        )


def _face_to_object(tables: SceneTables, face: torch.Tensor) -> torch.Tensor:
    """Global face index → model index via the model face offsets."""
    f = face.clamp(min=0).unsqueeze(-1)
    return (
        (f >= tables.model_face_offset[None, :]).to(torch.int32).sum(-1) - 1
    ).to(torch.int32)


def render_tile(
    buffers: FrameBuffers,
    tables: SceneTables,
    env_data,
    inputs: FrameInputs,
    row0: int,
    settings: RenderSettings,
    tile_height: int,
) -> Tuple[FrameBuffers, torch.Tensor]:
    """One progressive frame over a horizontal slab of the image
    (megakernel main, render.ts:1434-1509). Returns (buffers, rays)."""
    check_supported(settings)
    dev = tables.device
    h, w = tile_height, settings.render_width
    r = h * w

    ys, xs = torch.meshgrid(
        torch.arange(h, dtype=torch.int32, device=dev) + row0,
        torch.arange(w, dtype=torch.int32, device=dev),
        indexing="ij",
    )
    idx = (xs + ys * w).reshape(r)
    base_pos = (
        torch.stack([xs, ys], dim=-1).reshape(r, 2).to(torch.float32)
        + inputs.jitter[None, :]
    )

    state = rng.seed_state(inputs.seed, idx)
    integrator = trace_direct if settings.bounces_depth <= 1 else path_trace

    # clear on counter == 0 (render.ts:1454-1459), unless reprojection
    # replaces the accumulation base below
    image = buffers.image
    if inputs.counter == 0 and not settings.reproject:
        image = torch.zeros_like(image)

    # geometry_buffer_scale < 1 allocates fewer G-buffer rows than the
    # image (render.ts:144); rows past the allocation read as "no data"
    # (face -1 / position 0, the robust-access result), so the prev
    # snapshots are padded back to the render height for the readers below
    prev_geo_face = buffers.prev_geo_face
    prev_geo_position = buffers.prev_geo_position
    pad_rows = settings.render_height - prev_geo_face.shape[0]
    if pad_rows > 0:
        prev_geo_face = F.pad(prev_geo_face, (0, 0, 0, pad_rows), value=-1)
        prev_geo_position = F.pad(prev_geo_position, (0, 0, 0, 0, 0, pad_rows))

    # quad hit-distance candidates from the previous G-buffer
    # (render.ts:1121-1141, 1440-1446), over the WHOLE prev buffer and
    # the slab's rows sliced out after, so 2x2 blocks anchor at global row
    # parity however the frame is cut into slabs
    prev_quads = (
        quad_faces(prev_geo_face)[row0:row0 + h].reshape(r, 4)
        if settings.use_hit_predictor
        else None
    )

    def one_sample(pos, state):
        o, d, state = camera_rays(pos, inputs.view, state, settings)
        if prev_quads is not None:
            with span("wrt.raygen"):
                t_max = predict_hit_dist(o, d, prev_quads, tables)
        else:
            t_max = torch.full((r,), F32_MAX, dtype=torch.float32,
                               device=dev)
        return integrator(o, d, t_max, state, tables, env_data, settings)

    def hit_point(hit):
        face = hit.face.clamp(min=0).long()
        return face_point_offset(
            tables.tri[face], tables.shade_normal[face], hit.u, hit.v
        )

    def reproject_onto(point, color, state):
        return reproject(
            point, color, state, inputs.frustum, inputs.prev_origin,
            buffers.prev_image, prev_geo_position, settings,
        )

    # primary sample (render.ts:1464-1468)
    res = one_sample(base_pos, state)
    state = res.state
    color = torch.zeros((r, 3), dtype=torch.float32, device=dev) + res.color
    rays = res.rays
    samples = torch.ones((r, 1), dtype=torch.float32, device=dev)

    # G-buffer write from the primary hit (render.ts:1470-1475); writes
    # past the G-buffer's rows are dropped (the reference's robust-access
    # no-ops)
    fh = res.first_hit
    primary_point = hit_point(fh)
    g_out = buffers.geo_face.shape[0]
    geo_position = primary_point.reshape(h, w, 3)[:g_out]
    geo_face = fh.face.reshape(h, w)[:g_out]
    geo_object = _face_to_object(tables, fh.face).reshape(h, w)[:g_out]

    # extra stratified-jittered samples (render.ts:1477-1495)
    for _ in range(settings.sample_count):
        t2, state = rng.random_2(state)
        pos = base_pos + rng.sample_insquare(t2) * 0.5
        res = one_sample(pos, state)
        state = res.state
        color = color + res.color
        rays = rays + res.rays
        samples = samples + 1.0

        if settings.reproject:
            # temporal merge per extra sample (render.ts:1485-1494)
            rp, state = reproject_onto(hit_point(res.first_hit), color, state)
            ok = rp.color[..., 3:4] > 0.0
            color = color + torch.where(
                ok,
                rp.color[..., :3] / torch.clamp(rp.color[..., 3:4], min=1e-20),
                torch.zeros_like(color),
            )
            samples = samples + ok.to(torch.float32)

    if settings.reproject:
        # the primary point's reprojection REPLACES the accumulation base
        # (render.ts:1497-1500); the frame still accumulates on top
        # (render.ts:1506-1507)
        rp, state = reproject_onto(primary_point, color, state)
        image = rp.color.reshape(h, w, 4)

    if settings.debug_reprojection:
        new_image = image
    elif settings.blit_view == BlitView.NORMALS:
        new_image = torch.cat(
            [color, torch.ones_like(samples)], dim=-1
        ).reshape(h, w, 4)
    else:
        new_image = image + torch.cat([color, samples], dim=-1).reshape(h, w, 4)

    out = dataclasses.replace(
        buffers,
        image=new_image,
        geo_position=geo_position,
        geo_face=geo_face,
        geo_object=geo_object,
    )
    return out, rays


@torch.no_grad()
def render_frame(
    buffers: FrameBuffers,
    tables: SceneTables,
    env_data,
    inputs: FrameInputs,
    settings: RenderSettings,
) -> Tuple[FrameBuffers, torch.Tensor]:
    """Single-device frame: the whole image is one tile."""
    return render_tile(
        buffers, tables, env_data, inputs, 0, settings,
        settings.render_height,
    )


@torch.no_grad()
def render_frame_slabs(
    buffers: FrameBuffers,
    tables: SceneTables,
    env_data,
    inputs: FrameInputs,
    settings: RenderSettings,
) -> Tuple[FrameBuffers, torch.Tensor]:
    """Big-frame path (``frame_slabs`` > 1): the frame as ``frame_slabs``
    horizontal slabs, one :func:`render_tile` call each, so the
    wavefront's (rays x state-columns) temporaries scale with the slab,
    not the frame (config #5: 4K in 8 slabs of 1,036,800 rays).

    The current-frame rows are sliced per slab and the prev_* snapshots
    ride whole; ``row0`` keeps pixel indices, and so RNG streams, global,
    which makes the slabs bit-identical to the single-tile frame."""
    n = settings.frame_slabs
    h = settings.render_height
    if h % n:
        raise ValueError(f"frame_slabs={n} must divide render_height={h}")
    if settings.geo_height != h:
        raise ValueError(
            "frame_slabs requires geometry_buffer_scale == 1 (slab rows "
            "must align between the image and the G-buffer)"
        )
    hs = h // n
    current = ("image", "geo_position", "geo_face", "geo_object")
    outs = []
    rays = 0.0
    for b in range(n):
        sl = slice(b * hs, (b + 1) * hs)
        slab = dataclasses.replace(
            buffers, **{k: getattr(buffers, k)[sl] for k in current}
        )
        out, r = render_tile(
            slab, tables, env_data, inputs, b * hs, settings, hs
        )
        outs.append(out)
        rays = rays + r
    merged = dataclasses.replace(
        buffers,
        **{k: torch.cat([getattr(o, k) for o in outs]) for k in current},
    )
    return merged, rays


@torch.no_grad()
def blit(image: torch.Tensor, prev_image: torch.Tensor,
         settings: RenderSettings) -> torch.Tensor:
    """Accumulation buffer → display color (render.ts:184-244): pick the
    buffer by blit view, rgb / samples × exposure, gamma(1/γ), tonemap."""
    if settings.blit_view == BlitView.NORMALS:
        color = image[..., :3]
    elif settings.blit_view == BlitView.PREV_IMAGE:
        color = prev_image[..., :3] / torch.clamp(prev_image[..., 3:4], min=1e-20)
    else:
        color = image[..., :3] / torch.clamp(image[..., 3:4], min=1e-20)
        if settings.blit_view == BlitView.IMAGE:
            color = color * settings.exposure
    color = tonemap_gamma(color, 1.0 / settings.gamma)
    color = tonemap_apply(color, settings.tonemapping)
    color = torch.clamp(color, 0.0, 1.0)
    if color.shape[:2] != (settings.height, settings.width):
        # resolution_scale != 1: the reference's fullscreen blit stretches
        # the scaled backing store to the canvas (render.ts:109-113,
        # 163-183) with the sampler's bilinear filtering
        color = resize_linear(color, settings.height, settings.width)
    return color


def resize_linear(img: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """(h, w, C) → (height, width, C) as ``jax.image.resize(img, ...,
    method="linear")`` computes it: the triangle kernel at half-pixel
    centres, widened by the scale when shrinking, which is what
    ``F.interpolate``'s antialiased bilinear mode uses. Equal to the JAX
    function when enlarging, within about 1e-7 when shrinking (the sums
    run in another order)."""
    out = F.interpolate(
        img.permute(2, 0, 1)[None], size=(height, width), mode="bilinear",
        align_corners=False, antialias=True,
    )
    return out[0].permute(1, 2, 0)


def _check_env(settings: RenderSettings, env_data) -> None:
    if settings.env_importance_sampling and not isinstance(
        env_data, EnvDistribution
    ):
        raise ValueError(
            "env_importance_sampling needs env_data to be an "
            "EnvDistribution (ops.env_sample.build_env_distribution), "
            f"not {type(env_data).__name__}"
        )


class Renderer:
    """Host-side progressive renderer: owns the accumulation state, the
    reset-on-change policy (store.ts:192-344) and the prev-buffer rotation
    (render.ts:1651-1657). Everything lives on ``device``.

    ``env_data`` is an (H, W, 3) radiance image or cubemap faces, or, for
    ``env_importance_sampling``, an :class:`EnvDistribution` (whose
    ``img`` then serves the environment fetches too)."""

    def __init__(
        self,
        scene: Scene,
        settings: RenderSettings,
        env_data=None,
        camera: Optional[Camera] = None,
        base_seed: Optional[int] = None,
        *,
        device,
    ):
        check_supported(settings)
        _check_env(settings, env_data)
        camera_scalars(settings)  # cached: computed here, not in a frame
        self.device = torch.device(device)
        self.scene = scene
        self.settings = settings
        self.tables = scene.tables(self.device)
        if env_data is None:
            env_data = np.zeros((1, 1, 3), np.float32)
        if isinstance(env_data, EnvDistribution):
            self.env_data = env_data.to(self.device)
        else:
            self.env_data = torch.as_tensor(
                np.asarray(env_data, np.float32), device=self.device
            )
        self.camera = camera or Camera()
        self.counter = 0
        self.frame_counter = 0
        self.buffers = FrameBuffers.create(
            settings.render_width, settings.render_height, self.device,
            settings.geo_height,
        )
        self._rng = np.random.default_rng(base_seed)
        self.last_rays = 0.0  # rays traced in the last frame (metrics)
        # the last frame's counters (utils/timing.py); empty unless tracing
        self.last_counts = {}
        self._prev_view = np.eye(4, dtype=np.float32)
        self._jitter = None  # redrawn when updatePrev fires

    def reset(self) -> None:
        self.counter = 0

    def update_settings(self, **kw) -> None:
        """A settings change resets accumulation (gpu.ts:512-525)."""
        settings = self.settings.replace(**kw)
        check_supported(settings)
        _check_env(settings, self.env_data)
        camera_scalars(settings)
        self.settings = settings
        if kw.keys() & {
            "width", "height", "resolution_scale", "geometry_buffer_scale"
        }:
            self.buffers = FrameBuffers.create(
                settings.render_width, settings.render_height, self.device,
                settings.geo_height,
            )
        self.reset()

    def move_camera(self, d) -> None:
        if self.camera.move(np.asarray(d, dtype=np.float32)):
            self.reset()

    def rotate_camera(self, d) -> None:
        if self.camera.rotate(np.asarray(d, dtype=np.float32)):
            self.reset()

    def step(self, seed: Optional[int] = None) -> None:
        """renderFrame (render.ts:1651-1710). Seeds and jitter are drawn
        from the host generator in the JAX package's order. The frame is
        the span ``wrt.frame`` (its args: ``counter``); a frame that
        starts accumulating from zero counts ``renderer.restarts``."""
        timing.reset_counts()
        with span("wrt.frame", self.counter):
            self._step(seed)

    def _step(self, seed: Optional[int]) -> None:
        if self.counter == 0:
            timing.count("renderer.restarts", 1)
        if seed is None:
            seed = int(self._rng.integers(0, 2**32, dtype=np.uint64))
        rate = self.settings.reprojection_rate
        update_prev = rate == 0 or self.frame_counter % rate == 0
        if rate:
            self.frame_counter = (self.frame_counter + 1) % rate
        if update_prev or self._jitter is None:
            # the reference rewrites the jitter uniform only when
            # updatePrev fires (render.ts:1660-1665), keeping intermediate
            # frames aligned with the prev-buffer snapshot
            self._jitter = (
                (self._rng.random(2).astype(np.float32) - 0.5)
                * self.settings.jitter_strength
            )
        frustum = reprojection_frustum(
            self._prev_view,
            self.settings.render_width,
            self.settings.render_height,
            self.settings.fov,
        )
        view = self.camera.view_matrix()
        prev_origin = np.asarray(self._prev_view[:3, 3], np.float32)
        inputs = FrameInputs(
            view=torch.as_tensor(view, device=self.device),
            seed=seed,
            counter=self.counter,
            jitter=torch.as_tensor(self._jitter, device=self.device),
            frustum=torch.as_tensor(frustum, device=self.device),
            prev_origin=torch.as_tensor(prev_origin, device=self.device),
        )
        frame_fn = (
            render_frame_slabs if self.settings.frame_slabs > 1
            else render_frame
        )
        self.buffers, rays = frame_fn(
            self.buffers, self.tables, self.env_data, inputs, self.settings
        )
        # the frame's one read-back: the ray count, with tracing on
        # together with the frame's device counters
        self.last_rays, self.last_counts = timing.read_counts(rays)
        self.counter += 1
        if update_prev:
            self.buffers = self.buffers.rotated()
            self._prev_view = view

    def render(self, spp: int) -> np.ndarray:
        """Accumulate until >= spp samples/pixel; return display image."""
        per_frame = 1 + self.settings.sample_count
        while self.counter * per_frame < spp:
            self.step()
        return self.image()

    def image(self) -> np.ndarray:
        """Display image, top row first (the reference's blit maps buffer
        row 0 to the bottom of the canvas, render.ts:163-183)."""
        img = blit(self.buffers.image, self.buffers.prev_image, self.settings)
        if self.settings.debug_bvh:
            # the debug BVH wireframe (render.ts:1685-1692) composites last
            st = self.settings
            vp = self.camera.view_projection_matrix(st.width, st.height,
                                                    st.fov)
            wire = rasterize_bvh_wireframe(
                self.tables.node_box[:, 0:3],
                self.tables.node_box[:, 3:6],
                torch.as_tensor(np.asarray(vp, np.float32),
                                device=self.device),
                st.width,
                st.height,
            )
            img = overlay_wireframe(img, wire.flip(0))
        return img.cpu().numpy()[::-1]

    # --- checkpoint / resume, the JAX package's npz format ---
    def save_checkpoint(self, path: str) -> None:
        """Atomic: write a sibling temp file, fsync, then os.replace.
        Beside the JAX package's keys (which that package reads back), the
        file holds the host generator's state (``rng_state``, JSON) and the
        current jitter (``jitter``, which reprojection keeps between
        updatePrev frames), so a resumed run draws the same frame seeds
        and jitter as one that was never stopped."""
        extra = {} if self._jitter is None else {"jitter": self._jitter}
        arrays = {
            f.name: getattr(self.buffers, f.name).cpu().numpy()
            for f in dataclasses.fields(FrameBuffers)
        }
        final = path if path.endswith(".npz") else path + ".npz"
        tmp = final + ".tmp"
        with open(tmp, "wb") as fh:
            np.savez(
                fh,
                counter=self.counter,
                frame_counter=self.frame_counter,
                cam_position=self.camera.position,
                cam_orientation=self.camera.orientation,
                prev_view=self._prev_view,
                rng_state=np.array(json.dumps(self._rng.bit_generator.state)),
                **extra,
                **arrays,
            )
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, final)

    def load_checkpoint(self, path: str) -> None:
        z = np.load(path)
        self.buffers = FrameBuffers(
            **{
                f.name: torch.as_tensor(z[f.name], device=self.device)
                for f in dataclasses.fields(FrameBuffers)
            }
        )
        self.counter = int(z["counter"])
        self.frame_counter = int(z["frame_counter"])
        self.camera.position = z["cam_position"]
        self.camera.orientation = z["cam_orientation"]
        self._prev_view = z["prev_view"]
        if "rng_state" in z:
            self._rng.bit_generator.state = json.loads(str(z["rng_state"]))
        self._jitter = z["jitter"] if "jitter" in z else None
