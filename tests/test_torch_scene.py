"""PyTorch port: scene tables and settings against the JAX package.

The same scene, built from the same generators, must give the same
tables in both packages, array for array and bit for bit."""

import dataclasses
import inspect

import numpy as np
import pytest
import torch

import webgpu_raytracing_tpu.config as jcfg
import webgpu_raytracing_tpu_torch.config as tcfg
from webgpu_raytracing_tpu.models import scene as jscene
from webgpu_raytracing_tpu.models import stress as jstress
from webgpu_raytracing_tpu.models import test_models as jtm
from webgpu_raytracing_tpu.ops.cluster_pallas import (
    trace_closest_clustered_pallas,
)
from webgpu_raytracing_tpu_torch.models import scene as tscene
from webgpu_raytracing_tpu_torch.models import stress as tstress
from webgpu_raytracing_tpu_torch.models import test_models as ttm

torch.set_num_threads(1)


def _mini(scene_mod, tm):
    """tests/test_parity_ops.py golden scene."""
    return scene_mod.scene_from_facesets(
        [
            ("light", tm.uv_sphere((0, 3, -4), 0.5, material_idx=1, lat=4, lon=6)),
            ("sphere", tm.uv_sphere((0, 0, -4), 1.0, lat=6, lon=8)),
            ("plane", tm.ground_plane(-1.5, 8.0)),
        ],
        np.array([[0.8, 0.4, 0.3], [0, 0, 0]], np.float32),
        np.array([[0, 0, 0], [6, 6, 6]], np.float32),
    )


def _cluster_scene(scene_mod, tm):
    """tests/test_cluster.py scene."""
    return scene_mod.scene_from_facesets(
        [
            ("sphere", tm.uv_sphere((0, 0, -4), 1.0, lat=10, lon=14)),
            ("plane", tm.ground_plane(-1.5, 8.0)),
            ("cube", tm.unit_cube_model()),
        ],
        np.ones((1, 3), np.float32) * 0.8,
        np.zeros((1, 3), np.float32),
    )


SCENES = {
    "mini": lambda j: _mini(jscene, jtm) if j else _mini(tscene, ttm),
    "cluster": (
        lambda j: _cluster_scene(jscene, jtm) if j
        else _cluster_scene(tscene, ttm)
    ),
    "stress20k": (
        lambda j: jstress.stress_scene(20_000) if j
        else tstress.stress_scene(20_000)
    ),
}


def jax_tables_numpy(jt) -> dict:
    """JAX SceneTables → the numpy dict tables_from_numpy takes."""
    out = {k: np.asarray(getattr(jt, k)) for k in tscene.TABLE_FIELDS}
    for k in tscene.CLUSTER_FIELDS:
        if getattr(jt.clusters, k) is not None:
            out["clusters." + k] = np.asarray(getattr(jt.clusters, k))
    return out


@pytest.mark.parametrize("name", list(SCENES))
def test_scene_tables_match_jax(name):
    ref = jax_tables_numpy(SCENES[name](True).tables())
    got = tscene.tables_to_numpy(SCENES[name](False).tables("cpu"))
    assert set(got) == set(ref)
    for k, want in ref.items():
        assert got[k].dtype == want.dtype, k
        assert got[k].shape == want.shape, k
        np.testing.assert_array_equal(got[k], want, err_msg=k)


def test_tables_from_numpy_round_trip():
    arrays = jax_tables_numpy(SCENES["cluster"](True).tables())
    tables = tscene.tables_from_numpy(arrays, device="cpu")
    assert tables.device == torch.device("cpu")
    back = tscene.tables_to_numpy(tables)
    assert set(back) == set(arrays)
    for k, v in arrays.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    # .to() keeps every table
    again = tscene.tables_to_numpy(tables.to("cpu"))
    for k, v in arrays.items():
        np.testing.assert_array_equal(again[k], v, err_msg=k)


def test_render_settings_match_jax():
    jf = {f.name: f for f in dataclasses.fields(jcfg.RenderSettings)}
    tf = {f.name: f for f in dataclasses.fields(tcfg.RenderSettings)}
    assert set(jf) - set(tf) == set(tcfg.OMITTED_FIELDS)
    # kernel_near is an argument of the JAX dispatcher, not a JAX setting:
    # the one field of the port without a counterpart there
    assert set(tf) - set(jf) == set(tcfg.PORT_ONLY_FIELDS) == {"kernel_near"}
    jd, td = jcfg.RenderSettings(), tcfg.RenderSettings()
    # ... and the port's main path: on by default, with the reason stated
    # (the JAX dispatcher's argument of that name defaults to False)
    assert td.kernel_near is True and tcfg.DEFAULT_DEVIATIONS["kernel_near"]
    jax_default = inspect.signature(
        trace_closest_clustered_pallas).parameters["kernel_near"].default
    assert jax_default is False
    # the binned and multipass traces: the JAX fields, all off as there
    ported = ("binned_sort", "binned_any_sort", "multipass_cap",
              "multipass_passes")
    assert set(ported) <= set(tf) & set(jf)
    assert not set(ported) & (set(tcfg.OMITTED_FIELDS)
                              | set(tcfg.DEFAULT_DEVIATIONS))
    assert (td.binned_sort, td.binned_any_sort, td.multipass_cap,
            td.multipass_passes) == (False, False, 0, 2)
    assert set(tcfg.DEFAULT_DEVIATIONS) <= (
        set(tf) & set(jf) | set(tcfg.PORT_ONLY_FIELDS))
    for name in set(tf) & set(jf):
        a, b = getattr(jd, name), getattr(td, name)
        if name in tcfg.DEFAULT_DEVIATIONS:
            assert a != b and tcfg.DEFAULT_DEVIATIONS[name], name
        elif isinstance(a, (jcfg.BlitView,)):
            assert a.value == b.value, name
        else:
            assert a == b, name
    for k in ("render_width", "render_height", "geo_height", "reproject"):
        assert getattr(jd, k) == getattr(td, k)
    for c in ("PHI", "SRT", "PI", "E", "TWO_PI", "INV_PI", "EPSILON",
              "F32_MIN", "F32_MAX", "MIN_DIST", "MAX_DIST"):
        assert getattr(jcfg, c) == getattr(tcfg, c), c
