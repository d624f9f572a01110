"""PyTorch port: host ingestion against the JAX package — OBJ / MTL
parsing, materials, ``load_scene`` (fixtures, two-sided faces, per-model
BVHs, the reference's 8-model selection) through the native loader and
through the Python parser, and the image readers and writers. Every array
and table must equal the JAX package's exactly; files are written into
``tmp_path``."""

import os
import struct
import zlib

import numpy as np
import pytest

from webgpu_raytracing_tpu.models import mtl as jmtl
from webgpu_raytracing_tpu.models import obj as jobj
from webgpu_raytracing_tpu.models import scene as jscene
from webgpu_raytracing_tpu.utils import image as jimage
from webgpu_raytracing_tpu_torch.models import bvh as tbvh
from webgpu_raytracing_tpu_torch.models import mtl as tmtl
from webgpu_raytracing_tpu_torch.models import native as tnative
from webgpu_raytracing_tpu_torch.models import obj as tobj
from webgpu_raytracing_tpu_torch.models import scene as tscene
from webgpu_raytracing_tpu_torch.models import test_models as ttm
from webgpu_raytracing_tpu_torch.utils import image as timage

MTL_SNIPPET = """
# comment
newmtl Red
Ns 10.0
Ka 1 1 1
Kd 0.85 0.0 0.0
Ke 0 0 0
illum 1

newmtl Light
Kd 0.8 0.8 0.8
Ke 5 5 5
"""

MTL_RICH = MTL_SNIPPET + """
newmtl White
Kd 0.7
Ks 0.1 0.2
Tf spectral file.rfl
d -halo 0.5
Ni 1.5
sharpness 60
map_Kd -o 1 1 tex.png
bump bump.png
unknown_statement 1 2 3
newmtl Glow
Kd 0.2 0.3 0.4
Ke 0.5 0.25 0.125
Tr 0.25
"""

OBJ_SNIPPET = """
v 0 0 0
v 1 0 0
v 0 1 0
v 1 1 0
vn 0 0 1
o quad
usemtl Red
f 1//1 2//1 4//1 3//1
"""


def twelve_model_obj(seed: int = 0) -> str:
    """An OBJ of 10 ``o`` groups (12 models with load_scene's two
    fixtures, so REFERENCE_SUBSET selects from them): Light first, then
    boxes and polygons with and without normals and texcoords, a fan
    polygon, a ``g`` group, comments and a material the MTL lacks."""
    rng = np.random.default_rng(seed)
    lines = ["# twelve-model scene", "mtllib scene.mtl"]
    nv = 0
    mats = ["Light", "Red", "White", "Glow", "Missing"]
    for k in range(10):
        lines.append(("g " if k == 7 else "o ") + f"model_{k}")
        lines.append(f"usemtl {mats[k % len(mats)]}")
        c = rng.uniform(-3, 3, 3)
        n = 4 + k % 3  # a quad, a pentagon, a hexagon
        ang = np.sort(rng.uniform(0, 2 * np.pi, n))
        for a in ang:
            lines.append("v %.6f %.6f %.6f" % (
                c[0] + np.cos(a), c[1] + 0.3 * k, c[2] + np.sin(a)))
        with_n = k % 2 == 0
        if with_n:
            for _ in range(n):
                v = rng.normal(size=3)
                v = v / np.linalg.norm(v)
                lines.append("vn %.5f %.5f %.5f" % tuple(v))
        lines.append("vt 0.5 0.5")
        ids = [nv + i + 1 for i in range(n)]
        if with_n:
            nn = sum(4 + j % 3 for j in range(0, k, 2))
            toks = [f"{v}//{nn + i + 1}" for i, v in enumerate(ids)]
        else:
            toks = [f"{v}/1" for v in ids]
        lines.append("f " + " ".join(toks) + "  # fan")
        lines.append(f"f {ids[0]} {ids[2]} {ids[1]}")
        nv += n
    return "\n".join(lines) + "\n"


@pytest.fixture
def scene_files(tmp_path):
    obj = tmp_path / "scene.obj"
    mtl = tmp_path / "scene.mtl"
    obj.write_text(twelve_model_obj())
    mtl.write_text(MTL_RICH)
    return str(obj), str(mtl)


def _same_obj(a, b):
    for k in ("vertices", "normals", "texcoords"):
        assert getattr(a, k).dtype == getattr(b, k).dtype, k
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k), err_msg=k)
    assert len(a.models) == len(b.models)
    for ma, mb in zip(a.models, b.models):
        assert ma.name == mb.name and ma.material == mb.material
        for k in ("vertex_idx", "normal_idx", "texcoord_idx"):
            assert getattr(ma, k).dtype == getattr(mb, k).dtype, k
            np.testing.assert_array_equal(getattr(ma, k), getattr(mb, k))


@pytest.mark.parametrize("text", [OBJ_SNIPPET, twelve_model_obj()],
                         ids=["snippet", "twelve_models"])
def test_parse_obj_equals_jax(text):
    _same_obj(tobj.parse_obj(text), jobj.parse_obj(text))


@pytest.mark.parametrize("text", [MTL_SNIPPET, MTL_RICH],
                         ids=["snippet", "rich"])
def test_parse_mtl_and_materials_equal_jax(text):
    got, want = tmtl.parse_mtl(text), jmtl.parse_mtl(text)
    assert [vars(m) for m in got] == [vars(m) for m in want]
    tc, te, tn = tscene.materials_from_mtl(got)
    jc, je, jn = jscene.materials_from_mtl(want)
    assert tn == jn
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_array_equal(te, je)
    assert tc.dtype == te.dtype == np.float32


@pytest.mark.parametrize("text, line", [
    ("Kd 1 1 1\n", 1),
    ("newmtl A\nKd 1 1 1\n\nnewmtl\n", 4),
    ("newmtl A\nKd 1 x 1\n", 2),
    ("# c\nnewmtl A\nKe a\n", 3),
])
def test_mtl_parse_errors(text, line):
    with pytest.raises(jmtl.MTLParseError) as want:
        jmtl.parse_mtl(text)
    with pytest.raises(tmtl.MTLParseError) as got:
        tmtl.parse_mtl(text)
    assert isinstance(got.value, ValueError)
    assert got.value.line_number == want.value.line_number == line
    assert str(got.value) == str(want.value)


def _jax_tables(scene):
    jt = scene.tables()
    out = {k: np.asarray(getattr(jt, k)) for k in tscene.TABLE_FIELDS}
    for k in tscene.CLUSTER_FIELDS:
        if getattr(jt.clusters, k) is not None:
            out["clusters." + k] = np.asarray(getattr(jt.clusters, k))
    return out


@pytest.mark.parametrize("loader", ["native", "python"])
@pytest.mark.parametrize("selection", ["reference_subset", "all"])
def test_load_scene_tables_equal_jax(scene_files, monkeypatch, loader,
                                     selection):
    """load_scene on a written 12-model OBJ/MTL: the same models (Light
    first under the reference subset) and the same tables, array for
    array, through the native loader and through the Python parser."""
    obj, mtl = scene_files
    if loader == "python":
        monkeypatch.setenv("WRT_NO_NATIVE", "1")
    kw = {} if selection == "reference_subset" else {"selection": None}
    got = tscene.load_scene(obj, mtl, **kw)
    assert got.loader == loader
    monkeypatch.setenv("WRT_NO_NATIVE", "1")  # the JAX reference: Python
    want = jscene.load_scene(obj, mtl, **kw)
    assert [m.name for m in got.models] == [m.name for m in want.models]
    n = len(tscene.REFERENCE_SUBSET) if kw == {} else 12
    assert len(got.models) == n
    if kw == {}:
        assert got.models[0].name == "model_0"  # the Light group
    assert got.mat_names == want.mat_names
    ref = _jax_tables(want)
    tab = tscene.tables_to_numpy(got.tables("cpu"))
    assert set(tab) == set(ref)
    for k, v in ref.items():
        assert tab[k].dtype == v.dtype, k
        np.testing.assert_array_equal(tab[k], v, err_msg=k)


def test_native_loader_equals_python(scene_files, monkeypatch):
    """runtime/loader.cpp, built into build/native/ at first use: the
    parsed OBJ and the BVHs are byte-identical to the Python path, and
    WRT_NO_NATIVE turns it off."""
    obj, _ = scene_files
    assert tnative.get_lib() is not None, "g++ could not build the loader"
    assert os.path.dirname(tnative.BUILD_DIR).endswith("build")
    with open(obj) as fh:
        _same_obj(tnative.parse_obj_native(obj), tobj.parse_obj(fh.read()))
    assert tnative.parse_obj_native(obj + ".missing") is None
    for fs in (ttm.unit_cube_model(), ttm.uv_sphere((1, -2, 5), 2.0, lat=10,
                                                    lon=16),
               ttm.ground_plane(-1.0, 4.0)):
        a, b = tbvh.build_bvh_python(fs), tnative.build_bvh_native(fs)
        for k in ("node_min", "node_max", "right_idx", "face0", "face1",
                  "skip"):
            np.testing.assert_array_equal(getattr(a, k), getattr(b, k),
                                          err_msg=k)
    monkeypatch.setenv("WRT_NO_NATIVE", "1")
    assert tnative.get_lib() is None
    assert tnative.parse_obj_native(obj) is None
    monkeypatch.delenv("WRT_NO_NATIVE")
    assert tnative.get_lib() is not None


# --- images ---


def test_png_write_and_read_equal_jax(tmp_path):
    rng = np.random.default_rng(3)
    img = rng.uniform(-0.2, 1.2, (7, 11, 3)).astype(np.float32)
    a, b = str(tmp_path / "a.png"), str(tmp_path / "b.png")
    timage.write_png(a, img)
    jimage.write_png(b, img)
    assert open(a, "rb").read() == open(b, "rb").read()
    got, want = timage.read_image(a), jimage.read_image(b)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.float32 and got.shape == (7, 11, 3)
    u8 = (rng.uniform(0, 255, (5, 4, 3))).astype(np.uint8)
    timage.write_png(a, u8)
    np.testing.assert_array_equal(timage.read_image(a) * 255.0,
                                  u8.astype(np.float32))
    assert timage.rmse(got, want) == jimage.rmse(got, want) == 0.0
    assert timage.rmse(got, got + 0.5) == jimage.rmse(got, got + 0.5)


def test_load_cubemap_equal_jax(tmp_path):
    """Six faces (one of another size, resized), sRGB → linear."""
    from PIL import Image

    rng = np.random.default_rng(4)
    paths = []
    for k in range(6):
        s = 6 if k != 3 else 9
        arr = rng.integers(0, 256, (s, s, 3)).astype(np.uint8)
        p = str(tmp_path / f"f{k}.png")
        Image.fromarray(arr, mode="RGB").save(p)
        paths.append(p)
    got, want = timage.load_cubemap(paths), jimage.load_cubemap(paths)
    assert got.shape == (6, 6, 6, 3) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    x = rng.uniform(0, 1, 500).astype(np.float32)
    np.testing.assert_array_equal(timage.srgb_to_linear_np(x),
                                  jimage.srgb_to_linear_np(x))


def _rgbe(img):
    maxc = img.max(axis=2)
    e = np.ceil(np.log2(np.maximum(maxc, 1e-30))).astype(np.int32) + 1
    scale = 2.0 ** (e - 8)
    rgbe = np.zeros(img.shape[:2] + (4,), np.uint8)
    for c in range(3):
        rgbe[..., c] = np.clip(img[..., c] / scale, 0, 255).astype(np.uint8)
    rgbe[..., 3] = (e + 128).astype(np.uint8)
    return rgbe


def _rle_row(row):
    """One RGBE scanline (w, 4) in the new run-length form: per channel,
    runs of one value and literal spans."""
    w = row.shape[0]
    out = bytes([2, 2, w >> 8, w & 255])
    for c in range(4):
        ch = row[:, c]
        x = 0
        while x < w:
            run = 1
            while x + run < w and run < 127 and ch[x + run] == ch[x]:
                run += 1
            if run >= 3:
                out += bytes([128 + run, ch[x]])
                x += run
            else:
                n = min(128, w - x)
                out += bytes([n]) + ch[x:x + n].tobytes()
                x += n
    return out


@pytest.mark.parametrize("rle", [False, True], ids=["flat", "rle"])
def test_read_hdr_equal_jax(tmp_path, rle):
    rng = np.random.default_rng(5)
    img = (rng.random((5, 12, 3)) * 2.0).astype(np.float32)
    img[:, 4:10] = img[:, 4:5]  # runs
    rgbe = _rgbe(img)
    p = str(tmp_path / "t.hdr")
    body = (b"".join(_rle_row(r) for r in rgbe) if rle
            else rgbe.tobytes())
    with open(p, "wb") as fh:
        fh.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n-Y 5 +X 12\n")
        fh.write(body)
    got, want = timage.read_hdr(p), jimage.read_hdr(p)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got, img, rtol=0.02, atol=0.02)
    bad = str(tmp_path / "bad.hdr")
    with open(bad, "wb") as fh:
        fh.write(b"PNG")
    with pytest.raises(ValueError):
        timage.read_hdr(bad)


def _exr(path, img, zips):
    """A scanline EXR, f32 B/G/R, no compression or ZIPS (one line a
    block, the interleave-split and delta step before zlib)."""
    h, w = img.shape[:2]

    def attr(name, atype, data):
        return (name.encode() + b"\x00" + atype.encode() + b"\x00"
                + struct.pack("<i", len(data)) + data)

    chans = b"".join(c.encode() + b"\x00" + struct.pack("<iiii", 2, 0, 1, 1)
                     for c in ("B", "G", "R")) + b"\x00"
    win = struct.pack("<4i", 0, 0, w - 1, h - 1)
    header = (b"\x76\x2f\x31\x01" + struct.pack("<i", 2)
              + attr("channels", "chlist", chans)
              + attr("compression", "compression",
                     b"\x02" if zips else b"\x00")
              + attr("dataWindow", "box2i", win)
              + attr("displayWindow", "box2i", win)
              + attr("lineOrder", "lineOrder", b"\x00") + b"\x00")
    blocks = []
    for y in range(h):
        raw = b"".join(img[y, :, ci].astype("<f4").tobytes()
                       for ci in (2, 1, 0))
        if zips:
            arr = np.frombuffer(raw, np.uint8).astype(np.int64)
            half = (len(arr) + 1) // 2
            split = np.empty_like(arr)
            split[:half] = arr[0::2]
            split[half:] = arr[1::2]
            enc = split.copy()
            enc[1:] = (split[1:] - split[:-1] + 128) % 256
            raw = zlib.compress(enc.astype(np.uint8).tobytes())
        blocks.append(raw)
    off = len(header) + 8 * h
    table, body = b"", b""
    for y, blk in enumerate(blocks):
        table += struct.pack("<q", off)
        body += struct.pack("<ii", y, len(blk)) + blk
        off += 8 + len(blk)
    with open(path, "wb") as fh:
        fh.write(header + table + body)


@pytest.mark.parametrize("zips", [False, True], ids=["none", "zips"])
def test_read_exr_equal_jax(tmp_path, zips):
    img = (np.random.default_rng(6).random((6, 9, 3)) * 4.0).astype(
        np.float32)
    p = str(tmp_path / "t.exr")
    _exr(p, img, zips)
    got, want = timage.read_exr(p), jimage.read_exr(p)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, img)
