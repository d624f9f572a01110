"""Wavefront MTL parser (a copy of ``webgpu_raytracing_tpu/models/mtl.py``,
which this package does not import).

Parity with the reference's line-based parser (mtl.ts:64-167): recognizes
``newmtl, illum, Ka, Kd, Ks, Ke, Tf, Ns, Ni, d, Tr, sharpness,
map_Ka/Kd/Ks/Ns/d, disp, decal, bump, refl``. As in the reference, only
``Kd`` (albedo) and ``Ke`` (emission) ultimately reach the device
(scene.ts:92-108); the rest is recorded for completeness.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional


@dataclasses.dataclass
class MtlMaterial:
    name: str
    illum: int = 0
    Ka: tuple = (0.0, 0.0, 0.0)
    Kd: tuple = (0.0, 0.0, 0.0)
    Ks: tuple = (0.0, 0.0, 0.0)
    Ke: tuple = (0.0, 0.0, 0.0)
    Tf: tuple = (0.0, 0.0, 0.0)
    Ns: float = 0.0
    Ni: float = 0.0
    dissolve: float = 1.0
    sharpness: float = 0.0
    maps: Dict[str, str] = dataclasses.field(default_factory=dict)


class MTLParseError(ValueError):
    def __init__(self, message: str, line_number: int):
        super().__init__(f"MTL parse error at line {line_number}: {message}")
        self.line_number = line_number


def _strip_comments(line: str) -> str:
    i = line.find("#")
    return line if i < 0 else line[:i]


def _parse_color(items: List[str], line_number: int) -> tuple:
    # Spectral / xyz color statements are recorded-but-unused in the
    # reference too (mtl.ts "_notImplemented"); represent them as black.
    if items and items[0] in ("spectral", "xyz"):
        return (0.0, 0.0, 0.0)
    try:
        vals = [float(x) for x in items[:3]]
    except ValueError as e:
        raise MTLParseError(str(e), line_number) from e
    if len(vals) == 1:
        vals = vals * 3
    while len(vals) < 3:
        vals.append(0.0)
    return tuple(vals)


def parse_mtl(text: str) -> List[MtlMaterial]:
    materials: List[MtlMaterial] = []
    current: Optional[MtlMaterial] = None

    def cur(line_number: int) -> MtlMaterial:
        if current is None:
            raise MTLParseError("statement before newmtl", line_number)
        return current

    for line_number, raw in enumerate(text.split("\n"), start=1):
        items = _strip_comments(raw).split()
        if not items:
            continue
        key = items[0].lower()
        args = items[1:]

        if key == "newmtl":
            if not args:
                raise MTLParseError("newmtl missing name", line_number)
            current = MtlMaterial(name=args[0])
            materials.append(current)
        elif key == "illum":
            cur(line_number).illum = int(args[0])
        elif key == "ka":
            cur(line_number).Ka = _parse_color(args, line_number)
        elif key == "kd":
            cur(line_number).Kd = _parse_color(args, line_number)
        elif key == "ks":
            cur(line_number).Ks = _parse_color(args, line_number)
        elif key == "ke":
            cur(line_number).Ke = _parse_color(args, line_number)
        elif key == "tf":
            cur(line_number).Tf = _parse_color(args, line_number)
        elif key == "ns":
            cur(line_number).Ns = float(args[0])
        elif key == "ni":
            cur(line_number).Ni = float(args[0])
        elif key == "d":
            cur(line_number).dissolve = float(args[-1])
        elif key == "tr":
            cur(line_number).dissolve = 1.0 - float(args[0])
        elif key == "sharpness":
            cur(line_number).sharpness = float(args[0])
        elif key in (
            "map_ka",
            "map_kd",
            "map_ks",
            "map_ns",
            "map_d",
            "disp",
            "decal",
            "bump",
            "refl",
        ):
            if args:
                cur(line_number).maps[key] = args[-1]
        else:
            # Unknown statements are ignored, like mtl.ts:454-456.
            pass

    return materials
