from .scene import (  # noqa: F401
    Scene,
    SceneTables,
    load_scene,
    scene_from_facesets,
)
from .stress import stress_scene  # noqa: F401
