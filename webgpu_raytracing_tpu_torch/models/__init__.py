from .scene import Scene, SceneTables, scene_from_facesets  # noqa: F401
from .stress import stress_scene  # noqa: F401
