from rendering_jax.models.settings import RenderSettings
from rendering_jax.models.parser import SceneDef, parse_scene
from rendering_jax.models.scene import SceneData, SceneStatic, build_scene, load_scene

__all__ = [
    "RenderSettings",
    "SceneDef",
    "parse_scene",
    "SceneData",
    "SceneStatic",
    "build_scene",
    "load_scene",
]
