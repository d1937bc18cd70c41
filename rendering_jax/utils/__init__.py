from rendering_jax.utils.bmp import load_bmp, save_bmp, encode_bmp, decode_bmp
from rendering_jax.utils.timer import Timer, phase_timer
from rendering_jax.utils.stats import RenderStats

__all__ = [
    "load_bmp",
    "save_bmp",
    "encode_bmp",
    "decode_bmp",
    "Timer",
    "phase_timer",
    "RenderStats",
]
