from rendering_jax.diff.inverse import (
    apply_params,
    extract_params,
    make_train_step,
)
from rendering_jax.diff.checkpoint import load_checkpoint, save_checkpoint

__all__ = [
    "extract_params",
    "apply_params",
    "make_train_step",
    "save_checkpoint",
    "load_checkpoint",
]
