"""Checkpoint/resume for long renders and inverse-rendering runs.

The reference is all-or-nothing (SURVEY section 5.4 — the only persisted
artifact is the final BMP). Here: an npz of (step, params, opt_state,
and optionally a partially-accumulated framebuffer + finished-tile
mask) gives cheap resume on preemption — the accelerator analogue of
per-tile checkpointing.
"""

from __future__ import annotations

import os

import jax
import numpy as np


def _flatten(tree, prefix, out):
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    out[f"{prefix}__treedef"] = np.frombuffer(
        str(treedef).encode(), dtype=np.uint8
    )
    for i, leaf in enumerate(leaves):
        out[f"{prefix}__{i}"] = np.asarray(leaf)
    return treedef


def save_checkpoint(path: str, step: int, params, opt_state,
                    frame: np.ndarray | None = None,
                    tile_mask: np.ndarray | None = None,
                    meta: dict | None = None) -> None:
    """meta: optional flat dict of scalar/array metadata saved
    alongside (e.g. a scene fingerprint, accumulated stats counters);
    read back with load_checkpoint_meta."""
    out: dict = {"step": np.asarray(step)}
    _flatten(params, "params", out)
    _flatten(opt_state, "opt", out)
    if frame is not None:
        out["frame"] = np.asarray(frame)
    if tile_mask is not None:
        out["tile_mask"] = np.asarray(tile_mask)
    for k, v in (meta or {}).items():
        out[f"meta__{k}"] = np.asarray(v)
    # np.savez appends ".npz" to a path without it; write to a .tmp
    # sibling and atomically rename over the target.
    tmp = path + ".tmp"
    np.savez(tmp, **out)
    os.replace(tmp + ".npz", path)


def load_checkpoint_meta(path: str) -> dict:
    """The meta dict saved with save_checkpoint (empty if none)."""
    data = np.load(path, allow_pickle=False)
    pre = "meta__"
    return {k[len(pre):]: data[k] for k in data.files if k.startswith(pre)}


def load_checkpoint(path: str, params_like, opt_state_like):
    """Restore into the same pytree structures as the templates.

    The saved treedef string must match the template's: a same-leaf-
    count structural mismatch (renamed/reordered param dict keys across
    code versions) would otherwise silently assign leaves to the wrong
    parameters and resume from corrupted state."""
    data = np.load(path, allow_pickle=False)
    step = int(data["step"])

    def unflatten(tree_like, prefix):
        leaves, treedef = jax.tree_util.tree_flatten(tree_like)
        saved_def = bytes(data[f"{prefix}__treedef"]).decode()
        if saved_def != str(treedef):
            raise ValueError(
                f"checkpoint {prefix} structure mismatch:\n"
                f"  saved:    {saved_def}\n  template: {treedef}"
            )
        new_leaves = [data[f"{prefix}__{i}"] for i in range(len(leaves))]
        return jax.tree_util.tree_unflatten(treedef, new_leaves)

    params = unflatten(params_like, "params")
    opt_state = unflatten(opt_state_like, "opt")
    frame = data["frame"] if "frame" in data else None
    tile_mask = data["tile_mask"] if "tile_mask" in data else None
    return step, params, opt_state, frame, tile_mask
