"""Profiling — device tracing (SURVEY §5.1).

The reference's only profiling is RAII wall-clock phase timers
(include/timer.h:8-40); utils.timer replicates those. This module adds
`jax.profiler` trace capture around a render, giving XLA/Pallas
op-level device timing.

Usage:
    with trace("traces/render"):
        render(scene)
    find_xplanes("traces/render")  # -> the .xplane.pb capture files

or from the CLI: `python -m rendering_jax scene.scene --trace-dir DIR`.
A capture reads back with `jax.profiler.ProfileData.from_file(path)`.
"""

from __future__ import annotations

import contextlib
import glob
import os


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a `jax.profiler` device trace into `logdir`.

    Wrap the traced region's final values in `jax.block_until_ready`
    inside the context (the CLI does) so async dispatch cannot leak
    device work past `stop_trace`.
    """
    import jax

    os.makedirs(logdir, exist_ok=True)
    jax.profiler.start_trace(logdir)
    try:
        yield logdir
    finally:
        jax.profiler.stop_trace()


def find_xplanes(logdir: str) -> list[str]:
    """The .xplane.pb capture files under a trace dir (newest run last)."""
    return sorted(
        glob.glob(
            os.path.join(logdir, "**", "*.xplane.pb"), recursive=True
        ),
        key=os.path.getmtime,
    )
