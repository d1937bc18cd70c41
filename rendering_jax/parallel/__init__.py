"""Scale-out layer: sharded rendering + multi-host runtime.

Exports are lazy (PEP 562): `rendering_jax.parallel.multihost` must be
importable WITHOUT initializing the XLA backend, because
`jax.distributed.initialize()` has to run before any backend use —
importing `shard` eagerly would materialize jnp constants and spoil
that (see multihost.initialize_distributed).
"""

__all__ = ["make_ray_mesh", "render_scene_sharded", "render_sharded"]


def __getattr__(name):
    if name in __all__:
        from rendering_jax.parallel import shard

        return getattr(shard, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
