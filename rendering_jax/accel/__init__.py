from rendering_jax.accel.bvh import FlatBVH, build_bvh

__all__ = ["FlatBVH", "build_bvh"]
