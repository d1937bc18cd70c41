"""rendering_jax — a differentiable Whitted raytracer in JAX.

Built from scratch in JAX/XLA/Pallas with capability parity with the
holoskii/Rendering C++ engine (SURVEY.md maps it). The compute path is a
wavefront renderer: all rays of a bounce live as struct-of-arrays batches,
each bounce is one fused traced pass (traverse -> shade -> spawn), and the
whole pipeline is a pure function of a Scene pytree so `jax.grad` works
end-to-end. Scale-out is `shard_map` over a `jax.sharding.Mesh` with rays
sharded across chips and the scene replicated.

Layering (mirrors SURVEY.md section 1, re-designed for an accelerator):
  L7 CLI          rendering_jax.cli
  L6 scene/config rendering_jax.models (parser, objloader, scene pytree)
  L5 orchestrator rendering_jax.render.pipeline + rendering_jax.parallel
  L4 integrator   rendering_jax.render.integrator (wavefront bounce loop)
  L3 geometry     rendering_jax.ops (intersect, traversal, shading, skybox)
     + accel      rendering_jax.accel (host-side SAH BVH build -> flat arrays)
  L2 math         jnp arrays; no Vec3f class (SoA (N,3) everywhere)
  L1 io/obs       rendering_jax.utils (BMP codec, timers, stats)
"""

from rendering_jax.version import __version__

__all__ = ["__version__"]
