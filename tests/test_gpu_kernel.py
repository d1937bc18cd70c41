"""The compiled intersection kernel on a GPU vs the jnp dense oracle.

These need the card: the `gpu` fixture skips them where JAX's default
device is not a GPU (the test suite pins JAX to the CPU, so under
pytest they always skip). `python chip_smoke.py --phases device,gpu_tests`
runs them on the card, calling each test with its device.

On the card, Triton may contract mul+add into FMA where XLA's dense
oracle does not, so hits may differ at exact ties (either id is right)
and t agrees to a relative 1e-5, not bit for bit.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytestmark = pytest.mark.gpu


@pytest.fixture
def gpu():
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX's default device is {dev.platform}")
    return dev


def _case(n_tris, r, seed):
    from rendering_jax.flagship import procedural_mesh
    from rendering_jax.models.parser import ObjectDef, SceneDef
    from rendering_jax.models.scene import build_scene
    from rendering_jax.models.settings import RenderSettings

    sd = SceneDef(settings=RenderSettings(width=8, height=8))
    obj = ObjectDef("mesh", pos=(0, 0, -3), size=(2, 2, 2), rot=(0, 30, 0),
                    color=(1, 1, 1))
    obj.mesh = procedural_mesh(n_tris, pos=(0, 0, -3), size=(2, 2, 2),
                               seed=seed)
    sd.objects = [obj]
    mesh = build_scene(sd).meshes[0]
    rng = np.random.default_rng(seed)
    ro = rng.normal(0, 2, (r, 3)).astype(np.float32)
    rd = np.float32([0, 0, -3]) + rng.normal(0, 0.6, (r, 3)) - ro
    rd = (rd / np.linalg.norm(rd, axis=1, keepdims=True)).astype(np.float32)
    t_limit = rng.uniform(0.5, 8.0, (r,)).astype(np.float32)
    return mesh, jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(t_limit)


def _agree(t_k, id_k, t_d, id_d):
    """Ids equal up to ties; t equal to 1e-5 relative where both hit. At
    most 2 rays may flip hit/miss: a ray through a shared edge can fall
    in the crack between the two triangles under one rounding only."""
    t_k, id_k, t_d, id_d = map(np.asarray, (t_k, id_k, t_d, id_d))
    tol = 1e-5 * np.maximum(np.abs(t_d), 1.0)
    tie = (id_k >= 0) & (id_d >= 0) & (np.abs(t_k - t_d) <= tol)
    assert (~((id_k == id_d) | tie)).sum() <= 2
    hit = (id_d >= 0) & (id_k >= 0) & ((id_k == id_d) | tie)
    assert (np.abs(t_k - t_d)[hit] <= tol[hit]).all()


@pytest.mark.parametrize("backface_culling", [True, False])
@pytest.mark.parametrize("use_root_filter", [True, False])
def test_compiled_kernel_matches_dense(gpu, backface_culling,
                                       use_root_filter):
    from rendering_jax.ops.bruteforce import bruteforce_mesh
    from rendering_jax.ops.pallas_intersect import bruteforce_mesh_pallas

    mesh, ro, rd, tl = _case(20_000, 5000, seed=1)
    kw = dict(backface_culling=backface_culling,
              use_root_filter=use_root_filter)
    t_k, id_k, _, _ = jax.jit(lambda a, b, c: bruteforce_mesh_pallas(
        mesh, a, b, c, tables=mesh.itables, **kw))(ro, rd, tl)
    t_d, id_d, _, _ = bruteforce_mesh(mesh, ro, rd, tl, **kw)
    assert int(jnp.sum(id_d >= 0)) > 500
    _agree(t_k, id_k, t_d, id_d)


@pytest.mark.parametrize("ray_tile", [32, 64, 256])
def test_compiled_anyhit_and_stats(gpu, ray_tile):
    from rendering_jax.ops.bruteforce import bruteforce_mesh
    from rendering_jax.ops.pallas_intersect import bruteforce_mesh_pallas

    mesh, ro, rd, tl = _case(20_000, 3001, seed=2)
    _, occ, bt, tt = jax.jit(lambda a, b, c: bruteforce_mesh_pallas(
        mesh, a, b, c, tables=mesh.itables, mode="any",
        ray_tile=ray_tile, collect_stats=True))(ro, rd, tl)
    t_c, id_c, _, _ = bruteforce_mesh(mesh, ro, rd)
    occ_d = np.asarray(id_c >= 0) & (np.asarray(t_c) < np.asarray(tl))
    near = np.abs(np.asarray(t_c) - np.asarray(tl)) <= 1e-5 * np.asarray(tl)
    assert (((np.asarray(occ) >= 0) != occ_d) & ~near).sum() <= 2
    assert 0 < float(tt) < 3001 * 20_000 and float(bt) > 0
