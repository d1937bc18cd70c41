import os

# Virtual 8-device CPU mesh for sharding tests; must be set before the
# first jax import in the test process.
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)

import jax  # noqa: E402

# Tests always run on the host CPU (kernels in Pallas interpret mode),
# whatever accelerator the machine has.
jax.config.update("jax_platforms", "cpu")

import shutil  # noqa: E402

import pytest  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REFERENCE = os.environ.get("REFERENCE_DIR", os.path.join(REPO, "reference"))


@pytest.fixture(scope="session")
def workspace(tmp_path_factory):
    """Scene files reference assets relative to the cwd (same contract
    as the reference binary); build a workspace with the shared asset
    layout and chdir into it for the golden tests."""
    ws = tmp_path_factory.mktemp("ws")
    inp = ws / "input"
    inp.mkdir()
    for name in ("objects", "skybox"):
        src = os.path.join(REFERENCE, "input", name)
        if os.path.isdir(src):
            # Real directory with per-FILE symlinks (not a dir symlink):
            # a test that writes a generated asset under input/<name>/
            # must land in the tmp workspace, never through a symlink
            # into the read-only reference tree.
            sub = inp / name
            sub.mkdir()
            for fn in os.listdir(src):
                (sub / fn).symlink_to(os.path.join(src, fn))
    maps_src = os.path.join(REPO, "tests", "assets", "maps")
    shutil.copytree(maps_src, inp / "maps")
    for scene in os.listdir(os.path.join(REPO, "tests", "scenes")):
        shutil.copy(os.path.join(REPO, "tests", "scenes", scene), ws)
    return ws


@pytest.fixture()
def in_workspace(workspace, monkeypatch):
    monkeypatch.chdir(workspace)
    return workspace
