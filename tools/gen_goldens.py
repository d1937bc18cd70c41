"""Golden-image generation harness.

Builds the C++ reference (sources read from $REFERENCE_DIR, artifacts
kept strictly inside this repo), sets up a workspace with asset
symlinks + synthesized maps, renders every scene in tests/scenes/ with
the reference binary, and copies the BMPs into tests/goldens/.

Run: python tools/gen_goldens.py
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REFERENCE = os.environ.get("REFERENCE_DIR", os.path.join(REPO, "reference"))
GOLDEN_DIR = os.path.join(REPO, ".golden")
BINARY = os.path.join(GOLDEN_DIR, "RayTracing")
WS = os.path.join(GOLDEN_DIR, "ws")


def build_reference(ssaa: bool = True) -> str:
    """Compile the reference directly with g++ (its CMakeLists writes
    into the reference tree, which we must not touch).

    ssaa=False builds a second binary from a patched COPY of the tree
    with `options::enableSSAA = false` (options.h:36 — a compile-time
    global the scene grammar cannot override). The FD gradient tests
    use it: the Sobel mask flips discontinuously under scene
    perturbations, while jax.grad differentiates with the mask held
    fixed, so SSAA must be off on BOTH sides for a clean FD check."""
    binary = BINARY if ssaa else BINARY + "_nossaa"
    if os.path.exists(binary):
        return binary
    os.makedirs(GOLDEN_DIR, exist_ok=True)
    src_root = REFERENCE
    if not ssaa:
        src_root = os.path.join(GOLDEN_DIR, "ref_nossaa")
        if not os.path.isdir(src_root):
            for d in ("src", "include"):
                shutil.copytree(
                    os.path.join(REFERENCE, d), os.path.join(src_root, d),
                    dirs_exist_ok=True,
                )
            opts = os.path.join(src_root, "include", "options.h")
            with open(opts) as f:
                text = f.read()
            patched = text.replace(
                "inline bool enableSSAA\t\t\t\t= true;",
                "inline bool enableSSAA\t\t\t\t= false;",
            )
            assert patched != text, "options.h enableSSAA line not found"
            with open(opts, "w") as f:
                f.write(patched)
    srcs = sorted(
        os.path.join(src_root, "src", f)
        for f in os.listdir(os.path.join(src_root, "src"))
        if f.endswith(".cpp")
    )
    cmd = [
        "g++", "-O2", "-std=c++17",
        "-I", os.path.join(src_root, "include"),
        *srcs, "-o", binary, "-pthread",
    ]
    subprocess.run(cmd, check=True)
    return binary


def setup_workspace() -> str:
    os.makedirs(WS, exist_ok=True)
    inp = os.path.join(WS, "input")
    os.makedirs(inp, exist_ok=True)
    for name in ("objects", "skybox"):
        link = os.path.join(inp, name)
        if not os.path.exists(link):
            os.symlink(os.path.join(REFERENCE, "input", name), link)
    maps_src = os.path.join(REPO, "tests", "assets", "maps")
    maps_dst = os.path.join(inp, "maps")
    if os.path.isdir(maps_dst):
        shutil.rmtree(maps_dst)
    shutil.copytree(maps_src, maps_dst)
    os.makedirs(os.path.join(WS, "golden"), exist_ok=True)
    return WS


def main() -> int:
    build_reference()
    setup_workspace()
    scenes_dir = os.path.join(REPO, "tests", "scenes")
    out_dir = os.path.join(REPO, "tests", "goldens")
    os.makedirs(out_dir, exist_ok=True)
    only = sys.argv[1:] or None
    for scene in sorted(os.listdir(scenes_dir)):
        if not scene.endswith(".scene"):
            continue
        if only and not any(o in scene for o in only):
            continue
        shutil.copy(os.path.join(scenes_dir, scene), WS)
        name = scene[:-6]
        print(f"rendering {name} ...", flush=True)
        subprocess.run(
            [BINARY, scene], cwd=WS, check=True,
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
        )
        src = os.path.join(WS, "golden", f"{name}.bmp")
        if not os.path.exists(src):
            print(f"  MISSING OUTPUT for {name}", file=sys.stderr)
            return 1
        shutil.copy(src, os.path.join(out_dir, f"{name}.bmp"))
        print(f"  -> tests/goldens/{name}.bmp")
    return 0


if __name__ == "__main__":
    sys.exit(main())
