#!/usr/bin/env python
"""What is the per-dispatch floor made of?  Times a trivial jit on the
4K-crowd scene three ways: (a) scene passed as an argument, (b) scene
closed over (device constants), (c) uniforms-only.  JSON lines out."""

import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from softwarerenderer_tpu.utils import compile_cache  # noqa: E402

compile_cache.enable_compile_cache()

import numpy as np


def main():
    import jax
    import jax.numpy as jnp
    from softwarerenderer_tpu.models import scene as scene_mod
    from softwarerenderer_tpu.utils.profiling import timed_frames
    from softwarerenderer_tpu.models.workloads import lod_crowd_instances

    sc = jax.device_put(
        scene_mod.build_scene_buffers(lod_crowd_instances(True)))
    n_leaves = len(jax.tree_util.tree_leaves(sc))
    tot_mb = sum(l.nbytes for l in jax.tree_util.tree_leaves(sc)) / 1e6
    print(json.dumps({"leaves": n_leaves, "mb": round(tot_mb, 1)}),
          flush=True)

    def fsum(tree):
        return sum(jnp.sum(l.astype(jnp.float32))
                   for l in jax.tree_util.tree_leaves(tree)
                   if hasattr(l, "dtype"))

    u0 = {"fov": np.float32(90.0)}

    ja = jax.jit(lambda s, u: fsum(s) * u["fov"])
    jb = jax.jit(lambda u: fsum(sc) * u["fov"])
    jc = jax.jit(lambda u: u["fov"] * 2.0)

    for name, step in (
        ("scene_as_arg", lambda i: ja(sc, {"fov": np.float32(90 + i)})),
        ("scene_closed_over", lambda i: jb({"fov": np.float32(90 + i)})),
        ("uniforms_only", lambda i: jc({"fov": np.float32(90 + i)})),
    ):
        ms = timed_frames(step, 10) * 1e3
        print(json.dumps({"case": name, "ms": round(ms, 3)}), flush=True)


if __name__ == "__main__":
    main()
