#!/usr/bin/env python
"""Isolate the per-VERTEX cost on the LOD crowd: culling-only vs
+vertex-shade (geometry.shade_vertices over all packed vertices) vs
+masked-vertex compaction candidate.  JSON lines out."""

import json
import os
import sys
import time


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from softwarerenderer_tpu.utils import compile_cache  # noqa: E402

compile_cache.enable_compile_cache()

import numpy as np


def main():
    import jax
    import jax.numpy as jnp
    from softwarerenderer_tpu import RenderParams
    from softwarerenderer_tpu.engine import (Engine, camera_matrices,
                                             scene_fragment_shader,
                                             scene_vertex_shader)
    from softwarerenderer_tpu.models import scene as scene_mod
    from softwarerenderer_tpu.ops import culling, geometry, lod
    from softwarerenderer_tpu.utils import mathlib as ml
    from softwarerenderer_tpu.utils.profiling import timed_frames
    from softwarerenderer_tpu.models.workloads import lod_crowd_instances

    W, H = 3840, 2160
    sc_np = scene_mod.build_scene_buffers(lod_crowd_instances(True))
    sc = jax.device_put(sc_np)
    print(json.dumps({"V": int(sc_np["position"].shape[0]),
                      "T": int(sc_np["indices"].shape[0])}), flush=True)
    params0 = RenderParams(width=W, height=H)
    u0 = dict(Engine(sc, params0).uniforms)
    u0["camera_position"] = np.asarray([0.0, 0.3, 2.0], np.float32)
    u0["far_clip"] = np.float32(200.0)

    def fsum(tree):
        leaves = jax.tree_util.tree_leaves(tree)
        return sum(jnp.sum(l.astype(jnp.float32)) for l in leaves
                   if hasattr(l, "dtype"))

    def cull_only(scene, u):
        view, proj = camera_matrices(u, W, H)
        vp = ml.transform(view, proj, xp=jnp)
        visible = culling.spheres_in_frustum(
            scene["bounds_center"], scene["bounds_radius"],
            scene["mesh_matrices"], vp, xp=jnp)
        tri_mask = jnp.take(visible, scene["tri_mesh_id"])
        tri_mask = tri_mask & lod.lod_tri_mask(scene, u, H, xp=jnp)
        return tri_mask, visible, view, proj

    def shade_full(scene, u):
        tri_mask, visible, view, proj = cull_only(scene, u)
        model_pv = jnp.take(scene["mesh_matrices"],
                            scene["vert_mesh_id"], axis=0)
        uu = dict(u)
        uu.update(model=model_pv, view=view, projection=proj)
        vin = {k: scene[k] for k in ("position", "uv", "normal", "color")}
        vs_out = geometry.shade_vertices(scene_vertex_shader, vin, uu)
        flat = geometry._flatten_varyings(vs_out)
        keep = set(scene_fragment_shader.varyings) | {"clip_position"}
        return {k: v for k, v in flat.items() if k in keep}, tri_mask

    def shade_segbits(scene, u):
        """shade_full with the gather-free bitcast model-matrix broadcast
        (culling.model_matrices_per_vertex) instead of the (V, 4, 4)
        take."""
        tri_mask, visible, view, proj = cull_only(scene, u)
        model_pv = culling.model_matrices_per_vertex(scene, xp=jnp)
        uu = dict(u)
        uu.update(model=model_pv, view=view, projection=proj)
        vin = {k: scene[k] for k in ("position", "uv", "normal", "color")}
        vs_out = geometry.shade_vertices(scene_vertex_shader, vin, uu)
        flat = geometry._flatten_varyings(vs_out)
        keep = set(scene_fragment_shader.varyings) | {"clip_position"}
        return {k: v for k, v in flat.items() if k in keep}, tri_mask

    stages = dict(cull_only=cull_only, shade_full=shade_full,
                  shade_segbits=shade_segbits)
    prev = 0.0
    for name, fn in stages.items():
        jf = jax.jit(lambda s, u, fn=fn: fsum(fn(s, u)))

        def step(i, jf=jf):
            u = dict(u0)
            u["fov_degrees"] = np.float32(90.0 + 0.01 * i)
            return jf(sc, u)

        spf = timed_frames(step, 6)
        ms = spf * 1e3
        print(json.dumps({"stage": name, "ms": round(ms, 2),
                          "delta_ms": round(ms - prev, 2)}), flush=True)
        prev = ms


if __name__ == "__main__":
    main()
