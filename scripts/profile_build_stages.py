#!/usr/bin/env python
"""Bisect build_triangles(defer_attrs=True) on the LOD crowd: cumulative
jits of its internal phases so consecutive deltas attribute the ~150 ms
profile_defer_stages.py charges to the whole call.  JSON lines out."""

import argparse
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
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--width", type=int, default=3840)
    ap.add_argument("--height", type=int, default=2160)
    ap.add_argument("--stages", default=None)
    args = ap.parse_args()

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

    W, H = args.width, args.height
    sc_np = scene_mod.build_scene_buffers(lod_crowd_instances(True))
    sc = jax.device_put(sc_np)
    params0 = RenderParams(width=W, height=H)
    u0 = dict(Engine(sc, params0).uniforms)
    u0["camera_position"] = np.asarray([0.0, 0.3, 2.0], np.float32)
    u0["far_clip"] = np.float32(200.0)

    def fsum(tree):
        leaves = jax.tree_util.tree_leaves(tree)
        return sum(jnp.sum(l.astype(jnp.float32)) for l in leaves
                   if hasattr(l, "dtype"))

    def pre(scene, u):
        view, proj = camera_matrices(u, W, H)
        vp = ml.transform(view, proj, xp=jnp)
        visible = culling.spheres_in_frustum(
            scene["bounds_center"], scene["bounds_radius"],
            scene["mesh_matrices"], vp, xp=jnp)
        tri_mask = jnp.take(visible, scene["tri_mesh_id"])
        tri_mask = tri_mask & lod.lod_tri_mask(scene, u, H, xp=jnp)
        model_pv = jnp.take(scene["mesh_matrices"],
                            scene["vert_mesh_id"], axis=0)
        uu = dict(u)
        uu.update(model=model_pv, view=view, projection=proj)
        vin = {k: scene[k] for k in ("position", "uv", "normal", "color")}
        vs_out = geometry.shade_vertices(scene_vertex_shader, vin, uu)
        flat = geometry._flatten_varyings(vs_out)
        keep = set(scene_fragment_shader.varyings) | {"clip_position"}
        flat = {k: v for k, v in flat.items() if k in keep}
        idx3 = jnp.asarray(scene["indices"], jnp.int32).reshape(-1, 3)
        return flat, idx3, tri_mask, uu

    def a_assemble(scene, u):
        flat, idx3, tri_mask, uu = pre(scene, u)
        return {"clip_position": jnp.take(flat["clip_position"], idx3,
                                          axis=0)}

    def b_clip(scene, u):
        flat, idx3, tri_mask, uu = pre(scene, u)
        attrs = {"clip_position": jnp.take(flat["clip_position"], idx3,
                                           axis=0)}
        out = geometry.clip_triangles(attrs, uu["near_clip"],
                                      return_sources=True)
        return out

    def c_mask(scene, u):
        flat, idx3, tri_mask, uu = pre(scene, u)
        attrs = {"clip_position": jnp.take(flat["clip_position"], idx3,
                                           axis=0)}
        attrs2, valid, srcs = geometry.clip_triangles(
            attrs, uu["near_clip"], return_sources=True)
        valid = valid & jnp.repeat(jnp.asarray(tri_mask, bool), 2)
        return attrs2, valid, srcs

    def d_setup(scene, u):
        attrs2, valid, srcs = c_mask(scene, u)
        tris = geometry.setup_triangles(attrs2, valid, W, H,
                                        params0.cull_mode)
        return tris, srcs

    def e_full(scene, u):
        flat, idx3, tri_mask, uu = pre(scene, u)
        vin = {k: scene[k] for k in ("position", "uv", "normal", "color")}
        tris = geometry.build_triangles(
            scene_vertex_shader, vin, scene["indices"], uu, width=W,
            height=H, cull_mode=params0.cull_mode,
            near_clip=uu["near_clip"], tri_mask=tri_mask,
            keep_varyings=scene_fragment_shader.varyings,
            defer_attrs=True)
        return tris

    stages = dict(a_assemble=a_assemble, b_clip=b_clip, c_mask=c_mask,
                  d_setup=d_setup, e_full=e_full)
    only = set(args.stages.split(",")) if args.stages else None
    prev = 0.0
    for name, fn in stages.items():
        if only is not None and name not in only:
            continue
        jf = jax.jit(lambda s, u, fn=fn: fsum(fn(s, u)))
        t0 = time.time()

        def step(i, jf=jf):
            u = dict(u0)
            u["fov_degrees"] = np.float32(90.0 + 0.01 * i)
            return jf(sc, u)

        spf = timed_frames(step, args.frames)
        ms = spf * 1e3
        print(json.dumps({"stage": name, "ms": round(ms, 2),
                          "delta_ms": round(ms - prev, 2),
                          "compile_s": round(
                              time.time() - t0 - spf * args.frames, 1)}),
              flush=True)
        prev = ms


if __name__ == "__main__":
    main()
