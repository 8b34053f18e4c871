#!/usr/bin/env python
"""Binning statistics for the LOD crowd scene: how many triangles
go GLOBAL (span > span_cap → folded by EVERY tile), live pair counts, and
segment-length distribution.  Evidence for the round-3 wide-triangle
row-binning work.

Usage: python scripts/profile_bin_stats.py [--width 3840 --height 2160]
"""

import argparse
import json
import os
import sys


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from softwarerenderer_tpu.utils import compile_cache  # noqa: E402

compile_cache.enable_compile_cache()

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--width", type=int, default=3840)
    ap.add_argument("--height", type=int, default=2160)
    ap.add_argument("--scene", choices=["crowd", "dust2"], default="crowd")
    ap.add_argument("--cap-mode", choices=["none", "tight"], default="tight")
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

    W, H = args.width, args.height
    params = RenderParams(width=W, height=H)

    if args.scene == "crowd":
        from softwarerenderer_tpu.models.workloads import (
            lod_crowd_instances)
        insts = lod_crowd_instances(True)
    else:
        from softwarerenderer_tpu.io_host import model_loader
        model = model_loader.load_model(
            "/root/reference/OutputAssets/Assets/dust2/scene.gltf")
        insts = model_loader.model_instances(model)
    sc_np = scene_mod.build_scene_buffers(insts)
    sc = jax.device_put(sc_np)
    u0 = dict(Engine(sc, params).uniforms)
    u0["camera_position"] = np.asarray([0.0, 0.3, 2.0], np.float32)
    u0["far_clip"] = np.float32(200.0)
    u0["fov_degrees"] = np.float32(90.0)

    def prep(scene, u):
        view, proj = camera_matrices(u, W, H)
        vp = ml.transform(view, proj, xp=jnp)
        visible = culling.spheres_in_frustum(
            scene["bounds_center"], scene["bounds_radius"],
            scene["mesh_matrices"], vp, xp=jnp)
        tri_mask = jnp.take(visible, scene["tri_mesh_id"])
        if "tri_lod_level" in scene:
            tri_mask = tri_mask & lod.lod_tri_mask(scene, u, H, xp=jnp)
        model_pv = jnp.take(scene["mesh_matrices"],
                            scene["vert_mesh_id"], axis=0)
        uu = dict(u)
        uu.update(model=model_pv, view=view, projection=proj)
        vin = {k: scene[k] for k in ("position", "uv", "normal", "color")}
        return geometry.build_triangles(
            scene_vertex_shader, vin, scene["indices"], uu, width=W,
            height=H, cull_mode=params.cull_mode,
            near_clip=uu["near_clip"], tri_mask=tri_mask,
            keep_varyings=scene_fragment_shader.varyings)

    tris = jax.jit(prep)(sc, u0)
    if args.cap_mode == "tight" and "tri_lod_level" in sc_np:
        host = {k: np.asarray(v) for k, v in sc.items()}
        active = int(np.sum(lod.lod_tri_mask(host, u0, H, xp=np)))
        cap = -(-int(2 * active * 1.25) // 128) * 128
        tris, _, _ = jax.jit(
            lambda t: geometry.compact_triangles(t, cap, None))(tris)
    bbox = np.asarray(tris["bbox"])
    valid = np.asarray(tris["valid"])
    th, tw, span_cap = params.tile_h, params.tile_w, params.span_cap
    tx0 = bbox[:, 0] // tw
    ty0 = np.clip(bbox[:, 1], 0, H - 1) // th
    tx1 = bbox[:, 2] // tw
    ty1 = np.clip(bbox[:, 3], 0, H - 1) // th
    span_w = tx1 - tx0 + 1
    span_h = ty1 - ty0 + 1
    span = (span_w * span_h)[valid]
    n_valid = int(valid.sum())
    n_global = int((span > span_cap).sum())
    binned = span[span <= span_cap]
    ntx, nty = -(-W // tw), -(-H // th)
    print(json.dumps({
        "scene": args.scene, "n_slots": int(valid.shape[0]),
        "n_valid": n_valid, "n_global": n_global,
        "global_frac": round(n_global / max(n_valid, 1), 4),
        "live_pairs": int(binned.sum()),
        "pair_table": int(valid.shape[0] * span_cap),
        "ntiles": ntx * nty,
        "global_subchunk_evals_all_tiles":
            int(ntx * nty * -(-n_global // 32)),
        "span_hist": {str(s): int((span == s).sum())
                      for s in range(1, span_cap + 1)},
        "span_gt_cap_hist_w":
            {str(s): int((span_w[valid][span > span_cap] == s).sum())
             for s in range(1, 12)},
        "span_gt_cap_hist_h":
            {str(s): int((span_h[valid][span > span_cap] == s).sum())
             for s in range(1, 12)},
    }), flush=True)


if __name__ == "__main__":
    main()
