"""Measure the ray-traced mode: brute force vs the pair-table bundle
acceleration (ops/rt_accel.py raycast_bundles_*), plus live-pair
statistics to size cluster_cap.

Usage:  python scripts/profile_raytrace.py [--width 640] [--height 400]
            [--frames 8] [--cap N] [--group 64] [--pair-chunk 256]
            [--no-shadows] [--reflections] [--soft N] [--skip-brute]

cluster_cap here is the pair-table budget per bundle on AVERAGE
(pair_cap = cap × n_bundles — see render_frame_raytraced); the printed
live-pair count is what it must cover.  Timing uses the
pipelined methodology (utils.profiling.timed_frames + hard_sync with a
watchdog), not block_until_ready.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from softwarerenderer_tpu.utils import compile_cache  # noqa: E402

compile_cache.enable_compile_cache()

import jax
import jax.numpy as jnp
import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--height", type=int, default=400)
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--cap", type=int, default=0,
                    help="avg clusters per bundle the pair table holds "
                         "(0 = auto from measured live pairs)")
    ap.add_argument("--group", type=int, default=64)
    ap.add_argument("--pair-chunk", type=int, default=256)
    ap.add_argument("--tile", type=int, default=32,
                    help="bundle tile edge (pixels)")
    ap.add_argument("--no-shadows", action="store_true")
    ap.add_argument("--reflections", action="store_true")
    ap.add_argument("--soft", type=int, default=0,
                    help="soft-shadow samples (0 = hard shadow)")
    ap.add_argument("--skip-brute", action="store_true",
                    help="skip the brute baseline (its chunked lax.map "
                         "compiles for minutes at large resolutions)")
    args = ap.parse_args()

    from softwarerenderer_tpu.models import workloads as wl
    from softwarerenderer_tpu import RenderParams
    from softwarerenderer_tpu.engine.renderer import default_frame_uniforms
    from softwarerenderer_tpu.ops import rt_accel, sky as sky_mod
    from softwarerenderer_tpu.ops.raytrace import (
        build_rt_world,
        render_frame_raytraced,
    )
    from softwarerenderer_tpu.utils.profiling import timed_frames

    W, H = args.width, args.height
    scene = jax.device_put(wl.stand_in_scene())
    n_tri = int(scene["indices"].shape[0])
    params = RenderParams(width=W, height=H)
    u = wl.camera_uniforms(default_frame_uniforms(W, H))
    shadows = not args.no_shadows
    if args.soft:
        u["rt_light_radius"] = np.float32(0.25)

    # --- live-pair statistics on the frame path's 16×16 bundles -------
    world = build_rt_world(scene, u)
    accel = rt_accel.build_rt_accel(world, group=args.group)
    dirs = sky_mod.pixel_ray_directions(u, W, H, xp=jnp)
    tw, th = min(args.tile, W), min(args.tile, H)
    hp, Wp = -(-H // th) * th, -(-W // tw) * tw
    d2 = jnp.pad(dirs, ((0, hp - H), (0, Wp - W), (0, 0)), mode="edge")
    tiles = d2.reshape(hp // th, th, Wp // tw, tw, 3).transpose(
        0, 2, 1, 3, 4).reshape(-1, th * tw, 3)
    B = tiles.shape[0]
    eye = jnp.asarray(u["camera_position"], jnp.float32)
    o_t = jnp.broadcast_to(eye, tiles.shape)
    n_pairs = int(rt_accel.bundle_pair_count(
        o_t, tiles, world, accel, tri_mask=world["tri_mask"]))
    nc = accel["n_clusters"]
    print(f"scene: {n_tri} tris, {nc} clusters of {args.group}; "
          f"{B} bundles; primary live pairs {n_pairs} "
          f"({n_pairs / B:.1f}/bundle)")
    cap = args.cap or max(2, int(np.ceil(n_pairs / B * 1.3)))
    print(f"cluster_cap = {cap} (pair table {cap * B})")

    # --- timed frames (pipelined) -------------------------------------
    def run(label, **kw):
        fn = jax.jit(lambda s, uu: render_frame_raytraced(
            s, uu, params, shadows=shadows,
            shadow_samples=max(1, args.soft),
            reflections=args.reflections, pair_chunk=args.pair_chunk,
            pair_tile=(args.tile, args.tile),
            rt_white_colors=True, **kw))    # dust2 has no COLOR_0

        def step(i):
            uu = dict(u)
            uu["fov_degrees"] = np.float32(90.0 + 0.001 * i)
            return fn(scene, uu)

        spf = timed_frames(step, args.frames, timeout_s=900)
        print(f"{label:28s} {spf * 1e3:8.2f} ms/frame "
              f"({1.0 / spf:6.1f} fps)", flush=True)
        c, d = fn(scene, u)
        return spf, np.asarray(c), np.asarray(d)

    tc, cc, dc = run("pair-table bundles",
                     cluster_cap=cap, cluster_group=args.group)
    if not args.skip_brute:
        tb, cb, db = run("brute force")
        same_cov = ((db == dc) | (np.abs(db - dc) < 1e-5)).mean()
        cdiff = np.abs(cb - cc).max()
        print(f"speedup {tb / tc:.2f}x; depth agreement "
              f"{same_cov * 100:.2f}%; max color diff {cdiff:.4f}")


if __name__ == "__main__":
    main()
