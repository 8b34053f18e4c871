"""Multi-chip ray tracing: framebuffer-row sharding of the ray-traced
render mode (ops/raytrace.py) over an ("fb",) device mesh.

Ray tracing is embarrassingly parallel over PIXELS: the scene/world
replicate (small — triangle soup + atlas), each device traces its own
band of pixel rows, and there are NO collectives at all — the same
shape as the raster path's fb axis (parallel/sharding.py) minus the
winner all-reduce it needs for its tri axis.  The deterministic
soft-shadow jitter is seeded by GLOBAL ray ids, so an N-device frame is
bit-identical to the single-device frame (tested on the CPU mesh).

Cost model: the single-device brute mode is pixels × triangles bound —
fb sharding divides the pixel term by the device count.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from softwarerenderer_tpu.config import RenderParams
from softwarerenderer_tpu.parallel._compat import shard_map_unchecked


def render_frame_raytraced_sharded(scene: Dict, uniforms: Dict,
                                   params: RenderParams, mesh: Mesh,
                                   fragment_shader: Optional[Callable]
                                   = None,
                                   chunk: int = 512,
                                   shadows: bool = True,
                                   shadow_samples: int = 1,
                                   reflections: bool = False,
                                   cluster_cap=0,
                                   cluster_group: int = 64):
    """Ray-trace one frame with pixel rows sharded over mesh axis "fb".

    Returns (color (H, W, 4), depth (H, W)) sharded on rows; H must
    divide by the fb axis size.  Same options and uniforms as
    ops/raytrace.render_frame_raytraced, including the bundle-culled
    acceleration (cluster_cap, ops/rt_accel.py) — the accel build is
    replicated per device (it is traced work over the replicated scene)
    and each band culls against its own tiles, so the speedup composes
    with the fb scale-out.
    """
    from softwarerenderer_tpu.ops import sky as sky_mod
    from softwarerenderer_tpu.ops.raytrace import trace_pixel_rows

    D = mesh.shape["fb"]
    H, W = params.height, params.width
    if H % D:
        raise ValueError(f"height {H} not divisible by fb axis size {D}")

    dirs = sky_mod.pixel_ray_directions(uniforms, W, H, xp=jnp)
    ray_ids = jnp.arange(H * W, dtype=jnp.int32).reshape(H, W)

    def band(scene_rep, uni_rep, dirs_band, ids_band):
        return trace_pixel_rows(scene_rep, uni_rep, params, dirs_band,
                                ids_band, fragment_shader=fragment_shader,
                                chunk=chunk, shadows=shadows,
                                shadow_samples=shadow_samples,
                                reflections=reflections,
                                cluster_cap=cluster_cap,
                                cluster_group=cluster_group)

    fn = shard_map_unchecked(
        band, mesh=mesh,
        in_specs=(P(), P(), P("fb"), P("fb")),
        out_specs=(P("fb"), P("fb")))
    return fn(scene, uniforms, dirs, ray_ids)
