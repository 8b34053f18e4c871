"""Ray-traced render mode: primary visibility + hard shadow rays, built
on the batched Möller–Trumbore kernel (sim/raycast.py).

A capability far beyond the reference (its Physics.cs raycasts are
gameplay-only; rendering is pure rasterization): every pixel casts a
primary ray through the same camera model as the rasterizer
(sky.pixel_ray_directions — integer pixel centers, .NET vertical-FOV
perspective), hits shade through the SAME user fragment-shader ABI as
the raster path (uv/color/world_normal varyings interpolated at the
hit's barycentrics, atlas regions resolved per triangle), and optional
secondary rays toward the light give geometrically exact hard shadows —
no shadow-map resolution artifacts.

Shape: rays × triangles evaluate as chunked (C, T) tensor ops inside one
jitted program (`lax.map` over ray chunks bounds peak memory at C·T);
the brute path has no BVH, since T here is scene-sized (10⁴), not
film-sized.  Its cost scales as pixels × triangles: a quality /
ground-truth mode.  ``cluster_cap`` switches to the bundle-culled pair
sweep (ops/rt_accel.py), the interactive path.

Outputs match the raster conventions: depth = −(ndcZ+1)/2 at the hit
(the device raster's negated-reversed convention, directly comparable
with its buffer), misses carry DEPTH_CLEAR and show the sky panorama
(when present) or the clear color.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from softwarerenderer_tpu.config import RenderParams
from softwarerenderer_tpu.ops.raster import DEPTH_CLEAR
import importlib

# sim/__init__ re-exports the `raycast` FUNCTION under the submodule's
# name, so a plain `import ...sim.raycast as rc` binds the function.
rc = importlib.import_module("softwarerenderer_tpu.sim.raycast")
from softwarerenderer_tpu.utils import mathlib as ml

F32 = jnp.float32


def build_rt_world(scene: Dict, uniforms: Dict) -> Dict:
    """Collision world + the per-corner shading attributes the raster
    payload would carry: uv, vertex color, and the triangle's atlas
    region (base mip).  Frustum/app visibility folds into `tri_mask`."""
    world = rc.build_collision_world(scene)
    idx = jnp.asarray(scene["indices"], jnp.int32)
    uv = jnp.take(jnp.asarray(scene["uv"], F32), idx, axis=0)
    col = jnp.take(jnp.asarray(scene["color"], F32), idx, axis=0)
    tid = jnp.asarray(scene["tri_texture_id"], jnp.int32)
    aoff = jnp.asarray(scene["atlas_offsets"], jnp.int32)
    asiz = jnp.asarray(scene["atlas_sizes"], jnp.int32)
    mask = None
    if "mesh_visible" in uniforms:
        mask = jnp.take(jnp.asarray(uniforms["mesh_visible"], bool),
                        world["tri_mesh_id"])
    world.update(
        uv=uv, color=col,
        tex_oy=jnp.take(aoff[:, 0], tid), tex_ox=jnp.take(aoff[:, 1], tid),
        tex_h=jnp.take(asiz[:, 0], tid), tex_w=jnp.take(asiz[:, 1], tid),
        tri_mask=mask)
    # ONE flat (T, 22) shading table: uv corners | atlas region | color
    # corners.  Per-ray attribute reconstruction then costs a single
    # row-gather instead of six separate takes.  Region ints are exact
    # in f32 (atlas dims ≪ 2^24).
    world["shade_table"] = jnp.concatenate([
        uv.reshape(-1, 6),
        jnp.stack([world["tex_oy"], world["tex_ox"],
                   world["tex_h"], world["tex_w"]], axis=1).astype(F32),
        col.reshape(-1, 12),
    ], axis=1)
    # Same trick for the winner-geometry reconstruction inside the
    # bundle-cast wrappers (rt_accel pair paths): v0 | e1 |
    # e2 | n0 | n1 | n2 as one (T, 18) row-gather instead of six takes.
    world["geom_table"] = jnp.concatenate([
        world["v0"], world["v1"] - world["v0"], world["v2"] - world["v0"],
        world["n0"], world["n1"], world["n2"]], axis=1)
    return world


def _shade_hits(hits: Dict, world: Dict, uniforms: Dict,
                view, proj, fragment_shader: Callable,
                white_colors: bool = False):
    """Build the raster-ABI frag dict at each hit and run the user
    fragment shader; returns (rgba (R, 4), depth (R,)).

    Gathers cost per element, so this pass reuses
    the cast's barycentrics when the hits dict carries "u"/"v" (the
    bundle-cast paths export them) instead of re-gathering the 9 corner
    elements per ray to re-derive them; white_colors=True additionally
    skips the 12-element-per-ray vertex-color gather for scenes whose
    colors are known all-white (the loader default when a model has no
    COLOR_0 — e.g. dust2)."""
    tri = hits["tri"]
    if "u" in hits and "v" in hits:
        u, v = hits["u"], hits["v"]
    else:
        # Recover the winner's barycentrics from the smooth data:
        # re-derive u/v by projecting the hit point into the triangle's
        # edge basis.
        v0 = jnp.take(world["v0"], tri, axis=0)
        e1 = jnp.take(world["v1"], tri, axis=0) - v0
        e2 = jnp.take(world["v2"], tri, axis=0) - v0
        p = hits["point"] - v0
        d11 = ml.dot(e1, e1, xp=jnp)
        d12 = ml.dot(e1, e2, xp=jnp)
        d22 = ml.dot(e2, e2, xp=jnp)
        dp1 = ml.dot(p, e1, xp=jnp)
        dp2 = ml.dot(p, e2, xp=jnp)
        den = d11 * d22 - d12 * d12
        den = jnp.where(den == 0, F32(1), den)
        u = (d22 * dp1 - d12 * dp2) / den
        v = (d11 * dp2 - d12 * dp1) / den
    w = F32(1.0) - u - v
    bary = jnp.stack([w, u, v], axis=-1)[..., None]             # (R, 3, 1)

    if "shade_table" in world:
        # One wide row-gather for every per-triangle attribute (table
        # built in build_rt_world); the interpolation math below is the
        # same sum-over-bary expression as the separate-takes path.
        tbl = jnp.take(world["shade_table"], tri, axis=0)       # (R, 22)
        uv = jnp.sum(tbl[:, 0:6].reshape(-1, 3, 2) * bary, axis=1)
        region = {k: tbl[:, 6 + i].astype(jnp.int32)
                  for i, k in enumerate(("tex_oy", "tex_ox",
                                         "tex_h", "tex_w"))}
        if white_colors:
            col = jnp.ones(uv.shape[:-1] + (4,), F32)
        else:
            col = jnp.sum(tbl[:, 10:22].reshape(-1, 3, 4) * bary,
                          axis=1)
    else:
        uv = jnp.sum(jnp.take(world["uv"], tri, axis=0) * bary, axis=1)
        region = {k: jnp.take(world[k], tri, axis=0)
                  for k in ("tex_oy", "tex_ox", "tex_h", "tex_w")}
        if white_colors:
            col = jnp.ones(uv.shape[:-1] + (4,), F32)
        else:
            col = jnp.sum(jnp.take(world["color"], tri, axis=0) * bary,
                          axis=1)

    clip = ml.transform(
        ml.transform(ml.homogenize(hits["point"], xp=jnp), view, xp=jnp),
        proj, xp=jnp)                                           # (R, 4)
    wc = clip[..., 3]
    ndc_z = clip[..., 2] / jnp.where(wc == 0, F32(1), wc)
    # The device raster stores the NEGATED (ndcZ+1)/2 so its (depth,
    # index) max-fold picks the nearest fragment (ops/raster.py); match
    # that so ray-traced depth buffers compose with every consumer.
    # Exact agreement is expected off-edge: ndc z is screen-affine on a
    # planar triangle, so the raster's screen-linear vertex lerp equals
    # the analytic value at the hit.
    depth = -((ndc_z + F32(1.0)) * F32(0.5))

    frag = {
        "uv": uv,
        "color": col,
        "clip_position": clip,
        "normal": hits["normal"],
        "data": {"world_normal": hits["normal"]},
        "tri": region,
    }
    rgba = fragment_shader(frag, uniforms, jnp)
    return rgba, depth


def render_frame_raytraced(scene: Dict, uniforms: Dict,
                           params: RenderParams,
                           vertex_shader: Optional[Callable] = None,
                           fragment_shader: Optional[Callable] = None,
                           chunk: int = 512, shadows: bool = True,
                           shadow_samples: int = 1,
                           reflections: bool = False,
                           cluster_cap: int = 0,
                           cluster_group: int = 64,
                           pair_chunk: int = 256,
                           pair_tile=(32, 32),
                           rt_white_colors: bool = False):
    """Engine-compatible frame function (`Engine(scene, params,
    frame_fn=render_frame_raytraced)`): returns (color (H, W, 4),
    depth (H, W)).

    vertex_shader is accepted for signature compatibility and ignored —
    primary rays ARE the camera transform (a custom vertex program that
    displaces clip positions has no ray-space equivalent here; morph/
    skin/flip-book vertex updates likewise don't apply).  `chunk` is the
    rays-per-step bound: peak memory scales as chunk × triangles.
    shadows: secondary rays per hit toward -light_direction; occluded
    hits fall toward uniforms["rt_shadow_floor"] (default 0.35) of
    their shaded color — geometrically exact shadows.  shadow_samples
    with uniforms["rt_light_radius"] > 0 jitters the rays over a disc
    light for SOFT shadows (penumbrae) — the per-pixel jitter is a
    deterministic integer hash, so frames are reproducible and carry no
    PRNG state.  reflections: one mirror bounce at the smooth normal,
    shaded with the same fragment shader (misses show the sky/clear
    environment), mixed by uniforms["rt_reflectivity"] (default 0.25).

    cluster_cap > 0 enables bundle-culled acceleration (ops/rt_accel.py
    pair-table path): the frame becomes 16×16-px ray bundles, the live
    (bundle, cluster) pairs compact to one static table of size
    max(cluster_cap) × n_bundles, and chunked dense Möller–Trumbore
    sweeps (pair_chunk pairs per step) evaluate primary / shadow /
    reflection passes — work ∝ live pairs, dense blocks, with a
    lax.cond brute-force fallback on table overflow — exact for any cap
    (winner identity identical; floats to fp tolerance, see rt_accel
    docstring).  Size cluster_cap from rt_accel.bundle_pair_count /
    n_bundles on representative frames (it is the AVERAGE survivors per
    bundle the table can hold, not a per-bundle bound).
    """
    from softwarerenderer_tpu.ops import sky as sky_mod

    H, W = params.height, params.width
    dirs = sky_mod.pixel_ray_directions(uniforms, W, H, xp=jnp)
    ray_ids = jnp.arange(H * W, dtype=jnp.int32).reshape(H, W)
    return trace_pixel_rows(scene, uniforms, params, dirs, ray_ids,
                            fragment_shader=fragment_shader, chunk=chunk,
                            shadows=shadows,
                            shadow_samples=shadow_samples,
                            reflections=reflections,
                            cluster_cap=cluster_cap,
                            cluster_group=cluster_group,
                            pair_chunk=pair_chunk,
                            pair_tile=pair_tile,
                            rt_white_colors=rt_white_colors)


def trace_pixel_rows(scene: Dict, uniforms: Dict, params: RenderParams,
                     dirs, ray_ids, *,
                     fragment_shader: Optional[Callable] = None,
                     chunk: int = 512, shadows: bool = True,
                     shadow_samples: int = 1,
                     reflections: bool = False,
                     cluster_cap: int = 0,
                     cluster_group: int = 64,
                     pair_chunk: int = 256,
                     pair_tile=(32, 32),
                     rt_white_colors: bool = False):
    """Trace an arbitrary (h, W) block of pixel rays — the shard-friendly
    core of render_frame_raytraced.  `dirs` (h, W, 3) are world ray
    directions (sky.pixel_ray_directions rows), `ray_ids` (h, W) the
    GLOBAL ray indices (they seed the deterministic soft-shadow jitter,
    so a sharded frame reproduces the single-device image bit-for-bit).
    The camera view/projection come from `uniforms` + params (full-frame
    camera — independent of which rows this call owns).  Returns
    (color (h, W, 4), depth (h, W)) with background composited.
    """
    from softwarerenderer_tpu.engine.renderer import (
        camera_matrices,
        scene_fragment_shader,
    )
    from softwarerenderer_tpu.ops import sky as sky_mod

    fragment_shader = fragment_shader or scene_fragment_shader
    W = params.width
    h = dirs.shape[0]
    view, proj = camera_matrices(uniforms, W, params.height)

    u = dict(uniforms)
    u.update(atlas_data=scene["atlas_data"],
             atlas_offsets=scene["atlas_offsets"],
             atlas_sizes=scene["atlas_sizes"])

    world = build_rt_world(scene, uniforms)
    tri_mask = world["tri_mask"]

    use_accel = (tuple(cluster_cap)
                 if isinstance(cluster_cap, (tuple, list))
                 else ((cluster_cap,) if cluster_cap else ()))

    def cast(o, dd):
        return rc.raycast_batch(o, dd, world,
                                face_mask=rc.FACE_MASK_NONE,
                                tri_mask=tri_mask)

    eye = jnp.asarray(uniforms["camera_position"], F32)
    dirs_flat = jnp.asarray(dirs, F32).reshape(-1, 3)
    ids_flat = jnp.asarray(ray_ids, jnp.int32).reshape(-1)
    n_rays = h * W
    pad = (-n_rays) % chunk
    dirs_pad = jnp.pad(dirs_flat, ((0, pad), (0, 0)),
                       constant_values=1.0)
    ids_pad = jnp.pad(ids_flat, (0, pad))
    light = ml.safe_normalize(
        jnp.asarray(uniforms["light_direction"], F32), xp=jnp)
    floor = jnp.asarray(uniforms.get("rt_shadow_floor", 0.35), F32)
    sradius = jnp.asarray(uniforms.get("rt_light_radius", 0.0), F32)
    refl_amt = jnp.asarray(uniforms.get("rt_reflectivity", 0.25), F32)
    # Orthonormal basis around the light direction for area-light jitter.
    helper = jnp.where(jnp.abs(light[0]) < 0.9,
                       jnp.asarray([1.0, 0.0, 0.0], F32),
                       jnp.asarray([0.0, 1.0, 0.0], F32))
    lt1 = ml.safe_normalize(ml.cross(light, helper, xp=jnp), xp=jnp)
    lt2 = ml.cross(light, lt1, xp=jnp)

    def _background(d):
        if "sky_panorama" in uniforms:
            return sky_mod.sample_panorama(uniforms["sky_panorama"], d,
                                           xp=jnp)
        return jnp.broadcast_to(jnp.asarray(uniforms["clear_color"], F32),
                                d.shape[:-1] + (4,))

    def _shadow_dir(ray_id, s):
        """Deterministic disc-light jitter direction for flat (N,) ray
        ids at sample s — shared by the brute and pair paths so both
        produce identical shadow rays.  xorshift-style integer mix: a
        bare multiplicative hash leaves row-correlated low bits (visible
        striping in penumbrae); two shift-xor rounds decorrelate them."""
        hh = ray_id * jnp.int32(-1640531535) + jnp.int32(40503 * (s + 1))
        hh = hh ^ (hh >> 13)
        hh = hh * jnp.int32(-1028477387)               # 0xc2b2ae35 as i32
        hh = hh ^ (hh >> 16)
        a = (hh & jnp.int32(0x7FFFFF)).astype(F32) \
            * F32(2 * np.pi / 0x800000)
        r = jnp.sqrt(((hh >> 8) & 0xFFFF).astype(F32) / F32(0xFFFF))
        jx = jnp.cos(a) * r
        jy = jnp.sin(a) * r
        return ml.safe_normalize(
            -light[None] + (jx[:, None] * lt1[None]
                            + jy[:, None] * lt2[None]) * sradius, xp=jnp)

    def trace_chunk(args):
        d, ray_id = args
        o = jnp.broadcast_to(eye, d.shape)
        hits = cast(o, d)
        rgba, depth = _shade_hits(hits, world, u, view, proj,
                                  fragment_shader,
                                  white_colors=rt_white_colors)
        off = hits["point"] + hits["normal"] * F32(1e-3)
        if reflections:
            # One mirror bounce: reflect the view ray at the smooth
            # normal, shade the reflected hit with the same shader
            # (misses show the environment), mix by rt_reflectivity.
            n = hits["normal"]
            rdir = d - F32(2.0) * ml.dot(d, n, xp=jnp)[:, None] * n
            rh = cast(off, rdir)
            rrgba, _ = _shade_hits(rh, world, u, view, proj,
                                   fragment_shader,
                                   white_colors=rt_white_colors)
            refl = jnp.where(rh["hit"][:, None], rrgba, _background(rdir))
            rgba = jnp.concatenate(
                [rgba[..., :3] + (refl[..., :3] - rgba[..., :3])
                 * refl_amt, rgba[..., 3:]], axis=-1)
        if shadows:
            # shadow_samples rays from just off the surface toward a
            # disc of radius rt_light_radius around the light direction
            # (radius 0 or samples 1 = the classic hard shadow); the
            # per-pixel jitter is a deterministic integer hash of the
            # ray id — no PRNG state to carry.
            occl = jnp.zeros((d.shape[0],), F32)
            for s in range(max(1, shadow_samples)):
                sh = cast(off, _shadow_dir(ray_id, s))
                occl = occl + sh["hit"].astype(F32)
            vis = F32(1.0) - occl / F32(max(1, shadow_samples))
            lit = (floor + (F32(1.0) - floor) * vis)[:, None]
            rgba = jnp.concatenate([rgba[..., :3] * lit, rgba[..., 3:]],
                                   axis=-1)
        ok = hits["hit"]
        return (jnp.where(ok[:, None], rgba, F32(0.0)),
                jnp.where(ok, depth, DEPTH_CLEAR))

    if use_accel:
        # Pair-table path (ops/rt_accel.raycast_bundles_*): the frame
        # splits into 16×16-px ray BUNDLES (a tile's primary rays form a
        # narrow frustum; its hits sit close in world space, so shadow /
        # reflection bundles stay tight too).  All bundles cull at once
        # against the Morton clusters, the live (bundle, cluster) pairs
        # compact to one static table, and a single chunked dense sweep
        # evaluates them — work ∝ live pairs with uniform dense blocks,
        # replacing round 3's sequential per-tile lax.switch loop (which
        # was loop-bound: ~600 tiny blocks/frame).  Shadow rays use the
        # any-hit sweep (no winner reduction); soft-shadow samples stack
        # into the ray axis of ONE occlusion cast.  Edge padding
        # replicates border rays; pad results are cropped after
        # un-tiling.  cluster_cap sizes the pair table: pair_cap =
        # max(cluster_cap) × n_bundles (its legacy per-bundle-survivors
        # meaning), overflow lax.cond-falls back to a brute sweep.
        from softwarerenderer_tpu.ops import rt_accel
        tw = min(pair_tile[1], W)
        th = min(pair_tile[0], h)
        accel = rt_accel.build_rt_accel(world, group=cluster_group)
        hp = -(-h // th) * th
        Wp = -(-W // tw) * tw
        d2 = jnp.pad(jnp.asarray(dirs, F32), ((0, hp - h), (0, Wp - W),
                                              (0, 0)), mode="edge")
        i2 = jnp.pad(jnp.asarray(ray_ids, jnp.int32),
                     ((0, hp - h), (0, Wp - W)), mode="edge")
        nth, ntw = hp // th, Wp // tw
        B, R = nth * ntw, th * tw
        d_t = d2.reshape(nth, th, ntw, tw, 3).transpose(0, 2, 1, 3, 4) \
                .reshape(B, R, 3)
        i_t = i2.reshape(nth, th, ntw, tw).transpose(0, 2, 1, 3) \
                .reshape(B, R)
        pair_cap = int(max(use_accel)) * B

        def cast_nearest(o_b, d_b, origin_shared=False):
            return rt_accel.raycast_bundles_nearest(
                o_b, d_b, world, accel, pair_cap=pair_cap,
                chunk_pairs=pair_chunk, face_mask=rc.FACE_MASK_NONE,
                tri_mask=tri_mask, origin_shared=origin_shared)

        def cast_any(o_b, d_b, dir_shared=False):
            return rt_accel.raycast_bundles_any(
                o_b, d_b, world, accel, pair_cap=pair_cap,
                chunk_pairs=max(32, pair_chunk // max(1, shadow_samples)),
                face_mask=rc.FACE_MASK_NONE, tri_mask=tri_mask,
                dir_shared=dir_shared)

        o_t = jnp.broadcast_to(eye, (B, R, 3))
        prim = cast_nearest(o_t, d_t, origin_shared=True)
        hits = {k: prim[k].reshape((B * R,) + prim[k].shape[2:])
                for k in ("hit", "distance", "point", "normal", "tri",
                          "u", "v") if k in prim}
        rgba, depth = _shade_hits(hits, world, u, view, proj,
                                  fragment_shader,
                                  white_colors=rt_white_colors)  # (B*R,)
        hit_f = prim["hit"]                                  # (B, R)
        off = (prim["point"] + prim["normal"] * F32(1e-3))   # (B, R, 3)
        # Miss pixels carry zero points; replace their secondary-ray
        # origins with the BUNDLE's mean hit point so its AABB stays
        # tight (their results are discarded by the final select).
        # ALL-miss bundles (sky tiles) instead get NaN origins: every
        # slab-test comparison is then false, the bundle's survivor
        # count is 0, and its secondary-pass loop runs zero iterations
        # (the NaN also poisons any Möller–Trumbore test into a miss,
        # and the results are discarded by the final select anyway).
        nhit_b = jnp.sum(hit_f.astype(F32), axis=1)
        ctr = jnp.sum(jnp.where(hit_f[..., None], off, F32(0)),
                      axis=1) / jnp.maximum(nhit_b, F32(1))[:, None]
        ctr = jnp.where((nhit_b > 0)[:, None], ctr, F32(jnp.nan))
        off = jnp.where(hit_f[..., None], off, ctr[:, None, :])

        if reflections:
            n = prim["normal"]
            rdir = d_t - F32(2.0) * ml.dot(d_t, n, xp=jnp)[..., None] * n
            rh = cast_nearest(off, rdir)
            rh_flat = {k: rh[k].reshape((B * R,) + rh[k].shape[2:])
                       for k in ("hit", "distance", "point", "normal",
                                 "tri", "u", "v") if k in rh}
            rrgba, _ = _shade_hits(rh_flat, world, u, view, proj,
                                   fragment_shader,
                                   white_colors=rt_white_colors)
            refl = jnp.where(rh_flat["hit"][:, None], rrgba,
                             _background(rdir.reshape(-1, 3)))
            rgba = jnp.concatenate(
                [rgba[..., :3] + (refl[..., :3] - rgba[..., :3])
                 * refl_amt, rgba[..., 3:]], axis=-1)

        if shadows:
            S = max(1, shadow_samples)
            sdirs = jnp.stack(
                [_shadow_dir(i_t.reshape(-1), s).reshape(B, R, 3)
                 for s in range(S)], axis=1)                 # (B, S, R, 3)
            # Statically-hard shadows (one sample, no disc radius in
            # the uniforms) share ONE direction across every ray —
            # normalize(-light) exactly, since the jitter term is
            # multiplied by the absent radius's 0.0 default — so the
            # sweep broadcasts it instead of gathering (C, R, 3) dirs.
            hard = S == 1 and "rt_light_radius" not in uniforms
            sh = cast_any(
                jnp.broadcast_to(off[:, None], (B, S, R, 3)
                                 ).reshape(B, S * R, 3),
                sdirs.reshape(B, S * R, 3), dir_shared=hard)
            occl = jnp.sum(sh["hit"].reshape(B, S, R).astype(F32),
                           axis=1).reshape(-1)               # (B*R,)
            vis = F32(1.0) - occl / F32(S)
            lit = (floor + (F32(1.0) - floor) * vis)[:, None]
            rgba = jnp.concatenate([rgba[..., :3] * lit, rgba[..., 3:]],
                                   axis=-1)

        okf = hits["hit"]
        color = jnp.where(okf[:, None], rgba, F32(0.0))
        depth = jnp.where(okf, depth, DEPTH_CLEAR)
        color = color.reshape(nth, ntw, th, tw, 4).transpose(
            0, 2, 1, 3, 4).reshape(hp, Wp, 4)[:h, :W]
        depth = depth.reshape(nth, ntw, th, tw).transpose(
            0, 2, 1, 3).reshape(hp, Wp)[:h, :W]
    else:
        color_c, depth_c = jax.lax.map(
            trace_chunk, (dirs_pad.reshape(-1, chunk, 3),
                          ids_pad.reshape(-1, chunk)))
        color = color_c.reshape(-1, 4)[:n_rays].reshape(h, W, 4)
        depth = depth_c.reshape(-1)[:n_rays].reshape(h, W)

    covered = depth != DEPTH_CLEAR
    if "sky_panorama" in uniforms:
        bg = sky_mod.sample_panorama(uniforms["sky_panorama"], dirs,
                                     xp=jnp)
    else:
        bg = jnp.broadcast_to(
            jnp.asarray(uniforms["clear_color"], F32), (h, W, 4))
    color = jnp.where(covered[..., None], color, bg)
    return color, depth
