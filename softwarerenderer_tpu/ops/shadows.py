"""Directional shadow maps — a capability beyond the reference (ROADMAP #5).

The reference has no shadows (its single directional light is a hardcoded
dot product, /root/reference/Renderer.cs:851-858).  Here the visibility
machinery already renders depth from ANY camera, so shadows are one extra
depth-only pass:

  1. `directional_light_camera` builds an orthographic light camera over
     the scene's bounding sphere (row-vector .NET conventions, same depth
     semantics as the main camera: stored depth decreases with distance,
     nearest wins the LESS_EQUAL fold).
  2. `render_shadow_depth` runs the binned visibility fold from the light —
     depth only, no shading, one extra jitted stage inside the same frame
     program.
  3. `shadow_factor` projects world positions into the light's screen and
     compares against the map (one 4-byte row-gather per pixel — the same
     gather-lean layout as the texture atlas).

Shaders opt in by multiplying their lit term with
`shadow_factor(frag["data"]["world_position"], uniforms, xp)`; see
`shadowed_scene_fragment_shader` and `engine.render_frame_with_shadows`.
"""

from __future__ import annotations

from typing import Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from softwarerenderer_tpu.config import RenderParams
from softwarerenderer_tpu.ops import geometry
from softwarerenderer_tpu.ops.binning import visibility_binned
from softwarerenderer_tpu.utils import mathlib as ml

F32 = jnp.float32


def directional_light_camera(light_direction, center, radius, xp=jnp):
    """Ortho (view, projection) for a directional light covering the sphere
    (center, radius).  Returns (view, proj, view_proj)."""
    d = ml.normalize(xp.asarray(light_direction, xp.float32), xp=xp)
    center = xp.asarray(center, xp.float32)
    radius = xp.asarray(radius, xp.float32)
    eye = center - d * (radius * F32(2.0))
    up0 = xp.asarray([0.0, 1.0, 0.0], xp.float32)
    up1 = xp.asarray([1.0, 0.0, 0.0], xp.float32)
    up = xp.where(xp.abs(d[1]) > F32(0.95), up1, up0)
    view = ml.look_at(eye, center, up, xp=xp)
    extent = radius * F32(2.2)
    proj = ml.orthographic(extent, extent, F32(0.05) * radius,
                           radius * F32(4.0), xp=xp)
    return view, proj, ml.transform(view, proj, xp=xp)


def render_shadow_depth(scene: Dict, uniforms: Dict, light_view, light_proj,
                        shadow_size: int = 512,
                        params: Optional[RenderParams] = None):
    """Depth-only render from the light camera → (S, S) shadow map.

    Uses the same geometry pipeline + binned visibility fold as the main
    frame (cull_mode NONE so back faces still occlude)."""
    S = shadow_size
    sp = (params or RenderParams()).replace(
        width=S, height=S, cull_mode=0)
    from softwarerenderer_tpu.ops import culling
    model_pv = culling.model_matrices_per_vertex(scene, xp=jnp)
    u = dict(uniforms)
    u.update(model=model_pv, view=light_view, projection=light_proj)
    vin = {k: scene[k] for k in ("position", "uv", "normal", "color")}
    # Animated geometry must cast shadows in its CURRENT pose: run the
    # same vertex-update chain as the main frame (flip-book frames,
    # morph targets, skinning, particle billboards — billboards face the
    # MAIN camera, which is what their shadow should track too).
    from softwarerenderer_tpu.engine.renderer import (
        apply_vertex_updates,
        camera_matrices,
    )
    main_view, _ = camera_matrices(uniforms, S, S)
    vin = apply_vertex_updates(vin, scene, uniforms, main_view)
    tri_mask = scene.get("tri_valid")
    if "tri_lod_level" in scene:
        # Only each mesh's ACTIVE LOD level casts — otherwise every
        # packed level's triangles shadow simultaneously.
        from softwarerenderer_tpu.ops import lod
        h = params.height if params is not None else S
        lm = lod.lod_tri_mask(scene, uniforms, h, xp=jnp)
        tri_mask = lm if tri_mask is None else (tri_mask & lm)

    def light_vs(vin, uu, xp=jnp):
        world = ml.transform(ml.homogenize(vin["position"], xp=xp),
                             uu["model"], xp=xp)
        view_pos = ml.transform(world, uu["view"], xp=xp)
        clip = ml.transform(view_pos, uu["projection"], xp=xp)
        return {"clip_position": clip}

    tris = geometry.build_triangles(
        light_vs, vin, scene["indices"], u, width=S, height=S,
        cull_mode=0, near_clip=jnp.asarray(1e-4, F32), tri_mask=tri_mask,
        keep_varyings=())
    depth, _ = visibility_binned(
        tris, sp, sp.chunk, tile_h=min(sp.tile_h, S),
        tile_w=min(sp.tile_w, S), span_cap=sp.span_cap,
        tile_group=sp.tile_group)
    return depth


def shadow_factor(world_position, uniforms, xp=jnp, bias: float = 4e-3):
    """Per-pixel lit factor in {0, 1} from the shadow map.

    world_position: (..., 3) or (..., 4); uniforms must carry
    shadow_map (S, S), shadow_view, shadow_proj (render_frame_with_shadows
    populates them).  Points outside the light frustum count as lit."""
    smap = uniforms["shadow_map"]
    S = smap.shape[0]
    wp = xp.asarray(world_position, xp.float32)[..., :3]
    clip = ml.transform(
        ml.homogenize(wp, xp=xp),
        ml.transform(uniforms["shadow_view"], uniforms["shadow_proj"],
                     xp=xp), xp=xp)
    w = xp.where(clip[..., 3] == 0, F32(1.0), clip[..., 3])
    ndc = clip[..., :3] / w[..., None]
    # Same viewport mapping as geometry.setup_triangles (Y flip).
    sx = (ndc[..., 0] * F32(0.5) + F32(0.5)) * F32(S)
    sy = (F32(1.0) - (ndc[..., 1] * F32(0.5) + F32(0.5))) * F32(S)
    # Fragment depth in the light's buffer convention: the stored value is
    # the NEGATED (ndcZ+1)/2 (config.py depth-semantics note), decreasing
    # with distance from the light.
    d_f = -(ndc[..., 2] + F32(1.0)) * F32(0.5)
    xi = xp.clip(sx.astype(xp.int32), 0, S - 1)
    yi = xp.clip(sy.astype(xp.int32), 0, S - 1)
    # 4-byte row gather.
    d_m = xp.take(smap.reshape(S * S, 1), yi * S + xi, axis=0)[..., 0]
    inside = (sx >= 0) & (sx < S) & (sy >= 0) & (sy < S)
    lit = (d_f >= d_m - F32(bias)) | ~inside
    return lit.astype(xp.float32)


def shadowed_scene_fragment_shader(frag, uniforms, xp=jnp):
    """The game shader with the lit term scaled by the shadow factor."""
    from softwarerenderer_tpu.engine.renderer import _frag_atlas_sample

    world_normal = frag["data"]["world_normal"]
    light_dir = uniforms["light_direction"]
    diffuse = xp.maximum(F32(0.25),
                         ml.dot(world_normal, -light_dir, xp=xp))
    shade = shadow_factor(frag["data"]["world_position"], uniforms, xp=xp)
    # shadowed pixels fall to the ambient floor
    diffuse = F32(0.25) + (diffuse - F32(0.25)) * shade
    tex_color = _frag_atlas_sample(frag, uniforms, xp)
    base = frag["color"] * tex_color
    depth = frag["clip_position"][..., 2]
    fog = xp.clip((uniforms["fog_end"] - depth)
                  / (uniforms["fog_end"] - uniforms["fog_start"]),
                  F32(0.0), F32(1.0))
    fog = fog * fog * (F32(3.0) - F32(2.0) * fog)
    lit = base * (F32(0.1) + F32(0.9) * diffuse[..., None]) \
        * uniforms["light_color"]
    rgba = uniforms["fog_color"] + (lit - uniforms["fog_color"]) \
        * fog[..., None]
    return xp.concatenate([rgba[..., :3], base[..., 3:4]], axis=-1)


shadowed_scene_fragment_shader.varyings = (
    "color", "uv", "data.world_normal", "data.world_position")
shadowed_scene_fragment_shader.tri_extras = (
    "tex_oy", "tex_ox", "tex_h", "tex_w")


# ---------------------------------------------------------------------------
# Point-light cube shadows (6 perspective faces around the light position).
# The reference has no shadows at all; this extends the directional maps
# above to the point/spot lights the asset pipeline already imports
# (/root/reference/Light.cs:19-32 — loaded but never consumed there).
# ---------------------------------------------------------------------------

# Face order: +X -X +Y -Y +Z -Z.  Up vectors avoid the degenerate
# look_at when the view direction is parallel to +Y.
_CUBE_DIRS = np.asarray([
    [1, 0, 0], [-1, 0, 0],
    [0, 1, 0], [0, -1, 0],
    [0, 0, 1], [0, 0, -1],
], np.float32)
_CUBE_UPS = np.asarray([
    [0, 1, 0], [0, 1, 0],
    [0, 0, 1], [0, 0, -1],
    [0, 1, 0], [0, 1, 0],
], np.float32)


def point_light_cameras(light_position, near, far, xp=jnp):
    """(view, proj) per cube face: 6 stacked (4, 4) row-vector matrices.

    90° FOV, square aspect — the six frusta tile all directions."""
    lp = xp.asarray(light_position, xp.float32)
    views = xp.stack([
        ml.look_at(lp, lp + xp.asarray(_CUBE_DIRS[f]),
                   xp.asarray(_CUBE_UPS[f]), xp=xp)
        for f in range(6)
    ])
    proj = ml.perspective_fov(xp.float32(np.pi / 2), xp.float32(1.0),
                              xp.asarray(near, xp.float32),
                              xp.asarray(far, xp.float32), xp=xp)
    projs = xp.broadcast_to(proj, (6, 4, 4))
    return views, projs


def render_point_shadow_depth(scene: Dict, uniforms: Dict, light_position,
                              shadow_size: int = 256,
                              near: float = 0.05, far: float = 100.0,
                              params: Optional[RenderParams] = None):
    """Six depth-only renders from the light → (6, S, S) cube shadow map.

    Reuses the binned visibility fold per face inside the same jitted
    program (static 6-iteration loop; each face is an independent
    sort-middle pass)."""
    views, projs = point_light_cameras(light_position, near, far)
    maps = [render_shadow_depth(scene, uniforms, views[f], projs[f],
                                shadow_size=shadow_size, params=params)
            for f in range(6)]
    return jnp.stack(maps), views, projs


def point_shadow_factor(world_position, uniforms, xp=jnp,
                        bias: float = 4e-3):
    """Per-pixel lit factor {0, 1} from a cube shadow map.

    uniforms: point_shadow_map (6, S, S), point_shadow_views (6, 4, 4),
    point_shadow_projs (6, 4, 4), point_light_position (3,).  The face is
    the dominant axis of (wp - light); the fragment is projected with that
    face's camera and compared against its depth map (same negated
    (ndcZ+1)/2 buffer convention as the directional path)."""
    smap = uniforms["point_shadow_map"]          # (6, S, S)
    S = smap.shape[-1]
    lp = xp.asarray(uniforms["point_light_position"], xp.float32)
    wp = xp.asarray(world_position, xp.float32)[..., :3]
    v = wp - lp
    ax, ay, az = (xp.abs(v[..., 0]), xp.abs(v[..., 1]),
                  xp.abs(v[..., 2]))
    face = xp.where(
        (ax >= ay) & (ax >= az),
        xp.where(v[..., 0] >= 0, 0, 1),
        xp.where(ay >= az,
                 xp.where(v[..., 1] >= 0, 2, 3),
                 xp.where(v[..., 2] >= 0, 4, 5))).astype(xp.int32)

    # Project against all 6 face cameras (vectorized arithmetic), then
    # select by face — gather-free; the only per-pixel gather is the one
    # 4-byte shadow-map row fetch below.
    hom = ml.homogenize(wp, xp=xp)               # (..., 4)
    lit_any = None
    d_f_sel = xp.zeros(face.shape, xp.float32)
    sx_sel = xp.zeros(face.shape, xp.float32)
    sy_sel = xp.zeros(face.shape, xp.float32)
    for f in range(6):
        vp = ml.transform(uniforms["point_shadow_views"][f],
                          uniforms["point_shadow_projs"][f], xp=xp)
        clip = ml.transform(hom, vp, xp=xp)
        w = xp.where(clip[..., 3] == 0, F32(1.0), clip[..., 3])
        ndc = clip[..., :3] / w[..., None]
        sx = (ndc[..., 0] * F32(0.5) + F32(0.5)) * F32(S)
        sy = (F32(1.0) - (ndc[..., 1] * F32(0.5) + F32(0.5))) * F32(S)
        d_f = -(ndc[..., 2] + F32(1.0)) * F32(0.5)
        sel = face == f
        sx_sel = xp.where(sel, sx, sx_sel)
        sy_sel = xp.where(sel, sy, sy_sel)
        d_f_sel = xp.where(sel, d_f, d_f_sel)

    xi = xp.clip(sx_sel.astype(xp.int32), 0, S - 1)
    yi = xp.clip(sy_sel.astype(xp.int32), 0, S - 1)
    flat = smap.reshape(6 * S * S, 1)
    d_m = xp.take(flat, face * (S * S) + yi * S + xi, axis=0)[..., 0]
    inside = (sx_sel >= 0) & (sx_sel < S) & (sy_sel >= 0) & (sy_sel < S)
    lit = (d_f_sel >= d_m - F32(bias)) | ~inside
    return lit.astype(xp.float32)


def point_shadowed_fragment_shader(frag, uniforms, xp=jnp):
    """Game-style shader lit by one point light with cube-shadow occlusion
    and inverse-square falloff (uniforms: point_light_position,
    point_light_color, point_light_range + the cube-map uniforms)."""
    from softwarerenderer_tpu.engine.renderer import _frag_atlas_sample

    wp = frag["data"]["world_position"][..., :3]
    lp = xp.asarray(uniforms["point_light_position"], xp.float32)
    to_light = lp - wp
    dist = xp.sqrt(xp.maximum(ml.dot(to_light, to_light, xp=xp), F32(1e-12)))
    ldir = to_light / dist[..., None]
    world_normal = frag["data"]["world_normal"]
    diffuse = xp.maximum(F32(0.25), ml.dot(world_normal, ldir, xp=xp))
    shade = point_shadow_factor(wp, uniforms, xp=xp)
    diffuse = F32(0.25) + (diffuse - F32(0.25)) * shade
    rng = xp.asarray(uniforms.get("point_light_range", 25.0), xp.float32)
    atten = xp.clip(F32(1.0) - dist / rng, F32(0.0), F32(1.0)) ** 2
    tex_color = _frag_atlas_sample(frag, uniforms, xp)
    base = frag["color"] * tex_color
    lit = base * (F32(0.1) + F32(0.9) * (diffuse * atten)[..., None]) \
        * xp.asarray(uniforms["point_light_color"], xp.float32)
    return xp.concatenate([lit[..., :3], base[..., 3:4]], axis=-1)


point_shadowed_fragment_shader.varyings = (
    "color", "uv", "data.world_normal", "data.world_position")
point_shadowed_fragment_shader.tri_extras = (
    "tex_oy", "tex_ox", "tex_h", "tex_w")


# ---------------------------------------------------------------------------
# Spot-light shadows: ONE perspective depth pass along the cone axis.
# shadow_factor() is projection-agnostic (it projects with whatever
# shadow_view/shadow_proj ride in the uniforms), so a spot light reuses
# the directional machinery with a perspective camera + cone falloff.
# ---------------------------------------------------------------------------

def spot_light_camera(position, direction, outer_angle, near=0.05,
                      far=100.0, xp=jnp):
    """(view, proj) for a spot light: perspective camera at the light
    position looking along the cone axis, FOV = 2·outer_angle (the cone
    exactly fills the frustum)."""
    lp = xp.asarray(position, xp.float32)
    d = ml.normalize(xp.asarray(direction, xp.float32), xp=xp)
    up0 = xp.asarray([0.0, 1.0, 0.0], xp.float32)
    up1 = xp.asarray([1.0, 0.0, 0.0], xp.float32)
    up = xp.where(xp.abs(d[1]) > F32(0.95), up1, up0)
    view = ml.look_at(lp, lp + d, up, xp=xp)
    fov = F32(2.0) * xp.asarray(outer_angle, xp.float32)
    proj = ml.perspective_fov(fov, xp.float32(1.0),
                              xp.asarray(near, xp.float32),
                              xp.asarray(far, xp.float32), xp=xp)
    return view, proj


def spot_shadowed_fragment_shader(frag, uniforms, xp=jnp):
    """Game-style shader lit by one spot light: cone smoothstep falloff ×
    inverse-linear range falloff × shadow-map occlusion.  uniforms:
    spot_position, spot_direction, spot_inner, spot_outer (radians),
    spot_color, spot_range, plus shadow_map/shadow_view/shadow_proj from
    render_shadow_depth + spot_light_camera."""
    from softwarerenderer_tpu.engine.renderer import _frag_atlas_sample

    wp = frag["data"]["world_position"][..., :3]
    lp = xp.asarray(uniforms["spot_position"], xp.float32)
    sdir = ml.normalize(xp.asarray(uniforms["spot_direction"], xp.float32),
                        xp=xp)
    to_light = lp - wp
    dist = xp.sqrt(xp.maximum(ml.dot(to_light, to_light, xp=xp), F32(1e-12)))
    ldir = to_light / dist[..., None]
    world_normal = frag["data"]["world_normal"]
    diffuse = xp.maximum(F32(0.25), ml.dot(world_normal, ldir, xp=xp))
    shade = shadow_factor(wp, uniforms, xp=xp)
    diffuse = F32(0.25) + (diffuse - F32(0.25)) * shade
    # cone: smoothstep between cos(outer) and cos(inner) (Light.cs fields)
    cos_angle = ml.dot(-ldir, sdir, xp=xp)
    ci = xp.cos(xp.asarray(uniforms["spot_inner"], xp.float32))
    co = xp.cos(xp.asarray(uniforms["spot_outer"], xp.float32))
    t = xp.clip((cos_angle - co) / xp.where(ci == co, F32(1), ci - co),
                F32(0.0), F32(1.0))
    cone = t * t * (F32(3.0) - F32(2.0) * t)
    rng = xp.asarray(uniforms.get("spot_range", 25.0), xp.float32)
    atten = xp.clip(F32(1.0) - dist / rng, F32(0.0), F32(1.0)) ** 2
    tex_color = _frag_atlas_sample(frag, uniforms, xp)
    base = frag["color"] * tex_color
    lit = base * (F32(0.1)
                  + F32(0.9) * (diffuse * cone * atten)[..., None]) \
        * xp.asarray(uniforms["spot_color"], xp.float32)
    return xp.concatenate([lit[..., :3], base[..., 3:4]], axis=-1)


spot_shadowed_fragment_shader.varyings = (
    "color", "uv", "data.world_normal", "data.world_position")
spot_shadowed_fragment_shader.tri_extras = (
    "tex_oy", "tex_ox", "tex_h", "tex_w")
