"""Frame engine: packed scene + camera → one fused jitted device program.

The reference's per-frame loop fans per-mesh draws out over CPU threads and
re-uploads the framebuffer to GL each frame (Renderer.cs:404-419,
MainWindow.cs:217-266).  Here the whole frame — camera matrices, frustum
culling, vertex shading, clipping, visibility reduce, deferred shading —
is ONE XLA program over device-resident scene buffers (SURVEY.md §3.2:
"all of §P1-P8 collapse into one jitted device program per frame"); the
only host crossings are the per-frame uniform upload and the framebuffer
download for present.

Live-tunable parameters (fov, near/far clip, fog, light, clear color —
the reference's ImGui sliders, Renderer.cs:690-817) are TRACED scalars in
the uniforms pytree, so tuning never recompiles; anything that changes
program structure lives in the static RenderParams.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from softwarerenderer_tpu.config import RenderParams
from softwarerenderer_tpu.ops import culling, geometry, raster
from softwarerenderer_tpu.ops import texture as tex_ops
from softwarerenderer_tpu.ops.tile_fold import fold_route
from softwarerenderer_tpu.utils import mathlib as ml

F32 = jnp.float32


# ---------------------------------------------------------------------------
# Scene-level default shaders (the game's shaders, Renderer.cs:830-860,
# adapted to the packed-scene layout: per-vertex model matrices and a
# texture-atlas id per triangle instead of one model/texture per draw call).
# ---------------------------------------------------------------------------

def scene_vertex_shader(vin, uniforms, xp=jnp):
    """MVP transform + world normal varying (Renderer.cs:830-846), with
    uniforms["model"] batched per vertex ((V, 4, 4) gathered from the packed
    scene's mesh_matrices)."""
    model = uniforms["model"]
    world = ml.transform(ml.homogenize(vin["position"], xp=xp), model, xp=xp)
    view_pos = ml.transform(world, uniforms["view"], xp=xp)
    clip = ml.transform(view_pos, uniforms["projection"], xp=xp)
    world_normal = ml.normalize(
        ml.transform_normal(vin["normal"], model, xp=xp), xp=xp, eps=1e-30)
    return {
        "clip_position": clip,
        "color": vin["color"],
        "uv": vin["uv"],
        "normal": vin["normal"],
        "data": {"world_normal": world_normal},
    }


def _frag_atlas_sample(frag, uniforms, xp, bilinear=False):
    """Atlas fetch for scene shaders: uses per-triangle pre-resolved region
    channels when the raster path provides them (the only per-pixel memory
    access is then the texel row-gather — a per-pixel table `take` costs
    ~6.8 ms/frame at 1080p), falling back to tex_id table lookup."""
    tri = frag.get("tri", {})
    if not bilinear and "tex_oy" in tri:
        return tex_ops.sample_atlas_region(
            uniforms["atlas_data"], tri["tex_oy"], tri["tex_ox"],
            tri["tex_h"], tri["tex_w"], frag["uv"], xp=xp)
    fn = (tex_ops.sample_atlas_bilinear if bilinear
          else tex_ops.sample_atlas_nearest)
    return fn(uniforms["atlas_data"], uniforms["atlas_offsets"],
              uniforms["atlas_sizes"], tri["tex_id"], frag["uv"], xp=xp)


def scene_fragment_shader(frag, uniforms, xp=jnp):
    """Texture(atlas) × vertex color, half-Lambert max(0.25, N·-L),
    smoothstep fog on clip-space Z, alpha unfogged (Renderer.cs:848-860)."""
    world_normal = frag["data"]["world_normal"]
    light_dir = uniforms["light_direction"]
    diffuse = xp.maximum(F32(0.25), ml.dot(world_normal, -light_dir, xp=xp))
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


# Varying registry: the flat attribute names this shader reads — unused
# varyings are pruned from the raster payload (SURVEY.md §7 hard-part (c)).
scene_fragment_shader.varyings = ("color", "uv", "data.world_normal")
# Per-triangle channel registry: this shader samples via pre-resolved
# atlas regions only (no tex_id/mesh_id lookups).
scene_fragment_shader.tri_extras = ("tex_oy", "tex_ox", "tex_h", "tex_w")
# Alpha provenance: the output alpha is vertex color.a × texture alpha
# (the reference's base = color * tex, Renderer.cs:853/859) — lets the
# K-buffer peel prove triangles semantically opaque from pack-time data
# (opaque_tri_flags) and stop peeling behind their visible fragments.
scene_fragment_shader.alpha_sources = ("color", "texture")


def scene_fragment_shader_bilinear(frag, uniforms, xp=jnp):
    """scene_fragment_shader with bilinear texture filtering — the quality
    mode the reference lacks (it ships nearest only, SURVEY.md §6 note 4)."""
    world_normal = frag["data"]["world_normal"]
    light_dir = uniforms["light_direction"]
    diffuse = xp.maximum(F32(0.25), ml.dot(world_normal, -light_dir, xp=xp))
    tex_color = _frag_atlas_sample(frag, uniforms, xp, bilinear=True)
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


scene_fragment_shader_bilinear.varyings = scene_fragment_shader.varyings
# bilinear still resolves through tex_id tables
scene_fragment_shader_bilinear.tri_extras = (
    "tex_id", "tex_oy", "tex_ox", "tex_h", "tex_w")
scene_fragment_shader_bilinear.alpha_sources = ("color", "texture")


def scene_fragment_shader_trilinear(frag, uniforms, xp=jnp):
    """Trilinear filtering: bilinear in each of the triangle's two mip
    regions, lerped by the 8-bit-quantized per-triangle mip fraction.
    Use with RenderParams(use_mipmaps="trilinear").  8 texel fetches per
    pixel — the highest quality mode (the reference ships nearest only)."""
    tri = frag["tri"]
    t0 = tex_ops.sample_atlas_region_bilinear(
        uniforms["atlas_data"], tri["tex_oy"], tri["tex_ox"],
        tri["tex_h"], tri["tex_w"], frag["uv"], xp=xp)
    t1 = tex_ops.sample_atlas_region_bilinear(
        uniforms["atlas_data"], tri["tex_oy2"], tri["tex_ox2"],
        tri["tex_h2"], tri["tex_w2"], frag["uv"], xp=xp)
    a = tri["mip_frac256"].astype(xp.float32)[..., None] / F32(256.0)
    tex_color = t0 + (t1 - t0) * a
    world_normal = frag["data"]["world_normal"]
    light_dir = uniforms["light_direction"]
    diffuse = xp.maximum(F32(0.25), ml.dot(world_normal, -light_dir, xp=xp))
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


scene_fragment_shader_trilinear.varyings = scene_fragment_shader.varyings
scene_fragment_shader_trilinear.tri_extras = (
    "tex_oy", "tex_ox", "tex_h", "tex_w",
    "tex_oy2", "tex_ox2", "tex_h2", "tex_w2", "mip_frac256")
scene_fragment_shader_trilinear.alpha_sources = ("color", "texture")


def opaque_tri_flags(scene: Dict, vin: Dict, fragment_shader,
                     params: RenderParams, indices=None,
                     tri_texture_id=None):
    """Per-triangle 'semantically opaque' flags for the K-buffer peel's
    short-circuit, or None when unprovable.

    A triangle is flagged when the shader's declared alpha provenance
    (`alpha_sources`: output alpha == product of the named sources)
    evaluates to exactly 1 from pack-time data: "color" = all three
    vertex alphas are 1 (clip-fan lerps preserve 1), "texture" = the
    texture's pack-time min sampled alpha is 1
    (models.scene.pack_atlas; box-filtered mips of an all-1 base stay
    exactly 1).  The peel combines the winner's flag with its SHADED
    alpha > 0 (visibility: discarded or NaN-interpolated winners must
    keep peeling) — see tile_fold.render_kbuffer_peel and
    PARITY.md "Exactness-preserving optimizations" for the proof and
    the one-blend-ulp exactness bound.

    Only ALPHA blending needs the flags (NONE short-circuits on shaded
    alpha > 0 alone; ADDITIVE/MULTIPLY never short-circuit): returns
    None unless blend_mode == ALPHA and the registry + pack data are
    present.
    """
    from softwarerenderer_tpu.config import BlendMode
    srcs = getattr(fragment_shader, "alpha_sources", None)
    if srcs is None or params.blend_mode != BlendMode.ALPHA:
        return None
    idx = jnp.asarray(scene["indices"] if indices is None else indices,
                      jnp.int32)
    opq = jnp.ones((idx.shape[0],), bool)
    if "color" in srcs:
        a = jnp.asarray(vin["color"], F32)[:, 3]
        amin = jnp.minimum(
            jnp.minimum(jnp.take(a, idx[:, 0]), jnp.take(a, idx[:, 1])),
            jnp.take(a, idx[:, 2]))
        amax = jnp.maximum(
            jnp.maximum(jnp.take(a, idx[:, 0]), jnp.take(a, idx[:, 1])),
            jnp.take(a, idx[:, 2]))
        opq = opq & (amin == F32(1.0)) & (amax == F32(1.0))
    if "texture" in srcs:
        if "tex_min_alpha" not in scene:
            return None
        ta = jnp.take(jnp.asarray(scene["tex_min_alpha"], F32),
                      jnp.asarray(scene["tri_texture_id"]
                                  if tri_texture_id is None
                                  else tri_texture_id, jnp.int32))
        opq = opq & (ta >= F32(1.0))
    # ×2 for the clipper's fan slots, like every per-triangle channel.
    return jnp.repeat(opq.astype(jnp.int32), 2)


def default_frame_uniforms(width: int, height: int) -> Dict:
    """Per-frame traced parameters with the reference game's defaults
    (Renderer.cs:34-46, 74, 406-413)."""
    ld = np.asarray([0.5, -1.0, -0.3], np.float32)
    return {
        "camera_position": np.zeros(3, np.float32),
        "camera_rotation": ml.QUAT_IDENTITY.copy(),
        "fov_degrees": np.float32(90.0),
        "near_clip": np.float32(0.1),
        "far_clip": np.float32(1000.0),
        "light_direction": ld / np.linalg.norm(ld),
        "light_color": np.ones(4, np.float32),
        "fog_color": np.asarray([0.45, 0.64, 0.76, 1.0], np.float32),
        "fog_start": np.float32(40.0),
        "fog_end": np.float32(100.0),
        "clear_color": np.asarray([0.45, 0.64, 0.76, 1.0], np.float32),
    }


def camera_matrices(uniforms: Dict, width: int, height: int, xp=jnp):
    """View from position+quaternion (Camera.cs:12-26) and the .NET
    perspective from live-tuned FOV (Renderer.cs:406-410), traced."""
    pos = xp.asarray(uniforms["camera_position"], dtype=xp.float32)
    rot = xp.asarray(uniforms["camera_rotation"], dtype=xp.float32)
    front = ml.quat_rotate(xp.asarray([0.0, 0.0, -1.0], xp.float32), rot, xp=xp)
    up = ml.quat_rotate(xp.asarray([0.0, 1.0, 0.0], xp.float32), rot, xp=xp)
    view = ml.look_at(pos, pos + front, up, xp=xp)
    # xp-honoring scalar math: a jnp.float32 constant here would silently
    # promote the host (xp=np) path to a device dispatch + readback (the
    # dust2 nametag pass calls this every frame).
    fov = xp.asarray(uniforms["fov_degrees"],
                     xp.float32) * xp.float32(np.pi / 180.0)
    proj = ml.perspective_fov(fov,
                              xp.float32(width) / xp.float32(height),
                              uniforms["near_clip"], uniforms["far_clip"],
                              xp=xp)
    return view, proj


def _enabled_post_fx(params: RenderParams, uniforms: Dict):
    """The params.post_fx entries whose switches are on, in order.

    Each effect applies to the finished (color, depth) frame: "sky" fills
    clear-depth pixels from uniforms["sky_panorama"], "ssao" darkens
    creases from depth, "bloom" adds the bright-pass glow, "tonemap"
    compresses through params.tonemap.  The default order (sky → ssao →
    bloom → tonemap) reproduces the round-2 fixed nesting exactly.
    """
    on = {"sky": "sky_panorama" in uniforms,
          "ssao": bool(params.ssao),
          "bloom": bool(params.bloom),
          "tonemap": bool(params.tonemap),
          "fxaa": bool(params.fxaa)}
    names = [f for f in params.post_fx if isinstance(f, str)]
    unknown = [f for f in names if f not in on]
    if unknown:
        raise ValueError(f"unknown post_fx entries {unknown!r}; "
                         f"valid: {sorted(on)} or a callable "
                         "(color, depth, uniforms) -> (color, depth)")
    for f in on:
        if on[f] and f not in names:
            raise ValueError(f"post-fx {f!r} is enabled but absent from "
                             f"params.post_fx {params.post_fx!r}")
    # Callable stages (user post-FX programs — the post-pipeline analog
    # of the user vertex/fragment shader ABI) are always on.
    return tuple(f for f in params.post_fx
                 if not isinstance(f, str) or on[f])


def _apply_post_fx(fx, color, depth, uniforms: Dict,
                   params: RenderParams):
    if callable(fx):
        out = fx(color, depth, uniforms)
        return out if isinstance(out, tuple) else (out, depth)
    if fx == "sky":
        from softwarerenderer_tpu.ops import sky
        return sky.composite_sky(color, depth, uniforms, xp=jnp)
    if fx == "ssao":
        from softwarerenderer_tpu.ops import ssao as ssao_mod
        return ssao_mod.apply_ssao(color, depth, uniforms, xp=jnp)
    if fx == "bloom":
        from softwarerenderer_tpu.ops import bloom as bloom_mod
        return bloom_mod.apply_bloom(
            color, threshold=uniforms.get("bloom_threshold", 0.8),
            strength=uniforms.get("bloom_strength", 0.7), xp=jnp), depth
    if fx == "fxaa":
        from softwarerenderer_tpu.ops import fxaa as fxaa_mod
        return fxaa_mod.apply_fxaa(color, xp=jnp), depth
    from softwarerenderer_tpu.ops import tonemap as tm
    return tm.apply_tonemap(color, params.tonemap, uniforms, xp=jnp), depth


def apply_vertex_updates(vin: Dict, scene: Dict, uniforms: Dict,
                         view) -> Dict:
    """Per-frame device-side vertex updates, shared by EVERY render path
    (engine, parallel/sharding, parallel/ring): tangents, flip-book frame
    select, skeletal skinning, particle billboards.  Each is a traced
    computation of (scene, uniforms, view) with no per-shard state, so
    scale-out shards replicate it identically."""
    vin = dict(vin)
    if "tangent" in scene:
        vin["tangent"] = scene["tangent"]   # normal mapping (ops/normalmap)
    if "anim_positions" in scene:
        # Flip-book animation on device (ModelLoader.cs:331-348): select
        # each animated mesh's current frame from the traced
        # uniforms["anim_frame"] vector — scene buffers never re-upload
        # and frame changes never recompile.
        n_anim = scene["anim_n_frames"].shape[0]
        af = jnp.broadcast_to(
            jnp.atleast_1d(jnp.asarray(uniforms.get("anim_frame", 0),
                                       jnp.int32)), (n_anim,))
        f_mesh = af % scene["anim_n_frames"]
        fv = jnp.take(f_mesh, scene["anim_slot"])
        va = jnp.arange(fv.shape[0], dtype=jnp.int32)
        vin["position"] = vin["position"].at[scene["anim_vert_index"]].set(
            scene["anim_positions"][fv, va])
        vin["normal"] = vin["normal"].at[scene["anim_vert_index"]].set(
            scene["anim_normals"][fv, va])
    if "morph_vert_index" in scene:
        # Morph targets (ops/morph.py), before skinning per the glTF
        # order: weighted delta blend from the traced morph weights /
        # anim_time weight tracks.
        from softwarerenderer_tpu.ops import morph
        vin = morph.apply_morphs(vin, scene, uniforms, xp=jnp)
    if "skin_joints" in scene:
        # Skeletal animation on device (ops/skinning.py): FK + blended
        # matrix skinning inside the same jitted program, driven by the
        # traced uniforms["anim_time"] seconds clock.
        from softwarerenderer_tpu.ops import skinning
        vin = skinning.apply_skinning(vin, scene, uniforms, xp=jnp)
    if "particle_vert_index" in scene and "particle_centers" in uniforms:
        # Particle billboards on device (sim/particles.py): reserved quad
        # slots get world-space camera-facing corners from the traced
        # particle uniforms — the particle sim and its rendering share
        # one jitted program.
        from softwarerenderer_tpu.sim import particles
        vin = particles.apply_billboards(vin, scene, uniforms, view,
                                         xp=jnp)
    return vin


def render_frame(scene: Dict, uniforms: Dict, params: RenderParams,
                 vertex_shader: Callable = scene_vertex_shader,
                 fragment_shader: Callable = scene_fragment_shader,
                 chunk: int = 128,
                 fb: Optional[tuple] = None):
    """One full frame over a packed scene (models.scene.build_scene_buffers).

    Jit-friendly: call under jax.jit with `params`/`chunk` static.  Returns
    (color (H, W, 4) f32, depth (H, W) f32).
    """
    if params.kbuffer_stats and (params.ssaa > 1 or params.kbuffer <= 1
                                 or not (params.binned and params.deferred)
                                 or _enabled_post_fx(params, uniforms)):
        raise ValueError("kbuffer_stats needs kbuffer > 1 and no "
                         "ssaa/post-fx (the stats dict is a third return "
                         "value the recursive wrappers don't thread)")
    if params.active_cap_stats and (params.ssaa > 1
                                    or _enabled_post_fx(params, uniforms)):
        raise ValueError("active_cap_stats needs no ssaa/post-fx (the "
                         "stats dict is a third return value the "
                         "recursive wrappers don't thread)")
    if params.shade_rate > 1 and (params.kbuffer > 1
                                  or fold_route(params) == "xla"):
        raise ValueError("shade_rate > 1 is implemented on the tile-kernel "
                         "opaque route only (use_pallas deferred binned "
                         "LESS_EQUAL, kbuffer <= 1) — it would silently "
                         "shade full-rate elsewhere")
    if params.ssaa > 1:
        # Supersampled AA: render the whole frame at ssaa× and box-filter
        # down (beyond the reference — it has no AA at all).  fb seeds are
        # upsampled by sample replication so accumulation passes compose.
        f = params.ssaa
        hi = params.replace(width=params.width * f,
                            height=params.height * f, ssaa=1)
        if fb is not None:
            fb = (jnp.repeat(jnp.repeat(fb[0], f, 0), f, 1),
                  jnp.repeat(jnp.repeat(fb[1], f, 0), f, 1))
        color, depth = render_frame(scene, uniforms, hi,
                                    vertex_shader=vertex_shader,
                                    fragment_shader=fragment_shader,
                                    chunk=chunk, fb=fb)
        H, W = params.height, params.width
        color = color.reshape(H, f, W, f, 4).mean(axis=(1, 3))
        depth = depth[::f, ::f]
        return color, depth
    fx_chain = _enabled_post_fx(params, uniforms)
    if fx_chain:
        # Post-FX pipeline as DATA (params.post_fx; config.py): render the
        # base frame with every effect stripped, then apply the enabled
        # effects in the configured order — all inside the same jitted
        # program.  Runs inside the ssaa branch's inner call, so every
        # effect (sky included) is supersampled too.
        base = params.replace(
            tonemap=None, bloom=False, ssao=False, fxaa=False,
            # user-callable stages are always-on: strip them too, else
            # the base render would recurse forever
            post_fx=tuple(f for f in params.post_fx if isinstance(f, str)))
        u2 = uniforms
        if "sky" in fx_chain:
            u2 = {k: v for k, v in uniforms.items() if k != "sky_panorama"}
            # Shaders can still sample the environment (e.g. the PBR
            # metals' reflections) through this alias — only the
            # post-step key moves.
            u2["env_panorama"] = uniforms["sky_panorama"]
        color, depth = render_frame(scene, u2, base,
                                    vertex_shader=vertex_shader,
                                    fragment_shader=fragment_shader,
                                    chunk=chunk, fb=fb)
        for fx in fx_chain:
            color, depth = _apply_post_fx(fx, color, depth, uniforms,
                                          params)
        return color, depth
    H, W = params.height, params.width
    view, proj = camera_matrices(uniforms, W, H)
    view_proj = ml.transform(view, proj, xp=jnp)          # row-vector V·P

    visible = culling.spheres_in_frustum(
        scene["bounds_center"], scene["bounds_radius"],
        scene["mesh_matrices"], view_proj, xp=jnp)        # (M,)
    if "mesh_visible" in uniforms:
        # App-driven per-mesh visibility (e.g. unused player-model slots in
        # the Dust2 demo) ANDed with the frustum test.
        visible = visible & jnp.asarray(uniforms["mesh_visible"], bool)
    if "tri_seg_starts" in scene:
        # Gather-free mesh->tri broadcast (culling.segment_broadcast):
        # the contiguous-segment cumsum form of the take below — exact,
        # and free of a per-element gather at crowd scale.
        tri_mask = culling.segment_broadcast(
            visible, scene["tri_seg_starts"],
            int(scene["tri_mesh_id"].shape[0]), xp=jnp)
    else:
        tri_mask = jnp.take(visible, scene["tri_mesh_id"])
    if "tri_lod_level" in scene:
        # Mesh LOD: keep only each mesh's active level (ops/lod.py).
        from softwarerenderer_tpu.ops import lod
        tri_mask = tri_mask & lod.lod_tri_mask(scene, uniforms, H, xp=jnp)

    # Per-input-triangle arrays every later stage reads; geom_cap below
    # swaps them for compacted views.
    indices = scene["indices"]
    tri_tex = jnp.asarray(scene["tri_texture_id"], jnp.int32)
    tri_mesh = jnp.asarray(scene["tri_mesh_id"], jnp.int32)
    tri_ntex = (jnp.asarray(scene["tri_normal_tex_id"], jnp.int32)
                if "tri_normal_tex_id" in scene else None)
    geom_overflow = None
    if params.geom_cap:
        # Pre-GEOMETRY compaction (geometry.precompact_inputs): the
        # visibility+LOD mask is known before any vertex assembly, so
        # the build stage runs on the masked-in input triangles only —
        # counted by geom_overflow / "geom_cap_overflow".
        pt = {"tex": tri_tex, "mesh": tri_mesh}
        if tri_ntex is not None:
            pt["ntex"] = tri_ntex
        tri_mask, indices, pt, geom_overflow = geometry.precompact_inputs(
            tri_mask, params.geom_cap, indices, pt)
        tri_tex, tri_mesh = pt["tex"], pt["mesh"]
        tri_ntex = pt.get("ntex")

    model_pv = culling.model_matrices_per_vertex(scene, xp=jnp)
    u = dict(uniforms)
    u.update(model=model_pv, view=view, projection=proj,
             atlas_data=scene["atlas_data"],
             atlas_offsets=scene["atlas_offsets"],
             atlas_sizes=scene["atlas_sizes"],
             base_color=scene["base_color"])

    vin = {"position": scene["position"], "uv": scene["uv"],
           "normal": scene["normal"], "color": scene["color"]}
    vin = apply_vertex_updates(vin, scene, uniforms, view)
    # With active_cap, varying materialization is DEFERRED past the
    # compaction below (geometry.materialize_attrs) — the per-slot vertex
    # gathers are the dominant geometry cost at LOD-crowd scale and they
    # then run at cap size instead of packed-slot size.  Bit-exact.
    keep_v = getattr(fragment_shader, "varyings", None)
    defer = bool(params.active_cap)
    tris = geometry.build_triangles(
        vertex_shader, vin, indices, u,
        width=W, height=H, cull_mode=params.cull_mode,
        near_clip=u["near_clip"], tri_mask=tri_mask,
        keep_varyings=keep_v, defer_attrs=defer)

    # Per-triangle material plumbing; ×2 to match the clipper's fan slots.
    # Atlas regions resolve here (T-level takes ≈ free) so the fragment
    # stage's only per-pixel memory access is the texel gather itself.
    # Shaders can declare `tri_extras` (like `varyings`) to prune unused
    # channels from the resolve payload — fewer payload rows = fewer
    # bytes per resolved pixel.
    tid2 = jnp.repeat(tri_tex, 2)
    aoff = jnp.asarray(scene["atlas_offsets"], jnp.int32)
    asiz = jnp.asarray(scene["atlas_sizes"], jnp.int32)
    per_tri = {"tex_id": tid2,
               "mesh_id": jnp.repeat(tri_mesh, 2),
               "tex_oy": jnp.take(aoff[:, 0], tid2),
               "tex_ox": jnp.take(aoff[:, 1], tid2),
               "tex_h": jnp.take(asiz[:, 0], tid2),
               "tex_w": jnp.take(asiz[:, 1], tid2)}
    if tri_ntex is not None:
        nid2 = jnp.repeat(tri_ntex, 2)
        per_tri.update(nm_oy=jnp.take(aoff[:, 0], nid2),
                       nm_ox=jnp.take(aoff[:, 1], nid2),
                       nm_h=jnp.take(asiz[:, 0], nid2),
                       nm_w=jnp.take(asiz[:, 1], nid2))
    if "mesh_metallic" in scene:
        # PBR material channels, 8-bit-quantized into the integer
        # per-triangle extras (pruned unless the shader declares them).
        mid2 = jnp.repeat(tri_mesh, 2)

        def q256(table):
            return jnp.clip(jnp.round(jnp.take(
                jnp.asarray(table, F32), mid2) * F32(256.0)),
                0, 1020).astype(jnp.int32)

        em = jnp.asarray(scene["mesh_emissive"], F32)
        bc = jnp.asarray(scene["base_color"], F32)
        per_tri.update(mat_m256=q256(scene["mesh_metallic"]),
                       mat_r256=q256(scene["mesh_roughness"]),
                       mat_er256=q256(em[:, 0]),
                       mat_eg256=q256(em[:, 1]),
                       mat_eb256=q256(em[:, 2]),
                       mat_br256=q256(bc[:, 0]),
                       mat_bg256=q256(bc[:, 1]),
                       mat_bb256=q256(bc[:, 2]))
    if params.use_mipmaps and "atlas_mip_offsets" in scene:
        # Per-triangle LOD (deferred shading has no pixel quads for
        # derivatives): texel-per-pixel ratio = |uv cross| · texels ·
        # |inv screen cross|; each clip-fan slot uses its own screen area.
        # Per-polygon mipping is coarse on mega-triangles spanning near to
        # far (they keep one level) — subdivide such geometry, as classic
        # per-polygon-mip engines did.
        from softwarerenderer_tpu.models.scene import MAX_MIP_LEVELS
        uvb = jnp.asarray(scene["uv"], F32)
        idx = jnp.asarray(indices, jnp.int32).reshape(-1, 3)
        e1 = jnp.take(uvb, idx[:, 1], axis=0) \
            - jnp.take(uvb, idx[:, 0], axis=0)
        e2 = jnp.take(uvb, idx[:, 2], axis=0) \
            - jnp.take(uvb, idx[:, 0], axis=0)
        uv_cross = jnp.abs(e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0])
        texels = jnp.take((asiz[:, 0] * asiz[:, 1]).astype(F32), tri_tex)
        uv2 = jnp.repeat(uv_cross * texels, 2)
        ratio = jnp.maximum(uv2 * jnp.abs(tris["inv_area"]), F32(1.0))
        lod = F32(0.5) * jnp.log2(ratio)
        nm = jnp.take(jnp.asarray(scene["atlas_n_mips"], jnp.int32), tid2)
        moff = jnp.asarray(scene["atlas_mip_offsets"],
                           jnp.int32).reshape(-1, 2)
        msiz = jnp.asarray(scene["atlas_mip_sizes"],
                           jnp.int32).reshape(-1, 2)
        if params.use_mipmaps == "trilinear":
            # Two bracketing mips + an 8-bit fraction (per-tri extras are
            # integer channels); pair with scene_fragment_shader_trilinear.
            mip0 = jnp.clip(jnp.floor(lod).astype(jnp.int32), 0, nm - 1)
            mip1 = jnp.minimum(mip0 + 1, nm - 1)
            frac = jnp.where(mip1 > mip0, lod - jnp.floor(lod), 0.0)
            frac = jnp.clip(jnp.round(frac * F32(256.0)), 0, 255) \
                .astype(jnp.int32)
            f0 = tid2 * MAX_MIP_LEVELS + mip0
            f1 = tid2 * MAX_MIP_LEVELS + mip1
            per_tri.update(tex_oy=jnp.take(moff[:, 0], f0),
                           tex_ox=jnp.take(moff[:, 1], f0),
                           tex_h=jnp.take(msiz[:, 0], f0),
                           tex_w=jnp.take(msiz[:, 1], f0),
                           tex_oy2=jnp.take(moff[:, 0], f1),
                           tex_ox2=jnp.take(moff[:, 1], f1),
                           tex_h2=jnp.take(msiz[:, 0], f1),
                           tex_w2=jnp.take(msiz[:, 1], f1),
                           mip_frac256=frac)
        else:
            mip = jnp.clip((lod + F32(0.5)).astype(jnp.int32), 0, nm - 1)
            flat = tid2 * MAX_MIP_LEVELS + mip
            per_tri.update(tex_oy=jnp.take(moff[:, 0], flat),
                           tex_ox=jnp.take(moff[:, 1], flat),
                           tex_h=jnp.take(msiz[:, 0], flat),
                           tex_w=jnp.take(msiz[:, 1], flat))
    tri_extras = getattr(fragment_shader, "tri_extras", None)
    if tri_extras is not None:
        per_tri = {k: v for k, v in per_tri.items() if k in tri_extras}

    if params.kbuffer > 1 and params.kbuffer_short_circuit:
        # Semantically-opaque flags ride as an extra per-triangle channel
        # so the depth-peeled K-buffer can stop behind opaque VISIBLE
        # winners and lax.cond-skip entirely-empty passes
        # (tile_fold.render_kbuffer_peel; the XLA fold ignores the
        # channel).
        opq = opaque_tri_flags(scene, vin, fragment_shader, params,
                               indices=indices, tri_texture_id=tri_tex)
        if opq is not None:
            per_tri["opq"] = opq

    cap_overflow = None
    if params.active_cap:
        # Compact valid slots to a static prefix so binning/stream cost
        # tracks ACTIVE triangles, not packed slots (LOD levels, hidden
        # meshes).  Exact while the frame fits the cap — use
        # ops/lod.suggested_active_cap for a bound that always does, or
        # a tighter workload cap watched via active_cap_stats.
        n_slots = tris["valid"].shape[0]
        tris, per_tri, n_valid = geometry.compact_triangles(
            tris, params.active_cap, per_tri)
        cap_overflow = jnp.maximum(
            0, n_valid - min(params.active_cap, n_slots))
    if defer:
        tris = geometry.materialize_attrs(tris)

    if fb is None:
        clear = jnp.asarray(uniforms["clear_color"], dtype=F32)
        fb_color = jnp.broadcast_to(clear, (H, W, 4))
        fb_depth = jnp.full((H, W), raster.DEPTH_CLEAR, dtype=F32)
    else:
        fb_color, fb_depth = fb
    def _dispatch():
        from softwarerenderer_tpu.config import DebugMode, DepthTest
        order_dependent = params.depth_test in (DepthTest.EQUAL,
                                                DepthTest.NOT_EQUAL)
        if params.debug_mode == DebugMode.OVERDRAW:
            # Coverage heatmap (beyond reference; ops/debugviz.py) — the
            # returned depth plane carries the raw per-pixel counts.
            from softwarerenderer_tpu.ops import debugviz
            return debugviz.render_overdraw(tris, params)
        if params.debug_mode == DebugMode.DEPTH:
            from softwarerenderer_tpu.ops import debugviz
            return debugviz.render_depth_view(tris, params, fb_depth,
                                              chunk=chunk)
        if params.debug_mode == DebugMode.WIREFRAME:
            if params.deferred and not order_dependent:
                return raster.render_wireframe_deferred(
                    tris, fragment_shader, u, params, fb_color, fb_depth,
                    per_tri_extra=per_tri, chunk=chunk)
            from softwarerenderer_tpu.ops.forward import render_forward
            return render_forward(tris, fragment_shader, u, params,
                                  fb_color, fb_depth, per_tri_extra=per_tri)
        if not params.deferred or order_dependent:
            from softwarerenderer_tpu.ops.forward import render_forward
            return render_forward(tris, fragment_shader, u, params,
                                  fb_color, fb_depth, per_tri_extra=per_tri)
        if params.binned:
            route = fold_route(params)
            if params.kbuffer > 1:
                # Order-correct translucency / discard-reveal: K-layer replay
                # of the reference's sequential shade-blend (Rasterizer.cs:
                # 509-523) at binned cost — depth-peeled kernel folds, or
                # the XLA K-slot fold.
                if route != "xla":
                    from softwarerenderer_tpu.ops.tile_fold import (
                        render_kbuffer_peel,
                    )
                    return render_kbuffer_peel(
                        tris, fragment_shader, u, params, fb_color, fb_depth,
                        per_tri_extra=per_tri,
                        interpret=route == "interpret",
                        with_stats=params.kbuffer_stats)
                from softwarerenderer_tpu.ops.kbuffer import (
                    render_binned_kbuffer,
                )
                return render_binned_kbuffer(tris, fragment_shader, u, params,
                                             fb_color, fb_depth,
                                             per_tri_extra=per_tri,
                                             with_stats=params.kbuffer_stats)
            if route != "xla":
                from softwarerenderer_tpu.ops.tile_fold import (
                    render_tile_kernel,
                )
                return render_tile_kernel(tris, fragment_shader, u, params,
                                          fb_color, fb_depth,
                                          per_tri_extra=per_tri,
                                          interpret=route == "interpret")
            # Fully fused tile renderer: visibility + one-hot-matmul attribute
            # resolve + shading inside one per-tile loop (no full-screen
            # per-pixel gathers).
            from softwarerenderer_tpu.ops.binning import render_binned_fused
            return render_binned_fused(tris, fragment_shader, u, params,
                                       fb_color, fb_depth,
                                       per_tri_extra=per_tri)
        return raster.render_deferred(tris, fragment_shader, u, params,
                                      fb_color, fb_depth, per_tri_extra=per_tri,
                                      chunk=chunk)

    out = _dispatch()
    if params.active_cap_stats:
        # Runtime capacity counters (the K-overflow analog): frames are
        # exact iff every *_overflow == 0.  live_pairs is always
        # reported so workloads can be MEASURED before choosing
        # params.pair_cap (size the cap to live_pairs × headroom).
        from softwarerenderer_tpu.ops import binning
        live = binning.live_pair_count(tris, params)
        live_glob = binning.global_count(tris, params)
        stats = {"live_pairs": live, "live_globals": live_glob}
        if params.active_cap:
            stats["active_cap_overflow"] = cap_overflow
        if params.geom_cap:
            stats["geom_cap_overflow"] = geom_overflow
        if params.pair_cap:
            stats["pair_cap_overflow"] = jnp.maximum(
                0, live - params.pair_cap)
        if len(out) == 3:
            return out[0], out[1], {**out[2], **stats}
        return out[0], out[1], stats
    return out


def render_frame_multiview(scene: Dict, uniforms: Dict,
                           params: RenderParams, views,
                           layout: str = "h",
                           vertex_shader: Callable = scene_vertex_shader,
                           fragment_shader: Callable =
                           scene_fragment_shader,
                           chunk: int = 128):
    """Split-screen / multi-camera: render len(views) views of the same
    scene inside ONE jitted program and tile them into the (H, W) frame
    — local co-op splits, CCTV walls, stereo pairs.  Beyond the
    reference (one camera, Renderer.cs:404-419); unlike engine.rtt this
    composes the views in framebuffer space, so every view keeps full
    resolution and its own post-FX/translucency settings via `params`.

    `views` is a tuple of per-view uniform OVERRIDE dicts (camera pose,
    fov, lights, "mesh_visible" — anything in default_frame_uniforms);
    keys not overridden fall through to `uniforms`.  layout "h" tiles
    side-by-side columns, "v" stacks rows; the split axis must divide
    evenly.  Returns (color (H, W, 4), depth (H, W)) like render_frame —
    each tile is bit-identical to rendering that view alone at the tile
    resolution when `views` rides the jit as a traced pytree (pass it as
    an argument; a closed-over constant camera may constant-fold its
    view matrix with different FMA contraction and flip borderline edge
    pixels — PARITY.md cross-compilation note).
    """
    n = len(views)
    if n < 1:
        raise ValueError("views must be non-empty")
    if layout not in ("h", "v"):
        raise ValueError("layout must be 'h' or 'v'")
    if layout == "h":
        if params.width % n:
            raise ValueError(f"width {params.width} not divisible by "
                             f"{n} views")
        vp = params.replace(width=params.width // n)
    else:
        if params.height % n:
            raise ValueError(f"height {params.height} not divisible by "
                             f"{n} views")
        vp = params.replace(height=params.height // n)
    colors, depths = [], []
    for ov in views:
        u = dict(uniforms)
        u.update(ov)
        c, d = render_frame(scene, u, vp, vertex_shader=vertex_shader,
                            fragment_shader=fragment_shader, chunk=chunk)
        colors.append(c)
        depths.append(d)
    axis = 1 if layout == "h" else 0
    return (jnp.concatenate(colors, axis=axis),
            jnp.concatenate(depths, axis=axis))


def render_frame_pip(scene: Dict, uniforms: Dict, params: RenderParams,
                     pip_frac: int = 4, corner: str = "tc",
                     mirror: bool = True, border: int = 2,
                     vertex_shader: Callable = scene_vertex_shader,
                     fragment_shader: Callable = scene_fragment_shader,
                     chunk: int = 128):
    """Main view + a picture-in-picture inset of a second camera, both
    inside ONE jitted program — the classic rear-view mirror / kill-cam
    overlay (beyond the reference, which renders exactly one camera,
    Renderer.cs:404-419).

    The inset renders the SAME scene at (W, H)/pip_frac with the uniform
    overrides in uniforms["pip_view"] (camera pose, fov, "mesh_visible" —
    e.g. hide the view-model gun from a rear view), then pastes into the
    chosen corner ("tl"/"tr"/"bl"/"br"/"tc" top-center) over a
    `border`-px frame.  mirror=True flips the inset horizontally (a real
    mirror image).  Unlike engine/rtt.py (which writes a texture slot
    consumed by in-world geometry), this composites in framebuffer space
    — no atlas slot, no monitor mesh, full inset resolution.

    uniforms["hud_text"] (the device text overlay) is stripped from the
    inset render so burned-in HUD elements don't re-render inside the
    mirror.  Depth returns from the MAIN view untouched.
    """
    color, depth = render_frame(scene, uniforms, params,
                                vertex_shader=vertex_shader,
                                fragment_shader=fragment_shader,
                                chunk=chunk)
    pw = max(1, params.width // pip_frac)
    ph = max(1, params.height // pip_frac)
    pp = params.replace(width=pw, height=ph)
    pu = {k: v for k, v in uniforms.items() if k != "hud_text"}
    pu.update(uniforms.get("pip_view", {}))
    pc, _ = render_frame(scene, pu, pp, vertex_shader=vertex_shader,
                         fragment_shader=fragment_shader, chunk=chunk)
    if mirror:
        pc = pc[:, ::-1]
    m = border
    H, W = params.height, params.width
    offs = {"tl": (m, m), "tr": (m, W - pw - m),
            "bl": (H - ph - m, m), "br": (H - ph - m, W - pw - m),
            "tc": (m, (W - pw) // 2)}
    if corner not in offs:
        raise ValueError(f"corner must be one of {sorted(offs)}")
    y0, x0 = offs[corner]
    y0, x0 = max(0, y0), max(0, x0)
    frame_col = jnp.asarray([0.05, 0.05, 0.05, 1.0], F32)
    yb0, xb0 = max(0, y0 - m), max(0, x0 - m)
    color = color.at[yb0:y0 + ph + m, xb0:x0 + pw + m].set(frame_col)
    color = color.at[y0:y0 + ph, x0:x0 + pw].set(pc)
    return color, depth


def render_frame_with_shadows(scene: Dict, uniforms: Dict,
                              params: RenderParams,
                              shadow_size: int = 512,
                              vertex_shader: Optional[Callable] = None,
                              fragment_shader: Optional[Callable] = None,
                              chunk: int = 128):
    """Frame with a directional shadow map — one extra depth-only pass
    from the light inside the SAME jitted program (ops/shadows.py; a
    capability beyond the reference, ROADMAP #5).

    The light camera auto-fits the scene's world bounds; pass a custom
    fragment shader that calls shadows.shadow_factor to restyle the
    shadow response (the default is the game shader with shadowed pixels
    falling to the ambient floor)."""
    from softwarerenderer_tpu.ops.lighting import lit_scene_vertex_shader
    from softwarerenderer_tpu.ops.shadows import (
        directional_light_camera,
        render_shadow_depth,
        shadowed_scene_fragment_shader,
    )

    vertex_shader = vertex_shader or lit_scene_vertex_shader
    fragment_shader = fragment_shader or shadowed_scene_fragment_shader

    # World-space scene bounds (same conservative max-scale as culling).
    mm = jnp.asarray(scene["mesh_matrices"], F32)
    wc = ml.transform_point(jnp.asarray(scene["bounds_center"], F32), mm,
                            xp=jnp)
    row_norms = jnp.sqrt(jnp.sum(mm[:, :3, :3] ** 2, axis=-1))
    wr = jnp.asarray(scene["bounds_radius"], F32) * jnp.max(row_norms, -1)
    center = jnp.mean(wc, axis=0)
    radius = jnp.max(jnp.linalg.norm(wc - center, axis=-1) + wr)

    view, proj, _ = directional_light_camera(
        uniforms["light_direction"], center, radius)
    smap = render_shadow_depth(scene, uniforms, view, proj, shadow_size,
                               params)
    u = dict(uniforms)
    u.update(shadow_map=smap, shadow_view=view, shadow_proj=proj)
    return render_frame(scene, u, params, vertex_shader=vertex_shader,
                        fragment_shader=fragment_shader, chunk=chunk)


def to_rgb8(color: jnp.ndarray) -> jnp.ndarray:
    """Device-side RGBA f32 → RGB u8 (the present conversion the reference
    does on CPU threads, MainWindow.cs:236-240)."""
    return (jnp.clip(color[..., :3], 0.0, 1.0) * F32(255.0)
            ).astype(jnp.uint8)


class Engine:
    """Holds device-resident scene buffers and the compiled frame program.

    Usage:
        eng = Engine(build_scene_buffers(instances), RenderParams(w, h))
        u = eng.uniforms               # mutate traced values freely
        color, depth = eng.render(u)   # jitted; no recompile on tuning
        rgb = eng.present(u)           # uint8 RGB on host
    """

    def __init__(self, scene: Dict, params: RenderParams,
                 vertex_shader: Callable = scene_vertex_shader,
                 fragment_shader: Callable = scene_fragment_shader,
                 chunk: int = 128, rtt_passes: tuple = (),
                 frame_fn: Optional[Callable] = None):
        self.params = params
        self.scene = jax.device_put(scene)
        self.uniforms = default_frame_uniforms(params.width, params.height)
        if rtt_passes and frame_fn is not None:
            raise ValueError("frame_fn cannot combine with rtt_passes "
                             "(the RTT wrapper owns the whole-frame "
                             "program); wrap render_frame_rtt yourself")
        if rtt_passes:
            # Render-to-texture passes (engine/rtt.py): each pass gets its
            # own complete uniforms sub-dict, tunable without recompile.
            from softwarerenderer_tpu.engine.rtt import render_frame_rtt
            for p in rtt_passes:
                self.uniforms[p.uniforms_key] = default_frame_uniforms(
                    p.params.width, p.params.height)
            self._frame = jax.jit(functools.partial(
                render_frame_rtt, params=params, passes=tuple(rtt_passes),
                vertex_shader=vertex_shader,
                fragment_shader=fragment_shader, chunk=chunk))
        else:
            # frame_fn: render_frame-compatible callable (e.g.
            # render_frame_pip, or a functools.partial of it) — the
            # whole-frame program stays swappable without subclassing.
            self._frame = jax.jit(functools.partial(
                frame_fn or render_frame, params=params,
                vertex_shader=vertex_shader,
                fragment_shader=fragment_shader, chunk=chunk))
        self._present = jax.jit(lambda s, u: to_rgb8(self._frame(s, u)[0]))

    def render(self, uniforms: Optional[Dict] = None):
        return self._frame(self.scene, uniforms or self.uniforms)

    def present(self, uniforms: Optional[Dict] = None) -> np.ndarray:
        return np.asarray(self._present(self.scene,
                                        uniforms or self.uniforms))


def render_frame_with_point_shadows(scene: Dict, uniforms: Dict,
                                    params: RenderParams,
                                    shadow_size: int = 256,
                                    vertex_shader=None,
                                    fragment_shader=None,
                                    chunk: int = 128):
    """Frame lit by one point light with cube shadows — six depth-only
    passes from the light position inside the SAME jitted program
    (ops/shadows.py point-light extension; beyond the reference, which
    imports point lights but never consumes them, Light.cs:19-32).

    uniforms must carry point_light_position / point_light_color (and
    optionally point_light_range)."""
    from softwarerenderer_tpu.ops.lighting import lit_scene_vertex_shader
    from softwarerenderer_tpu.ops.shadows import (
        point_shadowed_fragment_shader,
        render_point_shadow_depth,
    )

    vertex_shader = vertex_shader or lit_scene_vertex_shader
    fragment_shader = fragment_shader or point_shadowed_fragment_shader

    smap, views, projs = render_point_shadow_depth(
        scene, uniforms, uniforms["point_light_position"],
        shadow_size=shadow_size, params=params)
    u = dict(uniforms)
    u.update(point_shadow_map=smap, point_shadow_views=views,
             point_shadow_projs=projs)
    return render_frame(scene, u, params, vertex_shader=vertex_shader,
                        fragment_shader=fragment_shader, chunk=chunk)


def render_frame_with_spot_shadow(scene: Dict, uniforms: Dict,
                                  params: RenderParams,
                                  shadow_size: int = 512,
                                  vertex_shader=None,
                                  fragment_shader=None,
                                  chunk: int = 128):
    """Frame lit by one spot light with a shadow map — a single
    perspective depth-only pass along the cone axis (ops/shadows.py).

    uniforms must carry spot_position / spot_direction / spot_inner /
    spot_outer (radians) / spot_color (and optionally spot_range)."""
    from softwarerenderer_tpu.ops.lighting import lit_scene_vertex_shader
    from softwarerenderer_tpu.ops.shadows import (
        render_shadow_depth,
        spot_light_camera,
        spot_shadowed_fragment_shader,
    )

    vertex_shader = vertex_shader or lit_scene_vertex_shader
    fragment_shader = fragment_shader or spot_shadowed_fragment_shader

    view, proj = spot_light_camera(uniforms["spot_position"],
                                   uniforms["spot_direction"],
                                   uniforms["spot_outer"])
    smap = render_shadow_depth(scene, uniforms, view, proj, shadow_size,
                               params)
    u = dict(uniforms)
    u.update(shadow_map=smap, shadow_view=view, shadow_proj=proj)
    return render_frame(scene, u, params, vertex_shader=vertex_shader,
                        fragment_shader=fragment_shader, chunk=chunk)
