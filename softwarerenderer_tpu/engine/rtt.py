"""Render-to-texture: multi-pass rendering inside one jitted program.

A capability beyond the reference (it has no offscreen render targets —
its only "texture source" is Assimp-loaded image files,
/root/reference/Texture.cs:70-94): render the scene from any extra camera
into a texture-atlas slot, then render the main view with that slot
textured onto geometry — a security monitor, a mirror, a portal.

Design: the whole multi-pass frame is ONE functional program.
The packed atlas (models/scene.pack_atlas) is just an array in the scene
pytree, so "writing a render target" is a `lax.dynamic_update_slice` into
the slot's sub-rectangle — static update shape, traced offsets, no host
round-trip and no recompile between passes.  Mip levels are rebuilt on
device with the exact pack-time box filter, so a dynamic texture samples
identically to the same image packed statically (test_rtt.py asserts
bit-equality).

Usage:
    slot = rtt_slot(128, 128)                 # placeholder image
    inst = MeshInstance(screen_quad, M, texture=slot)
    sc = build_scene_buffers([inst, ...])
    tid = atlas_id_of([inst, ...], slot)      # the slot's atlas id
    passes = (RttPass(tex_id=tid, params=RenderParams(128, 128),
                      uniforms_key="cctv"),)
    eng = Engine(sc, params, rtt_passes=passes)   # or render_frame_rtt(...)
    eng.uniforms["cctv"]["camera_position"] = ...  # traced; no recompile
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from softwarerenderer_tpu.config import RenderParams

F32 = np.float32


def rtt_slot(height: int, width: int,
             fill=(0.0, 0.0, 0.0, 0.0)) -> np.ndarray:
    """Placeholder image reserving an (height, width) atlas region whose
    content will be written per frame on device.

    The default fill has alpha 0 so the slot is NOT provably opaque at
    pack time (models/scene.TextureAtlas.min_alpha) — the K-buffer's
    opaque short-circuit then stays conservative no matter what alpha the
    rendered content carries.  Use an opaque fill only if every frame you
    write is fully opaque."""
    return np.broadcast_to(np.asarray(fill, F32),
                           (height, width, 4)).copy()


def atlas_id_of(instances, texture) -> int:
    """The atlas texture id `build_scene_buffers` assigned to `texture`.

    Delegates to models/scene.assign_texture_ids — the same function the
    builder packs with — so the two cannot desync."""
    from softwarerenderer_tpu.models.scene import assign_texture_ids
    _textures, id_of, _neutral = assign_texture_ids(instances)
    if id(texture) not in id_of:
        raise ValueError("texture is not used by any instance "
                         "(build_scene_buffers would not pack it)")
    return id_of[id(texture)]


def _box_downsample(im, xp):
    """2x2 box filter with odd row/col duplication — must stay in lockstep
    with models/scene._box_downsample (the pack-time mip builder) so
    device-rebuilt mips equal statically packed ones."""
    h, w = im.shape[0], im.shape[1]
    if h % 2:
        im = xp.concatenate([im, im[-1:]], axis=0)
        h += 1
    if w % 2:
        im = xp.concatenate([im, im[:, -1:]], axis=1)
        w += 1
    return im.reshape(h // 2, 2, w // 2, 2, im.shape[-1]).mean(axis=(1, 3))


def _quantize_u8(img, xp):
    """f32 [0,1] → u8 rows, exactly ops/texture.pack_rgba8."""
    return xp.clip(xp.round(xp.asarray(img, xp.float32) * F32(255.0)),
                   0.0, 255.0).astype(xp.uint8)


def _write_region(atlas, img_u8, oy, ox, xp):
    if xp is np:
        h, w = img_u8.shape[:2]
        atlas = np.array(atlas, copy=True)
        atlas[int(oy):int(oy) + h, int(ox):int(ox) + w] = img_u8
        return atlas
    return jax.lax.dynamic_update_slice(
        atlas, img_u8, (jnp.asarray(oy, jnp.int32),
                        jnp.asarray(ox, jnp.int32),
                        jnp.int32(0)))


def write_atlas_texture(scene: Dict, tex_id: int, color,
                        update_mips: bool = True, xp=jnp) -> Dict:
    """Functionally write a rendered image into texture `tex_id`'s atlas
    region; returns a new scene dict sharing every other buffer.

    `color` is (h, w, 4) float32 in [0,1] and MUST match the slot's
    pack-time placeholder size (`rtt_slot`) — the update shape is static,
    so a mismatch is a compile-time shape error, not corruption.  The
    image goes through the identical quantize-then-mip pipeline as
    pack-time textures (pack_rgba8 grid, box-filtered chain), so sampling
    a dynamic slot matches sampling the same image packed statically."""
    img = xp.asarray(color, xp.float32)
    offs = scene["atlas_offsets"]
    atlas = _write_region(xp.asarray(scene["atlas_data"]),
                          _quantize_u8(img, xp),
                          offs[tex_id][0], offs[tex_id][1], xp)
    if update_mips and scene.get("atlas_mip_offsets") is not None:
        # Same chain-length rule as pack_atlas: stop at 1 px or
        # MAX_MIP_LEVELS; clamped table levels alias the coarsest region,
        # which the last loop iteration already wrote.
        from softwarerenderer_tpu.models.scene import MAX_MIP_LEVELS
        moff = scene["atlas_mip_offsets"]
        m = img
        lv = 1
        while lv < MAX_MIP_LEVELS and min(m.shape[0], m.shape[1]) > 1:
            m = _box_downsample(m, xp)
            atlas = _write_region(atlas, _quantize_u8(m, xp),
                                  moff[tex_id, lv][0], moff[tex_id, lv][1],
                                  xp)
            lv += 1
    out = dict(scene)
    out["atlas_data"] = atlas
    return out


@dataclasses.dataclass(frozen=True)
class RttPass:
    """One offscreen pass: render the scene with `params` using the
    uniforms sub-dict `uniforms[uniforms_key]`, write the color image into
    atlas slot `tex_id` (then later passes and the main view sample it).

    The sub-dict must be a complete frame-uniforms dict
    (default_frame_uniforms(params.width, params.height)); use its
    "mesh_visible" to hide e.g. the monitor surface from its own feed.
    Static fields only — tune cameras/lights through the sub-dict without
    recompiling."""

    tex_id: int
    params: RenderParams
    uniforms_key: str
    vertex_shader: Optional[Callable] = None
    fragment_shader: Optional[Callable] = None
    update_mips: bool = True

    def __post_init__(self):
        if self.params.kbuffer_stats or self.params.active_cap_stats:
            raise ValueError("RttPass params cannot request stats dicts "
                             "(the pass discards the third return value)")


def render_frame_rtt(scene: Dict, uniforms: Dict, params: RenderParams,
                     passes: Tuple[RttPass, ...],
                     vertex_shader: Callable = None,
                     fragment_shader: Callable = None,
                     chunk: int = 128, return_atlas: bool = False):
    """Multi-pass frame: run each RttPass in order (each sees the slots
    written by the passes before it), then render the main view over the
    updated atlas.  Jit-friendly with `params`/`passes`/`chunk` static.

    Returns (color, depth); with return_atlas=True, (color, depth,
    atlas_data) — feed the atlas back into scene["atlas_data"] next frame
    for feedback loops (a monitor showing itself shows last frame)."""
    from softwarerenderer_tpu.engine import renderer as eng

    vertex_shader = vertex_shader or eng.scene_vertex_shader
    fragment_shader = fragment_shader or eng.scene_fragment_shader
    for p in passes:
        pu = uniforms[p.uniforms_key]
        color, _depth = eng.render_frame(
            scene, pu, p.params,
            vertex_shader=p.vertex_shader or eng.scene_vertex_shader,
            fragment_shader=p.fragment_shader or eng.scene_fragment_shader,
            chunk=chunk)
        scene = write_atlas_texture(scene, p.tex_id, color,
                                    update_mips=p.update_mips, xp=jnp)
    pass_keys = {p.uniforms_key for p in passes}
    u_main = {k: v for k, v in uniforms.items() if k not in pass_keys}
    out = eng.render_frame(scene, u_main, params,
                           vertex_shader=vertex_shader,
                           fragment_shader=fragment_shader, chunk=chunk)
    if return_atlas:
        return out[0], out[1], scene["atlas_data"]
    return out
