"""Programmable shader ABI — user-supplied vertex + fragment programs.

The reference makes shaders first-class via C# delegates supplied per mesh
(Shaders.cs:97-98, consumed at Rasterizer.cs:187,509); the game's shaders
live at Renderer.cs:830-860.  Here a shader is a plain Python function over
*arrays* (leading dims broadcast), so the same function runs scalar-faithful
under NumPy in the golden reference and batched/fused under jit on device:

  vertex_shader(vin: dict, uniforms: dict, xp) -> dict
      vin:  {"position": (...,3), "uv": (...,2), "normal": (...,3),
             "color": (...,4)}                       (Shaders.cs:10-24)
      out:  {"clip_position": (...,4), "color": (...,4), "uv": (...,2),
             "normal": (...,3), "data": {name: (...,K)}}
      The "data" dict is the user-extensible varying channel mirroring
      VertexOutput.Data (Shaders.cs:33); its vec3 entries are re-normalized
      after perspective-correct interpolation exactly like
      Rasterizer.InterpolateData (Rasterizer.cs:680-688).

  fragment_shader(frag: dict, uniforms: dict, xp) -> rgba (...,4)
      frag adds "screen_coords" (...,2) and "barycentric" (...,3)
      (normalized screen position / perspective-corrected weights, as the
      reference's Interpolate produces at Rasterizer.cs:629-639).
      Discard by returning alpha <= 0 (the reference's `null or W<=0`
      convention, Rasterizer.cs:511).

Uniforms are a dict of arrays (model/view/projection matrices, fog, light,
...) traced through jit, so live-tuning never recompiles.
"""

from __future__ import annotations

import numpy as np

from softwarerenderer_tpu.utils import mathlib as ml

F32 = np.float32

VARYING_KEYS = ("clip_position", "color", "uv", "normal")


def make_vertex_input(position, uv=None, normal=None, color=None, xp=np):
    """Assemble the vertex-attribute dict with reference defaults
    (white vertex color, zero normal/uv when absent — ModelLoader.cs:188-194)."""
    position = xp.asarray(position, dtype=xp.float32)
    n = position.shape[:-1]
    if uv is None:
        uv = xp.zeros(n + (2,), dtype=xp.float32)
    if normal is None:
        normal = xp.zeros(n + (3,), dtype=xp.float32)
    if color is None:
        color = xp.ones(n + (4,), dtype=xp.float32)
    return {
        "position": position,
        "uv": xp.asarray(uv, dtype=xp.float32),
        "normal": xp.asarray(normal, dtype=xp.float32),
        "color": xp.asarray(color, dtype=xp.float32),
    }


def default_vertex_shader(vin, uniforms, xp=np):
    """The game's vertex shader (Renderer.cs:830-846): MVP transform plus a
    world-space normal in the `data` varying channel."""
    model = uniforms["model"]
    view = uniforms["view"]
    projection = uniforms["projection"]
    world = ml.transform(ml.homogenize(vin["position"], xp=xp), model, xp=xp)
    view_pos = ml.transform(world, view, xp=xp)
    clip = ml.transform(view_pos, projection, xp=xp)
    world_normal = ml.normalize(
        ml.transform_normal(vin["normal"], model, xp=xp), xp=xp, eps=1e-30)
    return {
        "clip_position": clip,
        "color": vin["color"],
        "uv": vin["uv"],
        "normal": vin["normal"],
        "data": {"world_normal": world_normal},
    }


def default_fragment_shader(frag, uniforms, xp=np):
    """The game's fragment shader (Renderer.cs:848-860): texture * vertex
    color, half-Lambert-ish max(0.25, N·-L), smoothstep fog on clip-space Z,
    alpha passed through unfogged."""
    from softwarerenderer_tpu.ops import texture as tex_ops

    world_normal = frag["data"]["world_normal"]
    light_dir = uniforms["light_direction"]
    diffuse = xp.maximum(F32(0.25), ml.dot(world_normal, -light_dir, xp=xp))
    texture = uniforms.get("texture")
    if texture is not None:
        tex_color = tex_ops.sample_nearest(texture, frag["uv"], xp=xp)
    else:
        tex_color = xp.ones(frag["uv"].shape[:-1] + (4,), dtype=xp.float32)
    base = frag["color"] * tex_color
    depth = frag["clip_position"][..., 2]
    fog_start = uniforms["fog_start"]
    fog_end = uniforms["fog_end"]
    fog = xp.clip((fog_end - depth) / (fog_end - fog_start), F32(0.0), F32(1.0))
    fog = fog * fog * (F32(3.0) - F32(2.0) * fog)
    lit = base * (F32(0.1) + F32(0.9) * diffuse[..., None]) * uniforms["light_color"]
    rgba = uniforms["fog_color"] + (lit - uniforms["fog_color"]) * fog[..., None]
    return xp.concatenate([rgba[..., :3], base[..., 3:4]], axis=-1)


def flat_color_fragment_shader(frag, uniforms, xp=np):
    """Minimal unlit shader: interpolated vertex color only."""
    return frag["color"]


flat_color_fragment_shader.varyings = ("color",)


def textured_fragment_shader(frag, uniforms, xp=np):
    """Texture * vertex color, no lighting/fog."""
    from softwarerenderer_tpu.ops import texture as tex_ops

    tex_color = tex_ops.sample_nearest(uniforms["texture"], frag["uv"], xp=xp)
    return frag["color"] * tex_color


textured_fragment_shader.varyings = ("color", "uv")
default_fragment_shader.varyings = ("color", "uv", "data.world_normal")
