"""Tangent-space normal mapping.

The reference's asset pipeline extracts normal-map texture paths
(/root/reference/ModelLoader.cs:221-281, slot "normals" — e.g. the Gun's
`textures/Material.002_normal.png`) and Assimp even computes tangents
(CalcTangentSpace, ModelLoader.cs:149), but no reference shader ever
samples them.  This module closes that gap on the device:

  * ``compute_tangents`` — host-side per-vertex tangent generation
    (uv-gradient accumulation + Gram-Schmidt, handedness in w), run once
    at scene-pack time (models/scene.py) for meshes with a normal map.
  * ``normal_mapped_vertex_shader`` / ``normal_mapped_fragment_shader``
    — the game shader pair extended with a world-space TBN transform of
    the sampled tangent-space normal.  The normal map rides the SAME
    packed atlas as the diffuse textures; its per-triangle region
    channels (nm_*) resolve at triangle level like the diffuse ones, so
    the only extra per-pixel memory access is the one texel row-gather.
"""

from __future__ import annotations

import numpy as np

from softwarerenderer_tpu.ops import texture as tex_ops
from softwarerenderer_tpu.utils import mathlib as ml

F32 = np.float32


def compute_tangents(position: np.ndarray, uv: np.ndarray,
                     normal: np.ndarray, indices: np.ndarray) -> np.ndarray:
    """Per-vertex (V, 4) tangents: xyz = Gram-Schmidt-orthogonalized
    uv-aligned tangent, w = bitangent handedness (±1).  Standard
    Lengyel-style accumulation over triangles (host-side, pack time)."""
    idx = np.asarray(indices, np.int64).reshape(-1, 3)
    p = np.asarray(position, np.float64)
    t = np.asarray(uv, np.float64)
    v0, v1, v2 = idx[:, 0], idx[:, 1], idx[:, 2]
    e1 = p[v1] - p[v0]
    e2 = p[v2] - p[v0]
    du1 = t[v1] - t[v0]
    du2 = t[v2] - t[v0]
    det = du1[:, 0] * du2[:, 1] - du2[:, 0] * du1[:, 1]
    r = np.where(np.abs(det) < 1e-12, 0.0, 1.0 / np.where(det == 0, 1, det))
    tan = (e1 * du2[:, 1:2] - e2 * du1[:, 1:2]) * r[:, None]
    bit = (e2 * du1[:, 0:1] - e1 * du2[:, 0:1]) * r[:, None]

    acc_t = np.zeros_like(p)
    acc_b = np.zeros_like(p)
    for k, vk in enumerate((v0, v1, v2)):
        np.add.at(acc_t, vk, tan)
        np.add.at(acc_b, vk, bit)
    n = np.asarray(normal, np.float64)
    # Gram-Schmidt against the vertex normal.
    tangent = acc_t - n * np.sum(n * acc_t, axis=-1, keepdims=True)
    ln = np.linalg.norm(tangent, axis=-1, keepdims=True)
    fallback = np.where(np.abs(n[:, 0:1]) < 0.9,
                        np.asarray([1.0, 0, 0]), np.asarray([0, 0, 1.0]))
    tangent = np.where(ln > 1e-8, tangent / np.where(ln == 0, 1, ln),
                       fallback)
    hand = np.sign(np.sum(np.cross(n, tangent) * acc_b, axis=-1))
    hand = np.where(hand == 0, 1.0, hand)
    return np.concatenate([tangent, hand[:, None]], axis=-1).astype(F32)


def normal_mapped_vertex_shader(vin, uniforms, xp=np):
    """scene_vertex_shader + a world-space tangent varying (xyz rotated
    by the model matrix, w handedness passed through)."""
    model = uniforms["model"]
    world = ml.transform(ml.homogenize(vin["position"], xp=xp), model, xp=xp)
    view_pos = ml.transform(world, uniforms["view"], xp=xp)
    clip = ml.transform(view_pos, uniforms["projection"], xp=xp)
    world_normal = ml.normalize(
        ml.transform_normal(vin["normal"], model, xp=xp), xp=xp, eps=1e-30)
    tan = vin["tangent"]
    world_tan = ml.normalize(
        ml.transform_normal(tan[..., :3], model, xp=xp), xp=xp, eps=1e-30)
    return {
        "clip_position": clip,
        "color": vin["color"],
        "uv": vin["uv"],
        "normal": vin["normal"],
        "data": {"world_normal": world_normal,
                 "world_tangent": xp.concatenate(
                     [world_tan, tan[..., 3:4]], axis=-1)},
    }


def normal_mapped_fragment_shader(frag, uniforms, xp=np):
    """The game shader (texture × color, half-Lambert, fog —
    Renderer.cs:848-860) with the normal perturbed by the tangent-space
    normal map before lighting."""
    n = frag["data"]["world_normal"]
    n = n / xp.sqrt(xp.maximum(xp.sum(n * n, -1, keepdims=True),
                               F32(1e-30)))
    t4 = frag["data"]["world_tangent"]
    t = t4[..., :3]
    t = t - n * xp.sum(n * t, -1, keepdims=True)
    t = t / xp.sqrt(xp.maximum(xp.sum(t * t, -1, keepdims=True),
                               F32(1e-30)))
    b = xp.cross(n, t) * t4[..., 3:4]
    tri = frag["tri"]
    nm = tex_ops.sample_atlas_region(
        uniforms["atlas_data"], tri["nm_oy"], tri["nm_ox"],
        tri["nm_h"], tri["nm_w"], frag["uv"], xp=xp)
    nm = nm[..., :3] * F32(2.0) - F32(1.0)
    world_n = (t * nm[..., 0:1] + b * nm[..., 1:2] + n * nm[..., 2:3])
    world_n = world_n / xp.sqrt(xp.maximum(
        xp.sum(world_n * world_n, -1, keepdims=True), F32(1e-30)))

    light_dir = uniforms["light_direction"]
    diffuse = xp.maximum(F32(0.25), ml.dot(world_n, -light_dir, xp=xp))
    tex_color = tex_ops.sample_atlas_region(
        uniforms["atlas_data"], tri["tex_oy"], tri["tex_ox"],
        tri["tex_h"], tri["tex_w"], frag["uv"], xp=xp)
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


normal_mapped_fragment_shader.varyings = (
    "color", "uv", "data.world_normal", "data.world_tangent")
normal_mapped_fragment_shader.tri_extras = (
    "tex_oy", "tex_ox", "tex_h", "tex_w",
    "nm_oy", "nm_ox", "nm_h", "nm_w")
# Alpha provenance (engine.opaque_tri_flags): output alpha is vertex
# color.a x texture alpha (material/lighting touch rgb only).
normal_mapped_fragment_shader.alpha_sources = ("color", "texture")
