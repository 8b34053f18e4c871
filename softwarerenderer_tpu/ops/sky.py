"""Equirectangular sky/environment mapping (beyond the reference, whose
background is a flat clear color — Renderer.cs:44 ClearColor).

A panorama image (the standard lat-long environment map) is sampled by
per-pixel view direction for every pixel the rasterizer left uncovered
(depth still at the -inf clear, ops/raster.DEPTH_CLEAR).  Composes with
every raster path — deferred, fused, Pallas, forward, K-buffer — because
it runs as a post-step on the (color, depth) frame, inside the same
jitted program.

Cost: the directions are pure elementwise math; the panorama
fetch is one bilinear sample (4 row-gathers) per pixel, the same cost
class as the texture atlas path.  Enable by passing
uniforms["sky_panorama"] = (H, W, 4) float32/uint8 array (see
engine.render_frame).
"""

from __future__ import annotations

import numpy as np

from softwarerenderer_tpu.utils import mathlib as ml

F32 = np.float32


def pixel_ray_directions(uniforms, width: int, height: int, xp=np):
    """World-space view ray direction per pixel (H, W, 3), matching the
    raster projection: pixel centers at integer coords (SURVEY.md §6
    note 5), Y-down screen → Y-up NDC, the .NET perspective's FOV is the
    vertical angle."""
    rot = xp.asarray(uniforms["camera_rotation"], dtype=xp.float32)
    front = ml.quat_rotate(xp.asarray([0.0, 0.0, -1.0], xp.float32), rot,
                           xp=xp)
    up = ml.quat_rotate(xp.asarray([0.0, 1.0, 0.0], xp.float32), rot, xp=xp)
    right = ml.cross(front, up, xp=xp)
    fov = xp.asarray(uniforms["fov_degrees"], xp.float32) \
        * F32(np.pi / 180.0)
    th = xp.tan(fov * F32(0.5))
    tw = th * F32(width / height)
    # Integer pixel coords (no +0.5 center offset): the rasterizer
    # evaluates coverage at integer screen coords (SURVEY.md §6 note 5;
    # geometry's NDC→screen map is x_ndc = px/W·2-1), so the sky sample
    # grid must match or the background shifts half a pixel vs geometry.
    xs = xp.arange(width, dtype=xp.float32) / F32(width) * F32(2.0) \
        - F32(1.0)
    ys = F32(1.0) - xp.arange(height, dtype=xp.float32) / F32(height) \
        * F32(2.0)
    d = (front[None, None]
         + xs[None, :, None] * tw * right[None, None]
         + ys[:, None, None] * th * up[None, None])
    return d / xp.sqrt(xp.maximum(xp.sum(d * d, axis=-1, keepdims=True),
                                  F32(1e-30)))


def sample_panorama(panorama, directions, xp=np):
    """Bilinear lat-long lookup: u from atan2 around +y (u=0.5 faces -z),
    v from elevation (v=0 at +y).  panorama: (H, W, 4) f32 or u8."""
    from softwarerenderer_tpu.ops.texture import (
        sample_atlas_region_bilinear,
    )
    d = xp.asarray(directions, xp.float32)
    u = F32(0.5) + xp.arctan2(d[..., 0], -d[..., 2]) \
        * F32(1.0 / (2.0 * np.pi))
    v = F32(0.5) - xp.arcsin(xp.clip(d[..., 1], -1.0, 1.0)) \
        * F32(1.0 / np.pi)
    pan = xp.asarray(panorama)
    h, w = pan.shape[0], pan.shape[1]
    zeros = xp.zeros(u.shape, np.int32)
    return sample_atlas_region_bilinear(
        pan, zeros, zeros, zeros + h, zeros + w,
        xp.stack([u, v], axis=-1), xp=xp)


def irradiance_panorama(panorama, out_h: int = 16) -> np.ndarray:
    """Cosine-convolved (diffuse) irradiance map from an equirect
    panorama — host-side, run once at scene setup (numpy only).

    Returns a small (out_h, 2·out_h, 4) lat-long map: entry (v, u) is
    the cosine-weighted average of the environment over the hemisphere
    around that direction.  Sample it with ops/sky.sample_panorama by
    the surface NORMAL for image-based diffuse ambient
    (ops/lighting.pbr_scene_fragment_shader)."""
    pano = np.asarray(panorama, np.float32)
    if pano.dtype == np.uint8:
        pano = pano.astype(np.float32) / 255.0
    # Downsample the source for the O(out · in) convolution.
    sh, sw = 16, 32
    ys = (np.linspace(0, pano.shape[0] - 1, sh)).astype(int)
    xs = (np.linspace(0, pano.shape[1] - 1, sw)).astype(int)
    src = pano[np.ix_(ys, xs)][..., :3]                   # (sh, sw, 3)

    def dirs(h, w):
        v = (np.arange(h) + 0.5) / h
        u = (np.arange(w) + 0.5) / w
        theta = v * np.pi                     # 0 at +y
        phi = (u - 0.5) * 2 * np.pi           # u=0.5 faces -z
        st = np.sin(theta)[:, None]
        d = np.stack([np.broadcast_to(np.sin(phi)[None, :] * st, (h, w)),
                      np.broadcast_to(np.cos(theta)[:, None], (h, w)),
                      np.broadcast_to(-np.cos(phi)[None, :] * st, (h, w))],
                     axis=-1)
        return d, st

    sd, s_sin = dirs(sh, sw)                  # source dirs + solid angle
    od, _ = dirs(out_h, out_h * 2)
    cos = np.einsum("hwc,ijc->hwij", od, sd)  # (oh, ow, sh, sw)
    w = np.maximum(cos, 0.0) * s_sin[None, None]
    w = w / np.maximum(w.sum(axis=(2, 3), keepdims=True), 1e-9)
    out = np.einsum("hwij,ijc->hwc", w, src).astype(np.float32)
    return np.concatenate(
        [out, np.ones(out.shape[:2] + (1,), np.float32)], axis=-1)


def composite_sky(color, depth, uniforms, xp=np):
    """Replace clear-depth pixels with the panorama sample (alpha from the
    frame's clear color is preserved in spirit: sky alpha = 1)."""
    from softwarerenderer_tpu.ops.raster import DEPTH_CLEAR

    H, W = depth.shape
    dirs = pixel_ray_directions(uniforms, W, H, xp=xp)
    sky = sample_panorama(uniforms["sky_panorama"], dirs, xp=xp)
    uncovered = depth == DEPTH_CLEAR
    return xp.where(uncovered[..., None], sky, color), depth
