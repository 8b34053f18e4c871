"""FXAA-style post-process anti-aliasing (beyond the reference, which
has no AA at all; `RenderParams.ssaa` remains the exact supersampled
quality mode).

Gather-free: classic FXAA walks each edge with per-pixel DYNAMIC sample
offsets, which lower to full-frame gathers.  This implementation keeps FXAA's detection + blend model but restricts
sampling to static pixel SHIFTS (edge-padded slices, like ops/bloom.py
and ops/ssao.py), so the whole pass is a handful of fused elementwise
ops:

  * luma from the Rec.601 weights;
  * local contrast = max-min luma over the 4-neighborhood + center;
    below ``max(abs_threshold, rel_threshold * luma_max)`` the pixel is
    untouched (flat regions stay bit-identical);
  * edge orientation from horizontal vs vertical second differences
    (|N + S − 2C| vs |E + W − 2C|);
  * the pixel blends toward the neighbor average PERPENDICULAR to the
    edge, weighted by FXAA's subpixel factor: the normalized distance
    of the center luma from its neighborhood average, squared and
    clamped to ``subpix_cap``.

This is the "subpixel aliasing removal" half of FXAA 3.11; the
long-edge search half is intentionally dropped (gather-bound).  Jaggies
on near-vertical/horizontal silhouettes soften one pixel deep — for
stronger AA use ssaa=2 (exact) and fxaa on top.
"""

from __future__ import annotations

import numpy as np

F32 = np.float32


def _shift(a, dy, dx, xp):
    H, W = a.shape[:2]
    py, px = abs(dy), abs(dx)
    pad = ((py, py), (px, px)) + ((0, 0),) * (a.ndim - 2)
    p = xp.pad(a, pad, mode="edge")
    return p[py + dy:py + dy + H, px + dx:px + dx + W]


def luma(rgb, xp=np):
    """Rec.601 luma of an (H, W, 3+) image → (H, W)."""
    return (rgb[..., 0] * F32(0.299) + rgb[..., 1] * F32(0.587)
            + rgb[..., 2] * F32(0.114))


def apply_fxaa(color, abs_threshold=1.0 / 24.0, rel_threshold=1.0 / 8.0,
               subpix_cap=0.75, xp=np):
    """Anti-alias an (H, W, 4) frame; alpha passes through untouched.

    abs_threshold: minimum local contrast to touch a pixel at all.
    rel_threshold: contrast relative to the local max luma (dark scenes
        keep their detail).
    subpix_cap: FXAA's maximum blend fraction toward the neighbor
        average (0.75 is the FXAA 3.11 default quality).
    """
    rgb = color[..., :3]
    c = luma(rgb, xp=xp)
    n = _shift(c, -1, 0, xp)
    s = _shift(c, 1, 0, xp)
    e = _shift(c, 0, 1, xp)
    w = _shift(c, 0, -1, xp)

    lmax = xp.maximum(c, xp.maximum(xp.maximum(n, s), xp.maximum(e, w)))
    lmin = xp.minimum(c, xp.minimum(xp.minimum(n, s), xp.minimum(e, w)))
    contrast = lmax - lmin
    active = contrast >= xp.maximum(F32(abs_threshold),
                                    F32(rel_threshold) * lmax)

    # Subpixel blend factor (FXAA 3.11's pixel-blend term): how far the
    # center sits from its cross average, normalized by the contrast.
    avg4 = (n + s + e + w) * F32(0.25)
    amount = xp.clip(xp.abs(avg4 - c) / xp.maximum(contrast, F32(1e-6)),
                     F32(0.0), F32(1.0))
    amount = amount * amount * (F32(3.0) - F32(2.0) * amount)  # smoothstep
    amount = xp.minimum(amount * amount, F32(subpix_cap))

    # Edge orientation: blend PERPENDICULAR to the edge (a horizontal
    # edge mixes the vertical neighbors).
    horiz = xp.abs(n + s - c - c) >= xp.abs(e + w - c - c)
    rgb_n = _shift(rgb, -1, 0, xp)
    rgb_s = _shift(rgb, 1, 0, xp)
    rgb_e = _shift(rgb, 0, 1, xp)
    rgb_w = _shift(rgb, 0, -1, xp)
    perp = xp.where(horiz[..., None], (rgb_n + rgb_s) * F32(0.5),
                    (rgb_e + rgb_w) * F32(0.5))

    t = xp.where(active, amount, F32(0.0))[..., None]
    out = rgb + (perp - rgb) * t
    return xp.concatenate([out, color[..., 3:4]], axis=-1)
