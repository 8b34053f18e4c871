"""Bloom post-processing (beyond the reference, which has no post
effects): bright-pass + separable dilated box blur + additive
composite, all inside the same jitted program.

Like ops/ssao.py, the blur is built from static pixel SHIFTS
(edge-padded slices — zero gathers); three separable [1, 2, 1]/4 passes
at dilations 1, 2, 4 approximate a wide Gaussian for the cost of a few
fused elementwise ops per pixel.
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


def _blur121(a, axis, d, xp):
    if axis == 0:
        lo, hi = _shift(a, -d, 0, xp), _shift(a, d, 0, xp)
    else:
        lo, hi = _shift(a, 0, -d, xp), _shift(a, 0, d, xp)
    return (lo + a + a + hi) * F32(0.25)


def compute_bloom(color, threshold=0.8, dilations=(1, 2, 4), xp=np):
    """Blurred bright-pass of an (H, W, 4) frame → (H, W, 3)."""
    bright = xp.maximum(color[..., :3]
                        - xp.asarray(threshold, xp.float32), F32(0.0))
    b = bright
    for d in dilations:
        b = _blur121(b, 0, d, xp)
        b = _blur121(b, 1, d, xp)
    return b


def apply_bloom(color, threshold=0.8, strength=0.7, xp=np, **kw):
    """color + strength · blur(max(color − threshold, 0)); alpha kept."""
    glow = compute_bloom(color, threshold=threshold, xp=xp, **kw)
    rgb = xp.clip(color[..., :3]
                  + xp.asarray(strength, xp.float32) * glow, 0.0, 1.0)
    return xp.concatenate([rgb, color[..., 3:4]], axis=-1)
