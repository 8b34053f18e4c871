"""Screen-space ambient occlusion (beyond the reference, which has no
AO of any kind).

A depth-only post pass over the finished (color, depth) frame, inside
the same jitted program: reconstruct each pixel's linear view distance
from the stored depth (the reference's negated (ndcZ+1)/2 convention —
config.py semantics note), compare it against fixed-offset neighbors,
and darken pixels whose neighborhood is consistently nearer (creases,
contact lines).

Neighbor access is static pixel SHIFTS of the depth plane (pad + slice
— zero gathers, fully fused elementwise work), so the
whole effect costs a handful of rolls over an (H, W) f32 map.
"""

from __future__ import annotations

import numpy as np

from softwarerenderer_tpu.ops.raster import DEPTH_CLEAR

F32 = np.float32

# 4 direction PAIRS × per-radius taps: occlusion needs BOTH sides of a
# pair nearer than the center (a valley/crease) — a planar slope has one
# side nearer and the other farther, so flat geometry at any angle
# contributes nothing.
_PAIRS = [(1, 0), (0, 1), (1, 1), (1, -1)]


def linear_view_distance(depth, near, far, xp=np):
    """Stored depth → linear view distance d ∈ [near, far].

    stored = -(ndcZ+1)/2 with ndcZ = f·(n-d)/((n-f)·d) (the .NET
    row-vector perspective, mathlib.perspective_fov); uncovered pixels
    (clear = -inf) map to `far`."""
    near = xp.asarray(near, xp.float32)
    far = xp.asarray(far, xp.float32)
    s = xp.asarray(depth, xp.float32)
    clear = s == DEPTH_CLEAR
    # Replace clear entries (-FLT_MAX) with a finite stand-in BEFORE the
    # linearization: -2·(-FLT_MAX) overflows f32 to +inf (a NumPy
    # RuntimeWarning on every golden run) even though the value is masked
    # out below.
    s = xp.where(clear, F32(-0.5), s)
    ndc = -F32(2.0) * s - F32(1.0)
    den = far + ndc * (near - far)
    d = far * near / xp.where(den == 0, F32(1e-9), den)
    return xp.where(clear, far, xp.clip(d, near, far))


def _shift(a, dy, dx, xp):
    """Shift without wrap: edge-replicated pad + slice (static offsets)."""
    H, W = a.shape
    py, px = abs(dy), abs(dx)
    p = xp.pad(a, ((py, py), (px, px)), mode="edge")
    return p[py + dy:py + dy + H, px + dx:px + dx + W]


def compute_ssao(depth, uniforms, xp=np, radii=(1, 2, 4),
                 range_frac=0.02, bias_frac=0.002):
    """Occlusion map (H, W) in [0, 1] from the stored depth buffer.

    For each tap: occlusion when the neighbor is nearer by more than
    bias, fading out once the gap exceeds `range` (both relative to the
    center distance, so the effect is scale-invariant)."""
    near = uniforms["near_clip"]
    far = uniforms["far_clip"]
    d = linear_view_distance(depth, near, far, xp=xp)
    ao = xp.zeros_like(d)
    taps = 0
    for r in radii:
        rng = d * F32(range_frac) * F32(float(r))
        bias = d * F32(bias_frac)
        for dy, dx in _PAIRS:
            gp = d - _shift(d, dy * r, dx * r, xp)   # >0: nearer
            gm = d - _shift(d, -dy * r, -dx * r, xp)
            gap = xp.minimum(gp, gm)       # both sides must be nearer
            occ = xp.clip((gap - bias) / xp.maximum(rng, F32(1e-6)),
                          0.0, 1.0)
            # a fully-ranged gap is a silhouette edge over open space,
            # not a crease — fade it back out
            occ = occ * xp.clip(F32(2.0) - occ, 0.0, 1.0)
            ao = ao + occ
            taps += 1
    return xp.clip(ao * F32(2.0) / F32(float(taps)), 0.0, 1.0)


def apply_ssao(color, depth, uniforms, xp=np, strength=0.9, **kw):
    """Darken covered pixels by the occlusion term; uncovered (clear
    depth) pixels pass through."""
    ao = compute_ssao(depth, uniforms, xp=xp, **kw)
    covered = depth != DEPTH_CLEAR
    shade = F32(1.0) - xp.asarray(strength, xp.float32) * ao
    rgb = color[..., :3] * xp.where(covered, shade, 1.0)[..., None]
    return xp.concatenate([rgb, color[..., 3:4]], axis=-1), depth
