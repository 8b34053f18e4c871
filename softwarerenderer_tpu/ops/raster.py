"""Deferred (visibility-buffer) rasterization as fused XLA array programs.

Array re-design of the reference's tile-locked scanline rasterizer
(/root/reference/Rasterizer.cs:401-539).  The reference serializes
framebuffer read-modify-writes with a 16×16-px mutex matrix (SURVEY.md
§2.2 P2); here the z-buffer contention is designed out by turning the
depth test into an ASSOCIATIVE masked reduction over triangles (SURVEY.md
§7 hard-part (a)):

  pass 1 (visibility): for every pixel, reduce (depth, triangle-id) over
      all triangles under the active depth-test's ordering — including the
      reference's sequential tie-breaking ("new >= old" means the LATEST
      submitted triangle wins ties, "new > old" means the EARLIEST does),
      which maps to max/min reductions with index-preference tie rules.
  pass 2 (shading): gather the winning triangle's vertex outputs per pixel,
      perspective-correct interpolate (exact Rasterizer.Interpolate math,
      Rasterizer.cs:566-640), run the user fragment shader ONCE per pixel,
      blend with the background.

The brute-force variant tests every triangle against every pixel in
bounded chunks — the correctness slice (SURVEY.md §7 step 3).  The
binned variant (ops/binning.py) cuts the work to bbox-overlapping tiles.

Sequential-semantics notes:
  * EQUAL / NOT_EQUAL depth tests compare against the evolving buffer and
    are order-dependent non-monotone; they are only supported by the exact
    forward path (``render_forward``), matching the reference's behavior
    under its pinned sequential order.
  * Deferred shading evaluates the shader only for the visibility winner;
    a fragment the shader *discards* (alpha ≤ 0, Rasterizer.cs:511) leaves
    background rather than revealing the next-nearest triangle, and writes
    no depth.  The reference would reveal the next triangle.  Scenes using
    discard for cutouts should use the K-buffer
    (``RenderParams(kbuffer=K)``, ops/kbuffer.py — binned cost) or
    ``render_forward`` (O(T·H·W), always exact).
  * ALPHA/ADDITIVE/MULTIPLY blending of *overlapping* translucent geometry
    needs ordered composition — also K-buffer or ``render_forward``.  The
    deferred path blends the single winner against the background, which
    is exact for opaque scenes (the reference's own cross-mesh order is
    racy anyway — SURVEY.md §5).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from softwarerenderer_tpu.config import (
    BlendMode,
    DepthTest,
    RenderParams,
)
from softwarerenderer_tpu.ops.geometry import unflatten_varyings

F32 = jnp.float32
DEPTH_CLEAR = jnp.finfo(jnp.float32).min  # float.MinValue (MainWindow.cs:434)
NO_TRI = np.int32(-1)   # plain host scalar: a module-level jnp
                        # constant would initialize the backend at
                        # import (breaking jax.distributed) and
                        # can't be captured by Pallas kernels

# Depth-test reduction rules: mode -> (use_max, later_wins_ties).
# Derived from the reference's inverted comparison table
# (Rasterizer.cs:542-559): LESS_EQUAL = "new >= old" → a max-reduction where
# the latest triangle wins ties; LESS = "new > old" → max, earliest wins; etc.
_REDUCE_RULES = {
    DepthTest.LESS_EQUAL: (True, True),
    DepthTest.LESS: (True, False),
    DepthTest.GREATER: (False, False),
    DepthTest.GREATER_EQUAL: (False, True),
    DepthTest.ALWAYS: (None, True),   # last valid triangle wins
    DepthTest.DISABLED: (None, True),
}


def _pad_pow2_chunks(n: int, chunk: int) -> int:
    return -(-n // chunk) * chunk


def visibility_brute_force(tris: Dict, params: RenderParams,
                           chunk: int = 128,
                           init_depth: Optional[jnp.ndarray] = None,
                           row_offset=0, col_offset=0):
    """Per-pixel (depth, triangle-id) reduction over ALL triangles.

    tris: the geometry SoA from ops.geometry (screen/depth/valid/inv_area).
    Returns (best_depth (H, W) f32, best_tri (H, W) i32; -1 = uncovered).

    init_depth seeds the reduction (the cleared or previous-pass depth
    buffer): every fragment must beat it under the active comparison,
    exactly like the reference testing against the buffer contents — so a
    GREATER test against a MinValue-cleared buffer correctly draws nothing.

    Triangles stream through a fori_loop in submission-order chunks; inside
    a chunk the winner is picked with the tie rule, and the cross-chunk
    merge applies the same comparison, so the result equals the reference's
    sequential fold for every monotone depth mode.
    """
    mode = params.depth_test
    if mode not in _REDUCE_RULES:
        raise NotImplementedError(
            f"depth test {mode!r} is order-dependent; use render_forward")
    use_max, later_wins = _REDUCE_RULES[mode]

    H, W = params.height, params.width
    n = tris["screen"].shape[0]
    n_pad = _pad_pow2_chunks(max(n, 1), chunk)

    def pad(a):
        cfg = [(0, n_pad - n)] + [(0, 0)] * (a.ndim - 1)
        return jnp.pad(a, cfg)

    screen = pad(tris["screen"])
    depth_v = pad(tris["depth"])
    inv_area = pad(tris["inv_area"])
    valid = pad(tris["valid"])

    px = (jax.lax.broadcasted_iota(jnp.int32, (H, W), 1)
          + jnp.asarray(col_offset, jnp.int32)).astype(F32)
    py = (jax.lax.broadcasted_iota(jnp.int32, (H, W), 0)
          + jnp.asarray(row_offset, jnp.int32)).astype(F32)

    bad = F32(-jnp.inf) if use_max in (True, None) else F32(jnp.inf)

    def chunk_body(c, carry):
        best_d, best_i = carry
        sl = lambda a: jax.lax.dynamic_slice_in_dim(a, c * chunk, chunk)
        s = sl(screen)                 # (C, 3, 2)
        dv = sl(depth_v)               # (C, 3)
        ia = sl(inv_area)              # (C,)
        vm = sl(valid)                 # (C,)

        s0 = s[:, 0][:, None, None]    # (C, 1, 1, 2)
        s1 = s[:, 1][:, None, None]
        s2 = s[:, 2][:, None, None]
        # Edge deltas exactly as Rasterizer.cs:445-447.
        a01 = s0[..., 1] - s1[..., 1]; b01 = s1[..., 0] - s0[..., 0]
        a12 = s1[..., 1] - s2[..., 1]; b12 = s2[..., 0] - s1[..., 0]
        a20 = s2[..., 1] - s0[..., 1]; b20 = s0[..., 0] - s2[..., 0]
        w0 = a12 * (px - s1[..., 0]) + b12 * (py - s1[..., 1])  # (C, H, W)
        w1 = a20 * (px - s2[..., 0]) + b20 * (py - s2[..., 1])
        w2 = a01 * (px - s0[..., 0]) + b01 * (py - s0[..., 1])
        inside = ((w0 >= 0) & (w1 >= 0) & (w2 >= 0)) | \
                 ((w0 <= 0) & (w1 <= 0) & (w2 <= 0))
        iab = ia[:, None, None]
        d = (dv[:, 0, None, None] * (w0 * iab)
             + dv[:, 1, None, None] * (w1 * iab)
             + dv[:, 2, None, None] * (w2 * iab))
        mask = inside & vm[:, None, None]

        idx = c * chunk + jax.lax.broadcasted_iota(jnp.int32, (chunk, 1, 1), 0)
        if use_max is None:
            # ALWAYS/DISABLED: the last valid fragment wins unconditionally.
            key = jnp.where(mask, idx, -1)
            pick = jnp.argmax(key, axis=0)
            cand_valid = jnp.any(mask, axis=0)
            cand_d = jnp.take_along_axis(d, pick[None], axis=0)[0]
            cand_i = jnp.take_along_axis(
                jnp.broadcast_to(idx, d.shape), pick[None], axis=0)[0]
            take = cand_valid
        else:
            dm = jnp.where(mask, d, bad)
            cand_d = (jnp.max if use_max else jnp.min)(dm, axis=0)
            at_best = mask & (d == cand_d)
            sel = jnp.where(at_best, idx, -1 if later_wins else n_pad)
            cand_i = (jnp.max(sel, axis=0) if later_wins
                      else jnp.min(sel, axis=0))
            cand_valid = jnp.any(at_best, axis=0)
            if use_max:
                cmp = (cand_d >= best_d) if later_wins else (cand_d > best_d)
            else:
                cmp = (cand_d <= best_d) if later_wins else (cand_d < best_d)
            take = cand_valid & cmp
        new_d = jnp.where(take, cand_d, best_d)
        new_i = jnp.where(take, cand_i.astype(jnp.int32), best_i)
        return new_d, new_i

    if init_depth is None:
        init_depth = jnp.full((H, W), DEPTH_CLEAR, dtype=F32)
    init = (init_depth, jnp.full((H, W), NO_TRI, dtype=jnp.int32))
    best_d, best_i = jax.lax.fori_loop(0, n_pad // chunk, chunk_body, init)
    return best_d, best_i


def interpolate_at_pixels(tris: Dict, tri_id: jnp.ndarray,
                          covered: jnp.ndarray, row_offset=0,
                          col_offset=0) -> Dict:
    """Perspective-correct fragment inputs for each pixel's winning triangle.

    Replicates Rasterizer.Interpolate exactly (Rasterizer.cs:566-640):
    area-normalized edge weights at integer pixel coords, clip-w reciprocal
    correction with the reference's left-to-right summation, and the vec3
    "data" renormalization (Rasterizer.cs:680-688).

    Gather-efficiency: all per-vertex varyings plus the triangle's screen
    positions and inv_area are packed into ONE contiguous (N, 3, Ktot)
    block, so each pixel issues a single row-gather instead of one gather
    per attribute.
    """
    H, W = tri_id.shape
    t = jnp.where(covered, tri_id, 0)

    keys = sorted(tris["attrs"].keys())
    slices = {}
    parts = []
    off = 0
    for k in keys:
        arr = tris["attrs"][k]
        parts.append(arr)
        slices[k] = (off, off + arr.shape[-1])
        off += arr.shape[-1]
    n = parts[0].shape[0]
    parts.append(tris["screen"])                       # (N, 3, 2)
    sl_screen = (off, off + 2); off += 2
    parts.append(jnp.broadcast_to(tris["inv_area"][:, None, None],
                                  (n, 3, 1)))
    sl_ia = off; off += 1
    packed = jnp.concatenate(parts, axis=-1)           # (N, 3, Ktot)

    av = jnp.take(packed, t, axis=0)                   # (H, W, 3, Ktot)
    a0, a1, a2 = av[..., 0, :], av[..., 1, :], av[..., 2, :]

    s = av[..., sl_screen[0]:sl_screen[1]]             # (H, W, 3, 2)
    inv_area = av[..., 0, sl_ia]
    cw0, cw1 = slices["clip_position"]
    clip_w = av[..., cw1 - 1]                          # (H, W, 3)

    px = (jax.lax.broadcasted_iota(jnp.int32, (H, W), 1)
          + jnp.asarray(col_offset, jnp.int32)).astype(F32)
    py = (jax.lax.broadcasted_iota(jnp.int32, (H, W), 0)
          + jnp.asarray(row_offset, jnp.int32)).astype(F32)
    s0x, s0y = s[..., 0, 0], s[..., 0, 1]
    s1x, s1y = s[..., 1, 0], s[..., 1, 1]
    s2x, s2y = s[..., 2, 0], s[..., 2, 1]
    w0 = ((s1y - s2y) * (px - s1x) + (s2x - s1x) * (py - s1y)) * inv_area
    w1 = ((s2y - s0y) * (px - s2x) + (s0x - s2x) * (py - s2y)) * inv_area
    w2 = ((s0y - s1y) * (px - s0x) + (s1x - s0x) * (py - s0y)) * inv_area

    rcp_wa = w0 / clip_w[..., 0]
    rcp_wb = w1 / clip_w[..., 1]
    rcp_wc = w2 / clip_w[..., 2]
    wsum = rcp_wa + rcp_wb + rcp_wc
    w = F32(1.0) / jnp.where(wsum == 0, F32(1), wsum)
    wa = rcp_wa * w
    wb = rcp_wb * w
    wc = rcp_wc * w

    # Two interpolation flavors over the whole packed block; per-attribute
    # columns pick the right one (plain-weight for "data" varyings,
    # perspective-reciprocal for the rest — Rasterizer.cs:598-639).
    pc = (a0 * rcp_wa[..., None] + a1 * rcp_wb[..., None]
          + a2 * rcp_wc[..., None]) * w[..., None]
    pw = (a0 * wa[..., None] + a1 * wb[..., None] + a2 * wc[..., None])

    flat = {}
    for k in keys:
        lo, hi = slices[k]
        if k.startswith("data."):
            val = pw[..., lo:hi]
            if hi - lo == 3:
                length_sq = jnp.sum(val * val, axis=-1, keepdims=True)
                norm = val / jnp.sqrt(jnp.where(length_sq > 0, length_sq,
                                                F32(1)))
                val = jnp.where(length_sq > F32(1e-6), norm, val)
        else:
            val = pc[..., lo:hi]
        flat[k] = val

    frag = unflatten_varyings(flat)
    frag["barycentric"] = jnp.stack([wa, wb, wc], axis=-1)
    return frag


def _blend(src, dst, mode: BlendMode):
    """Rasterizer.Blend (Rasterizer.cs:57-65), xp-generic over jnp arrays."""
    if mode == BlendMode.NONE:
        return src
    if mode == BlendMode.ALPHA:
        a = src[..., 3:4]
        return src * a + dst * (F32(1.0) - a)
    if mode == BlendMode.ADDITIVE:
        return jnp.minimum(src + dst, F32(1.0))
    if mode == BlendMode.MULTIPLY:
        return src * dst
    return src


def shade_deferred(tris: Dict, best_depth, best_tri,
                   fragment_shader: Callable, uniforms: Dict,
                   params: RenderParams,
                   fb_color: jnp.ndarray, fb_depth: jnp.ndarray,
                   per_tri_extra: Optional[Dict[str, jnp.ndarray]] = None,
                   row_offset=0, col_offset=0):
    """Shade each covered pixel's winning triangle once, blend, write depth.

    per_tri_extra: optional dict of (T,) or (T, K) per-triangle arrays
    (e.g. texture/material ids from the packed scene) gathered into the
    fragment dict as frag["tri"][name] so shaders can do material lookups.
    """
    covered = best_tri != NO_TRI
    frag = interpolate_at_pixels(tris, best_tri, covered, row_offset,
                                 col_offset)
    if per_tri_extra:
        t = jnp.where(covered, best_tri, 0)
        frag["tri"] = {k: jnp.take(v, t, axis=0)
                       for k, v in per_tri_extra.items()}
    color = fragment_shader(frag, uniforms, jnp)
    written = covered & (color[..., 3] > 0)

    out_color = jnp.where(written[..., None],
                          _blend(color, fb_color, params.blend_mode),
                          fb_color)
    if params.depth_test == DepthTest.DISABLED:
        out_depth = fb_depth
    else:
        out_depth = jnp.where(written, best_depth, fb_depth)
    return out_color, out_depth


def render_wireframe_deferred(tris: Dict, fragment_shader: Callable,
                              uniforms: Dict, params: RenderParams,
                              fb_color: jnp.ndarray, fb_depth: jnp.ndarray,
                              per_tri_extra: Optional[Dict] = None,
                              chunk: Optional[int] = None,
                              row_offset=0, col_offset=0):
    """Deferred wireframe: per-pixel (depth, segment) reduction over all
    3N triangle edges, then one shade of the winner.

    Line semantics replicate DrawLine (Rasterizer.cs:232-340) — pixel
    centers at +0.5, truncated bbox clamp, reciprocal depth of the lerped
    FIRST-TWO-vertex depths, attributes anchored to raster vertices 0/1
    with weights (1−t, t, 0) for every edge, write when alpha != 0.  Like
    the fill-mode deferred path it shades only the winner (ordered-blend
    exactness lives in ops/forward.py).
    """
    if chunk is None:
        chunk = params.chunk
    mode = params.depth_test
    if mode not in _REDUCE_RULES:
        raise NotImplementedError(
            f"depth test {mode!r} is order-dependent; use render_forward")
    use_max, later_wins = _REDUCE_RULES[mode]
    H, W = fb_depth.shape

    screen = tris["screen"]                     # (N, 3, 2)
    n = screen.shape[0]
    edge_order = jnp.asarray([[0, 1], [1, 2], [2, 0]])
    p0 = screen[:, edge_order[:, 0]].reshape(-1, 2)   # (3N, 2) interleaved
    p1 = screen[:, edge_order[:, 1]].reshape(-1, 2)
    d01 = jnp.repeat(tris["depth"][:, :2], 3, axis=0)  # (3N, 2) d0,d1 quirk
    valid = jnp.repeat(tris["valid"], 3)
    n_seg = 3 * n
    n_pad = _pad_pow2_chunks(max(n_seg, 1), chunk)

    def pad(a):
        cfg = [(0, n_pad - n_seg)] + [(0, 0)] * (a.ndim - 1)
        return jnp.pad(a, cfg)

    p0, p1, d01, valid = pad(p0), pad(p1), pad(d01), pad(valid)

    px = (jax.lax.broadcasted_iota(jnp.int32, (H, W), 1)
          + jnp.asarray(col_offset, jnp.int32)).astype(F32)
    py = (jax.lax.broadcasted_iota(jnp.int32, (H, W), 0)
          + jnp.asarray(row_offset, jnp.int32)).astype(F32)
    pxc = px + F32(0.5)
    pyc = py + F32(0.5)
    bad = F32(-jnp.inf) if use_max in (True, None) else F32(jnp.inf)

    def seg_eval(a0, a1, dd):
        """Coverage + depth + t of one chunk of segments over all pixels."""
        min_x = jnp.maximum(jnp.minimum(a0[:, 0], a1[:, 0]), 0) \
            .astype(jnp.int32)
        max_x = jnp.minimum(jnp.maximum(a0[:, 0], a1[:, 0]), W - 1) \
            .astype(jnp.int32)
        min_y = jnp.maximum(jnp.minimum(a0[:, 1], a1[:, 1]), 0) \
            .astype(jnp.int32)
        max_y = jnp.minimum(jnp.maximum(a0[:, 1], a1[:, 1]), H - 1) \
            .astype(jnp.int32)
        in_bbox = ((px >= min_x[:, None, None])
                   & (px <= max_x[:, None, None])
                   & (py >= min_y[:, None, None])
                   & (py <= max_y[:, None, None]))
        dx = (a1[:, 0] - a0[:, 0])[:, None, None]
        dy = (a1[:, 1] - a0[:, 1])[:, None, None]
        len_sq = dx * dx + dy * dy
        rx = pxc - a0[:, 0][:, None, None]
        ry = pyc - a0[:, 1][:, None, None]
        t = jnp.where(len_sq <= 0, 0.0,
                      (rx * dx + ry * dy)
                      / jnp.where(len_sq == 0, F32(1), len_sq))
        t = jnp.clip(t, 0.0, 1.0)
        cx = a0[:, 0][:, None, None] + t * dx
        cy = a0[:, 1][:, None, None] + t * dy
        dist_sq = (pxc - cx) ** 2 + (pyc - cy) ** 2
        covered = in_bbox & (dist_sq <= F32(0.25))
        d = F32(1.0) / (dd[:, 0][:, None, None] * (F32(1.0) - t)
                        + dd[:, 1][:, None, None] * t)
        return covered, d

    def chunk_body(c, carry):
        best_d, best_i = carry
        sl = lambda a: jax.lax.dynamic_slice_in_dim(a, c * chunk, chunk)
        covered, d = seg_eval(sl(p0), sl(p1), sl(d01))
        mask = covered & sl(valid)[:, None, None]
        idx = c * chunk + jax.lax.broadcasted_iota(jnp.int32,
                                                   (chunk, 1, 1), 0)
        if use_max is None:
            key = jnp.where(mask, idx, -1)
            pick = jnp.argmax(key, axis=0)
            cand_valid = jnp.any(mask, axis=0)
            cand_d = jnp.take_along_axis(d, pick[None], axis=0)[0]
            cand_i = jnp.take_along_axis(
                jnp.broadcast_to(idx, d.shape), pick[None], axis=0)[0]
            take = cand_valid
        else:
            dm = jnp.where(mask, d, bad)
            cand_d = (jnp.max if use_max else jnp.min)(dm, axis=0)
            at = mask & (d == cand_d)
            sel = jnp.where(at, idx, -1 if later_wins else n_pad)
            cand_i = (jnp.max(sel, axis=0) if later_wins
                      else jnp.min(sel, axis=0))
            cand_valid = jnp.any(at, axis=0)
            if use_max:
                cmp = (cand_d >= best_d) if later_wins else (cand_d > best_d)
            else:
                cmp = (cand_d <= best_d) if later_wins else (cand_d < best_d)
            take = cand_valid & cmp
        return (jnp.where(take, cand_d, best_d),
                jnp.where(take, cand_i.astype(jnp.int32), best_i))

    init = (fb_depth, jnp.full((H, W), NO_TRI, dtype=jnp.int32))
    best_d, best_i = jax.lax.fori_loop(0, n_pad // chunk, chunk_body, init)
    covered = best_i != NO_TRI

    # Winner's t parameter + triangle id; shade with (1-t, t, 0) anchors.
    seg = jnp.where(covered, best_i, 0)
    tri_of = seg // 3
    a0 = jnp.take(p0, seg, axis=0)
    a1 = jnp.take(p1, seg, axis=0)
    dx = a1[..., 0] - a0[..., 0]
    dy = a1[..., 1] - a0[..., 1]
    len_sq = dx * dx + dy * dy
    t = jnp.where(len_sq <= 0, 0.0,
                  ((pxc - a0[..., 0]) * dx + (pyc - a0[..., 1]) * dy)
                  / jnp.where(len_sq == 0, F32(1), len_sq))
    t = jnp.clip(t, 0.0, 1.0)

    keys = sorted(tris["attrs"].keys())
    flat = {}
    ow = F32(1.0) - t
    clip_w = jnp.take(tris["attrs"]["clip_position"][:, :2, 3], tri_of,
                      axis=0)
    rcp_a = ow / clip_w[..., 0]
    rcp_b = t / clip_w[..., 1]
    wsum = rcp_a + rcp_b
    wgt = F32(1.0) / jnp.where(wsum == 0, F32(1), wsum)
    wa, wb = rcp_a * wgt, rcp_b * wgt
    for k in keys:
        av = jnp.take(tris["attrs"][k][:, :2], tri_of, axis=0)  # (H,W,2,K)
        if k.startswith("data."):
            val = av[..., 0, :] * wa[..., None] + av[..., 1, :] * wb[..., None]
            if val.shape[-1] == 3:
                lsq = jnp.sum(val * val, axis=-1, keepdims=True)
                nrm = val / jnp.sqrt(jnp.where(lsq > 0, lsq, F32(1)))
                val = jnp.where(lsq > F32(1e-6), nrm, val)
        else:
            val = (av[..., 0, :] * rcp_a[..., None]
                   + av[..., 1, :] * rcp_b[..., None]) * wgt[..., None]
        flat[k] = val
    frag = unflatten_varyings(flat)
    frag["barycentric"] = jnp.stack([wa, wb, jnp.zeros_like(wa)], axis=-1)
    if per_tri_extra:
        frag["tri"] = {k: jnp.take(v, tri_of, axis=0)
                       for k, v in per_tri_extra.items()}
    color = fragment_shader(frag, uniforms, jnp)
    written = covered & (color[..., 3] != 0)
    out_color = jnp.where(written[..., None],
                          _blend(color, fb_color, params.blend_mode),
                          fb_color)
    out_depth = fb_depth if params.depth_test == DepthTest.DISABLED \
        else jnp.where(written, best_d, fb_depth)
    return out_color, out_depth


def render_deferred(tris: Dict, fragment_shader: Callable, uniforms: Dict,
                    params: RenderParams,
                    fb_color: jnp.ndarray, fb_depth: jnp.ndarray,
                    per_tri_extra: Optional[Dict] = None,
                    chunk: Optional[int] = None,
                    visibility_fn: Optional[Callable] = None,
                    row_offset=0):
    """Full deferred pass: visibility reduce + single-shade + blend.

    The reduction is seeded with the incoming fb_depth, so stacked passes
    (e.g. map first, then the view-model gun) depth-test against earlier
    passes exactly like the reference's shared buffer.

    visibility_fn defaults from params.binned (the sort-middle binned
    reducer, ops/binning.py) — pass explicitly to override.
    """
    if chunk is None:
        chunk = params.chunk
    if visibility_fn is None:
        if params.binned:
            from softwarerenderer_tpu.ops.binning import make_binned_visibility
            visibility_fn = make_binned_visibility(
                tile_h=params.tile_h, tile_w=params.tile_w,
                span_cap=params.span_cap, tile_group=params.tile_group)
        else:
            visibility_fn = visibility_brute_force
    best_depth, best_tri = visibility_fn(tris, params, chunk,
                                         init_depth=fb_depth,
                                         row_offset=row_offset)
    return shade_deferred(tris, best_depth, best_tri, fragment_shader,
                          uniforms, params, fb_color, fb_depth, per_tri_extra,
                          row_offset=row_offset)
