"""NumPy scalar-faithful golden reference of the exact reference pipeline.

This is the trusted oracle (SURVEY.md §7 step 1): a sequential, deterministic
implementation of the reference rasterizer's semantics (Rasterizer.cs,
MainWindow.cs framebuffer accessors) against which the device path is
pixel-compared.  Per-triangle work is vectorized over the bounding-box pixel
grid for speed, but triangles are processed strictly in submission order so
results are deterministic (the reference itself races across tiles/meshes —
SURVEY.md §5; we pin sequential order as the parity definition).

Faithfulness ledger (file:line cites into /root/reference):
  * depth clear = float.MinValue (MainWindow.cs:434); pixel depth =
    (ndcZ+1)/2 (Rasterizer.cs:388); depth test table as implemented
    (Rasterizer.cs:542-559), incl. EQUAL/NOT_EQUAL epsilon 1e-6.
  * vertex order reversed before raster: outputs = {v2,v1,v0}
    (Rasterizer.cs:367); front face = signed area < 0 (:414); Y-flip in
    viewport mapping (:385); NaN/Inf NDC drops the whole triangle
    (:378-380); any clip w == 0 drops it (:393); zero edge area drops it
    (:396, :412).
  * edge functions evaluated at integer pixel coordinates (Rasterizer.cs:
    481-483); inside test accepts both winding signs (:493-494); no
    top-left fill rule (shared edges double-shade).
  * near clip at z >= NearClip*w, only when some (not all) w <= 0
    (Rasterizer.cs:208-224, 95-160): Sutherland-Hodgman with clip-space
    attribute lerp (Shaders.cs:49-95), t clamped to [0,1], denominator
    fallback t=0.5; fan triangulation.
  * perspective-correct interpolation via clip-w reciprocals
    (Rasterizer.cs:566-640); "data" dict vec3 entries re-normalized after
    interpolation when lengthSq > 1e-6 (:680-688); depth interpolated
    LINEARLY in screen space with area-normalized weights (:502).  NOTE
    the weights w0f+w1f+w2f sum to -1 (EdgeFunction sign convention), so
    the stored depth is the NEGATED lerp of the per-vertex (ndcZ+1)/2 —
    which together with the inverted ">=" test gives nearest-wins
    z-buffering (see config.py docstring).  Attribute interpolation is
    unaffected (the negations cancel inside Interpolate).
  * fragment discard when alpha <= 0 (no color OR depth write)
    (Rasterizer.cs:509-519); depth written only when color written and
    depth test enabled (:517-518); blend table (:57-65).
  * wireframe mode: distance-to-segment <= 0.5 px lines with depth =
    1/(lerp of vertex depths) (Rasterizer.cs:232-340).

Documented divergences from the reference (also absent from the device
path):
  * the reference walks edge functions incrementally across rows
    (Rasterizer.cs:527-534), accumulating float error; we evaluate directly
    at each pixel.  Divergence is sub-ulp-per-step and does not change
    coverage except on exactly-degenerate boundaries.
  * the BlendMode.None scanline early-out on discard (Rasterizer.cs:520-523)
    — a row-coverage quirk triggered only by discarding fragments with
    blending off — is not replicated.
  * cross-mesh/tile race outcomes are replaced by sequential order.
"""

from __future__ import annotations

import numpy as np

from softwarerenderer_tpu.config import (
    EPSILON,
    BlendMode,
    CullMode,
    DebugMode,
    DepthTest,
)

F32 = np.float32
DEPTH_CLEAR = np.finfo(np.float32).min  # float.MinValue


class Framebuffer:
    """Color (H,W,4) + depth (H,W) float32 buffers (MainWindow.cs:30-31).

    rows=(y0, y1) is a scissor: filled triangles touch only rows
    y0 <= y < y1, so a frame can be rendered as independent row bands."""

    def __init__(self, width: int, height: int, rows=None):
        self.width = width
        self.height = height
        self.rows = (0, height) if rows is None else tuple(rows)
        self.color = np.zeros((height, width, 4), dtype=F32)
        self.depth = np.full((height, width), DEPTH_CLEAR, dtype=F32)

    def clear_color(self, rgba):
        self.color[:] = np.asarray(rgba, dtype=F32)

    def clear_depth(self, value=DEPTH_CLEAR):
        # The reference always clears to float.MinValue (MainWindow.cs:434),
        # which only the LESS/LESS_EQUAL rows of its inverted test table can
        # pass against.  Apps using the conventional GREATER/GREATER_EQUAL
        # rows should clear to float.MaxValue instead.
        self.depth[:] = F32(value)


# ---------------------------------------------------------------------------
# Depth / blend tables
# ---------------------------------------------------------------------------

def depth_test_passes(test: DepthTest, new_depth, old_depth):
    """The reference's table exactly as implemented (Rasterizer.cs:542-559)."""
    if test == DepthTest.LESS_EQUAL:
        return new_depth >= old_depth
    if test == DepthTest.DISABLED or test == DepthTest.ALWAYS:
        return np.ones_like(new_depth, dtype=bool)
    if test == DepthTest.LESS:
        return new_depth > old_depth
    if test == DepthTest.GREATER:
        return new_depth < old_depth
    if test == DepthTest.GREATER_EQUAL:
        return new_depth <= old_depth
    if test == DepthTest.EQUAL:
        return np.abs(new_depth - old_depth) < F32(EPSILON)
    if test == DepthTest.NOT_EQUAL:
        return np.abs(new_depth - old_depth) >= F32(EPSILON)
    return np.ones_like(new_depth, dtype=bool)


def blend(src, dst, mode: BlendMode):
    """Rasterizer.Blend (Rasterizer.cs:57-65); src/dst are (..., 4)."""
    if mode == BlendMode.NONE:
        return src
    if mode == BlendMode.ALPHA:
        a = src[..., 3:4]
        return src * a + dst * (F32(1.0) - a)
    if mode == BlendMode.ADDITIVE:
        return np.minimum(src + dst, F32(1.0))
    if mode == BlendMode.MULTIPLY:
        return src * dst
    return src


# ---------------------------------------------------------------------------
# Vertex-output helpers.  A vertex output is a dict:
#   {"clip_position": (4,), "color": (4,), "uv": (2,), "normal": (3,),
#    "screen_coords": (2,), "data": {name: (K,)}}
# ---------------------------------------------------------------------------

def _slice_vertex(vs_out, i):
    return {
        "clip_position": vs_out["clip_position"][i],
        "color": vs_out["color"][i],
        "uv": vs_out["uv"][i],
        "normal": vs_out["normal"][i],
        "data": {k: v[i] for k, v in vs_out.get("data", {}).items()},
    }


def lerp_vertex(a, b, t):
    """Shaders.Lerp with interpolate=true (Shaders.cs:49-95): plain lerp of
    clip position and every attribute (no perspective correction — this runs
    in clip space inside the clipper)."""
    t = F32(t)

    def _l(x, y):
        return x + (y - x) * t

    return {
        "clip_position": _l(a["clip_position"], b["clip_position"]),
        "uv": _l(a["uv"], b["uv"]),
        "color": _l(a["color"], b["color"]),
        "normal": _l(a["normal"], b["normal"]),
        "data": {k: _l(a["data"][k], b["data"][k]) for k in a["data"]},
    }


def clip_triangle_near(v0, v1, v2, near_clip):
    """ClipTriangleAgainstNearPlane (Rasterizer.cs:95-160): Sutherland-
    Hodgman vs z = NearClip*w, then fan triangulation.  Returns a list of
    (a, b, c) vertex-output triples."""
    near = F32(near_clip)
    verts = [v0, v1, v2]
    out = []
    for i in range(3):
        cur = verts[i]
        nxt = verts[(i + 1) % 3]
        z0, w0 = cur["clip_position"][2], cur["clip_position"][3]
        z1, w1 = nxt["clip_position"][2], nxt["clip_position"][3]
        cur_inside = z0 >= near * w0
        nxt_inside = z1 >= near * w1
        if cur_inside:
            out.append(cur)
        if cur_inside != nxt_inside:
            denom = (z1 - z0) - near * (w1 - w0)
            if abs(denom) < EPSILON:
                t = F32(0.5)
            else:
                t = (z0 - near * w0) / (near * (w1 - w0) - (z1 - z0))
                t = F32(np.clip(t, 0.0, 1.0))
            out.append(lerp_vertex(cur, nxt, t))
    if len(out) < 3:
        return []
    return [(out[0], out[i], out[i + 1]) for i in range(1, len(out) - 1)]


def _edge_function(ax, ay, bx, by, cx, cy):
    """(c-a) x (b-a) — Rasterizer.cs:561-563."""
    return (cx - ax) * (by - ay) - (cy - ay) * (bx - ax)


def interpolate_fragment(a, b, c, w0, w1, w2):
    """Rasterizer.Interpolate (Rasterizer.cs:566-640), vectorized over pixels.

    a/b/c: per-vertex output dicts; w0/w1/w2: (N,) area-normalized weights.
    Returns a fragment dict of (N, ...) arrays including perspective-correct
    barycentrics.  Vec3 entries of `data` are re-normalized when their
    squared length exceeds 1e-6 (Rasterizer.cs:680-688).
    """
    rcp_wa = w0 / a["clip_position"][3]
    rcp_wb = w1 / b["clip_position"][3]
    rcp_wc = w2 / c["clip_position"][3]
    w = F32(1.0) / (rcp_wa + rcp_wb + rcp_wc)
    wa = rcp_wa * w
    wb = rcp_wb * w
    wc = rcp_wc * w

    def _pc(key):
        return (a[key] * rcp_wa[:, None] + b[key] * rcp_wb[:, None]
                + c[key] * rcp_wc[:, None]) * w[:, None]

    data = {}
    for k in a["data"]:
        val = (a["data"][k] * wa[:, None] + b["data"][k] * wb[:, None]
               + c["data"][k] * wc[:, None])
        if val.shape[-1] == 3:
            length_sq = np.sum(val * val, axis=-1, keepdims=True)
            norm = val / np.sqrt(length_sq)
            val = np.where(length_sq > F32(1e-6), norm, val)
        data[k] = val

    return {
        "clip_position": _pc("clip_position"),
        "uv": _pc("uv"),
        "screen_coords": _pc("screen_coords"),
        "color": _pc("color"),
        "normal": _pc("normal"),
        "data": data,
        "barycentric": np.stack([wa, wb, wc], axis=-1),
    }


# ---------------------------------------------------------------------------
# Triangle + line rasterization
# ---------------------------------------------------------------------------

def _rasterize_triangle(fb, screen, depths, outputs, fragment_shader, uniforms,
                        cull_mode, depth_test, blend_mode, debug_mode):
    """RasterizeTriangle (Rasterizer.cs:401-539); `screen`/`depths`/`outputs`
    already in the reversed (v2,v1,v0) order."""
    s0, s1, s2 = screen
    area = _edge_function(s0[0], s0[1], s1[0], s1[1], s2[0], s2[1])
    if area == 0:
        return
    is_front = area < 0
    if cull_mode == CullMode.BACK and not is_front:
        return
    if cull_mode == CullMode.FRONT and is_front:
        return

    if debug_mode == DebugMode.WIREFRAME:
        for pa, pb in ((s0, s1), (s1, s2), (s2, s0)):
            _draw_line(fb, pa, pb, depths, outputs, fragment_shader, uniforms,
                       depth_test, blend_mode)
        return

    inv_area = F32(1.0) / area
    h, w = fb.height, fb.width
    min_x = max(int(np.floor(min(s0[0], s1[0], s2[0]))), 0)
    max_x = min(int(np.ceil(max(s0[0], s1[0], s2[0]))), w - 1)
    min_y = max(int(np.floor(min(s0[1], s1[1], s2[1]))), fb.rows[0])
    max_y = min(int(np.ceil(max(s0[1], s1[1], s2[1]))), h - 1,
                fb.rows[1] - 1)
    if min_x > max_x or min_y > max_y:
        return

    a01 = s0[1] - s1[1]; b01 = s1[0] - s0[0]
    a12 = s1[1] - s2[1]; b12 = s2[0] - s1[0]
    a20 = s2[1] - s0[1]; b20 = s0[0] - s2[0]

    xs = np.arange(min_x, max_x + 1, dtype=F32)
    ys = np.arange(min_y, max_y + 1, dtype=F32)
    px, py = np.meshgrid(xs, ys)
    w0 = a12 * (px - s1[0]) + b12 * (py - s1[1])
    w1 = a20 * (px - s2[0]) + b20 * (py - s2[1])
    w2 = a01 * (px - s0[0]) + b01 * (py - s0[1])

    inside = ((w0 >= 0) & (w1 >= 0) & (w2 >= 0)) | \
             ((w0 <= 0) & (w1 <= 0) & (w2 <= 0))
    if not inside.any():
        return

    w0f = w0 * inv_area
    w1f = w1 * inv_area
    w2f = w2 * inv_area
    depth = depths[0] * w0f + depths[1] * w1f + depths[2] * w2f

    region_depth = fb.depth[min_y:max_y + 1, min_x:max_x + 1]
    passes = inside & depth_test_passes(depth_test, depth, region_depth)
    if not passes.any():
        return

    idx = np.nonzero(passes)
    frag = interpolate_fragment(outputs[0], outputs[1], outputs[2],
                                w0f[idx].astype(F32), w1f[idx].astype(F32),
                                w2f[idx].astype(F32))
    color = np.asarray(fragment_shader(frag, uniforms, np), dtype=F32)
    writes = color[:, 3] > 0
    if not writes.any():
        return

    wy = idx[0][writes] + min_y
    wx = idx[1][writes] + min_x
    src = color[writes]
    dst = fb.color[wy, wx]
    fb.color[wy, wx] = blend(src, dst, blend_mode)
    if depth_test != DepthTest.DISABLED:
        fb.depth[wy, wx] = depth[idx][writes]


def _draw_line(fb, p0, p1, depths, outputs, fragment_shader, uniforms,
               depth_test, blend_mode):
    """DrawLine (Rasterizer.cs:232-340): pixels within 0.5px of the segment,
    depth = 1/(lerp of depths[0..1]), persp interpolation with (1-t, t, 0)."""
    h, w = fb.height, fb.width
    min_x = int(max(min(p0[0], p1[0]), 0))
    max_x = int(min(max(p0[0], p1[0]), w - 1))
    min_y = int(max(min(p0[1], p1[1]), 0))
    max_y = int(min(max(p0[1], p1[1]), h - 1))
    if min_x > max_x or min_y > max_y:
        return
    dx = p1[0] - p0[0]
    dy = p1[1] - p0[1]
    len_sq = dx * dx + dy * dy

    xs = np.arange(min_x, max_x + 1, dtype=F32)
    ys = np.arange(min_y, max_y + 1, dtype=F32)
    gx, gy = np.meshgrid(xs, ys)
    px = gx + F32(0.5) - p0[0]
    py = gy + F32(0.5) - p0[1]
    t = np.zeros_like(px) if len_sq <= 0 else (px * dx + py * dy) / len_sq
    t = np.clip(t, F32(0.0), F32(1.0))
    cx = p0[0] + t * dx
    cy = p0[1] + t * dy
    dist_sq = (gx + F32(0.5) - cx) ** 2 + (gy + F32(0.5) - cy) ** 2
    covered = dist_sq <= F32(0.25)
    if not covered.any():
        return
    depth = F32(1.0) / (depths[0] * (F32(1.0) - t) + depths[1] * t)
    region_depth = fb.depth[min_y:max_y + 1, min_x:max_x + 1]
    passes = covered & depth_test_passes(depth_test, depth, region_depth)
    if not passes.any():
        return
    idx = np.nonzero(passes)
    tt = t[idx].astype(F32)
    frag = interpolate_fragment(outputs[0], outputs[1], outputs[0],
                                (F32(1.0) - tt), tt, np.zeros_like(tt))
    color = np.asarray(fragment_shader(frag, uniforms, np), dtype=F32)
    writes = color[:, 3] != 0
    if not writes.any():
        return
    wy = idx[0][writes] + min_y
    wx = idx[1][writes] + min_x
    dst = fb.color[wy, wx]
    fb.color[wy, wx] = blend(color[writes], dst, blend_mode)
    if depth_test != DepthTest.DISABLED:
        fb.depth[wy, wx] = depth[idx][writes]


def _draw_triangle(fb, v0, v1, v2, fragment_shader, uniforms, cull_mode,
                   depth_test, blend_mode, debug_mode):
    """DrawTriangle (Rasterizer.cs:342-399): reverse vertex order, NDC,
    viewport map with Y flip, depth = (ndcZ+1)/2, degenerate rejects."""
    w = fb.width
    h = fb.height
    inv_w = F32(1.0) / F32(w - 1)
    inv_h = F32(1.0) / F32(h - 1)

    outputs = [dict(v2), dict(v1), dict(v0)]
    screen = []
    depths = []
    for i in range(3):
        clip = outputs[i]["clip_position"]
        inv_cw = F32(1.0) / clip[3]
        ndc = clip[:3] * inv_cw
        if not np.isfinite(ndc).all():
            return
        sx = (ndc[0] * F32(0.5) + F32(0.5)) * F32(w)
        sy = (F32(1.0) - (ndc[1] * F32(0.5) + F32(0.5))) * F32(h)
        screen.append(np.array([sx, sy], dtype=F32))
        depths.append((ndc[2] + F32(1.0)) * F32(0.5))
        outputs[i] = dict(outputs[i])
        outputs[i]["screen_coords"] = np.array([sx * inv_w, sy * inv_h], dtype=F32)

    if (v0["clip_position"][3] == 0 or v1["clip_position"][3] == 0
            or v2["clip_position"][3] == 0):
        return
    if _edge_function(screen[0][0], screen[0][1], screen[1][0], screen[1][1],
                      screen[2][0], screen[2][1]) == 0:
        return
    _rasterize_triangle(fb, screen, depths, outputs, fragment_shader, uniforms,
                        cull_mode, depth_test, blend_mode, debug_mode)


def render_mesh(fb, vertex_input, indices, uniforms, vertex_shader,
                fragment_shader, cull_mode=CullMode.BACK,
                depth_test=DepthTest.LESS_EQUAL, blend_mode=BlendMode.ALPHA,
                near_clip=0.1, debug_mode=DebugMode.NONE):
    """RenderMesh (Rasterizer.cs:163-230), sequential over triangles.

    vertex_input: attribute dict of (V, ...) arrays (shaders.make_vertex_input)
    indices: (T, 3) int array
    uniforms: passed to both shaders (must include model/view/projection for
              the default shader)
    """
    vs_out = vertex_shader(vertex_input, uniforms, np)
    vs_out.setdefault("data", {})
    indices = np.asarray(indices).reshape(-1, 3)

    for tri in indices:
        v0 = _slice_vertex(vs_out, tri[0])
        v1 = _slice_vertex(vs_out, tri[1])
        v2 = _slice_vertex(vs_out, tri[2])
        w_behind = [v["clip_position"][3] <= 0 for v in (v0, v1, v2)]
        if all(w_behind):
            continue
        if any(w_behind):
            for (a, b, c) in clip_triangle_near(v0, v1, v2, near_clip):
                _draw_triangle(fb, a, b, c, fragment_shader, uniforms,
                               cull_mode, depth_test, blend_mode, debug_mode)
        else:
            _draw_triangle(fb, v0, v1, v2, fragment_shader, uniforms,
                           cull_mode, depth_test, blend_mode, debug_mode)
    return fb
