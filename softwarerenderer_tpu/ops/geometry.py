"""Device geometry pipeline: vertex shading → clip → viewport/cull setup.

Array re-design of the reference's per-triangle geometry work
(Rasterizer.RenderMesh/ClipTriangleAgainstNearPlane/DrawTriangle,
/root/reference/Rasterizer.cs:163-399).  Where the reference runs a
`Parallel.For` over triangles and shades 3 vertices at a time (SURVEY.md
§2.2 P1), here every stage is one batched array op over ALL vertices /
triangles — static shapes, no data-dependent control flow, everything
inside one jitted program:

  * ``shade_vertices``     — user vertex shader applied to (V, ...) arrays
  * ``assemble_triangles`` — gather vertex outputs into (T, 3, ...) SoA
  * ``clip_triangles``     — vectorized Sutherland–Hodgman near clip with a
    static 8-case emission table; each input triangle yields 2 output slots
    (fan triangles) with validity masks, so shapes stay static
  * ``setup_triangles``    — reversed-vertex NDC/viewport transform, depth,
    signed area, cull/degeneracy masks, screen bbox

Faithfulness (SURVEY.md §6): clipping fires only when some-but-not-all
clip w ≤ 0 (Rasterizer.cs:208-224); the clip plane is z ≥ NearClip·w with
the reference's t formula incl. the |denom|<ε → t=0.5 fallback and [0,1]
clamp (Rasterizer.cs:95-160, Shaders.cs:49-95); vertices are reversed
{v2,v1,v0} before raster (Rasterizer.cs:367); Y-flip viewport and depth =
(ndcZ+1)/2 (Rasterizer.cs:385-388); front face = signed area < 0 (:414);
NaN/Inf NDC or any clip w == 0 or zero area drops the triangle (:378-396).
"""

from __future__ import annotations

from typing import Callable, Dict

import jax
import jax.numpy as jnp
import numpy as np

from softwarerenderer_tpu.config import EPSILON, CullMode

F32 = jnp.float32

# Static Sutherland–Hodgman emission table.  Walking edges (0→1, 1→2, 2→0)
# and emitting [cur if inside] + [intersection if crossing] gives, for each
# 3-bit inside mask (case = b0 + 2*b1 + 4*b2), an ordered polygon of up to 4
# sources.  Source ids: 0-2 = original vertex, 3-5 = intersection on edge
# (3 = edge 0→1, 4 = edge 1→2, 5 = edge 2→0), 6 = padding.
_CLIP_TABLE = np.array(
    [
        [6, 6, 6, 6],  # 000 — fully outside
        [0, 3, 5, 6],  # 100 — only v0 inside
        [3, 1, 4, 6],  # 010
        [0, 1, 4, 5],  # 110
        [4, 2, 5, 6],  # 001
        [0, 3, 4, 2],  # 101
        [3, 1, 2, 5],  # 011
        [0, 1, 2, 6],  # 111 — untouched
    ],
    dtype=np.int32,
)
_CLIP_COUNT = np.array([0, 3, 3, 4, 3, 4, 4, 3], dtype=np.int32)


def _select_rows(arr: jnp.ndarray, sel: jnp.ndarray, n: int) -> jnp.ndarray:
    """Per-row candidate select: arr (T, n[, K]) picked by sel (T, S) →
    (T, S[, K]), as a branchless where-chain.

    Replaces jnp.take_along_axis on the clip tables: the n-way select
    chain fuses into elementwise ops instead of a per-element gather.
    Bit-exact:
    the same candidate values are selected."""
    a = arr[:, :, None] if arr.ndim == 2 else arr
    out = jnp.broadcast_to(a[:, 0:1], (a.shape[0], sel.shape[1],
                                       a.shape[2]))
    for c in range(1, n):
        out = jnp.where((sel == c)[:, :, None], a[:, c:c + 1], out)
    return out[..., 0] if arr.ndim == 2 else out


def shade_vertices(vertex_shader: Callable, vertex_input: Dict, uniforms: Dict
                   ) -> Dict:
    """Run the user vertex shader over all packed vertices at once.

    The shader contract is shaders.py's: dict of (V, ...) attribute arrays
    in, dict with "clip_position"/"color"/"uv"/"normal" and optional "data"
    varyings out.  The reference shades per-triangle inside Parallel.For
    (Rasterizer.cs:200-206, shading shared vertices redundantly); here each
    vertex is shaded exactly once.
    """
    out = vertex_shader(vertex_input, uniforms, jnp)
    out.setdefault("data", {})
    return out


def _flatten_varyings(vs_out: Dict) -> Dict[str, jnp.ndarray]:
    """Flatten {k: arr, "data": {name: arr}} into a flat dict with
    "data."-prefixed keys (the user-extensible varying channel of
    Shaders.cs:33 becomes extra SoA planes)."""
    flat = {k: v for k, v in vs_out.items() if k != "data"}
    for name, arr in vs_out.get("data", {}).items():
        flat["data." + name] = arr
    return flat


def unflatten_varyings(flat: Dict[str, jnp.ndarray]) -> Dict:
    out = {k: v for k, v in flat.items() if not k.startswith("data.")}
    out["data"] = {k[len("data."):]: v for k, v in flat.items()
                   if k.startswith("data.")}
    return out


def assemble_triangles(vs_out: Dict, indices: jnp.ndarray
                       ) -> Dict[str, jnp.ndarray]:
    """Gather per-vertex shader outputs into per-triangle (T, 3, K) SoA."""
    indices = jnp.asarray(indices, dtype=jnp.int32).reshape(-1, 3)
    flat = _flatten_varyings(vs_out)
    return {k: jnp.take(v, indices, axis=0) for k, v in flat.items()}


def clip_triangles(attrs: Dict[str, jnp.ndarray], near_clip, *,
                   return_sources: bool = False):
    """Vectorized near-plane clip.  attrs: flat varying dict of (T, 3, K).

    Returns (attrs2, valid) where attrs2 arrays are (2T, 3, K) — for each
    input triangle, fan slots [2t] = (p0,p1,p2) and [2t+1] = (p0,p2,p3) in
    the reference's emission order — and valid is (2T,) bool.  Triangles
    needing no clip pass through slot [2t] unchanged (case-7 identity row).

    return_sources: additionally return (ia_local, ib_local, t) arrays of
    shape (T, 4) describing each emitted polygon vertex as the lerp
    `a + (b - a) * t` of the LOCAL input vertices ia/ib (kept vertices
    have ia == ib, t == 0) — the deferred-attribute decomposition
    build_triangles(defer_attrs=True) fans into per-slot sources so
    varyings can be materialized AFTER compaction with identical
    arithmetic.
    """
    clip = attrs["clip_position"]            # (T, 3, 4)
    near = jnp.asarray(near_clip, dtype=F32)
    z = clip[..., 2]
    w = clip[..., 3]

    w_nonpos = w <= 0                         # (T, 3)
    any_out = jnp.any(w_nonpos, axis=-1)
    all_out = jnp.all(w_nonpos, axis=-1)

    inside = z >= near * w                    # (T, 3) plane test
    bits = (inside[:, 0].astype(jnp.int32)
            + 2 * inside[:, 1].astype(jnp.int32)
            + 4 * inside[:, 2].astype(jnp.int32))
    # Clip only when some-but-not-all w ≤ 0 (Rasterizer.cs:208-224); all w ≤ 0
    # drops the triangle; all w > 0 passes through even if z < near·w.
    case = jnp.where(all_out, 0, jnp.where(any_out, bits, 7))

    # Edge intersections: edge i runs vert i → vert (i+1)%3.
    nxt = jnp.roll(jnp.arange(3), -1)
    z0, w0 = z, w
    z1, w1 = z[:, nxt], w[:, nxt]
    denom = (z1 - z0) - near * (w1 - w0)
    t_raw = (z0 - near * w0) / jnp.where(denom == 0, F32(1), near * (w1 - w0) - (z1 - z0))
    t = jnp.where(jnp.abs(denom) < EPSILON, F32(0.5),
                  jnp.clip(t_raw, 0.0, 1.0))  # (T, 3)

    # Constant-table lookups as where-chains over the 8 rows (same
    # rationale as _select_rows: no per-element gather from a tiny
    # table).
    table = jnp.broadcast_to(jnp.asarray(_CLIP_TABLE[0]),
                             (case.shape[0], 4))            # (T, 4)
    count = jnp.full_like(case, _CLIP_COUNT[0])             # (T,)
    for c in range(1, 8):
        is_c = case == c
        table = jnp.where(is_c[:, None], jnp.asarray(_CLIP_TABLE[c]),
                          table)
        count = jnp.where(is_c, _CLIP_COUNT[c], count)

    def clip_one(arr):
        # arr: (T, 3, K) → candidates (T, 7, K): verts, edge lerps, pad.
        a = arr
        b = arr[:, nxt]
        x = a + (b - a) * t[..., None]        # Shaders.Lerp order: a+(b-a)*t
        cand = jnp.concatenate([a, x, jnp.zeros_like(a[:, :1])], axis=1)
        out4 = _select_rows(cand, table, 7)                          # (T,4,K)
        tri_a = out4[:, jnp.asarray([0, 1, 2])]
        tri_b = out4[:, jnp.asarray([0, 2, 3])]
        # Interleave so global order matches sequential fan emission.
        return jnp.stack([tri_a, tri_b], axis=1).reshape(
            (-1, 3) + arr.shape[2:])

    attrs2 = {k: clip_one(v) for k, v in attrs.items()}
    valid_a = count >= 3
    valid_b = count == 4
    valid = jnp.stack([valid_a, valid_b], axis=1).reshape(-1)
    if not return_sources:
        return attrs2, valid
    # Source decomposition per candidate id: 0-2 = vertex c (a=b=c, t=0);
    # 3-5 = lerp on edge (c-3) → (c-3+1)%3 with this triangle's t[c-3];
    # 6 = padding (never consumed: it only lands in fan slot 3 of
    # count==3 polygons, whose second triangle is invalid).
    loc_a = np.array([0, 1, 2, 0, 1, 2, 0], np.int32)
    loc_b = np.array([0, 1, 2, 1, 2, 0, 0], np.int32)
    ia_l = jnp.full_like(table, loc_a[0])                   # (T, 4)
    ib_l = jnp.full_like(table, loc_b[0])
    for c in range(1, 7):
        is_c = table == c
        ia_l = jnp.where(is_c, loc_a[c], ia_l)
        ib_l = jnp.where(is_c, loc_b[c], ib_l)
    edge = jnp.clip(table - 3, 0, 2)
    t4 = jnp.where((table >= 3) & (table <= 5),
                   _select_rows(t, edge, 3), F32(0.0))
    return attrs2, valid, (ia_l, ib_l, t4)


def setup_triangles(attrs: Dict[str, jnp.ndarray], valid: jnp.ndarray,
                    width: int, height: int, cull_mode: CullMode) -> Dict:
    """DrawTriangle setup (Rasterizer.cs:342-399), vectorized.

    Reverses vertex order to {v2,v1,v0}, computes screen positions (Y flip,
    pixel centers at integer coords), per-vertex depth (ndcZ+1)/2, the
    normalized "screen_coords" varying, signed area and all validity masks.

    Returns a triangle-SoA pytree:
      screen  (N, 3, 2)   raster-order screen positions
      depth   (N, 3)      per-vertex (ndcZ+1)/2
      area    (N,)        signed area (front face < 0)
      inv_area(N,)
      valid   (N,)        all masks combined
      bbox    (N, 4)      [min_x, min_y, max_x, max_y] clamped to screen, i32
      attrs   flat varying dict of (N, 3, K), raster vertex order, incl.
              the "screen_coords" varying added here
    """
    rev = jnp.asarray([2, 1, 0])
    attrs = {k: v[:, rev] for k, v in attrs.items()}
    clip = attrs["clip_position"]             # (N, 3, 4)
    w = clip[..., 3]
    inv_w = F32(1.0) / w
    ndc = clip[..., :3] * inv_w[..., None]

    fw = F32(float(width))
    fh = F32(float(height))
    sx = (ndc[..., 0] * F32(0.5) + F32(0.5)) * fw
    sy = (F32(1.0) - (ndc[..., 1] * F32(0.5) + F32(0.5))) * fh
    screen = jnp.stack([sx, sy], axis=-1)     # (N, 3, 2)
    depth = (ndc[..., 2] + F32(1.0)) * F32(0.5)

    inv_w1 = F32(1.0) / F32(float(width - 1))
    inv_h1 = F32(1.0) / F32(float(height - 1))
    attrs = dict(attrs)
    attrs["screen_coords"] = jnp.stack([sx * inv_w1, sy * inv_h1], axis=-1)

    area = _edge_function(
        screen[:, 0, 0], screen[:, 0, 1],
        screen[:, 1, 0], screen[:, 1, 1],
        screen[:, 2, 0], screen[:, 2, 1])

    finite = jnp.all(jnp.isfinite(ndc), axis=(1, 2))
    w_nonzero = jnp.all(w != 0, axis=1)
    nondegenerate = area != 0
    is_front = area < 0
    if cull_mode == CullMode.BACK:
        cull_ok = is_front
    elif cull_mode == CullMode.FRONT:
        cull_ok = ~is_front
    else:
        cull_ok = jnp.ones_like(is_front)

    valid = valid & finite & w_nonzero & nondegenerate & cull_ok

    min_x = jnp.maximum(jnp.floor(jnp.min(sx, axis=1)), 0).astype(jnp.int32)
    max_x = jnp.minimum(jnp.ceil(jnp.max(sx, axis=1)),
                        width - 1).astype(jnp.int32)
    min_y = jnp.maximum(jnp.floor(jnp.min(sy, axis=1)), 0).astype(jnp.int32)
    max_y = jnp.minimum(jnp.ceil(jnp.max(sy, axis=1)),
                        height - 1).astype(jnp.int32)
    valid = valid & (min_x <= max_x) & (min_y <= max_y)

    safe_area = jnp.where(area == 0, F32(1), area)
    return {
        "screen": screen,
        "depth": depth,
        "area": area,
        "inv_area": F32(1.0) / safe_area,
        "valid": valid,
        "bbox": jnp.stack([min_x, min_y, max_x, max_y], axis=-1),
        "attrs": attrs,
    }


def _edge_function(ax, ay, bx, by, cx, cy):
    """(c-a) × (b-a) — Rasterizer.cs:561-563."""
    return (cx - ax) * (by - ay) - (cy - ay) * (bx - ax)


def compact_triangles(tris: Dict, cap: int,
                      per_tri_extra: Dict | None = None):
    """Stable-partition the VALID triangle slots into a static `cap`-slot
    prefix — every downstream stage (pair-table sort, stream gathers,
    payload packing) then scales with the ACTIVE triangle count instead of
    the packed slot count.

    Scenes that pack alternative geometry the frame masks off — every
    mesh-LOD level (ops/lod.py), app-hidden meshes — otherwise pay full
    binning cost for slots that can never win: the pair sort runs over
    N·span_cap slots (scripts/profile_lod.py measures the effect).

    Exactness: the permutation keeps valid slots in submission order, and
    every reduction downstream is the lexicographic (depth, submission
    index) fold — invariant under an order-preserving index remap — so
    results are identical to the uncompacted frame whenever the frame's
    valid-slot count fits in cap.  On overflow the LAST-submitted valid
    slots are dropped (deterministically); callers watch the returned
    traced n_valid (overflow = max(0, n_valid - cap)).
    ops/lod.suggested_active_cap computes a static bound that can never
    overflow.

    The permutation is built with a cumsum + scatter (position of valid
    slot i = its running count; out-of-cap targets drop) instead of the
    earlier stable argsort over all n slots: identical prefix
    (scripts/profile_compaction.py asserts it), free of the sort's
    log²-pass scaling.  Unfilled tail slots (n_valid < cap)
    gather slot 0's data; their `valid` is forced False below, which is
    all any downstream stage reads.

    Returns (tris, per_tri_extra, n_valid) with all arrays cap-sized.
    """
    valid = tris["valid"]
    n = valid.shape[0]
    cap = min(int(cap), n)
    pos = jnp.cumsum(valid.astype(jnp.int32)) - 1
    tgt = jnp.where(valid, pos, cap)
    perm = jnp.zeros((cap,), jnp.int32).at[tgt].set(
        jnp.arange(n, dtype=jnp.int32), mode="drop")
    n_valid = jnp.sum(valid.astype(jnp.int32))
    tail_ok = jnp.arange(cap, dtype=jnp.int32) < n_valid

    def g(a):
        return jnp.take(a, perm, axis=0)

    # Deferred-attr dicts (build_triangles defer_attrs): "attr_src" rows
    # are per-slot (gathered), "vert_attrs" is per-VERTEX (untouched —
    # this is the whole point: the wide varying tables never see a
    # slot-count-sized gather).
    out = {}
    for k, v in tris.items():
        if k == "vert_attrs":
            out[k] = v
        elif k in ("attrs", "attr_src"):
            out[k] = {ak: g(av) for ak, av in v.items()}
        else:
            out[k] = g(v)
    out["valid"] = out["valid"] & tail_ok
    extra = None
    if per_tri_extra is not None:
        extra = {k: g(jnp.asarray(v)) for k, v in per_tri_extra.items()}
    return out, extra, n_valid


def precompact_inputs(tri_mask: jnp.ndarray, cap: int,
                      indices: jnp.ndarray,
                      per_tri: Dict | None = None):
    """Pre-GEOMETRY compaction (RenderParams.geom_cap): stable-partition
    the masked-in INPUT triangles into a static `cap`-slot prefix BEFORE
    vertex assembly, so the whole geometry build (assemble/clip/setup —
    and everything after) scales with ACTIVE triangles instead of packed
    input slots (every LOD level, hidden meshes).

    compact_triangles (active_cap) runs AFTER build_triangles and can
    only shrink the post-geometry stages; the visibility+LOD mask is
    known before geometry runs, so this removes the build-stage cost too
    (measured ~34 ms of the 4K LOD-crowd frame at 1.17M fan slots,
    scripts/profile_build_stages.py).

    Exactness: same argument as compact_triangles — the partition keeps
    submission order, and every downstream reduction is the
    lexicographic (depth, submission index) fold, which is invariant
    under an order-preserving index remap.  Unfilled tail slots gather
    triangle 0's data with the returned mask forced False; on overflow
    the LAST-submitted masked-in triangles drop deterministically
    (overflow = max(0, n_active - cap); ops/lod.suggested_geom_cap gives
    a bound that never overflows).

    per_tri: optional dict of (T,)-leading per-input-triangle arrays
    (texture ids, mesh ids, ...) compacted with the same permutation.

    Returns (tri_mask(cap,), indices(cap, 3), per_tri, overflow).
    """
    idx3 = jnp.asarray(indices, jnp.int32).reshape(-1, 3)
    n_in = idx3.shape[0]
    cap = min(int(cap), n_in)
    pos = jnp.cumsum(tri_mask.astype(jnp.int32)) - 1
    tgt = jnp.where(tri_mask, pos, cap)
    perm = jnp.zeros((cap,), jnp.int32).at[tgt].set(
        jnp.arange(n_in, dtype=jnp.int32), mode="drop")
    n_act = jnp.sum(tri_mask.astype(jnp.int32))
    overflow = jnp.maximum(0, n_act - cap)
    out_mask = jnp.arange(cap, dtype=jnp.int32) < n_act
    out_idx = jnp.take(idx3, perm, axis=0)
    out_pt = None
    if per_tri is not None:
        out_pt = {k: jnp.take(jnp.asarray(v), perm, axis=0)
                  for k, v in per_tri.items()}
    return out_mask, out_idx, out_pt, overflow


def build_triangles(vertex_shader: Callable, vertex_input: Dict,
                    indices: jnp.ndarray, uniforms: Dict, *,
                    width: int, height: int,
                    cull_mode: CullMode = CullMode.BACK,
                    near_clip=0.1,
                    tri_mask: jnp.ndarray | None = None,
                    keep_varyings=None,
                    defer_attrs: bool = False) -> Dict:
    """Full geometry stage: shade → assemble → clip → setup.

    tri_mask: optional (T,) bool per INPUT triangle (e.g. frustum-cull mask
    per mesh, SURVEY.md §2.2 P6 — culled meshes become masked triangles
    rather than dynamic shapes).

    keep_varyings: optional collection of flat varying names the fragment
    shader actually reads ("color", "uv", "data.world_normal", ...) — the
    typed-registry answer to the reference's open Data dictionary
    (SURVEY.md §7 hard-part (c)).  Unused varyings are dropped before
    clipping so they never enter the resolve payload; clip_position is
    always kept.

    defer_attrs: skip materializing per-slot varyings entirely — the
    dominant geometry cost at LOD-crowd scale (per-slot vertex gathers of
    every varying channel; scripts/profile_lod.py prep_only).  The returned dict instead carries
    "vert_attrs" (the per-VERTEX shaded varyings, untouched) and
    "attr_src" ((N, 3) ia/ib/t lerp decompositions per slot vertex);
    materialize_attrs() rebuilds "attrs" bit-exactly at any later point —
    in the engine, AFTER active_cap compaction, so gather cost scales
    with the cap instead of packed slots.  Geometry/validity outputs are
    identical to the eager path (clip_position math runs at full size
    either way).
    """
    vs_out = shade_vertices(vertex_shader, vertex_input, uniforms)
    if defer_attrs:
        flat = _flatten_varyings(vs_out)
        if keep_varyings is not None:
            keep = set(keep_varyings) | {"clip_position"}
            flat = {k: v for k, v in flat.items() if k in keep}
        idx3 = jnp.asarray(indices, dtype=jnp.int32).reshape(-1, 3)
        attrs = {"clip_position": jnp.take(flat["clip_position"], idx3,
                                           axis=0)}
        attrs2, valid, (ia_l, ib_l, t4) = clip_triangles(
            attrs, uniforms.get("near_clip", near_clip),
            return_sources=True)
        if tri_mask is not None:
            valid = valid & jnp.repeat(jnp.asarray(tri_mask, bool), 2)
        tris = setup_triangles(attrs2, valid, width, height, cull_mode)
        # Per-slot synthesized varyings stay eager (elementwise from the
        # slot's own screen positions — no vertex gather to defer, and
        # recomputing them post-compaction can fuse differently by 1 ulp);
        # the vertex-sourced varyings are what materialize_attrs rebuilds.
        full_attrs = tris.pop("attrs")
        tris["attrs"] = (
            {"screen_coords": full_attrs["screen_coords"]}
            if keep_varyings is None or "screen_coords" in keep_varyings
            else {})

        # Fan-slice the (T, 4) polygon sources into the (2T, 3) slot
        # layout exactly like clip_one, then apply setup's vertex
        # reversal so slot vertex v matches attrs row v everywhere.
        ga = _select_rows(idx3, ia_l, 3)                    # global ids
        gb = _select_rows(idx3, ib_l, 3)
        fan_a = jnp.asarray([0, 1, 2])
        fan_b = jnp.asarray([0, 2, 3])
        rev = jnp.asarray([2, 1, 0])

        def fan2(a4):
            out = jnp.stack([a4[:, fan_a], a4[:, fan_b]],
                            axis=1).reshape(-1, 3)
            return out[:, rev]

        tris["attr_src"] = {"ia": fan2(ga), "ib": fan2(gb),
                            "t": fan2(t4)}
        tris["vert_attrs"] = flat
        return tris
    attrs = assemble_triangles(vs_out, indices)
    if keep_varyings is not None:
        keep = set(keep_varyings) | {"clip_position"}
        attrs = {k: v for k, v in attrs.items() if k in keep}
    attrs2, valid = clip_triangles(attrs, uniforms.get("near_clip", near_clip))
    if tri_mask is not None:
        valid = valid & jnp.repeat(jnp.asarray(tri_mask, bool), 2)
    tris = setup_triangles(attrs2, valid, width, height, cull_mode)
    if keep_varyings is not None and "screen_coords" not in keep_varyings:
        tris["attrs"].pop("screen_coords", None)
    return tris


def materialize_attrs(tris: Dict) -> Dict:
    """Gather + lerp the deferred per-vertex varyings into per-slot
    (N, 3, K) "attrs" — the second half of build_triangles(
    defer_attrs=True), run AFTER compaction so the per-element vertex
    gathers scale with the active cap instead of packed slots.

    Bit-exact vs the eager path for every CONSUMED value: kept vertices
    read their vertex value (a + (b - a)·0 == a), clipped vertices apply
    the clipper's own `a + (b - a) * t` to the same operand values, and
    the synthesized screen_coords varying was kept eager at build time
    (it has no vertex source).  Only invalid/pad slots differ (eager
    zeros vs arbitrary rows) — no downstream stage reads those (winner
    folds and payload masks are validity-gated)."""
    tris = dict(tris)
    flat = tris.pop("vert_attrs")
    src = tris.pop("attr_src")
    attrs_eager = dict(tris.get("attrs", {}))
    keys = sorted(flat.keys())
    # One wide row-gather per endpoint instead of per-key element
    # gathers — group by dtype so exotic shader outputs stay exact.
    by_dtype: Dict = {}
    for k in keys:
        by_dtype.setdefault(jnp.asarray(flat[k]).dtype, []).append(k)
    attrs: Dict[str, jnp.ndarray] = attrs_eager
    t = src["t"][..., None]
    for dt, group in by_dtype.items():
        parts, slices, off = [], {}, 0
        for k in group:
            a = jnp.asarray(flat[k])
            parts.append(a)
            slices[k] = (off, off + a.shape[-1])
            off += a.shape[-1]
        cat = jnp.concatenate(parts, axis=-1) if len(parts) > 1 \
            else parts[0]
        va = jnp.take(cat, src["ia"], axis=0)               # (N, 3, K)
        vb = jnp.take(cat, src["ib"], axis=0)
        # clip_one's exact expression (dtype promotion included)
        m = va + (vb - va) * t
        for k, (lo, hi) in slices.items():
            attrs[k] = m[..., lo:hi]
    tris["attrs"] = attrs
    return tris
