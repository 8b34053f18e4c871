"""Tile-binned visibility: sort-middle rasterization without locks.

The reference rasterizes each triangle over the 16×16-px tiles its bbox
touches, serializing tile access with a mutex matrix
(/root/reference/Rasterizer.cs:449-539, SURVEY.md §2.2 P2).  The lock-free
equivalent is sort-middle binning (SURVEY.md §7 step 4):

  1. every valid triangle emits (tile_id, tri_id) pairs for the screen
     tiles its clamped bbox overlaps — a static-shape expansion of up to
     `span_cap` slots per triangle;
  2. pairs are stable-sorted by tile id (keeps submission order inside a
     tile), giving per-tile contiguous segments located by searchsorted;
  3. each tile folds its segment through the same lexicographic
     (depth, index) reduction the brute-force path uses — exactly
     equivalent to the reference's sequential depth test because every
     monotone depth mode is a total preorder on (depth, submission index).

Triangles whose bbox spans more than `span_cap` tiles (near-camera walls,
sky quads) would explode the pair table; they go to a capacity-free
"global" list instead — a stable partition of the triangle ids — and every
tile folds the globals before its own segment.  Order-independence of the
lexicographic reduce makes the global/binned processing order irrelevant.

All loop trip counts that depend on scene content (segment lengths, global
count) are TRACED fori_loop bounds (lowered to while_loop), so there are
no capacity knobs to overflow and no dynamic shapes.
"""

from __future__ import annotations

from typing import Dict, Optional

import jax
import jax.numpy as jnp

from softwarerenderer_tpu.config import DepthTest, RenderParams
from softwarerenderer_tpu.ops.raster import DEPTH_CLEAR, NO_TRI, _REDUCE_RULES

F32 = jnp.float32
# Precision of the one-hot payload resolve.  The payload carries screen
# vertices, varyings and integer atlas offsets, so the product must be
# exact: on a GPU an unpinned float32 product may run in TF32, which keeps
# about three decimal digits (and integers only up to 2048).
RESOLVE_PRECISION = jax.lax.Precision.HIGHEST


def _cdiv(a, b):
    return -(-a // b)


def bin_triangles(tris: Dict, params: RenderParams, tile_h: int, tile_w: int,
                  span_cap: int, row_offset=0):
    """Build the sorted (tile, triangle) pair table + the global-tri list.

    Returns dict with:
      order      (N,) i32 — triangle ids, globals first (submission order)
      n_global   ()  i32
      sorted_tri (N * span_cap,) i32 — pair table triangle ids
      starts/counts (ntiles,) i32 — per-tile segment into sorted_tri
    """
    nty = _cdiv(params.height, tile_h)
    ntx = _cdiv(params.width, tile_w)
    ntiles = nty * ntx
    bbox = tris["bbox"]                    # (N, 4) min_x, min_y, max_x, max_y
    valid = tris["valid"]
    n = bbox.shape[0]

    # Shard-local rows: params.height is this shard's height; bbox rows are
    # GLOBAL screen coordinates, shifted here (row_offset = the shard's
    # first row).  Triangles not overlapping the shard emit nothing.
    off = jnp.asarray(row_offset, jnp.int32)
    by0 = bbox[:, 1] - off
    by1 = bbox[:, 3] - off
    overlap = (by1 >= 0) & (by0 <= params.height - 1)
    valid = valid & overlap

    tx0 = bbox[:, 0] // tile_w
    ty0 = jnp.clip(by0, 0, params.height - 1) // tile_h
    tx1 = bbox[:, 2] // tile_w
    ty1 = jnp.clip(by1, 0, params.height - 1) // tile_h
    span_w = tx1 - tx0 + 1
    span_h = ty1 - ty0 + 1
    span = span_w * span_h

    is_global = valid & (span > span_cap)
    is_binned = valid & ~is_global

    # Stable partition: global triangle ids first, in submission order.
    # Built as a cumsum + scatter permutation (target of slot i = its
    # running count within its class) — equivalent to the stable argsort
    # it replaces (scripts/profile_compaction.py asserts it); the scatter
    # avoids the sort's log²-pass scaling).
    n_global = jnp.sum(is_global.astype(jnp.int32))
    gi = is_global.astype(jnp.int32)
    posg = jnp.cumsum(gi) - 1
    posb = jnp.cumsum(1 - gi) - 1
    tgt = jnp.where(is_global, posg, n_global + posb)
    order = jnp.zeros((n,), jnp.int32).at[tgt].set(
        jnp.arange(n, dtype=jnp.int32))

    # Pair expansion: slot s of triangle t covers bbox tile (s//span_w,
    # s%span_w); slots ≥ span (or non-binned tris) get the ntiles sentinel
    # and sort to the tail.
    s_idx = jnp.arange(span_cap, dtype=jnp.int32)[None, :]      # (1, S)
    dy = s_idx // span_w[:, None]
    dx = s_idx % span_w[:, None]
    tile_id = (ty0[:, None] + dy) * ntx + (tx0[:, None] + dx)   # (N, S)
    pair_ok = is_binned[:, None] & (s_idx < span[:, None])
    tile_id = jnp.where(pair_ok, tile_id, ntiles).reshape(-1)

    tri_bits = max(1, (n - 1).bit_length())
    tile_bits = (ntiles + 1 - 1).bit_length()
    tri_id = jnp.broadcast_to(
        jnp.arange(n, dtype=jnp.int32)[:, None],
        (n, span_cap)).reshape(-1)

    # Live-pair compaction (params.pair_cap): stable-compact the live
    # pairs to a static prefix with a cumsum + scatter BEFORE sorting —
    # the sort and every downstream stream gather then scale with the
    # cap instead of the n·span_cap table.  Order within the compacted
    # prefix is the original tri-major pair order, so sorting the
    # compacted keys yields exactly the live prefix of the full table's
    # sort.  Overflow (live pairs > cap) drops the LAST pairs in
    # submission order; engine.render_frame surfaces the traced count as
    # "pair_cap_overflow" when active_cap_stats is set (0 = exact).
    pair_cap = int(getattr(params, "pair_cap", 0) or 0)
    if pair_cap >= n * span_cap:
        pair_cap = 0
    live = tile_id < ntiles            # == pair_ok, flattened

    def compact(arr, sentinel):
        pos = jnp.cumsum(live.astype(jnp.int32)) - 1
        tgt = jnp.where(live, pos, pair_cap)
        return jnp.full((pair_cap,), sentinel, arr.dtype).at[tgt].set(
            arr, mode="drop")

    if tri_bits + tile_bits <= 32:
        # Packed single-key sort: key = tile_id << tri_bits | tri_id.
        # A triangle emits each tile AT MOST ONCE (its span_cap slots map
        # to distinct bbox tiles), so inside one tile the triangle id is
        # exactly the submission-order stability tiebreak — and it needs
        # log2(span_cap) fewer bits than the old pair-position tiebreak,
        # which overflowed 32 bits (and fell back to the 2-array sort)
        # already at ~300k-triangle scenes at 4K.  One u32 per pair keeps
        # the bandwidth-bound bitonic sort passes minimal (measured ~2×
        # on the ~4.5 ms binning stage at 1080p dust2).
        key = (tile_id.astype(jnp.uint32) << tri_bits) \
            | tri_id.astype(jnp.uint32)
        if pair_cap:
            key = compact(key, jnp.uint32(ntiles) << tri_bits)
        skey = jnp.sort(key)
        sorted_tile = (skey >> tri_bits).astype(jnp.int32)
        sorted_tri = (skey & jnp.uint32((1 << tri_bits) - 1)) \
            .astype(jnp.int32)
    else:
        # Beyond u32 capacity: one two-operand lexicographic sort —
        # (tile, tri) composite keys are unique, so is_stable is not
        # needed and the carried value replaces argsort + two
        # n·span_cap-element gathers.
        if pair_cap:
            tile_id = compact(tile_id, jnp.int32(ntiles))
            tri_id = compact(tri_id, jnp.int32(0))
        sorted_tile, sorted_tri = jax.lax.sort(
            (tile_id, tri_id), num_keys=2, is_stable=False)

    tids = jnp.arange(ntiles, dtype=jnp.int32)
    starts = jnp.searchsorted(sorted_tile, tids, side="left")
    ends = jnp.searchsorted(sorted_tile, tids, side="right")
    return {
        "order": order.astype(jnp.int32),
        "n_global": n_global,
        "sorted_tri": sorted_tri,
        "starts": starts.astype(jnp.int32),
        "counts": (ends - starts).astype(jnp.int32),
        "ntx": ntx, "nty": nty,
    }


def live_pair_count(tris: Dict, params: RenderParams,
                    tile_h: int | None = None, tile_w: int | None = None,
                    span_cap: int | None = None, row_offset=0):
    """Traced count of live (tile, triangle) pairs this frame's binning
    emits — the quantity params.pair_cap truncates.  Recomputes the
    bbox→tile-span arithmetic of bin_triangles (cheap: no sort, no pair
    table) so the engine can surface capacity counters without plumbing
    bins through every render path, and so users can MEASURE a workload
    before choosing a cap (run one frame with active_cap_stats and read
    stats["live_pairs"])."""
    span, valid = _tile_spans(tris, params, tile_h, tile_w, row_offset)
    span_cap = params.span_cap if span_cap is None else span_cap
    return jnp.sum(jnp.where(valid & (span <= span_cap), span, 0)
                   .astype(jnp.int32))


def _tile_spans(tris, params, tile_h, tile_w, row_offset):
    """(tile span, validity) per slot — the bbox→tile arithmetic of
    bin_triangles without the pair table."""
    tile_h = params.tile_h if tile_h is None else tile_h
    tile_w = params.tile_w if tile_w is None else tile_w
    bbox = tris["bbox"]
    valid = tris["valid"]
    off = jnp.asarray(row_offset, jnp.int32)
    by0 = bbox[:, 1] - off
    by1 = bbox[:, 3] - off
    valid = valid & (by1 >= 0) & (by0 <= params.height - 1)
    tx0 = bbox[:, 0] // tile_w
    ty0 = jnp.clip(by0, 0, params.height - 1) // tile_h
    tx1 = bbox[:, 2] // tile_w
    ty1 = jnp.clip(by1, 0, params.height - 1) // tile_h
    span = (tx1 - tx0 + 1) * (ty1 - ty0 + 1)
    return span, valid


def global_count(tris: Dict, params: RenderParams,
                 tile_h: int | None = None, tile_w: int | None = None,
                 span_cap: int | None = None, row_offset=0):
    """Traced count of GLOBAL (span > span_cap) triangles this frame —
    the list every tile walks before its own segment; reported as
    stats["live_globals"] by active_cap_stats."""
    span, valid = _tile_spans(tris, params, tile_h, tile_w, row_offset)
    span_cap = params.span_cap if span_cap is None else span_cap
    return jnp.sum((valid & (span > span_cap)).astype(jnp.int32))


def pair_cap_overflow(tris: Dict, params: RenderParams,
                      tile_h: int | None = None, tile_w: int | None = None,
                      span_cap: int | None = None, row_offset=0):
    """Traced count of live (tile, triangle) pairs params.pair_cap drops
    this frame (0 = the frame is exact)."""
    live = live_pair_count(tris, params, tile_h, tile_w, span_cap,
                           row_offset)
    return jnp.maximum(0, live - params.pair_cap)


def visibility_binned(tris: Dict, params: RenderParams, chunk: int = 32,
                      init_depth=None, row_offset=0, *, tile_h: int = 32,
                      tile_w: int = 128, span_cap: int = 16,
                      tile_group: int = 8, tile_row_map=None,
                      full_height=None, tile_map=None):
    """Binned per-pixel (depth, triangle-id) reduction.

    Drop-in replacement for raster.visibility_brute_force (same contract)
    with work proportional to triangle-tile overlap instead of T × H × W.
    tile_group adjacent tiles are processed per sequential step, which
    bounds the (group, chunk, tile_h·tile_w) working set.

    tile_row_map (traced (params.height // tile_h,) i32, with full_height):
    this call owns an ARBITRARY set of GLOBAL tile rows instead of the
    contiguous band at row_offset — the load-balanced fb-sharding mode
    (parallel.sharding): binning runs over the full frame and only the
    owned tiles' segments fold.  Output rows follow tile_row_map order.

    tile_map (traced (n_owned,) i32 GLOBAL tile ids over the full
    params.height × params.width frame): this call owns an arbitrary set
    of individual TILES (the tile-level balanced fb-sharding mode — a
    single hot tile row can split across devices).  Returns a
    (n_owned · tile_h, tile_w) pseudo-image whose block r//tile_h is the
    owned tile tile_map[r//tile_h]; ids == ntiles are dummy padding tiles
    (they fold nothing from the segments and their output is dropped by
    the caller's reassembly).
    """
    mode = params.depth_test
    if mode not in _REDUCE_RULES:
        raise NotImplementedError(
            f"depth test {mode!r} is order-dependent; use render_forward")
    use_max, later_wins = _REDUCE_RULES[mode]

    H, W = params.height, params.width
    if tile_map is not None:
        bins = bin_triangles(tris, params, tile_h, tile_w, span_cap, 0)
    elif tile_row_map is not None:
        if H % tile_h:
            raise ValueError("height must be a tile_h multiple for "
                             "tile_row_map mode")
        bins = bin_triangles(tris, params.replace(height=full_height),
                             tile_h, tile_w, span_cap, 0)
    else:
        bins = bin_triangles(tris, params, tile_h, tile_w, span_cap,
                             row_offset)
    ntx = bins["ntx"]
    if tile_map is not None:
        n_owned = tile_map.shape[0]
        nty = n_owned
        ntiles = n_owned
        n_tiles_full = ntx * bins["nty"]
    else:
        nty = _cdiv(H, tile_h)
        ntiles = ntx * nty
    ngroups = _cdiv(ntiles, tile_group)
    ntiles_pad = ngroups * tile_group
    tpx = tile_h * tile_w

    screen = tris["screen"]
    depth_v = tris["depth"]
    inv_area = tris["inv_area"]
    n = screen.shape[0]

    # Framebuffer in tile layout (ntiles_pad, tpx).
    if tile_map is not None:
        if init_depth is None:
            init_depth = jnp.full((n_owned * tile_h, tile_w), DEPTH_CLEAR,
                                  dtype=F32)
        d0 = init_depth.reshape(n_owned, tpx)
        d0 = jnp.pad(d0, ((0, ntiles_pad - ntiles), (0, 0)))
    else:
        if init_depth is None:
            init_depth = jnp.full((H, W), DEPTH_CLEAR, dtype=F32)
        Hp, Wp = nty * tile_h, ntx * tile_w
        d0 = jnp.pad(init_depth, ((0, Hp - H), (0, Wp - W)))
        d0 = d0.reshape(nty, tile_h, ntx, tile_w).transpose(0, 2, 1, 3)
        d0 = d0.reshape(ntiles, tpx)
        d0 = jnp.pad(d0, ((0, ntiles_pad - ntiles), (0, 0)))
    i0 = jnp.full((ntiles_pad, tpx), NO_TRI, dtype=jnp.int32)

    sorted_tri = bins["sorted_tri"]
    order = bins["order"]
    n_global = bins["n_global"]

    if tile_map is not None:
        # Arbitrary owned tiles: gather segments + pixel bases per tile.
        # Dummy ids (== n_tiles_full) get zero-length segments.
        tm = jnp.asarray(tile_map, jnp.int32)
        dummy = tm >= n_tiles_full
        tmc = jnp.clip(tm, 0, n_tiles_full - 1)
        starts = jnp.pad(jnp.take(bins["starts"], tmc),
                         (0, ntiles_pad - ntiles))
        counts = jnp.pad(jnp.where(dummy, 0, jnp.take(bins["counts"], tmc)),
                         (0, ntiles_pad - ntiles))
        ty_base = jnp.pad((tmc // ntx) * tile_h, (0, ntiles_pad - ntiles))
        tx_base = jnp.pad((tmc % ntx) * tile_w, (0, ntiles_pad - ntiles))
    elif tile_row_map is not None:
        # Gather the owned tiles' segments + global pixel-row bases.
        trm = jnp.asarray(tile_row_map, jnp.int32)
        gids = (trm[:, None] * ntx
                + jnp.arange(ntx, dtype=jnp.int32)[None, :]).reshape(-1)
        starts = jnp.pad(jnp.take(bins["starts"], gids),
                         (0, ntiles_pad - ntiles))
        counts = jnp.pad(jnp.take(bins["counts"], gids),
                         (0, ntiles_pad - ntiles))
        ty_base = jnp.pad(jnp.repeat(trm, ntx) * tile_h,
                          (0, ntiles_pad - ntiles))
        tx_base = (jnp.arange(ntiles_pad, dtype=jnp.int32) % ntx) * tile_w
    else:
        starts = jnp.pad(bins["starts"], (0, ntiles_pad - ntiles))
        counts = jnp.pad(bins["counts"], (0, ntiles_pad - ntiles))
        ty_base = (jnp.arange(ntiles_pad, dtype=jnp.int32) // ntx) * tile_h \
            + jnp.asarray(row_offset, jnp.int32)
        tx_base = (jnp.arange(ntiles_pad, dtype=jnp.int32) % ntx) * tile_w

    tile_ids_all = jnp.arange(ntiles_pad, dtype=jnp.int32)
    px_in_tile = (jax.lax.broadcasted_iota(jnp.int32, (tile_h, tile_w), 1)
                  .reshape(tpx))
    py_in_tile = (jax.lax.broadcasted_iota(jnp.int32, (tile_h, tile_w), 0)
                  .reshape(tpx))

    def eval_chunk(tri_ids, tri_ok, px, py):
        """tri_ids (G, C), tri_ok (G, C), px/py (G, tpx) →
        depth (G, C, tpx), mask, idx."""
        t = jnp.clip(tri_ids, 0, n - 1)
        s = jnp.take(screen, t, axis=0)        # (G, C, 3, 2)
        dv = jnp.take(depth_v, t, axis=0)      # (G, C, 3)
        ia = jnp.take(inv_area, t, axis=0)     # (G, C)
        s0 = s[..., 0, :][..., None, :]        # (G, C, 1, 2)
        s1 = s[..., 1, :][..., None, :]
        s2 = s[..., 2, :][..., None, :]
        pxb = px[:, None, :].astype(F32)       # (G, 1, tpx)
        pyb = py[:, None, :].astype(F32)
        w0 = ((s1[..., 1] - s2[..., 1]) * (pxb - s1[..., 0])
              + (s2[..., 0] - s1[..., 0]) * (pyb - s1[..., 1]))
        w1 = ((s2[..., 1] - s0[..., 1]) * (pxb - s2[..., 0])
              + (s0[..., 0] - s2[..., 0]) * (pyb - s2[..., 1]))
        w2 = ((s0[..., 1] - s1[..., 1]) * (pxb - s0[..., 0])
              + (s1[..., 0] - s0[..., 0]) * (pyb - s0[..., 1]))
        inside = ((w0 >= 0) & (w1 >= 0) & (w2 >= 0)) | \
                 ((w0 <= 0) & (w1 <= 0) & (w2 <= 0))
        iab = ia[..., None]
        d = (dv[..., 0, None] * (w0 * iab) + dv[..., 1, None] * (w1 * iab)
             + dv[..., 2, None] * (w2 * iab))
        mask = inside & tri_ok[..., None]
        return d, mask, t

    def merge(best_d, best_i, d, mask, idx):
        """Lexicographic (depth, submission index) fold step over the chunk
        axis (axis=-2) of d/mask/idx — order-independent, so globals and
        per-tile segments can be folded in any order."""
        if use_max is None:
            key = jnp.where(mask, idx[..., None], -1)
            pick = jnp.argmax(key, axis=-2)
            cand_valid = jnp.any(mask, axis=-2)
            cand_d = jnp.take_along_axis(d, pick[..., None, :],
                                         axis=-2)[..., 0, :]
            cand_i = jnp.take_along_axis(
                jnp.broadcast_to(idx[..., None], d.shape),
                pick[..., None, :], axis=-2)[..., 0, :]
            take = cand_valid & (cand_i > best_i)
        else:
            bad = F32(-jnp.inf) if use_max else F32(jnp.inf)
            dm = jnp.where(mask, d, bad)
            cand_d = (jnp.max if use_max else jnp.min)(dm, axis=-2)
            at_best = mask & (d == cand_d[..., None, :])
            idxb = jnp.broadcast_to(idx[..., None], d.shape)
            sel = jnp.where(at_best, idxb, -1 if later_wins else n)
            cand_i = (jnp.max(sel, axis=-2) if later_wins
                      else jnp.min(sel, axis=-2))
            cand_valid = jnp.any(at_best, axis=-2)
            if use_max:
                strict = cand_d > best_d
            else:
                strict = cand_d < best_d
            if later_wins:
                # NO_TRI = -1 makes a tie against the initial buffer PASS,
                # matching the reference's "new >= old" style comparisons.
                tie = (cand_d == best_d) & (cand_i > best_i)
            else:
                # Strict modes: a tie against the initial buffer (-1) fails,
                # matching "new > old"; among triangles the earlier wins.
                tie = (cand_d == best_d) & (cand_i < best_i)
            take = cand_valid & (strict | tie)
        new_d = jnp.where(take, cand_d, best_d)
        new_i = jnp.where(take, cand_i.astype(jnp.int32), best_i)
        return new_d, new_i

    def group_body(g, carry):
        all_d, all_i = carry
        base = g * tile_group
        tiles = jax.lax.dynamic_slice_in_dim(tile_ids_all, base, tile_group)
        g_starts = jax.lax.dynamic_slice_in_dim(starts, base, tile_group)
        g_counts = jax.lax.dynamic_slice_in_dim(counts, base, tile_group)
        g_ty_base = jax.lax.dynamic_slice_in_dim(ty_base, base, tile_group)
        g_tx_base = jax.lax.dynamic_slice_in_dim(tx_base, base, tile_group)
        px = g_tx_base[:, None] + px_in_tile[None, :]     # (G, tpx) global
        py = g_ty_base[:, None] + py_in_tile[None, :]     # global rows

        best_d = jax.lax.dynamic_slice_in_dim(all_d, base, tile_group)
        best_i = jax.lax.dynamic_slice_in_dim(all_i, base, tile_group)

        c_off = jnp.arange(chunk, dtype=jnp.int32)

        # Fold the capacity-free global list (traced trip count).
        def glob_body(c, bi_bd):
            bd, bi = bi_bd
            pos = c * chunk + c_off                       # (C,)
            ok = pos < n_global
            ids = jnp.take(order, jnp.clip(pos, 0, order.shape[0] - 1))
            ids_g = jnp.broadcast_to(ids[None, :], (tile_group, chunk))
            ok_g = jnp.broadcast_to(ok[None, :], (tile_group, chunk))
            d, m, t = eval_chunk(ids_g, ok_g, px, py)
            return merge(bd, bi, d, m, t)

        best_d, best_i = jax.lax.fori_loop(
            0, _cdiv(n_global, chunk), glob_body, (best_d, best_i))

        # Fold this group's per-tile segments (traced trip count = the
        # group's longest segment).
        max_count = jnp.max(g_counts)

        def seg_body(c, bi_bd):
            bd, bi = bi_bd
            pos = g_starts[:, None] + c * chunk + c_off[None, :]  # (G, C)
            ok = (c * chunk + c_off)[None, :] < g_counts[:, None]
            ids = jnp.take(sorted_tri,
                           jnp.clip(pos, 0, sorted_tri.shape[0] - 1))
            d, m, t = eval_chunk(ids, ok, px, py)
            return merge(bd, bi, d, m, t)

        best_d, best_i = jax.lax.fori_loop(
            0, _cdiv(max_count, chunk), seg_body, (best_d, best_i))

        all_d = jax.lax.dynamic_update_slice_in_dim(all_d, best_d, base,
                                                    axis=0)
        all_i = jax.lax.dynamic_update_slice_in_dim(all_i, best_i, base,
                                                    axis=0)
        return all_d, all_i

    all_d, all_i = jax.lax.fori_loop(0, ngroups, group_body, (d0, i0))

    if tile_map is not None:
        def untile(a):
            return a[:ntiles].reshape(n_owned * tile_h, tile_w)
    else:
        def untile(a):
            a = a[:ntiles].reshape(nty, ntx, tile_h, tile_w)
            a = a.transpose(0, 2, 1, 3).reshape(Hp, Wp)
            return a[:H, :W]

    return untile(all_d), untile(all_i)


def render_binned_fused(tris: Dict, fragment_shader, uniforms: Dict,
                        params: RenderParams,
                        fb_color, fb_depth,
                        per_tri_extra: Optional[Dict] = None,
                        row_offset=0):
    """Fully fused tile renderer: visibility fold + winner-attribute resolve
    + perspective-correct interpolation + fragment shading + blend, all
    inside one per-tile-group loop.

    The deferred path's full-screen per-pixel row-gathers (the HBM-bound
    stage: ~60 gathered floats × 2M pixels) are replaced by a second
    streaming pass over each tile's triangle bins that resolves the
    winner's packed payload with ONE-HOT MATMULS — (tpx, C) match matrix ×
    (C, 3·K) chunk payload — so triangle data is only ever read
    in contiguous chunk order and per-pixel attributes never round-trip
    through HBM.
    """
    mode = params.depth_test
    if mode not in _REDUCE_RULES:
        raise NotImplementedError(
            f"depth test {mode!r} is order-dependent; use render_forward")
    use_max, later_wins = _REDUCE_RULES[mode]
    tile_h, tile_w = params.tile_h, params.tile_w
    span_cap, tile_group = params.span_cap, params.tile_group
    chunk = params.chunk

    H, W = params.height, params.width
    bins = bin_triangles(tris, params, tile_h, tile_w, span_cap, row_offset)
    ntx, nty = bins["ntx"], bins["nty"]
    ntiles = ntx * nty
    ngroups = _cdiv(ntiles, tile_group)
    ntiles_pad = ngroups * tile_group
    tpx = tile_h * tile_w

    screen = tris["screen"]
    depth_v = tris["depth"]
    inv_area = tris["inv_area"]
    n = screen.shape[0]

    # ---- packed per-triangle resolve payload: varyings + screen + inv_area
    # + per-tri extras, flattened to (N, 3*Kp) so a chunk is one contiguous
    # block and the one-hot matmul resolves everything at once.
    keys = sorted(tris["attrs"].keys())
    slices = {}
    parts = []
    off = 0
    for k in keys:
        arr = tris["attrs"][k]
        parts.append(arr)
        slices[k] = (off, off + arr.shape[-1])
        off += arr.shape[-1]
    parts.append(screen)
    sl_screen = (off, off + 2); off += 2
    parts.append(jnp.broadcast_to(inv_area[:, None, None], (n, 3, 1)))
    sl_ia = off; off += 1
    extra_slices = {}
    if per_tri_extra:
        for k in sorted(per_tri_extra.keys()):
            v = jnp.asarray(per_tri_extra[k], jnp.float32)[:, None, None]
            parts.append(jnp.broadcast_to(v, (n, 3, 1)))
            extra_slices[k] = off
            off += 1
    kp = off
    payload = jnp.concatenate(parts, axis=-1).reshape(n, 3 * kp)
    # Invalid slots (clip-rejected fans, degenerate tris) carry NaN screen/
    # inv_area; they never win the fold, but 0·NaN = NaN would poison the
    # one-hot matmul — zero them, and add a zero row as the target for
    # masked candidate slots.
    payload = jnp.where(tris["valid"][:, None], payload, 0.0)
    payload = jnp.concatenate([payload, jnp.zeros((1, 3 * kp), F32)], axis=0)
    clo, chi = slices["clip_position"]

    # ---- framebuffer in tile layout --------------------------------------
    Hp, Wp = nty * tile_h, ntx * tile_w

    def tile_in(a, fill):
        a = jnp.pad(a, ((0, Hp - H), (0, Wp - W)) + ((0, 0),) * (a.ndim - 2),
                    constant_values=fill)
        a = a.reshape((nty, tile_h, ntx, tile_w) + a.shape[2:])
        a = jnp.moveaxis(a, 2, 1).reshape((ntiles, tpx) + a.shape[4:])
        pad_cfg = ((0, ntiles_pad - ntiles), (0, 0)) \
            + ((0, 0),) * (a.ndim - 2)
        return jnp.pad(a, pad_cfg, constant_values=fill)

    d0 = tile_in(fb_depth, DEPTH_CLEAR)
    c0 = tile_in(fb_color, 0.0)
    i0 = jnp.full((ntiles_pad, tpx), NO_TRI, dtype=jnp.int32)

    starts = jnp.pad(bins["starts"], (0, ntiles_pad - ntiles))
    counts = jnp.pad(bins["counts"], (0, ntiles_pad - ntiles))
    sorted_tri = bins["sorted_tri"]
    order = bins["order"]
    n_global = bins["n_global"]
    c_off = jnp.arange(chunk, dtype=jnp.int32)
    tile_ids_all = jnp.arange(ntiles_pad, dtype=jnp.int32)
    px_in_tile = (jax.lax.broadcasted_iota(jnp.int32, (tile_h, tile_w), 1)
                  .reshape(tpx))
    py_in_tile = (jax.lax.broadcasted_iota(jnp.int32, (tile_h, tile_w), 0)
                  .reshape(tpx))

    def eval_chunk(tri_ids, tri_ok, px, py):
        t = jnp.clip(tri_ids, 0, n - 1)
        s = jnp.take(screen, t, axis=0)
        dv = jnp.take(depth_v, t, axis=0)
        ia = jnp.take(inv_area, t, axis=0)
        s0 = s[..., 0, :][..., None, :]
        s1 = s[..., 1, :][..., None, :]
        s2 = s[..., 2, :][..., None, :]
        pxb = px[:, None, :].astype(F32)
        pyb = py[:, None, :].astype(F32)
        w0 = ((s1[..., 1] - s2[..., 1]) * (pxb - s1[..., 0])
              + (s2[..., 0] - s1[..., 0]) * (pyb - s1[..., 1]))
        w1 = ((s2[..., 1] - s0[..., 1]) * (pxb - s2[..., 0])
              + (s0[..., 0] - s2[..., 0]) * (pyb - s2[..., 1]))
        w2 = ((s0[..., 1] - s1[..., 1]) * (pxb - s0[..., 0])
              + (s1[..., 0] - s0[..., 0]) * (pyb - s0[..., 1]))
        inside = ((w0 >= 0) & (w1 >= 0) & (w2 >= 0)) | \
                 ((w0 <= 0) & (w1 <= 0) & (w2 <= 0))
        iab = ia[..., None]
        d = (dv[..., 0, None] * (w0 * iab) + dv[..., 1, None] * (w1 * iab)
             + dv[..., 2, None] * (w2 * iab))
        return d, inside & tri_ok[..., None], t

    def merge(best_d, best_i, d, mask, idx):
        if use_max is None:
            key = jnp.where(mask, idx[..., None], -1)
            pick = jnp.argmax(key, axis=-2)
            cand_valid = jnp.any(mask, axis=-2)
            cand_d = jnp.take_along_axis(d, pick[..., None, :],
                                         axis=-2)[..., 0, :]
            cand_i = jnp.take_along_axis(
                jnp.broadcast_to(idx[..., None], d.shape),
                pick[..., None, :], axis=-2)[..., 0, :]
            take = cand_valid & (cand_i > best_i)
        else:
            bad = F32(-jnp.inf) if use_max else F32(jnp.inf)
            dm = jnp.where(mask, d, bad)
            cand_d = (jnp.max if use_max else jnp.min)(dm, axis=-2)
            at_best = mask & (d == cand_d[..., None, :])
            idxb = jnp.broadcast_to(idx[..., None], d.shape)
            sel = jnp.where(at_best, idxb, -1 if later_wins else n)
            cand_i = (jnp.max(sel, axis=-2) if later_wins
                      else jnp.min(sel, axis=-2))
            cand_valid = jnp.any(at_best, axis=-2)
            strict = (cand_d > best_d) if use_max else (cand_d < best_d)
            tie = (cand_d == best_d) & ((cand_i > best_i) if later_wins
                                        else (cand_i < best_i))
            take = cand_valid & (strict | tie)
        return (jnp.where(take, cand_d, best_d),
                jnp.where(take, cand_i.astype(jnp.int32), best_i))

    def group_body(g, carry):
        all_c, all_d = carry
        base = g * tile_group
        tiles = jax.lax.dynamic_slice_in_dim(tile_ids_all, base, tile_group)
        g_starts = jax.lax.dynamic_slice_in_dim(starts, base, tile_group)
        g_counts = jax.lax.dynamic_slice_in_dim(counts, base, tile_group)
        ty = tiles // ntx
        tx = tiles % ntx
        px = tx[:, None] * tile_w + px_in_tile[None, :]
        py = ty[:, None] * tile_h + py_in_tile[None, :] \
            + jnp.asarray(row_offset, jnp.int32)

        best_d = jax.lax.dynamic_slice_in_dim(d0, base, tile_group)
        best_i = jnp.full((tile_group, tpx), NO_TRI, jnp.int32)

        n_glob_chunks = _cdiv(n_global, chunk)

        def glob_ids(c):
            pos = c * chunk + c_off
            ok = pos < n_global
            ids = jnp.take(order, jnp.clip(pos, 0, order.shape[0] - 1))
            return (jnp.broadcast_to(ids[None, :], (tile_group, chunk)),
                    jnp.broadcast_to(ok[None, :], (tile_group, chunk)))

        def seg_ids(c):
            pos = g_starts[:, None] + c * chunk + c_off[None, :]
            ok = (c * chunk + c_off)[None, :] < g_counts[:, None]
            ids = jnp.take(sorted_tri,
                           jnp.clip(pos, 0, sorted_tri.shape[0] - 1))
            return ids, ok

        # ---- pass A: visibility fold ----
        def fold(ids_fn):
            def body(c, bd_bi):
                bd, bi = bd_bi
                ids, ok = ids_fn(c)
                d, m, t = eval_chunk(ids, ok, px, py)
                return merge(bd, bi, d, m, t)
            return body
        best_d, best_i = jax.lax.fori_loop(
            0, n_glob_chunks, fold(glob_ids), (best_d, best_i))
        max_count = jnp.max(g_counts)
        best_d, best_i = jax.lax.fori_loop(
            0, _cdiv(max_count, chunk), fold(seg_ids), (best_d, best_i))

        # ---- pass B: winner payload resolve via one-hot matmul ----
        def resolve(ids_fn):
            def body(c, acc):
                ids, ok = ids_fn(c)
                t = jnp.where(ok, jnp.clip(ids, 0, n - 1), n)  # n = zero row
                pl = jnp.take(payload, t, axis=0)        # (G, C, 3Kp)
                onehot = ((best_i[..., None] == t[:, None, :]) & ok[:, None, :]
                          ).astype(F32)                  # (G, tpx, C)
                return acc + jax.lax.dot_general(
                    onehot, pl, (((2,), (1,)), ((0,), (0,))),
                    precision=RESOLVE_PRECISION,
                    preferred_element_type=jnp.float32)
            return body
        acc0 = jnp.zeros((tile_group, tpx, 3 * kp), F32)
        acc = jax.lax.fori_loop(0, n_glob_chunks, resolve(glob_ids), acc0)
        acc = jax.lax.fori_loop(0, _cdiv(max_count, chunk),
                                resolve(seg_ids), acc)
        av = acc.reshape(tile_group, tpx, 3, kp)

        covered = best_i != NO_TRI
        fb_c = jax.lax.dynamic_slice_in_dim(c0, base, tile_group)
        fb_d = jax.lax.dynamic_slice_in_dim(d0, base, tile_group)

        # ---- interpolate (Rasterizer.Interpolate, Rasterizer.cs:566-640),
        # in-loop so `acc` never round-trips through HBM ----
        s = av[..., sl_screen[0]:sl_screen[1]]
        ia = av[..., 0, sl_ia]
        clip_w = av[..., chi - 1]
        pxf = px.astype(F32)
        pyf = py.astype(F32)
        s0x, s0y = s[..., 0, 0], s[..., 0, 1]
        s1x, s1y = s[..., 1, 0], s[..., 1, 1]
        s2x, s2y = s[..., 2, 0], s[..., 2, 1]
        w0 = ((s1y - s2y) * (pxf - s1x) + (s2x - s1x) * (pyf - s1y)) * ia
        w1 = ((s2y - s0y) * (pxf - s2x) + (s0x - s2x) * (pyf - s2y)) * ia
        w2 = ((s0y - s1y) * (pxf - s0x) + (s1x - s0x) * (pyf - s0y)) * ia
        rcp_wa = w0 / jnp.where(clip_w[..., 0] == 0, F32(1), clip_w[..., 0])
        rcp_wb = w1 / jnp.where(clip_w[..., 1] == 0, F32(1), clip_w[..., 1])
        rcp_wc = w2 / jnp.where(clip_w[..., 2] == 0, F32(1), clip_w[..., 2])
        wsum = rcp_wa + rcp_wb + rcp_wc
        wgt = F32(1.0) / jnp.where(wsum == 0, F32(1), wsum)
        wa, wb, wc = rcp_wa * wgt, rcp_wb * wgt, rcp_wc * wgt
        a0, a1, a2 = av[..., 0, :], av[..., 1, :], av[..., 2, :]
        pc = (a0 * rcp_wa[..., None] + a1 * rcp_wb[..., None]
              + a2 * rcp_wc[..., None]) * wgt[..., None]
        pw = a0 * wa[..., None] + a1 * wb[..., None] + a2 * wc[..., None]

        flat = {}
        for k in keys:
            lo, hi = slices[k]
            if k.startswith("data."):
                val = pw[..., lo:hi]
                if hi - lo == 3:
                    lsq = jnp.sum(val * val, axis=-1, keepdims=True)
                    nrm = val / jnp.sqrt(jnp.where(lsq > 0, lsq, F32(1)))
                    val = jnp.where(lsq > F32(1e-6), nrm, val)
            else:
                val = pc[..., lo:hi]
            flat[k] = val
        from softwarerenderer_tpu.ops.geometry import unflatten_varyings
        frag = unflatten_varyings(flat)
        frag["barycentric"] = jnp.stack([wa, wb, wc], axis=-1)
        if extra_slices:
            frag["tri"] = {k: av[..., 0, i].astype(jnp.int32)
                           for k, i in extra_slices.items()}

        color = fragment_shader(frag, uniforms, jnp)
        written = covered & (color[..., 3] > 0)
        out_c = jnp.where(written[..., None],
                          _fused_blend(color, fb_c, params.blend_mode), fb_c)
        if params.depth_test == DepthTest.DISABLED:
            out_d = fb_d
        else:
            out_d = jnp.where(written, best_d, fb_d)

        all_c = jax.lax.dynamic_update_slice_in_dim(all_c, out_c, base, 0)
        all_d = jax.lax.dynamic_update_slice_in_dim(all_d, out_d, base, 0)
        return all_c, all_d

    all_c, all_d = jax.lax.fori_loop(0, ngroups, group_body, (c0, d0))

    def untile(a):
        a = a[:ntiles].reshape((nty, ntx, tile_h, tile_w) + a.shape[2:])
        a = jnp.moveaxis(a, 1, 2).reshape((Hp, Wp) + a.shape[4:])
        return a[:H, :W]

    return untile(all_c), untile(all_d)


def _fused_blend(src, dst, mode):
    from softwarerenderer_tpu.ops.raster import _blend
    return _blend(src, dst, mode)


def _pack_payload(tris: Dict, per_tri_extra: Optional[Dict]):
    """Flatten varyings + screen + inv_area + per-tri extras to (N+1, 3·Kp)
    (row N = zero target for masked one-hot slots) — the resolve payload
    shared by render_binned_fused and shade_binned_fused."""
    screen = tris["screen"]
    inv_area = tris["inv_area"]
    n = screen.shape[0]
    keys = sorted(tris["attrs"].keys())
    slices, parts, off = {}, [], 0
    for k in keys:
        arr = tris["attrs"][k]
        parts.append(arr)
        slices[k] = (off, off + arr.shape[-1])
        off += arr.shape[-1]
    parts.append(screen)
    sl_screen = (off, off + 2); off += 2
    parts.append(jnp.broadcast_to(inv_area[:, None, None], (n, 3, 1)))
    sl_ia = off; off += 1
    extra_slices = {}
    if per_tri_extra:
        for k in sorted(per_tri_extra.keys()):
            v = jnp.asarray(per_tri_extra[k], jnp.float32)[:, None, None]
            parts.append(jnp.broadcast_to(v, (n, 3, 1)))
            extra_slices[k] = off
            off += 1
    kp = off
    payload = jnp.concatenate(parts, axis=-1).reshape(n, 3 * kp)
    # Invalid slots carry NaN screen/inv_area; they never win the fold,
    # but 0·NaN = NaN would poison the one-hot matmul — zero them.
    payload = jnp.where(tris["valid"][:, None], payload, 0.0)
    payload = jnp.concatenate([payload, jnp.zeros((1, 3 * kp), F32)],
                              axis=0)
    return payload, keys, slices, sl_screen, sl_ia, extra_slices, kp


def shade_binned_fused(tris: Dict, best_depth, best_tri, fragment_shader,
                       uniforms: Dict, params: RenderParams,
                       fb_color, fb_depth,
                       per_tri_extra: Optional[Dict] = None,
                       row_offset=0, tile_row_map=None, full_height=None,
                       tile_map=None):
    """Deferred shading of a precomputed winner map WITHOUT per-pixel
    gathers: stream each tile's bins a second time and resolve the
    winner's packed payload with one-hot matmuls, then
    interpolate + shade in the same per-tile-group loop — the fused
    path's pass B applied to an external (best_depth, best_tri).

    Same contract as raster.shade_deferred (frag dict, discard, blend,
    depth-write semantics) but HBM traffic ∝ triangle-tile overlap
    instead of ~60 gathered floats × H·W.  This is what the multi-chip
    path shades through (parallel/sharding.py): the sharded winner index
    comes from the lexicographic all-reduce, masked to this shard's
    triangles.

    Layout modes mirror visibility_binned: contiguous rows at
    ``row_offset``; ``tile_row_map`` (+ full_height) — the input/output
    pseudo-image's row block r//tile_h is GLOBAL tile row
    tile_row_map[r//tile_h]; ``tile_map`` — one owned GLOBAL tile per
    (tile_h, tile_w) block of the pseudo-image (ids == ntiles are dummy
    padding tiles).  best_tri/best_depth/fb_color/fb_depth all share the
    mode's layout.
    """
    from softwarerenderer_tpu.ops.geometry import unflatten_varyings
    from softwarerenderer_tpu.config import DepthTest
    tile_h, tile_w = params.tile_h, params.tile_w
    span_cap, tile_group = params.span_cap, params.tile_group
    chunk = params.chunk
    H, W = params.height, params.width

    if tile_map is not None:
        bins = bin_triangles(tris, params, tile_h, tile_w, span_cap, 0)
        n_tiles_full = bins["ntx"] * bins["nty"]
        ntx = bins["ntx"]
        n_owned = tile_map.shape[0]
        ntiles = n_owned
    elif tile_row_map is not None:
        if H % tile_h:
            raise ValueError("height must be a tile_h multiple for "
                             "tile_row_map mode")
        bins = bin_triangles(tris, params.replace(height=full_height),
                             tile_h, tile_w, span_cap, 0)
        ntx = bins["ntx"]
        nty = H // tile_h
        ntiles = ntx * nty
    else:
        bins = bin_triangles(tris, params, tile_h, tile_w, span_cap,
                             row_offset)
        ntx, nty = bins["ntx"], bins["nty"]
        ntiles = ntx * nty
    ngroups = _cdiv(ntiles, tile_group)
    ntiles_pad = ngroups * tile_group
    tpx = tile_h * tile_w

    screen = tris["screen"]
    n = screen.shape[0]
    (payload, keys, slices, sl_screen, sl_ia,
     extra_slices, kp) = _pack_payload(tris, per_tri_extra)
    clo, chi = slices["clip_position"]

    # ---- inputs in tile layout ------------------------------------------
    if tile_map is not None:
        def tile_in(a, fill):
            a = a.reshape((n_owned, tpx) + a.shape[2:])
            pad_cfg = ((0, ntiles_pad - ntiles), (0, 0)) \
                + ((0, 0),) * (a.ndim - 2)
            return jnp.pad(a, pad_cfg, constant_values=fill)
    else:
        a_h = fb_depth.shape[0]
        Hp, Wp = _cdiv(a_h, tile_h) * tile_h, ntx * tile_w

        def tile_in(a, fill):
            a = jnp.pad(a, ((0, Hp - a_h), (0, Wp - W))
                        + ((0, 0),) * (a.ndim - 2), constant_values=fill)
            a = a.reshape((Hp // tile_h, tile_h, ntx, tile_w) + a.shape[2:])
            a = jnp.moveaxis(a, 2, 1).reshape((ntiles, tpx) + a.shape[4:])
            pad_cfg = ((0, ntiles_pad - ntiles), (0, 0)) \
                + ((0, 0),) * (a.ndim - 2)
            return jnp.pad(a, pad_cfg, constant_values=fill)

    d0 = tile_in(fb_depth, DEPTH_CLEAR)
    c0 = tile_in(fb_color, 0.0)
    bd = tile_in(best_depth, DEPTH_CLEAR)
    bi = tile_in(best_tri, NO_TRI)

    # ---- per-tile segments + global pixel bases (visibility_binned) -----
    if tile_map is not None:
        tm = jnp.asarray(tile_map, jnp.int32)
        dummy = tm >= n_tiles_full
        tmc = jnp.clip(tm, 0, n_tiles_full - 1)
        starts = jnp.pad(jnp.take(bins["starts"], tmc),
                         (0, ntiles_pad - ntiles))
        counts = jnp.pad(jnp.where(dummy, 0,
                                   jnp.take(bins["counts"], tmc)),
                         (0, ntiles_pad - ntiles))
        ty_base = jnp.pad((tmc // ntx) * tile_h, (0, ntiles_pad - ntiles))
        tx_base = jnp.pad((tmc % ntx) * tile_w, (0, ntiles_pad - ntiles))
    elif tile_row_map is not None:
        trm = jnp.asarray(tile_row_map, jnp.int32)
        gids = (trm[:, None] * ntx
                + jnp.arange(ntx, dtype=jnp.int32)[None, :]).reshape(-1)
        starts = jnp.pad(jnp.take(bins["starts"], gids),
                         (0, ntiles_pad - ntiles))
        counts = jnp.pad(jnp.take(bins["counts"], gids),
                         (0, ntiles_pad - ntiles))
        ty_base = jnp.pad(jnp.repeat(trm, ntx) * tile_h,
                          (0, ntiles_pad - ntiles))
        tx_base = (jnp.arange(ntiles_pad, dtype=jnp.int32) % ntx) * tile_w
    else:
        starts = jnp.pad(bins["starts"], (0, ntiles_pad - ntiles))
        counts = jnp.pad(bins["counts"], (0, ntiles_pad - ntiles))
        ty_base = (jnp.arange(ntiles_pad, dtype=jnp.int32) // ntx) \
            * tile_h + jnp.asarray(row_offset, jnp.int32)
        tx_base = (jnp.arange(ntiles_pad, dtype=jnp.int32) % ntx) * tile_w

    sorted_tri = bins["sorted_tri"]
    order = bins["order"]
    n_global = bins["n_global"]
    c_off = jnp.arange(chunk, dtype=jnp.int32)
    px_in_tile = (jax.lax.broadcasted_iota(jnp.int32, (tile_h, tile_w), 1)
                  .reshape(tpx))
    py_in_tile = (jax.lax.broadcasted_iota(jnp.int32, (tile_h, tile_w), 0)
                  .reshape(tpx))

    def group_body(g, carry):
        all_c, all_d = carry
        base = g * tile_group
        g_starts = jax.lax.dynamic_slice_in_dim(starts, base, tile_group)
        g_counts = jax.lax.dynamic_slice_in_dim(counts, base, tile_group)
        g_ty = jax.lax.dynamic_slice_in_dim(ty_base, base, tile_group)
        g_tx = jax.lax.dynamic_slice_in_dim(tx_base, base, tile_group)
        px = g_tx[:, None] + px_in_tile[None, :]
        py = g_ty[:, None] + py_in_tile[None, :]

        best_i = jax.lax.dynamic_slice_in_dim(bi, base, tile_group)
        best_d = jax.lax.dynamic_slice_in_dim(bd, base, tile_group)

        n_glob_chunks = _cdiv(n_global, chunk)

        def glob_ids(c):
            pos = c * chunk + c_off
            ok = pos < n_global
            ids = jnp.take(order, jnp.clip(pos, 0, order.shape[0] - 1))
            return (jnp.broadcast_to(ids[None, :], (tile_group, chunk)),
                    jnp.broadcast_to(ok[None, :], (tile_group, chunk)))

        def seg_ids(c):
            pos = g_starts[:, None] + c * chunk + c_off[None, :]
            ok = (c * chunk + c_off)[None, :] < g_counts[:, None]
            ids = jnp.take(sorted_tri,
                           jnp.clip(pos, 0, sorted_tri.shape[0] - 1))
            return ids, ok

        # ---- winner payload resolve via one-hot matmul ----
        def resolve(ids_fn):
            def body(c, acc):
                ids, ok = ids_fn(c)
                t = jnp.where(ok, jnp.clip(ids, 0, n - 1), n)  # n = zero row
                pl = jnp.take(payload, t, axis=0)        # (G, C, 3Kp)
                onehot = ((best_i[..., None] == t[:, None, :])
                          & ok[:, None, :]).astype(F32)  # (G, tpx, C)
                return acc + jax.lax.dot_general(
                    onehot, pl, (((2,), (1,)), ((0,), (0,))),
                    precision=RESOLVE_PRECISION,
                    preferred_element_type=jnp.float32)
            return body
        acc0 = jnp.zeros((tile_group, tpx, 3 * kp), F32)
        max_count = jnp.max(g_counts)
        acc = jax.lax.fori_loop(0, n_glob_chunks, resolve(glob_ids), acc0)
        acc = jax.lax.fori_loop(0, _cdiv(max_count, chunk),
                                resolve(seg_ids), acc)
        av = acc.reshape(tile_group, tpx, 3, kp)

        covered = best_i != NO_TRI
        fb_c = jax.lax.dynamic_slice_in_dim(c0, base, tile_group)
        fb_d = jax.lax.dynamic_slice_in_dim(d0, base, tile_group)

        # ---- interpolate (Rasterizer.cs:566-640) + shade in-loop ----
        s = av[..., sl_screen[0]:sl_screen[1]]
        ia = av[..., 0, sl_ia]
        clip_w = av[..., chi - 1]
        pxf = px.astype(F32)
        pyf = py.astype(F32)
        s0x, s0y = s[..., 0, 0], s[..., 0, 1]
        s1x, s1y = s[..., 1, 0], s[..., 1, 1]
        s2x, s2y = s[..., 2, 0], s[..., 2, 1]
        w0 = ((s1y - s2y) * (pxf - s1x) + (s2x - s1x) * (pyf - s1y)) * ia
        w1 = ((s2y - s0y) * (pxf - s2x) + (s0x - s2x) * (pyf - s2y)) * ia
        w2 = ((s0y - s1y) * (pxf - s0x) + (s1x - s0x) * (pyf - s0y)) * ia
        rcp_wa = w0 / jnp.where(clip_w[..., 0] == 0, F32(1),
                                clip_w[..., 0])
        rcp_wb = w1 / jnp.where(clip_w[..., 1] == 0, F32(1),
                                clip_w[..., 1])
        rcp_wc = w2 / jnp.where(clip_w[..., 2] == 0, F32(1),
                                clip_w[..., 2])
        wsum = rcp_wa + rcp_wb + rcp_wc
        wgt = F32(1.0) / jnp.where(wsum == 0, F32(1), wsum)
        wa, wb, wc = rcp_wa * wgt, rcp_wb * wgt, rcp_wc * wgt
        a0, a1, a2 = av[..., 0, :], av[..., 1, :], av[..., 2, :]
        pc = (a0 * rcp_wa[..., None] + a1 * rcp_wb[..., None]
              + a2 * rcp_wc[..., None]) * wgt[..., None]
        pw = a0 * wa[..., None] + a1 * wb[..., None] + a2 * wc[..., None]

        flat = {}
        for k in keys:
            lo, hi = slices[k]
            if k.startswith("data."):
                val = pw[..., lo:hi]
                if hi - lo == 3:
                    lsq = jnp.sum(val * val, axis=-1, keepdims=True)
                    nrm = val / jnp.sqrt(jnp.where(lsq > 0, lsq, F32(1)))
                    val = jnp.where(lsq > F32(1e-6), nrm, val)
            else:
                val = pc[..., lo:hi]
            flat[k] = val
        frag = unflatten_varyings(flat)
        frag["barycentric"] = jnp.stack([wa, wb, wc], axis=-1)
        if extra_slices:
            frag["tri"] = {k: av[..., 0, i].astype(jnp.int32)
                           for k, i in extra_slices.items()}

        color = fragment_shader(frag, uniforms, jnp)
        written = covered & (color[..., 3] > 0)
        out_c = jnp.where(written[..., None],
                          _fused_blend(color, fb_c, params.blend_mode),
                          fb_c)
        if params.depth_test == DepthTest.DISABLED:
            out_d = fb_d
        else:
            out_d = jnp.where(written, best_d, fb_d)

        all_c = jax.lax.dynamic_update_slice_in_dim(all_c, out_c, base, 0)
        all_d = jax.lax.dynamic_update_slice_in_dim(all_d, out_d, base, 0)
        return all_c, all_d

    all_c, all_d = jax.lax.fori_loop(0, ngroups, group_body, (c0, d0))

    if tile_map is not None:
        def untile(a):
            return a[:ntiles].reshape((n_owned * tile_h, tile_w)
                                      + a.shape[2:])
    else:
        def untile(a):
            a = a[:ntiles].reshape((Hp // tile_h, ntx, tile_h, tile_w)
                                   + a.shape[2:])
            a = jnp.moveaxis(a, 1, 2).reshape((Hp, Wp) + a.shape[4:])
            return a[:a_h, :W]

    return untile(all_c), untile(all_d)


def make_binned_visibility(tile_h: int = 32, tile_w: int = 128,
                           span_cap: int = 16, tile_group: int = 8):
    """Factory producing a visibility_fn for raster.render_deferred."""
    def fn(tris, params, chunk=32, init_depth=None, row_offset=0,
           tile_row_map=None, full_height=None, tile_map=None):
        return visibility_binned(tris, params, chunk, init_depth, row_offset,
                                 tile_h=tile_h, tile_w=tile_w,
                                 span_cap=span_cap, tile_group=tile_group,
                                 tile_row_map=tile_row_map,
                                 full_height=full_height, tile_map=tile_map)
    return fn
