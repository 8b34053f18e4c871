"""Multi-device rendering: framebuffer + triangle sharding over a mesh.

The reference scales by decomposing the screen into mutex-guarded tiles on
CPU threads (SURVEY.md §2.2 P2).  Here the same two axes are sharded over
a `jax.sharding.Mesh` with `shard_map` (SURVEY.md §7 step 8):

  * axis "fb" — framebuffer ROWS: each device rasterizes + shades its own
    horizontal band.  Embarrassingly parallel: triangles are replicated
    (small), pixels are not.
  * axis "tri" (optional) — TRIANGLES: geometry + visibility fold only the
    local triangle shard; shard winners combine with a LEXICOGRAPHIC
    (depth, global-submission-index) all-reduce (pmax/pmin pairs), the
    collective form of the same total preorder the single-device fold
    uses.  Each device then shades only the pixels its shard won and the
    color contributions combine with one psum (BASELINE config 5's
    1M+-triangle instancing).

Collectives used: pmax/pmin/psum on ("tri",) only — everything on the "fb"
axis is local, so collective traffic is O(pixels·tri_shards), independent
of triangle count.  The devices are taken from ``jax.devices()`` in order;
no interconnect topology is assumed.

Per-shard work runs the single-device architecture: where
``tile_fold.fold_route`` picks the tile kernel (contiguous bands and
balanced rows), each shard folds visibility with it and shades with
per-pixel gathers (raster.shade_deferred); otherwise the XLA binned
reducer folds and the fused one-hot path resolves the winner
(ops/binning.shade_binned_fused).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from softwarerenderer_tpu.parallel._compat import shard_map_unchecked

from softwarerenderer_tpu.config import DepthTest, RenderParams
from softwarerenderer_tpu.ops import culling, geometry, raster
from softwarerenderer_tpu.ops.raster import (
    DEPTH_CLEAR,
    NO_TRI,
    _REDUCE_RULES,
)
from softwarerenderer_tpu.ops.tile_fold import fold_route, fold_visibility

F32 = jnp.float32


def make_mesh(n_fb: int, n_tri: int = 1,
              devices=None) -> Mesh:
    """Build an (fb, tri) device mesh from the first n_fb*n_tri devices."""
    if devices is None:
        devices = jax.devices()
    need = n_fb * n_tri
    if len(devices) < need:
        raise ValueError(f"need {need} devices, have {len(devices)}")
    arr = np.asarray(devices[:need]).reshape(n_fb, n_tri)
    return Mesh(arr, axis_names=("fb", "tri"))


def shard_scene_triangles(scene: Dict, n_tri: int) -> Dict:
    """Pad triangle-major arrays to a multiple of n_tri so shard_map can
    split them evenly; padded slots point at vertex 0 of a culled mesh id
    (they are masked out by an explicit pad mask)."""
    t = scene["indices"].shape[0]
    t_pad = -(-t // n_tri) * n_tri
    out = dict(scene)
    if n_tri > 1:
        # tri_seg_starts indexes the FULL triangle array; a tri-sharded
        # slice (and its unsorted zero-padding) invalidates it, so the
        # mesh->tri broadcasts fall back to take inside shard_fn.
        out.pop("tri_seg_starts", None)
    pad = t_pad - t
    if pad:
        for k in ("indices", "tri_mesh_id", "tri_texture_id",
                  "tri_lod_level"):
            if k in scene:
                cfg = [(0, pad)] + [(0, 0)] * (scene[k].ndim - 1)
                out[k] = np.pad(np.asarray(scene[k]), cfg)
    out["tri_valid"] = np.arange(t_pad, dtype=np.int32) < t
    return out


def _lex_allreduce(depth, idx, covered, mode: DepthTest, n_total: int):
    """Combine per-shard (depth, global idx) winners over the 'tri' axis
    with the same total preorder the sequential fold uses."""
    use_max, later = _REDUCE_RULES[mode]
    if use_max is None:
        gidx = jnp.where(covered, idx, -1)
        istar = jax.lax.pmax(gidx, "tri")
        owner = covered & (gidx == istar)
        dstar = jax.lax.psum(jnp.where(owner, depth, 0.0), "tri")
        return istar >= 0, dstar, istar
    bad = F32(-jnp.inf) if use_max else F32(jnp.inf)
    dm = jnp.where(covered, depth, bad)
    dstar = (jax.lax.pmax if use_max else jax.lax.pmin)(dm, "tri")
    at = covered & (depth == dstar)
    if later:
        istar = jax.lax.pmax(jnp.where(at, idx, -1), "tri")
        covered_star = istar >= 0
    else:
        istar = jax.lax.pmin(jnp.where(at, idx, n_total), "tri")
        covered_star = istar < n_total
        istar = jnp.where(covered_star, istar, -1)
    return covered_star, dstar, istar


def render_frame_sharded(scene: Dict, uniforms: Dict, params: RenderParams,
                         mesh: Mesh,
                         vertex_shader: Optional[Callable] = None,
                         fragment_shader: Optional[Callable] = None,
                         balanced: bool = False):
    """Jit-compatible sharded frame: call under jax.jit with static params.

    scene must come through shard_scene_triangles(scene, mesh.shape["tri"])
    (a no-op-ish pad for n_tri == 1).  params.height must divide evenly by
    mesh.shape["fb"].  Returns (color (H, W, 4), depth (H, W)) laid out
    row-sharded over "fb".

    balanced=True / "rows" (binned only): instead of contiguous row bands,
    each fb device owns an equal-size set of TILE ROWS chosen by
    triangle-bbox occupancy (greedy LPT over the occupancy-sorted rows) —
    a camera that concentrates geometry in one band (the dust2 floor) no
    longer idles the other devices.  The occupancy ranking is a traced,
    replicated computation, so camera motion rebalances every frame with
    no recompile, and the final gather restores global row order.

    balanced="tiles" (binned only): ownership at individual-TILE
    granularity — a single hot tile row can split across devices (ROADMAP
    #9).  Per-tile occupancy is one (nty, T)×(T, ntx) matmul over the
    bbox row/column overlap masks; tiles assign by the same greedy LPT
    under an equal-tiles-per-device constraint; each device renders its
    tiles as an (tiles_per_dev·tile_h, tile_w) pseudo-image and the final
    gather scatters tiles back to frame positions.
    """
    from softwarerenderer_tpu.engine.renderer import (
        camera_matrices,
        scene_fragment_shader,
        scene_vertex_shader,
    )
    from softwarerenderer_tpu.utils import mathlib as ml

    vertex_shader = vertex_shader or scene_vertex_shader
    fragment_shader = fragment_shader or scene_fragment_shader

    if params.ssaa > 1:
        # Supersampled AA composes with sharding: render the f×-size frame
        # sharded, then box-filter the gathered full frame (exactness vs
        # the single-device SSAA path is preserved — the downsample runs
        # after the order-restoring gather).
        f = params.ssaa
        color, depth = render_frame_sharded(
            scene, uniforms,
            params.replace(width=params.width * f,
                           height=params.height * f, ssaa=1),
            mesh, vertex_shader, fragment_shader, balanced)
        H, W = params.height, params.width
        color = color.reshape(H, f, W, f, 4).mean(axis=(1, 3))
        return color, depth[::f, ::f]

    from softwarerenderer_tpu.engine.renderer import (
        _apply_post_fx,
        _enabled_post_fx,
    )
    fx_chain = _enabled_post_fx(params, uniforms)
    if fx_chain:
        # Post-FX compose with sharding exactly like the engine (same
        # params.post_fx data pipeline): render the base frame sharded,
        # then apply the chain to the full frame — under jit the
        # full-frame ops run on the row-sharded output with XLA
        # inserting any cross-band halo collectives.
        # Strip EVERY chain entry from the base render: the built-in
        # switches, fxaa, and user-callable stages (always-on — leaving
        # them in post_fx would recurse forever).
        base = params.replace(
            tonemap=None, bloom=False, ssao=False, fxaa=False,
            post_fx=tuple(f for f in params.post_fx if isinstance(f, str)))
        u2 = uniforms
        if "sky" in fx_chain:
            u2 = {k: v for k, v in uniforms.items() if k != "sky_panorama"}
            u2["env_panorama"] = uniforms["sky_panorama"]
        color, depth = render_frame_sharded(
            scene, u2, base, mesh, vertex_shader, fragment_shader,
            balanced)
        for fx in fx_chain:
            color, depth = _apply_post_fx(fx, color, depth, uniforms,
                                          params)
        return color, depth

    n_fb = mesh.shape["fb"]
    n_tri = mesh.shape["tri"]
    H, W = params.height, params.width
    if H % n_fb:
        raise ValueError(f"height {H} not divisible by fb axis {n_fb}")
    shard_h = H // n_fb
    shard_params = params.replace(height=shard_h)
    balanced_mode = {False: None, True: "rows"}.get(balanced, balanced)
    if balanced_mode not in (None, "rows", "tiles"):
        raise ValueError(f"balanced must be False/True/'rows'/'tiles', "
                         f"got {balanced!r}")
    if balanced_mode and not params.binned:
        raise ValueError("balanced fb sharding requires binned=True")
    route = fold_route(params)
    if params.kbuffer > 1 and (mesh.shape["tri"] != 1
                               or not params.binned
                               or balanced_mode == "tiles"
                               or (balanced_mode == "rows"
                                   and route == "xla")):
        raise NotImplementedError(
            "sharded K-buffer supports replicated triangles (n_tri == 1, "
            "binned) over contiguous fb bands (any route) or "
            "balanced='rows' through the tile kernel's tile-row map "
            "(use_pallas, LESS_EQUAL depth, power-of-two tiles)")
    if balanced_mode == "rows":
        n_tile_rows = -(-H // params.tile_h)
        if H % params.tile_h or n_tile_rows % n_fb:
            raise ValueError(
                f"balanced mode needs height ({H}) a multiple of "
                f"tile_h*n_fb ({params.tile_h}*{n_fb})")
        rows_per_dev = n_tile_rows // n_fb
    elif balanced_mode == "tiles":
        th_t, tw_t = params.tile_h, params.tile_w
        nty_full = -(-H // th_t)
        ntx_full = -(-W // tw_t)
        ntiles_full = nty_full * ntx_full
        tiles_per_dev = -(-ntiles_full // n_fb)
        n_pad_tiles = tiles_per_dev * n_fb
    t_pad = scene["indices"].shape[0]
    if t_pad % n_tri:
        raise ValueError("run scene through shard_scene_triangles first")
    t_local = t_pad // n_tri
    n_total = 2 * t_pad  # post-clip global submission slots

    tri_sharded = {"indices", "tri_mesh_id", "tri_texture_id", "tri_valid",
                   "tri_lod_level"}
    if n_tri > 1:
        # Defense in depth (shard_scene_triangles also pops): global
        # segment starts don't describe a tri-shard slice.
        scene = {k: v for k, v in scene.items() if k != "tri_seg_starts"}
    in_specs = ({k: (P("tri") if k in tri_sharded else P())
                 for k in scene}, P())
    out_specs = (P("fb"), P("fb"))

    def shard_fn(scene, uniforms):
        fb_idx = jax.lax.axis_index("fb")
        tri_idx = jax.lax.axis_index("tri")
        row_offset = fb_idx * shard_h
        tri_offset = tri_idx * (2 * t_local)

        view, proj = camera_matrices(uniforms, W, H)
        view_proj = ml.transform(view, proj, xp=jnp)
        visible = culling.spheres_in_frustum(
            scene["bounds_center"], scene["bounds_radius"],
            scene["mesh_matrices"], view_proj, xp=jnp)
        tri_mask = jnp.take(visible, scene["tri_mesh_id"]) \
            & scene["tri_valid"]
        if "tri_lod_level" in scene:
            from softwarerenderer_tpu.ops import lod
            tri_mask = tri_mask & lod.lod_tri_mask(scene, uniforms, H,
                                                   xp=jnp)

        indices = scene["indices"]
        tri_tex = jnp.asarray(scene["tri_texture_id"], jnp.int32)
        tri_mesh = jnp.asarray(scene["tri_mesh_id"], jnp.int32)
        if params.geom_cap:
            # Pre-geometry compaction per shard (the single-chip
            # engine's params.geom_cap, geometry.precompact_inputs).
            # The cap is PER SHARD SLICE here: fb shards see the whole
            # replicated triangle set (identical permutation on every
            # band); tri shards compact their own slice
            # order-preservingly, and compacted local ids stay inside
            # the shard's 2·t_local submission window (gcap ≤ t_local),
            # so the global (depth, index) fold stays order-isomorphic.
            # No stats surface on this path — size it with
            # ops/lod.suggested_geom_cap (÷ n_tri for tri shards),
            # which never overflows.
            pt = {"tex": tri_tex, "mesh": tri_mesh}
            tri_mask, indices, pt, _ = geometry.precompact_inputs(
                tri_mask, params.geom_cap, indices, pt)
            tri_tex, tri_mesh = pt["tex"], pt["mesh"]

        model_pv = culling.model_matrices_per_vertex(scene, xp=jnp)
        u = dict(uniforms)
        u.update(model=model_pv, view=view, projection=proj,
                 atlas_data=scene["atlas_data"],
                 atlas_offsets=scene["atlas_offsets"],
                 atlas_sizes=scene["atlas_sizes"],
                 base_color=scene["base_color"])

        vin = {k: scene[k] for k in ("position", "uv", "normal", "color")}
        # Per-frame vertex updates (tangents, flip-book, skinning,
        # particles) — replicated traced computations, identical on
        # every shard (engine.renderer.apply_vertex_updates).
        from softwarerenderer_tpu.engine.renderer import (
            apply_vertex_updates,
        )
        vin = apply_vertex_updates(vin, scene, uniforms, view)
        tris = geometry.build_triangles(
            vertex_shader, vin, indices, u,
            width=W, height=H, cull_mode=params.cull_mode,
            near_clip=u["near_clip"], tri_mask=tri_mask)

        # Per-triangle material plumbing (×2 for the clipper's fan slots),
        # pruned by the shader's tri_extras registry like the single-chip
        # engine.
        tid2 = jnp.repeat(tri_tex, 2)
        aoff = jnp.asarray(scene["atlas_offsets"], jnp.int32)
        asiz = jnp.asarray(scene["atlas_sizes"], jnp.int32)
        per_tri_in = {"tex_id": tid2,
                      "mesh_id": jnp.repeat(tri_mesh, 2),
                      "tex_oy": jnp.take(aoff[:, 0], tid2),
                      "tex_ox": jnp.take(aoff[:, 1], tid2),
                      "tex_h": jnp.take(asiz[:, 0], tid2),
                      "tex_w": jnp.take(asiz[:, 1], tid2)}
        tri_extras = getattr(fragment_shader, "tri_extras", None)
        if tri_extras is not None:
            per_tri_in = {k: v for k, v in per_tri_in.items()
                          if k in tri_extras}

        if params.kbuffer > 1 and params.kbuffer_short_circuit:
            # Opaque short-circuit flags for the per-band K-buffer peel
            # (engine.renderer.opaque_tri_flags) — replicated triangles,
            # so identical on every band; each band's lax.cond pass skip
            # diverges independently (no collectives inside the peel).
            from softwarerenderer_tpu.engine.renderer import (
                opaque_tri_flags,
            )
            opq = opaque_tri_flags(scene, vin, fragment_shader, params,
                                   indices=indices, tri_texture_id=tri_tex)
            if opq is not None:
                per_tri_in["opq"] = opq

        if params.active_cap:
            # Active-slot compaction per shard (the single-chip engine's
            # params.active_cap, ops/geometry.compact_triangles).  Safe
            # under BOTH axes: fb shards share one triangle set, so the
            # stable permutation is identical on every band; tri shards
            # compact their own slice order-preservingly, and the global
            # submission comparison (local id + tri_offset) stays
            # order-isomorphic because compacted ids never leave the
            # shard's 2·t_local-wide offset window.
            tris, per_tri_in, _ = geometry.compact_triangles(
                tris, params.active_cap, per_tri_in)

        def _rows_assignment():
            """Occupancy-balanced equal-count tile-row ownership for this
            fb shard: rank GLOBAL tile rows by triangle-bbox overlap
            (psum over the tri axis keeps every shard's ranking
            identical), then assign rows in descending load to the
            least-loaded device that still has capacity (greedy LPT
            under the equal-rows-per-device constraint — static shapes,
            recomputed every frame, no recompile on camera motion).
            Returns (my_rows (rows_per_dev,) global tile rows,
            row_map_px (shard_h,) global pixel rows,
            row_offset_arr (shard_h, 1) pixel-row delta map)."""
            th = params.tile_h
            n_rows = H // th
            bbox = tris["bbox"]
            ty0 = jnp.clip(bbox[:, 1], 0, H - 1) // th
            ty1 = jnp.clip(bbox[:, 3], 0, H - 1) // th
            rows = jnp.arange(n_rows, dtype=jnp.int32)
            overlap = (ty0[:, None] <= rows[None, :]) \
                & (ty1[:, None] >= rows[None, :]) \
                & tris["valid"][:, None]
            occ = jax.lax.psum(jnp.sum(overlap, axis=0), "tri")
            order_rows = jnp.argsort(-occ).astype(jnp.int32)
            occ_sorted = jnp.take(occ, order_rows).astype(F32)

            def assign_step(i, carry):
                loads, cnt, assign = carry
                avail = jnp.where(cnt < rows_per_dev, loads, jnp.inf)
                k = jnp.argmin(avail).astype(jnp.int32)
                return (loads.at[k].add(occ_sorted[i]),
                        cnt.at[k].add(1), assign.at[i].set(k))

            _, _, assign = jax.lax.fori_loop(
                0, n_rows, assign_step,
                (jnp.zeros(n_fb, F32), jnp.zeros(n_fb, jnp.int32),
                 jnp.zeros(n_rows, jnp.int32)))
            mine_pos = jnp.argsort(
                jnp.where(assign == fb_idx, 0, 1), stable=True
            )[:rows_per_dev]
            my_rows = jnp.sort(jnp.take(order_rows, mine_pos))
            row_map_px = (my_rows[:, None] * th
                          + jnp.arange(th, dtype=jnp.int32)[None, :]
                          ).reshape(-1)
            row_offset_arr = (row_map_px
                              - jnp.arange(shard_h,
                                           dtype=jnp.int32))[:, None]
            return my_rows, row_map_px, row_offset_arr

        clear = jnp.asarray(uniforms["clear_color"], dtype=F32)
        if balanced_mode == "tiles":
            pseudo_h = tiles_per_dev * th_t
            fb_color = jnp.broadcast_to(clear, (pseudo_h, tw_t, 4))
            fb_depth = jnp.full((pseudo_h, tw_t), DEPTH_CLEAR, dtype=F32)
        else:
            fb_color = jnp.broadcast_to(clear, (shard_h, W, 4))
            fb_depth = jnp.full((shard_h, W), DEPTH_CLEAR, dtype=F32)

        if params.kbuffer > 1:
            # Ordered translucency at scale: triangles are replicated
            # (n_tri == 1 enforced above), so each shard's K-layer fold +
            # submission-order replay is self-contained — the kernel
            # peel where the route allows, the XLA K-slot fold elsewhere.
            # Balanced rows ride the kernel's tile-row map (validated
            # above): each shard peels its OWNED global tile rows; the
            # outer gather restores row order.
            row_offset_k = fb_idx * shard_h
            if route != "xla":
                from softwarerenderer_tpu.ops.tile_fold import (
                    render_kbuffer_peel,
                )
                if balanced_mode == "rows":
                    my_rows, row_map_px, _ = _rows_assignment()
                    out_c, out_d = render_kbuffer_peel(
                        tris, fragment_shader, u, shard_params, fb_color,
                        fb_depth, per_tri_extra=per_tri_in,
                        tile_row_map=my_rows, full_height=H,
                        interpret=route == "interpret")
                    return out_c, out_d, row_map_px
                return render_kbuffer_peel(
                    tris, fragment_shader, u, shard_params, fb_color,
                    fb_depth, per_tri_extra=per_tri_in,
                    row_offset=row_offset_k,
                    interpret=route == "interpret")
            from softwarerenderer_tpu.ops.kbuffer import (
                render_binned_kbuffer,
            )
            return render_binned_kbuffer(
                tris, fragment_shader, u, shard_params, fb_color,
                fb_depth, per_tri_extra=per_tri_in,
                row_offset=row_offset_k)

        # Local visibility over this shard's triangles and rows: the tile
        # kernel where the route allows (contiguous bands and balanced
        # rows), else the XLA binned reducer.  The kernel route shades
        # with per-pixel gathers (raster.shade_deferred) like the
        # single-device kernel frame; the XLA route resolves the winner
        # payload with the fused one-hot path (shade_binned_fused).
        use_kernel = route != "xla" and balanced_mode in (None, "rows")
        if params.binned:
            from softwarerenderer_tpu.ops.binning import (
                make_binned_visibility,
            )
            vis = make_binned_visibility(
                tile_h=params.tile_h, tile_w=params.tile_w,
                span_cap=params.span_cap, tile_group=params.tile_group)
        else:
            vis = raster.visibility_brute_force
        col_offset_arr = 0
        if balanced_mode == "tiles":
            # Per-TILE occupancy via one matmul over the bbox overlap
            # masks: occ[y, x] = Σ_t row_t(y)·col_t(x); psum over "tri"
            # keeps the ranking identical on every shard.
            bbox = tris["bbox"]
            ty0 = jnp.clip(bbox[:, 1], 0, H - 1) // th_t
            ty1 = jnp.clip(bbox[:, 3], 0, H - 1) // th_t
            tx0 = jnp.clip(bbox[:, 0], 0, W - 1) // tw_t
            tx1 = jnp.clip(bbox[:, 2], 0, W - 1) // tw_t
            rows = jnp.arange(nty_full, dtype=jnp.int32)
            cols = jnp.arange(ntx_full, dtype=jnp.int32)
            rowm = ((ty0[:, None] <= rows[None, :])
                    & (ty1[:, None] >= rows[None, :])
                    & tris["valid"][:, None]).astype(F32)
            colm = ((tx0[:, None] <= cols[None, :])
                    & (tx1[:, None] >= cols[None, :])).astype(F32)
            occ = jax.lax.psum(
                jax.lax.dot_general(rowm, colm, (((0,), (0,)), ((), ())),
                                    precision=jax.lax.Precision.HIGHEST,
                                    preferred_element_type=jnp.float32),
                "tri").reshape(-1)                     # (ntiles_full,)
            # Descending-occupancy greedy LPT under the equal-tiles
            # constraint; dummy padding tiles (occ −1 → sorted last, load
            # clamped to 0) fill the remainder.
            occp = jnp.pad(occ, (0, n_pad_tiles - ntiles_full),
                           constant_values=-1.0)
            order_tiles = jnp.argsort(-occp).astype(jnp.int32)
            occ_sorted = jnp.maximum(jnp.take(occp, order_tiles), 0.0)

            def assign_step(i, carry):
                loads, cnt, assign = carry
                avail = jnp.where(cnt < tiles_per_dev, loads, jnp.inf)
                k = jnp.argmin(avail).astype(jnp.int32)
                return (loads.at[k].add(occ_sorted[i]),
                        cnt.at[k].add(1), assign.at[i].set(k))

            _, _, assign = jax.lax.fori_loop(
                0, n_pad_tiles, assign_step,
                (jnp.zeros(n_fb, F32), jnp.zeros(n_fb, jnp.int32),
                 jnp.zeros(n_pad_tiles, jnp.int32)))
            mine_pos = jnp.argsort(
                jnp.where(assign == fb_idx, 0, 1), stable=True
            )[:tiles_per_dev]
            my_tiles = jnp.sort(jnp.take(order_tiles, mine_pos))
            tmc = jnp.clip(my_tiles, 0, ntiles_full - 1)
            r = jnp.arange(pseudo_h, dtype=jnp.int32)
            ty_base = jnp.take((tmc // ntx_full) * th_t, r // th_t)
            tx_base = jnp.take((tmc % ntx_full) * tw_t, r // th_t)
            # shade's py = local_row + row_offset, px = local_col +
            # col_offset; map pseudo rows to global pixel coords.
            row_offset_arr = (ty_base + r % th_t - r)[:, None]
            col_offset_arr = tx_base[:, None]
            depth_l, tri_l = vis(tris, params, params.chunk,
                                 init_depth=fb_depth, tile_map=my_tiles)
        elif balanced_mode == "rows":
            my_rows, row_map_px, row_offset_arr = _rows_assignment()
            if use_kernel:
                depth_l, tri_l = fold_visibility(
                    tris, shard_params, fb_depth, tile_row_map=my_rows,
                    full_height=H, interpret=route == "interpret")
            else:
                depth_l, tri_l = vis(tris, shard_params, params.chunk,
                                     init_depth=fb_depth,
                                     tile_row_map=my_rows, full_height=H)
        else:
            row_map_px = row_offset + jnp.arange(shard_h, dtype=jnp.int32)
            row_offset_arr = row_offset
            if use_kernel:
                depth_l, tri_l = fold_visibility(
                    tris, shard_params, fb_depth, row_offset,
                    interpret=route == "interpret")
            else:
                depth_l, tri_l = vis(tris, shard_params, params.chunk,
                                     init_depth=fb_depth,
                                     row_offset=row_offset)

        covered_l = tri_l != NO_TRI
        if n_tri == 1:
            # Triangles are replicated: the local winner IS the global
            # winner — skip the allreduce and the psum compositing below
            # (statically: the axis size is part of the mesh shape).
            # This is what makes a Mesh((1,1)) sharded frame run within
            # a few percent of the unsharded kernel frame.
            mine = covered_l
            dstar = depth_l
            local_best = tri_l
        else:
            gidx = jnp.where(covered_l, tri_l + tri_offset, NO_TRI)
            covered, dstar, istar = _lex_allreduce(
                depth_l, gidx, covered_l, params.depth_test, n_total)

            # Shade only the pixels THIS shard's winner owns; combine by
            # psum.
            mine = covered & (istar >= tri_offset) \
                & (istar < tri_offset + 2 * t_local)
            local_best = jnp.where(mine, istar - tri_offset, NO_TRI)
        if use_kernel or not params.binned:
            color_s, depth_s = raster.shade_deferred(
                tris, dstar, local_best, fragment_shader, u, shard_params,
                fb_color, fb_depth, per_tri_extra=per_tri_in,
                row_offset=row_offset_arr, col_offset=col_offset_arr)
        else:
            # Fused one-hot resolve of the (all-reduced) winner — the
            # single-chip fast resolve, never per-pixel row-gathers.
            from softwarerenderer_tpu.ops.binning import shade_binned_fused
            if balanced_mode == "tiles":
                sp, kw = params, dict(tile_map=my_tiles)
            elif balanced_mode == "rows":
                sp, kw = shard_params, dict(tile_row_map=my_rows,
                                            full_height=H)
            else:
                sp, kw = shard_params, dict(row_offset=row_offset)
            color_s, depth_s = shade_binned_fused(
                tris, dstar, local_best, fragment_shader, u, sp,
                fb_color, fb_depth, per_tri_extra=per_tri_in, **kw)
        if n_tri == 1:
            out_c, out_d = color_s, depth_s
        else:
            # The shading path composited the owner's fragments onto the
            # clear background; exactly one shard owns each covered
            # pixel, so masked contributions sum exclusively across the
            # 'tri' axis.  (A shader discard leaves color_s == background
            # there, which still resolves to the background after the
            # psum — consistent with the deferred path's documented
            # discard semantics.)
            written = mine
            contrib_c = jnp.where(written[..., None], color_s, 0.0)
            contrib_d = jnp.where(written, depth_s, 0.0)
            any_written = jax.lax.psum(written.astype(jnp.int32),
                                       "tri") > 0
            sum_c = jax.lax.psum(contrib_c, "tri")
            sum_d = jax.lax.psum(contrib_d, "tri")
            out_c = jnp.where(any_written[..., None], sum_c, fb_color)
            out_d = jnp.where(any_written, sum_d, fb_depth)
        if balanced_mode == "tiles":
            return out_c, out_d, my_tiles
        if balanced_mode == "rows":
            return out_c, out_d, row_map_px
        return out_c, out_d

    if balanced_mode == "tiles":
        fn = shard_map_unchecked(shard_fn, mesh=mesh, in_specs=in_specs,
                                 out_specs=(P("fb"), P("fb"), P("fb")))
        c, d, tmap = fn(scene, uniforms)
        # Scatter tiles back to frame positions: sort the concatenated
        # per-device tile lists by global tile id (dummies sort last) and
        # keep the first ntiles_full.
        th, tw = th_t, tw_t
        ct = c.reshape(-1, th, tw, 4)
        dt = d.reshape(-1, th, tw)
        perm = jnp.argsort(tmap)[:ntiles_full]
        ct = jnp.take(ct, perm, axis=0).reshape(nty_full, ntx_full, th,
                                                tw, 4)
        dt = jnp.take(dt, perm, axis=0).reshape(nty_full, ntx_full, th, tw)
        c_full = ct.transpose(0, 2, 1, 3, 4).reshape(
            nty_full * th, ntx_full * tw, 4)[:H, :W]
        d_full = dt.transpose(0, 2, 1, 3).reshape(
            nty_full * th, ntx_full * tw)[:H, :W]
        return c_full, d_full
    if balanced_mode == "rows":
        fn = shard_map_unchecked(shard_fn, mesh=mesh, in_specs=in_specs,
                                 out_specs=(P("fb"), P("fb"), P("fb")))
        c, d, perm = fn(scene, uniforms)
        inv = jnp.argsort(perm)          # restore global row order
        return jnp.take(c, inv, axis=0), jnp.take(d, inv, axis=0)
    fn = shard_map_unchecked(shard_fn, mesh=mesh, in_specs=in_specs,
                             out_specs=out_specs)
    return fn(scene, uniforms)
