"""K-buffer rendering: order-correct translucency + discard-reveal, binned.

The deferred/fused paths shade only the per-pixel visibility winner — exact
for opaque scenes, wrong when a discarded fragment should reveal the next
triangle (/root/reference/Rasterizer.cs:509-523: a null/alpha≤0 fragment
skips BOTH the color and depth write, so later geometry behind it still
draws) or when translucent layers must blend in submission order
(Rasterizer.cs:57-65).  The exact fallback, ops/forward.render_forward, is
an O(T·H·W) sequential scan.

This path closes the gap at binned cost: per pixel it keeps the K best
(depth, submission-index) fragments (lexicographic by the depth mode's
order), shades each layer, then REPLAYS the reference's sequential
algorithm over the K fragments in submission order — depth test against
the running buffer, shade, discard on alpha≤0, blend, write.  The replay
is bit-exact with render_forward whenever every fragment that contributes
to the pixel is among its K best:

  * discard-reveal — exact while < K discarded layers stack in front of
    the visible surface;
  * translucency — exact while the nearest opaque fragment and everything
    in front of it fit in K (an ALPHA-blend opaque write erases deeper
    contributions, so farther fragments cannot matter);
  * ADDITIVE/MULTIPLY stacks deeper than K lose the layers beyond K.

Enable with RenderParams(kbuffer=K); K=4 covers the reference's content.

Cost: this XLA K-slot fold is the PORTABLE path (other depth modes, CPU
runs) and is expensive — each layer re-streams the bins for its one-hot
resolve and runs the full interpolate+shade.  Where tile_fold.fold_route
picks the tile kernel (LESS_EQUAL on a GPU), the engine instead routes
K-buffer frames through ops.tile_fold.render_kbuffer_peel — depth
peeling over the single-winner kernel with the opaque short-circuit
(peel passes whose prev maps show no eligible pixel lax.cond-skip
wholesale), so K-buffer mode charges for the translucency actually on
screen, not for K itself.
"""

from __future__ import annotations

from typing import Dict, Optional

import jax
import jax.numpy as jnp

from softwarerenderer_tpu.config import DepthTest, RenderParams
from softwarerenderer_tpu.ops.binning import _cdiv, bin_triangles
from softwarerenderer_tpu.ops.forward import _depth_passes
from softwarerenderer_tpu.ops.geometry import unflatten_varyings
from softwarerenderer_tpu.ops.raster import (
    DEPTH_CLEAR,
    NO_TRI,
    _REDUCE_RULES,
    _blend,
)

F32 = jnp.float32


def render_binned_kbuffer(tris: Dict, fragment_shader, uniforms: Dict,
                          params: RenderParams, fb_color, fb_depth,
                          per_tri_extra: Optional[Dict] = None,
                          row_offset=0, with_stats: bool = False):
    """Same contract as binning.render_binned_fused with K-layer replay.

    with_stats=True additionally returns {"kbuffer_saturated_px": n} —
    the number of pixels whose LAST (K-th) slot holds a fragment, i.e. a
    conservative upper bound on pixels where the exactness contract may
    have degraded (a pixel with exactly K contributing fragments is
    counted but still exact; one with more dropped the overflow)."""
    mode = params.depth_test
    if mode not in _REDUCE_RULES:
        raise NotImplementedError(
            f"depth test {mode!r} is order-dependent; use render_forward")
    use_max, later_wins = _REDUCE_RULES[mode]
    if use_max is None:
        # ALWAYS/DISABLED: "best" is just the latest; the replay still
        # orders by submission, so rank slots by index alone.
        use_max = True
    K = params.kbuffer
    assert K >= 1
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

    # Packed resolve payload — identical layout to render_binned_fused.
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
            v = jnp.asarray(per_tri_extra[k], F32)[:, None, None]
            parts.append(jnp.broadcast_to(v, (n, 3, 1)))
            extra_slices[k] = off
            off += 1
    kp = off
    payload = jnp.concatenate(parts, axis=-1).reshape(n, 3 * kp)
    payload = jnp.where(tris["valid"][:, None], payload, 0.0)
    payload = jnp.concatenate([payload, jnp.zeros((1, 3 * kp), F32)], axis=0)
    clo, chi = slices["clip_position"]

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

    def lex_better(d_a, i_a, d_b, i_b):
        """Is fragment a strictly higher visibility-rank than b?
        (the fold order: depth by mode direction, index as tiebreak)."""
        strict = (d_a > d_b) if use_max else (d_a < d_b)
        tie = (d_a == d_b) & ((i_a > i_b) if later_wins else (i_a < i_b))
        return strict | tie

    def insert_candidates(slots_d, slots_i, d, mask, idx):
        """Merge a chunk's candidates into the per-pixel sorted K-slot
        lists (slot 0 = highest rank).  d (G, C, tpx), mask same, idx
        (G, C).

        Two stages, both chunk-parallel: (1) the chunk's own top-K by
        K masked-max/min passes; (2) the K sorted chunk winners bubble
        into the K sorted slots.  (Frame time is set by the per-slot
        resolve+shade replay, not this fold — see the module docstring.)
        """
        bad = F32(-jnp.inf) if use_max else F32(jnp.inf)
        idxb = jnp.broadcast_to(idx[..., None].astype(F32), d.shape)
        dm = jnp.where(mask, d, bad)
        pick = jnp.max if use_max else jnp.min

        for _ in range(K):
            cd = pick(dm, axis=1)                          # (G, tpx)
            # `dm == bad` entries are exhausted picks, not fragments — a
            # chunk with fewer than K fragments must not re-pick them
            # (the phantom (±inf, idx) duplicates would occupy lower
            # slots: saturation over-counts, and under ALWAYS-mode depth
            # tests a duplicate could double-blend its fragment).
            at = mask & (dm == cd[:, None, :]) & (dm != bad)
            if later_wins:
                ci = jnp.max(jnp.where(at, idxb, F32(NO_TRI)), axis=1)
                has = ci != F32(NO_TRI)
            else:
                big = F32(n)
                ci = jnp.min(jnp.where(at, idxb, big), axis=1)
                has = ci < big
                ci = jnp.where(has, ci, F32(NO_TRI))
            # remove exactly the picked candidate and repeat
            dm = jnp.where(at & (idxb == ci[:, None, :]), bad, dm)

            # bubble this (rank-ordered) winner through the K slots
            cd = jnp.where(has, cd, bad)
            for k in range(K):
                occupied = slots_i[k] != F32(NO_TRI)
                cand_valid = ci != F32(NO_TRI)
                goes_here = cand_valid & (
                    ~occupied | lex_better(cd, ci, slots_d[k], slots_i[k]))
                new_d = jnp.where(goes_here, cd, slots_d[k])
                new_i = jnp.where(goes_here, ci, slots_i[k])
                cd = jnp.where(goes_here, slots_d[k], cd)
                ci = jnp.where(goes_here, slots_i[k], ci)
                slots_d = slots_d.at[k].set(new_d)
                slots_i = slots_i.at[k].set(new_i)
        return slots_d, slots_i

    def group_body(g, carry):
        all_c, all_d, all_s = carry
        base = g * tile_group
        tiles = jax.lax.dynamic_slice_in_dim(tile_ids_all, base, tile_group)
        g_starts = jax.lax.dynamic_slice_in_dim(starts, base, tile_group)
        g_counts = jax.lax.dynamic_slice_in_dim(counts, base, tile_group)
        ty = tiles // ntx
        tx = tiles % ntx
        px = tx[:, None] * tile_w + px_in_tile[None, :]
        py = ty[:, None] * tile_h + py_in_tile[None, :] \
            + jnp.asarray(row_offset, jnp.int32)

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

        # ---- pass A: K-slot visibility fold ----
        bad_d = F32(-jnp.inf) if use_max else F32(jnp.inf)
        slots_d = jnp.full((K, tile_group, tpx), bad_d, F32)
        slots_i = jnp.full((K, tile_group, tpx), F32(NO_TRI), F32)

        def fold(ids_fn):
            def body(c, sl):
                sd, si = sl
                ids, ok = ids_fn(c)
                d, m, t = eval_chunk(ids, ok, px, py)
                return insert_candidates(sd, si, d, m, t)
            return body
        slots_d, slots_i = jax.lax.fori_loop(
            0, n_glob_chunks, fold(glob_ids), (slots_d, slots_i))
        max_count = jnp.max(g_counts)
        slots_d, slots_i = jax.lax.fori_loop(
            0, _cdiv(max_count, chunk), fold(seg_ids), (slots_d, slots_i))

        # ---- pass B: resolve each slot's payload via one-hot matmul ----
        def resolve(ids_fn, want_i):
            def body(c, acc):
                ids, ok = ids_fn(c)
                t = jnp.where(ok, jnp.clip(ids, 0, n - 1), n)
                pl = jnp.take(payload, t, axis=0)
                onehot = ((want_i[..., None]
                           == t[:, None, :].astype(F32)) & ok[:, None, :]
                          ).astype(F32)
                return acc + jax.lax.dot_general(
                    onehot, pl, (((2,), (1,)), ((0,), (0,))),
                    precision=jax.lax.Precision.HIGHEST,
                    preferred_element_type=jnp.float32)
            return body

        fb_c = jax.lax.dynamic_slice_in_dim(all_c, base, tile_group)
        fb_d = jax.lax.dynamic_slice_in_dim(all_d, base, tile_group)

        # ---- pass C: replay the reference's sequential algorithm over the
        # K fragments in SUBMISSION order (selection over slot indices) ----
        cur_c, cur_d = fb_c, fb_d
        used = jnp.zeros((K, tile_group, tpx), bool)
        pxf = px.astype(F32)
        pyf = py.astype(F32)
        depth_writes = params.depth_test != DepthTest.DISABLED
        for step in range(K):
            # next fragment = unused slot with the SMALLEST index
            masked_i = jnp.where(
                (slots_i != F32(NO_TRI)) & ~used, slots_i, F32(jnp.inf))
            pick = jnp.argmin(masked_i, axis=0)          # (G, tpx)
            sel_i = jnp.take_along_axis(slots_i, pick[None], axis=0)[0]
            sel_d = jnp.take_along_axis(slots_d, pick[None], axis=0)[0]
            valid = sel_i != F32(NO_TRI)
            valid &= ~jnp.take_along_axis(used, pick[None], axis=0)[0]
            used = used | (jax.lax.broadcasted_iota(
                jnp.int32, used.shape, 0) == pick[None])

            acc0 = jnp.zeros((tile_group, tpx, 3 * kp), F32)
            acc = jax.lax.fori_loop(0, n_glob_chunks,
                                    resolve(glob_ids, sel_i), acc0)
            acc = jax.lax.fori_loop(0, _cdiv(max_count, chunk),
                                    resolve(seg_ids, sel_i), acc)
            av = acc.reshape(tile_group, tpx, 3, kp)

            # interpolate (identical math to render_binned_fused)
            s = av[..., sl_screen[0]:sl_screen[1]]
            ia = av[..., 0, sl_ia]
            clip_w = av[..., chi - 1]
            s0x, s0y = s[..., 0, 0], s[..., 0, 1]
            s1x, s1y = s[..., 1, 0], s[..., 1, 1]
            s2x, s2y = s[..., 2, 0], s[..., 2, 1]
            w0 = ((s1y - s2y) * (pxf - s1x) + (s2x - s1x) * (pyf - s1y)) * ia
            w1 = ((s2y - s0y) * (pxf - s2x) + (s0x - s2x) * (pyf - s2y)) * ia
            w2 = ((s0y - s1y) * (pxf - s0x) + (s1x - s0x) * (pyf - s0y)) * ia
            rcp_a = w0 / jnp.where(clip_w[..., 0] == 0, F32(1),
                                   clip_w[..., 0])
            rcp_b = w1 / jnp.where(clip_w[..., 1] == 0, F32(1),
                                   clip_w[..., 1])
            rcp_c = w2 / jnp.where(clip_w[..., 2] == 0, F32(1),
                                   clip_w[..., 2])
            wsum = rcp_a + rcp_b + rcp_c
            wgt = F32(1.0) / jnp.where(wsum == 0, F32(1), wsum)
            wa, wb, wc = rcp_a * wgt, rcp_b * wgt, rcp_c * wgt
            a0, a1, a2 = av[..., 0, :], av[..., 1, :], av[..., 2, :]
            pc = (a0 * rcp_a[..., None] + a1 * rcp_b[..., None]
                  + a2 * rcp_c[..., None]) * wgt[..., None]
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

            src = fragment_shader(frag, uniforms, jnp)
            passes = valid & _depth_passes(params.depth_test, sel_d, cur_d)
            written = passes & (src[..., 3] > 0)
            cur_c = jnp.where(written[..., None],
                              _blend(src, cur_c, params.blend_mode), cur_c)
            if depth_writes:
                cur_d = jnp.where(written, sel_d, cur_d)

        all_c = jax.lax.dynamic_update_slice_in_dim(all_c, cur_c, base, 0)
        all_d = jax.lax.dynamic_update_slice_in_dim(all_d, cur_d, base, 0)
        all_s = jax.lax.dynamic_update_slice_in_dim(
            all_s, (slots_i[K - 1] != F32(NO_TRI)).astype(jnp.int32),
            base, 0)
        return all_c, all_d, all_s

    s0_ = jnp.zeros((ntiles_pad, tpx), jnp.int32)
    all_c, all_d, all_s = jax.lax.fori_loop(0, ngroups, group_body,
                                            (c0, d0, s0_))

    def untile(a):
        a = a[:ntiles].reshape((nty, ntx, tile_h, tile_w) + a.shape[2:])
        a = jnp.moveaxis(a, 1, 2).reshape((Hp, Wp) + a.shape[4:])
        return a[:H, :W]

    if with_stats:
        return untile(all_c), untile(all_d), {
            "kbuffer_saturated_px": jnp.sum(untile(all_s))}
    return untile(all_c), untile(all_d)
