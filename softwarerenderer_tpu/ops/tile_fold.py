"""Tile visibility fold as a Pallas kernel on the Triton route (GPU).

The fold is the binned path's inner loop (ops/binning.py): every screen
tile reduces (depth, submission index) over the global triangle list and
its own bin segment, in the reference's LESS_EQUAL order ("new >= old",
the later triangle wins ties — Rasterizer.cs:462-546).  The XLA version
(binning.visibility_binned / render_binned_fused) walks tile groups in a
sequential fori_loop and materialises (group, chunk, pixels) broadcast
intermediates; here each tile is one program:

  * the tile's pixels live in registers as a (tile_h, tile_w) block, with
    its best depth and best index;
  * the program loads its own segment start, length and pixel origin from
    a per-tile table, then walks the global list and its segment one
    triangle at a time, reading the triangle's setup row (screen
    vertices, vertex depths, inverse area) through the cache — the next
    triangle's row is loaded while the current one is evaluated;
  * all tiles run at once, one program per tile across the SMs.

The kernel returns the winner maps only.  The winner's attributes are
gathered per pixel afterwards (raster.shade_deferred): on the GPU a
per-pixel gather reads the small triangle table through L1/L2, so the
one-hot matmul resolve of the XLA fused path is not needed.

With ``prev`` maps the same kernel peels: it keeps the best fragment
strictly worse-ranked than the previous pass's winner — the K-buffer's
depth peel (render_kbuffer_peel below).

LESS_EQUAL only; every other depth mode takes the XLA paths
(``fold_route``).  Tiles must be powers of two (Triton block shapes).
"""

from __future__ import annotations

import functools
from typing import Dict, Optional

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

from softwarerenderer_tpu.config import (
    BlendMode,
    DebugMode,
    DepthTest,
    RenderParams,
)
from softwarerenderer_tpu.ops.binning import _cdiv, bin_triangles
from softwarerenderer_tpu.ops.raster import (
    DEPTH_CLEAR,
    NO_TRI,
    _blend,
    interpolate_at_pixels,
    shade_deferred,
)

F32 = jnp.float32
N_SETUP = 10      # setup row: s0x s0y s1x s1y s2x s2y d0 d1 d2 inv_area


def _is_pow2(n: int) -> bool:
    return n > 0 and (n & (n - 1)) == 0


def fold_route(params: RenderParams, platform: Optional[str] = None) -> str:
    """The one place that chooses how a binned frame folds visibility.

    Returns "kernel" (the Triton tile kernel, compiled for the GPU),
    "interpret" (the same kernel in Pallas interpret mode — only when
    ``params.pallas_interpret`` asks for it) or "xla" (the XLA fused,
    K-slot and binned paths).  The kernel serves deferred, binned,
    LESS_EQUAL frames with power-of-two tiles and no debug view; on the
    CPU, and for every other configuration, the XLA paths run.
    """
    eligible = (params.use_pallas and params.deferred and params.binned
                and params.debug_mode == DebugMode.NONE
                and params.depth_test == DepthTest.LESS_EQUAL
                and _is_pow2(params.tile_h) and _is_pow2(params.tile_w))
    if not eligible:
        return "xla"
    if params.pallas_interpret:
        return "interpret"
    platform = platform or jax.default_backend()
    return "kernel" if platform == "gpu" else "xla"


def _num_warps(tpx: int) -> int:
    return int(min(8, max(1, tpx // 256)))


def _fold_kernel(info_ref, ng_ref, setup_ref, order_ref, seg_ref, d0_ref,
                 *rest, tile_h: int, tile_w: int, n_seg: int, n_tris: int,
                 peel: bool):
    if peel:
        pd_ref, pi_ref, od_ref, oi_ref = rest
    else:
        od_ref, oi_ref = rest
    ty = pl.program_id(0)
    tx = pl.program_id(1)
    t = ty * pl.num_programs(1) + tx
    start = info_ref[t, 0]
    count = info_ref[t, 1]
    px = (info_ref[t, 3]
          + jax.lax.broadcasted_iota(jnp.int32, (tile_h, tile_w), 1)
          ).astype(F32)
    py = (info_ref[t, 2]
          + jax.lax.broadcasted_iota(jnp.int32, (tile_h, tile_w), 0)
          ).astype(F32)
    bd = d0_ref[...]
    bi = jnp.full((tile_h, tile_w), -1, jnp.int32)
    if peel:
        peel_d = pd_ref[...]
        peel_i = pi_ref[...]

    def row(tri):
        return tuple(setup_ref[tri, f] for f in range(N_SETUP))

    def step(tri, f, bd, bi):
        s0x, s0y, s1x, s1y, s2x, s2y, d0, d1, d2, ia = f
        w0 = (s1y - s2y) * (px - s1x) + (s2x - s1x) * (py - s1y)
        w1 = (s2y - s0y) * (px - s2x) + (s0x - s2x) * (py - s2y)
        w2 = (s0y - s1y) * (px - s0x) + (s1x - s0x) * (py - s0y)
        inside = ((w0 >= 0) & (w1 >= 0) & (w2 >= 0)) | \
                 ((w0 <= 0) & (w1 <= 0) & (w2 <= 0))
        d = d0 * (w0 * ia) + d1 * (w1 * ia) + d2 * (w2 * ia)
        ok = inside
        if peel:
            # Admit only fragments strictly worse-ranked than the previous
            # pass's winner; `tri != peel_i` pins out that winner itself.
            ok = ok & (tri != peel_i) & (
                (d < peel_d) | ((d == peel_d) & (tri < peel_i)))
        # LESS_EQUAL: lexicographic (depth, index) max, later index wins
        # ties (Rasterizer.cs:546 "new >= old").
        take = ok & ((d > bd) | ((d == bd) & (tri > bi)))
        return jnp.where(take, d, bd), jnp.where(take, tri, bi)

    def walk(n, index_of, bd, bi):
        # Software-pipelined: iteration k evaluates triangle k while the
        # loads of triangle k+1 are in flight.
        def body(k, carry):
            bd, bi, tri, f = carry
            nxt = index_of(jnp.minimum(k + 1, n - 1))
            nf = row(nxt)
            bd, bi = step(tri, f, bd, bi)
            return bd, bi, nxt, nf

        tri0 = index_of(0)
        bd, bi, _, _ = jax.lax.fori_loop(0, n, body,
                                         (bd, bi, tri0, row(tri0)))
        return bd, bi

    n_global = ng_ref[0]
    if peel:
        # A tile whose previous winners admit nothing (no winner, or all
        # reset by the opaque short-circuit) can fold nothing: skip its
        # walks (PARITY.md, tile-granular peel eligibility).
        live = jnp.max(peel_i) >= 0
        n_global = jnp.where(live, n_global, 0)
        count = jnp.where(live, count, 0)
    bd, bi = walk(n_global,
                  lambda k: order_ref[jnp.minimum(k, n_tris - 1)], bd, bi)
    bd, bi = walk(count,
                  lambda k: seg_ref[jnp.minimum(start + k, n_seg - 1)],
                  bd, bi)
    od_ref[...] = bd
    oi_ref[...] = bi


def _setup_rows(tris: Dict):
    screen = tris["screen"]
    depth = tris["depth"]
    ia = jnp.where(tris["valid"], tris["inv_area"], 0.0)
    return jnp.stack([
        screen[:, 0, 0], screen[:, 0, 1], screen[:, 1, 0], screen[:, 1, 1],
        screen[:, 2, 0], screen[:, 2, 1],
        depth[:, 0], depth[:, 1], depth[:, 2], ia], axis=1).astype(F32)


def fold_visibility(tris: Dict, params: RenderParams, init_depth=None,
                    row_offset=0, *, tile_row_map=None, full_height=None,
                    prev=None, interpret: bool = False):
    """Per-pixel LESS_EQUAL (depth, triangle id) winners through the tile
    kernel — the contract of binning.visibility_binned.

    row_offset: this call's first GLOBAL pixel row (a framebuffer band).
    tile_row_map (traced (height // tile_h,) i32, with full_height): the
    call owns an arbitrary set of GLOBAL tile rows instead of a band (the
    balanced fb-sharding mode); output row block r // tile_h is global
    tile row tile_row_map[r // tile_h].
    prev: optional (depth, index) maps of a previous pass — the fold then
    peels (keeps the best fragment strictly worse-ranked than prev).

    Returns (depth (H, W) f32, tri (H, W) i32, NO_TRI where uncovered).
    """
    if params.depth_test != DepthTest.LESS_EQUAL:
        raise NotImplementedError("the tile kernel folds LESS_EQUAL only")
    tile_h, tile_w = params.tile_h, params.tile_w
    if not (_is_pow2(tile_h) and _is_pow2(tile_w)):
        raise ValueError(f"tile kernel needs power-of-two tiles, got "
                         f"{tile_h}x{tile_w}")
    H, W = params.height, params.width
    nty, ntx = _cdiv(H, tile_h), _cdiv(W, tile_w)
    Hp, Wp = nty * tile_h, ntx * tile_w

    if tile_row_map is not None:
        if H % tile_h:
            raise ValueError("height must be a tile_h multiple for "
                             "tile_row_map mode")
        bins = bin_triangles(tris, params.replace(height=full_height),
                             tile_h, tile_w, params.span_cap, 0)
        trm = jnp.asarray(tile_row_map, jnp.int32)
        gids = (trm[:, None] * ntx
                + jnp.arange(ntx, dtype=jnp.int32)[None, :]).reshape(-1)
        starts = jnp.take(bins["starts"], gids)
        counts = jnp.take(bins["counts"], gids)
        py0 = jnp.repeat(trm * tile_h, ntx)
    else:
        bins = bin_triangles(tris, params, tile_h, tile_w, params.span_cap,
                             row_offset)
        starts, counts = bins["starts"], bins["counts"]
        py0 = (jnp.arange(nty * ntx, dtype=jnp.int32) // ntx) * tile_h \
            + jnp.asarray(row_offset, jnp.int32)
    px0 = (jnp.arange(nty * ntx, dtype=jnp.int32) % ntx) * tile_w
    info = jnp.stack([starts, counts, py0, px0], axis=1).astype(jnp.int32)

    if init_depth is None:
        init_depth = jnp.full((H, W), DEPTH_CLEAR, F32)
    d0 = jnp.pad(init_depth, ((0, Hp - H), (0, Wp - W)),
                 constant_values=DEPTH_CLEAR)
    setup = _setup_rows(tris)
    # One trailing entry each keeps the kernel's clamped look-ahead load
    # in bounds when a list is empty.
    order = jnp.pad(bins["order"], (0, 1))
    seg = jnp.pad(bins["sorted_tri"], (0, 1))
    ng = jnp.reshape(bins["n_global"], (1,)).astype(jnp.int32)

    tile = pl.BlockSpec((tile_h, tile_w), lambda i, j: (i, j))
    inputs = [info, ng, setup, order, seg, d0]
    whole = pl.BlockSpec()          # read in place by scalar index
    in_specs = [whole, whole, whole, whole, whole, tile]
    peel = prev is not None
    if peel:
        pd, pi = prev
        inputs += [jnp.pad(pd, ((0, Hp - H), (0, Wp - W)),
                           constant_values=DEPTH_CLEAR),
                   jnp.pad(pi, ((0, Hp - H), (0, Wp - W)),
                           constant_values=NO_TRI)]
        in_specs += [tile, tile]
    kernel = functools.partial(
        _fold_kernel, tile_h=tile_h, tile_w=tile_w,
        n_seg=int(seg.shape[0]), n_tris=int(order.shape[0]), peel=peel)
    bd, bi = pl.pallas_call(
        kernel,
        grid=(nty, ntx),
        in_specs=in_specs,
        out_specs=[tile, tile],
        out_shape=[jax.ShapeDtypeStruct((Hp, Wp), F32),
                   jax.ShapeDtypeStruct((Hp, Wp), jnp.int32)],
        backend="triton",
        compiler_params=pl_triton.CompilerParams(
            num_warps=_num_warps(tile_h * tile_w), num_stages=1),
        interpret=interpret,
        name="tile_fold",
    )(*inputs)
    return bd[:H, :W], bi[:H, :W]


def _shade_at(tris, per_tri_extra, fragment_shader, uniforms, tri,
              row_offset, col_offset=0):
    """Interpolate each pixel's winner and run the fragment shader."""
    covered = tri != NO_TRI
    frag = interpolate_at_pixels(tris, tri, covered, row_offset, col_offset)
    if per_tri_extra:
        t = jnp.where(covered, tri, 0)
        frag["tri"] = {k: jnp.take(v, t, axis=0)
                       for k, v in per_tri_extra.items()}
    return fragment_shader(frag, uniforms, jnp)


def render_tile_kernel(tris: Dict, fragment_shader, uniforms: Dict,
                       params: RenderParams, fb_color, fb_depth,
                       per_tri_extra: Optional[Dict] = None, row_offset=0,
                       *, interpret: bool = False):
    """Opaque frame: kernel fold, then one gather-interpolate-shade pass.

    Same contract as binning.render_binned_fused (LESS_EQUAL).  With
    ``params.shade_rate`` = sr > 1 the shader runs on every sr-th row of
    the winner maps and the colour is replicated down each row block —
    an approximate mode with its own contract (config.RenderParams).
    """
    H = params.height
    best_d, best_i = fold_visibility(tris, params, fb_depth, row_offset,
                                     interpret=interpret)
    sr = int(params.shade_rate)
    if sr <= 1:
        return shade_deferred(tris, best_d, best_i, fragment_shader,
                              uniforms, params, fb_color, fb_depth,
                              per_tri_extra=per_tri_extra,
                              row_offset=row_offset)
    if H % sr:
        raise ValueError(f"shade_rate={sr} needs the frame height "
                         f"divisible by it, got {H}")
    rows = jnp.arange(H // sr, dtype=jnp.int32)
    off = (rows * (sr - 1))[:, None] + jnp.asarray(row_offset, jnp.int32)
    color = _shade_at(tris, per_tri_extra, fragment_shader, uniforms,
                      best_i[::sr], off)
    color = jnp.repeat(color, sr, 0)
    written = (best_i != NO_TRI) & (color[..., 3] > 0)
    out_c = jnp.where(written[..., None],
                      _blend(color, fb_color, params.blend_mode), fb_color)
    out_d = jnp.where(written, best_d, fb_depth)
    return out_c, out_d


def render_kbuffer_peel(tris: Dict, fragment_shader, uniforms: Dict,
                        params: RenderParams, fb_color, fb_depth,
                        per_tri_extra: Optional[Dict] = None, row_offset=0,
                        *, interpret: bool = False, with_stats: bool = False,
                        tile_row_map=None, full_height=None):
    """K-buffer by depth peeling: K kernel folds, each admitting only
    fragments strictly worse-ranked than the previous pass's winner, then
    the reference's sequential shade-blend replayed over the K layers in
    submission order (Rasterizer.cs:509-523 + Blend :57-65 — the
    exactness contract of ops/kbuffer.render_binned_kbuffer).

    Opaque short-circuit (``params.kbuffer_short_circuit``; proof and the
    one-blend-ulp bound in PARITY.md "Exactness-preserving
    optimizations"): a pixel whose winner is semantically opaque (the
    per-triangle ``opq`` flag, engine.renderer.opaque_tri_flags) and
    visibly shaded (alpha > 0) can never show a worse-ranked fragment, so
    its peel stops; a pass with no eligible pixel is skipped with
    lax.cond, and so is every pass after it.

    Compacted layer shading (``params.kbuffer_compact_rows``): layers
    k >= 1 are typically sparse, so the row segments holding a live
    winner are gathered, shaded as one compacted block and scattered
    back — bit-exact, because the shader runs per pixel.
    """
    if params.depth_test != DepthTest.LESS_EQUAL:
        raise NotImplementedError("the K-buffer peel supports LESS_EQUAL "
                                  "only")
    K = params.kbuffer
    H, W = params.height, params.width
    extra = dict(per_tri_extra or {})
    use_opq = (params.kbuffer_short_circuit and "opq" in extra
               and params.blend_mode == BlendMode.ALPHA)
    none_stop = (params.kbuffer_short_circuit
                 and params.blend_mode == BlendMode.NONE)
    stops = use_opq or none_stop
    if tile_row_map is not None:
        # Pixel-row origin of each output row (balanced fb sharding).
        trm = jnp.asarray(tile_row_map, jnp.int32)
        rows_px = (trm[:, None] * params.tile_h + jnp.arange(
            params.tile_h, dtype=jnp.int32)[None, :]).reshape(-1)
        row_off = (rows_px - jnp.arange(H, dtype=jnp.int32))[:, None]
    else:
        row_off = jnp.asarray(row_offset, jnp.int32)

    def fold(prev):
        return fold_visibility(tris, params, fb_depth, row_offset,
                               tile_row_map=tile_row_map,
                               full_height=full_height, prev=prev,
                               interpret=interpret)

    def shade_full(tri):
        col = _shade_at(tris, extra, fragment_shader, uniforms, tri,
                        row_off)
        return col, opq_of(col, tri)

    def opq_of(col, tri):
        if use_opq:
            t = jnp.where(tri != NO_TRI, tri, 0)
            return (jnp.take(extra["opq"], t) > 0) & (col[..., 3] > 0)
        if none_stop:
            return col[..., 3] > 0
        return jnp.zeros((), bool)

    seg = 128
    while seg > 8 and W % seg:
        seg //= 2
    frac = params.kbuffer_compact_rows
    compactable = frac > 0 and W % seg == 0
    if compactable:
        nseg = W // seg
        seg_cap = int(H * nseg * frac)
        seg_cap = min(H * nseg, max(8, -(-seg_cap // 8) * 8))
        compactable = seg_cap < H * nseg

    def shade_layer(tri):
        if not compactable:
            return shade_full(tri)
        live_seg = jnp.any((tri != NO_TRI).reshape(H * nseg, seg), axis=1)
        n_live = jnp.sum(live_seg.astype(jnp.int32))

        def compact(tri):
            idx = jnp.nonzero(live_seg, size=seg_cap, fill_value=0)[0]
            sub = jnp.take(tri.reshape(H * nseg, seg), idx, axis=0)
            r = jnp.arange(seg_cap, dtype=jnp.int32)
            y = idx // nseg
            ro = jnp.broadcast_to(row_off, (H, 1))[y, 0] \
                if tile_row_map is not None else row_off
            off_r = (y - r + ro)[:, None]
            off_c = ((idx % nseg) * seg)[:, None]
            colr = _shade_at(tris, extra, fragment_shader, uniforms, sub,
                             off_r, off_c)
            col = jnp.zeros((H * nseg, seg, 4), F32).at[idx].set(colr)
            opq = opq_of(colr, sub)
            if stops:
                opq = jnp.zeros((H * nseg, seg), bool).at[idx].set(opq) \
                    .reshape(H, W)
            return col.reshape(H, W, 4), opq

        return jax.lax.cond(n_live <= seg_cap, compact, shade_full, tri)

    colors, depths, indices = [], [], []
    bd, bi = fold(None)
    col, opq = shade_full(bi)
    colors.append(col)
    depths.append(bd)
    indices.append(bi)
    for _ in range(1, K):
        prev_d, prev_i = bd, bi
        if stops:
            prev_d = jnp.where(opq, DEPTH_CLEAR, prev_d)
            prev_i = jnp.where(opq, NO_TRI, prev_i)
        eligible = jnp.any(prev_i != NO_TRI)

        def live(pd, pi):
            d, i = fold((pd, pi))
            c, o = shade_layer(i)
            return c, d, i, o

        def dead(pd, pi):
            return (jnp.zeros((H, W, 4), F32),
                    jnp.full((H, W), DEPTH_CLEAR, F32),
                    jnp.full((H, W), NO_TRI, jnp.int32),
                    jnp.zeros((H, W) if stops else (), bool))

        col, bd, bi, opq = jax.lax.cond(eligible, live, dead, prev_d,
                                        prev_i)
        colors.append(col)
        depths.append(bd)
        indices.append(bi)
    return replay_layers(jnp.stack(colors), jnp.stack(depths),
                         jnp.stack(indices), fb_color, fb_depth, params,
                         with_stats)


def replay_layers(src, sd, si_i, fb_color, fb_depth, params: RenderParams,
                  with_stats: bool = False):
    """Submission-order replay of K shaded layers (Rasterizer.cs:509-523
    + Blend :57-65).

    src (K, H, W, 4) shaded colours; sd (K, H, W) depths; si_i (K, H, W)
    winner indices (NO_TRI = none).  The layers of one pixel hold distinct
    indices, so each round picks at most one layer.  with_stats adds the
    conservative K-overflow indicator: pixels whose K-th (deepest) layer
    holds a fragment."""
    K = src.shape[0]
    si = jnp.where(si_i != NO_TRI, si_i.astype(F32), F32(jnp.inf))

    def one_round(cur_c, cur_d, used):
        masked_i = jnp.where(used, F32(jnp.inf), si)
        sel_i = jnp.min(masked_i, axis=0)
        valid = jnp.isfinite(sel_i)
        is_pick = (masked_i == sel_i[None]) & valid[None]
        used = used | is_pick
        sel_d = jnp.sum(jnp.where(is_pick, sd, 0.0), axis=0)
        sel_c = jnp.sum(jnp.where(is_pick[..., None], src, 0.0), axis=0)
        # LESS_EQUAL: reference "new >= old" (Rasterizer.cs:545-546)
        written = valid & (sel_d >= cur_d) & (sel_c[..., 3] > 0)
        cur_c = jnp.where(written[..., None],
                          _blend(sel_c, cur_c, params.blend_mode), cur_c)
        cur_d = jnp.where(written, sel_d, cur_d)
        return cur_c, cur_d, used

    cur_c, cur_d, used = one_round(fb_color, fb_depth,
                                   jnp.zeros(si.shape, bool))
    if K > 1:
        # Rounds 2..K are no-ops when every deeper layer is empty (the
        # opaque short-circuit's common case): skip them with one cond.
        def rest(cur_c, cur_d, used):
            for _ in range(K - 1):
                cur_c, cur_d, used = one_round(cur_c, cur_d, used)
            return cur_c, cur_d

        cur_c, cur_d = jax.lax.cond(
            jnp.any(si_i[1:] != NO_TRI), rest,
            lambda c, d, u: (c, d), cur_c, cur_d, used)
    if with_stats:
        return cur_c, cur_d, {
            "kbuffer_saturated_px": jnp.sum(
                (si_i[K - 1] != NO_TRI).astype(jnp.int32))}
    return cur_c, cur_d
