"""Ring-pass rendering: triangle shards rotate, the framebuffer stays.

The ring-attention-shaped dataflow from SURVEY.md §5: each device owns a
horizontal framebuffer band AND 1/n of the triangles; the triangle shards
cycle around the ring with `lax.ppermute` while every device folds each
arriving shard into its own band.  After n steps each band has seen every
triangle, with per-device triangle MEMORY O(T/n) — the scaling mode for
the 1M+-triangle instancing config when replicating geometry per chip
(parallel/sharding.py) would not fit.

Two ring passes:
  1. visibility — fold (depth, GLOBAL submission index) per pixel; the
     global index rides with each shard so the lexicographic tie rules
     stay exact across rotation order
  2. resolve — rotate the packed payloads again, accumulating the winner's
     attributes via the same one-hot matmuls as the fused single-chip path

then interpolation + fragment shading run band-locally.

Collective traffic: 2·(n−1) permutes of the triangle SoA per frame —
independent
of resolution; the broadcast design in parallel/sharding.py is the right
choice when triangles fit per-chip, this one when they don't.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from softwarerenderer_tpu.parallel._compat import shard_map_unchecked

from softwarerenderer_tpu.config import DepthTest, RenderParams
from softwarerenderer_tpu.ops import culling, geometry
from softwarerenderer_tpu.ops.geometry import unflatten_varyings
from softwarerenderer_tpu.ops.raster import (
    DEPTH_CLEAR,
    NO_TRI,
    _REDUCE_RULES,
    _blend,
)

F32 = jnp.float32
AXIS = "shard"


def make_ring_mesh(n: int, devices=None) -> Mesh:
    if devices is None:
        devices = jax.devices()
    return Mesh(np.asarray(devices[:n]), axis_names=(AXIS,))


def _fold_shard(tris_soa, best, px, py, mode, tri_offset):
    """Fold one arriving triangle shard into this band's (depth, idx)."""
    use_max, later_wins = _REDUCE_RULES[mode]
    s, dv, ia, valid = (tris_soa["screen"], tris_soa["depth"],
                        tris_soa["inv_area"], tris_soa["valid"])
    best_d, best_i = best
    s0 = s[:, 0][:, None, None]
    s1 = s[:, 1][:, None, None]
    s2 = s[:, 2][:, None, None]
    w0 = ((s1[..., 1] - s2[..., 1]) * (px - s1[..., 0])
          + (s2[..., 0] - s1[..., 0]) * (py - s1[..., 1]))
    w1 = ((s2[..., 1] - s0[..., 1]) * (px - s2[..., 0])
          + (s0[..., 0] - s2[..., 0]) * (py - s2[..., 1]))
    w2 = ((s0[..., 1] - s1[..., 1]) * (px - s0[..., 0])
          + (s1[..., 0] - s0[..., 0]) * (py - s0[..., 1]))
    inside = ((w0 >= 0) & (w1 >= 0) & (w2 >= 0)) | \
             ((w0 <= 0) & (w1 <= 0) & (w2 <= 0))
    iab = ia[:, None, None]
    d = (dv[:, 0, None, None] * (w0 * iab)
         + dv[:, 1, None, None] * (w1 * iab)
         + dv[:, 2, None, None] * (w2 * iab))
    mask = inside & valid[:, None, None]
    idx = tri_offset + jax.lax.broadcasted_iota(
        jnp.int32, (s.shape[0], 1, 1), 0)

    if use_max is None:
        key = jnp.where(mask, idx, -1)
        pick = jnp.argmax(key, axis=0)
        cand_valid = jnp.any(mask, axis=0)
        cand_d = jnp.take_along_axis(d, pick[None], axis=0)[0]
        cand_i = jnp.take_along_axis(jnp.broadcast_to(idx, d.shape),
                                     pick[None], axis=0)[0]
        take = cand_valid & (cand_i > best_i)
    else:
        bad = F32(-jnp.inf) if use_max else F32(jnp.inf)
        dm = jnp.where(mask, d, bad)
        cand_d = (jnp.max if use_max else jnp.min)(dm, axis=0)
        at = mask & (d == cand_d)
        idxb = jnp.broadcast_to(idx, d.shape)
        sel = jnp.where(at, idxb, -1 if later_wins else 1 << 30)
        cand_i = jnp.max(sel, axis=0) if later_wins else jnp.min(sel, axis=0)
        cand_valid = jnp.any(at, axis=0)
        strict = (cand_d > best_d) if use_max else (cand_d < best_d)
        tie = (cand_d == best_d) & ((cand_i > best_i) if later_wins
                                    else (cand_i < best_i))
        take = cand_valid & (strict | tie)
    return (jnp.where(take, cand_d, best_d),
            jnp.where(take, cand_i.astype(jnp.int32), best_i))


def render_frame_ring(scene: Dict, uniforms: Dict, params: RenderParams,
                      mesh: Mesh,
                      vertex_shader: Optional[Callable] = None,
                      fragment_shader: Optional[Callable] = None):
    """Full ring-pass frame; scene must be pre-padded with
    parallel.shard_scene_triangles(scene, n).  Returns row-sharded
    (color, depth)."""
    from softwarerenderer_tpu.engine.renderer import (
        camera_matrices,
        scene_fragment_shader,
        scene_vertex_shader,
    )
    from softwarerenderer_tpu.utils import mathlib as ml

    vertex_shader = vertex_shader or scene_vertex_shader
    fragment_shader = fragment_shader or scene_fragment_shader
    if params.depth_test not in _REDUCE_RULES:
        raise NotImplementedError("order-dependent depth tests need the "
                                  "forward path")
    if params.ssaa > 1:
        # SSAA composes with the ring pass (see sharding.py): render f×,
        # box-filter after the gather.
        f = params.ssaa
        color, depth = render_frame_ring(
            scene, uniforms,
            params.replace(width=params.width * f,
                           height=params.height * f, ssaa=1),
            mesh, vertex_shader, fragment_shader)
        H, W = params.height, params.width
        color = color.reshape(H, f, W, f, 4).mean(axis=(1, 3))
        return color, depth[::f, ::f]

    n = mesh.shape[AXIS]
    H, W = params.height, params.width
    if H % n:
        raise ValueError(f"height {H} not divisible by ring size {n}")
    shard_h = H // n
    t_pad = scene["indices"].shape[0]
    t_local = t_pad // n

    tri_sharded = {"indices", "tri_mesh_id", "tri_texture_id", "tri_valid",
                   "tri_lod_level"}
    if n > 1:
        # Triangle shards rotate around the ring — global segment starts
        # don't describe a slice, so mesh->tri broadcasts use take here.
        scene = {k: v for k, v in scene.items() if k != "tri_seg_starts"}
    in_specs = ({k: (P(AXIS) if k in tri_sharded else P())
                 for k in scene}, P())

    def shard_fn(scene, u):
        i = jax.lax.axis_index(AXIS)
        row_offset = i * shard_h

        view, proj = camera_matrices(u, W, H)
        view_proj = ml.transform(view, proj, xp=jnp)
        visible = culling.spheres_in_frustum(
            scene["bounds_center"], scene["bounds_radius"],
            scene["mesh_matrices"], view_proj, xp=jnp)
        tri_mask = jnp.take(visible, scene["tri_mesh_id"]) \
            & scene["tri_valid"]
        if "tri_lod_level" in scene:
            from softwarerenderer_tpu.ops import lod
            tri_mask = tri_mask & lod.lod_tri_mask(scene, u, H, xp=jnp)
        indices = scene["indices"]
        tri_tex = jnp.asarray(scene["tri_texture_id"], jnp.int32)
        tri_mesh_c = jnp.asarray(scene["tri_mesh_id"], jnp.int32)
        if params.geom_cap:
            # Pre-geometry compaction per ring shard (params.geom_cap,
            # geometry.precompact_inputs — same per-shard-slice contract
            # as the sharded path: compacted local ids stay inside the
            # shard's 2·t_local global offset window, so the rotated
            # (depth, gidx) fold is order-isomorphic).  Size with
            # ops/lod.suggested_geom_cap ÷ n_devices.
            pt = {"tex": tri_tex, "mesh": tri_mesh_c}
            tri_mask, indices, pt, _ = geometry.precompact_inputs(
                tri_mask, params.geom_cap, indices, pt)
            tri_tex, tri_mesh_c = pt["tex"], pt["mesh"]
        model_pv = culling.model_matrices_per_vertex(scene, xp=jnp)
        uu = dict(u)
        uu.update(model=model_pv, view=view, projection=proj,
                  atlas_data=scene["atlas_data"],
                  atlas_offsets=scene["atlas_offsets"],
                  atlas_sizes=scene["atlas_sizes"],
                  base_color=scene["base_color"])
        vin = {k: scene[k] for k in ("position", "uv", "normal", "color")}
        # Per-frame vertex updates (tangents, flip-book, skinning,
        # particles) — replicated, identical on every ring shard.
        from softwarerenderer_tpu.engine.renderer import (
            apply_vertex_updates,
        )
        vin = apply_vertex_updates(vin, scene, u, view)
        tris = geometry.build_triangles(
            vertex_shader, vin, indices, uu,
            width=W, height=H, cull_mode=params.cull_mode,
            near_clip=uu["near_clip"], tri_mask=tri_mask,
            keep_varyings=getattr(fragment_shader, "varyings", None))

        # Pre-resolved atlas regions ride the payload (pruned by the
        # shader's tri_extras registry) so band-local shading is
        # gather-lean — same plumbing as the single-chip engine.  Built
        # BEFORE payload packing so compaction covers them too.
        tid2 = jnp.repeat(tri_tex, 2)
        aoff = jnp.asarray(scene["atlas_offsets"], jnp.int32)
        asiz = jnp.asarray(scene["atlas_sizes"], jnp.int32)
        per_tri = {"tex_id": tid2,
                   "mesh_id": jnp.repeat(tri_mesh_c, 2),
                   "tex_oy": jnp.take(aoff[:, 0], tid2),
                   "tex_ox": jnp.take(aoff[:, 1], tid2),
                   "tex_h": jnp.take(asiz[:, 0], tid2),
                   "tex_w": jnp.take(asiz[:, 1], tid2)}
        tri_extras = getattr(fragment_shader, "tri_extras", None)
        if tri_extras is not None:
            per_tri = {k: v for k, v in per_tri.items() if k in tri_extras}

        if params.active_cap:
            # Active-slot compaction (params.active_cap, same contract as
            # the engine/sharded paths) — here it ALSO shrinks the ring
            # traffic: the rotated SoA + payload carry cap rows instead of
            # 2·t_local.  Cross-shard ordering is preserved because each
            # shard's compacted ids stay inside its 2·t_local-wide global
            # offset window (gidx stride below is unchanged).
            tris, per_tri, _ = geometry.compact_triangles(
                tris, params.active_cap, per_tri)

        # Packed payload for the resolve ring (same layout as the fused
        # single-chip path).
        keys = sorted(tris["attrs"].keys())
        parts, slices, off = [], {}, 0
        for k in keys:
            arr = tris["attrs"][k]
            parts.append(arr)
            slices[k] = (off, off + arr.shape[-1])
            off += arr.shape[-1]
        parts.append(tris["screen"]); sl_screen = (off, off + 2); off += 2
        nloc = tris["screen"].shape[0]
        parts.append(jnp.broadcast_to(tris["inv_area"][:, None, None],
                                      (nloc, 3, 1)))
        sl_ia = off; off += 1
        extra_slices = {}
        for k in sorted(per_tri):
            v = jnp.asarray(per_tri[k], F32)[:, None, None]
            parts.append(jnp.broadcast_to(v, (nloc, 3, 1)))
            extra_slices[k] = off; off += 1
        kp = off
        payload = jnp.concatenate(parts, axis=-1).reshape(nloc, 3 * kp)
        payload = jnp.where(tris["valid"][:, None], payload, 0.0)

        ring_state = {
            "screen": tris["screen"], "depth": tris["depth"],
            "inv_area": tris["inv_area"], "valid": tris["valid"],
            "payload": payload,
            "src": jnp.asarray(i, jnp.int32),
        }

        px = jax.lax.broadcasted_iota(jnp.int32, (shard_h, W), 1) \
            .astype(F32)
        py = (jax.lax.broadcasted_iota(jnp.int32, (shard_h, W), 0)
              + row_offset).astype(F32)
        clear = jnp.asarray(u["clear_color"], dtype=F32)
        fb_color = jnp.broadcast_to(clear, (shard_h, W, 4))
        fb_depth = jnp.full((shard_h, W), DEPTH_CLEAR, dtype=F32)

        perm = [(k, (k + 1) % n) for k in range(n)]

        # ---- ring pass 1: visibility ----
        def vis_step(k, carry):
            state, best = carry
            best = _fold_shard(state, best, px[None], py[None],
                               params.depth_test,
                               state["src"] * (2 * t_local))
            nxt = {kk: jax.lax.ppermute(vv, AXIS, perm)
                   for kk, vv in state.items()}
            return nxt, best

        best = (fb_depth, jnp.full((shard_h, W), NO_TRI, jnp.int32))
        state, best = jax.lax.fori_loop(0, n, vis_step,
                                        (ring_state, best))
        best_d, best_i = best
        covered = best_i != NO_TRI

        # ---- ring pass 2: winner payload resolve ----
        def res_step(k, carry):
            state, acc = carry
            gidx = state["src"] * (2 * t_local) + jnp.arange(
                state["payload"].shape[0], dtype=jnp.int32)
            onehot = (best_i[..., None] == gidx).astype(F32)  # (h, W, 2Tl)
            acc = acc + jax.lax.dot_general(
                onehot, state["payload"], (((2,), (0,)), ((), ())),
                precision=jax.lax.Precision.HIGHEST,
                preferred_element_type=jnp.float32)
            nxt = {kk: jax.lax.ppermute(vv, AXIS, perm)
                   for kk, vv in state.items()}
            return nxt, acc

        acc0 = jnp.zeros((shard_h, W, 3 * kp), F32)
        _, acc = jax.lax.fori_loop(0, n, res_step, (state, acc0))
        av = acc.reshape(shard_h, W, 3, kp)

        # ---- interpolate + shade (band-local) ----
        s = av[..., sl_screen[0]:sl_screen[1]]
        ia = av[..., 0, sl_ia]
        clo, chi = slices["clip_position"]
        clip_w = av[..., chi - 1]
        s0x, s0y = s[..., 0, 0], s[..., 0, 1]
        s1x, s1y = s[..., 1, 0], s[..., 1, 1]
        s2x, s2y = s[..., 2, 0], s[..., 2, 1]
        w0 = ((s1y - s2y) * (px - s1x) + (s2x - s1x) * (py - s1y)) * ia
        w1 = ((s2y - s0y) * (px - s2x) + (s0x - s2x) * (py - s2y)) * ia
        w2 = ((s0y - s1y) * (px - s0x) + (s1x - s0x) * (py - s0y)) * ia
        rcp_a = w0 / jnp.where(clip_w[..., 0] == 0, F32(1), clip_w[..., 0])
        rcp_b = w1 / jnp.where(clip_w[..., 1] == 0, F32(1), clip_w[..., 1])
        rcp_c = w2 / jnp.where(clip_w[..., 2] == 0, F32(1), clip_w[..., 2])
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
        frag["tri"] = {k: av[..., 0, i].astype(jnp.int32)
                       for k, i in extra_slices.items()}

        color = fragment_shader(frag, uu, jnp)
        written = covered & (color[..., 3] > 0)
        out_c = jnp.where(written[..., None],
                          _blend(color, fb_color, params.blend_mode),
                          fb_color)
        out_d = jnp.where(written, best_d, fb_depth) \
            if params.depth_test != DepthTest.DISABLED else fb_depth
        return out_c, out_d

    fn = shard_map_unchecked(shard_fn, mesh=mesh, in_specs=in_specs,
                             out_specs=(P(AXIS), P(AXIS)))
    return fn(scene, uniforms)
