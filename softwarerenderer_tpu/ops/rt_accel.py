"""Ray-tracing acceleration: Morton-clustered triangles + conservative
ray-BUNDLE culling — an array-program answer to "the ray tracer needs a
BVH".

Classic BVHs are per-ray pointer chases: data-dependent traversal, tiny
irregular reads — a poor fit for one dense jitted program.  The
observation that fits instead: the renderer's rays arrive
in COHERENT chunks (a pixel tile's primary rays share a camera frustum;
a tile's shadow rays march toward one light; see ops/raytrace.py), so
culling can happen once per CHUNK against clustered geometry, and the
surviving work stays a dense rays × triangles Möller–Trumbore block:

  1. Build (inside the jitted frame — world matrices are traced):
     triangles sort by the Morton code of their world centroid, so each
     run of `group` consecutive slots is spatially tight; per-cluster
     AABBs are one reshape + min/max.  (`build_rt_accel`)
  2. Per chunk: a conservative interval slab test asks, per cluster,
     "could ANY ray with origin in the chunk's origin-AABB and direction
     in its direction-AABB hit this cluster's AABB?"  — O(clusters)
     elementwise work, no per-ray traversal.  (`_bundle_hits_aabb`)
  3. Surviving clusters stable-compact to a static `cap` (the same
     cumsum-rank partition idiom as ops/binning.py); their triangle
     slots gather once; Möller–Trumbore runs dense on (rays, cap·group).
  4. Exactness is UNCONDITIONAL: if more than `cap` clusters survive,
     a `lax.cond` falls back to the brute-force raycast for that chunk —
     the cap is a performance knob, never a correctness knob (the same
     contract as RenderParams.active_cap's overflow counters).

Winner semantics match sim/raycast.raycast_batch exactly: nearest hit,
ties to the LOWEST GLOBAL triangle index (the Morton permutation is
invisible — the tie reduction runs on global ids), identical epsilon and
face-mask rules (Physics.cs:136-179 faithful).  Tests assert the winner
identity (hit, tri) is IDENTICAL to brute force; derived floats
(t/point/normal) agree to fp tolerance — the formulas are the same
elementwise ops, but XLA contracts mul-adds to FMAs differently in the
two program shapes, so the last ulp can drift (the same
cross-compilation caveat as PARITY.md's constant-folded camera note).

The reference has no analog (its Physics.cs is brute force per mesh);
this accelerates the beyond-reference ray-traced render mode
(ops/raytrace.py) and any bulk raycast workload with coherent batches.
"""

from __future__ import annotations

from typing import Dict, Optional

import jax
import jax.numpy as jnp

import importlib

from softwarerenderer_tpu.utils import mathlib as ml

# sim/__init__ re-exports the `raycast` FUNCTION under the submodule's
# name, so a plain `from ...sim import raycast` binds the function.
rc_mod = importlib.import_module("softwarerenderer_tpu.sim.raycast")

F32 = jnp.float32
I32 = jnp.int32
BIG = jnp.finfo(jnp.float32).max
EPSILON = rc_mod.EPSILON


def _morton3(q: jnp.ndarray) -> jnp.ndarray:
    """Interleave three 10-bit integer coordinates (N, 3) -> (N,) i32
    Morton codes (x bit i -> code bit 3i, y -> 3i+1, z -> 3i+2)."""
    def spread(x):
        # classic bit-spreading: 10 bits -> every 3rd bit of 30
        x = (x | (x << 16)) & jnp.int32(0x030000FF)
        x = (x | (x << 8)) & jnp.int32(0x0300F00F)
        x = (x | (x << 4)) & jnp.int32(0x030C30C3)
        x = (x | (x << 2)) & jnp.int32(0x09249249)
        return x
    x, y, z = q[:, 0], q[:, 1], q[:, 2]
    return spread(x) | (spread(y) << 1) | (spread(z) << 2)


def build_rt_accel(world: Dict, group: int = 64) -> Dict:
    """Cluster the collision world's triangles for bundle culling.

    `world` is sim/raycast.build_collision_world output (v0/v1/v2 world-
    space corners).  Returns a dict of device arrays — everything traced,
    so moving meshes just rebuild it each frame (one argsort over T plus
    reductions; ~micro-seconds at game scale):

      perm      (Tp,)  i32  slot -> global triangle id (pad slots -> 0)
      slot_ok   (Tp,)  bool pad mask
      v0/e1/e2  (Tp, 3) f32 permuted corners / edge vectors
      cl_lo/hi  (NC, 3) f32 cluster AABBs (pad slots excluded)
      group, n_clusters  (static ints)
    """
    v0, v1, v2 = world["v0"], world["v1"], world["v2"]
    T = v0.shape[0]
    Tp = -(-T // group) * group

    cent = (v0 + v1 + v2) * F32(1.0 / 3.0)
    lo = jnp.min(cent, axis=0)
    hi = jnp.max(cent, axis=0)
    span = jnp.maximum(hi - lo, F32(1e-20))
    q = jnp.clip(((cent - lo) / span * F32(1023.0)).astype(I32), 0, 1023)
    code = _morton3(q)
    perm = jnp.argsort(code).astype(I32)                       # (T,)

    pad = Tp - T
    perm = jnp.pad(perm, (0, pad))                             # pad -> tri 0
    slot_ok = jnp.pad(jnp.ones((T,), bool), (0, pad))

    pv0 = jnp.take(v0, perm, axis=0)
    pv1 = jnp.take(v1, perm, axis=0)
    pv2 = jnp.take(v2, perm, axis=0)

    nc = Tp // group
    corners = jnp.stack([pv0, pv1, pv2], axis=1)               # (Tp, 3, 3)
    corners = corners.reshape(nc, group, 3, 3)
    okc = slot_ok.reshape(nc, group, 1, 1)
    cl_lo = jnp.min(jnp.where(okc, corners, BIG), axis=(1, 2))
    cl_hi = jnp.max(jnp.where(okc, corners, -BIG), axis=(1, 2))

    return {
        "perm": perm, "slot_ok": slot_ok,
        "v0": pv0, "e1": pv1 - pv0, "e2": pv2 - pv0,
        "cl_lo": cl_lo, "cl_hi": cl_hi,
        "group": group, "n_clusters": nc,
    }


def _reach_ge(x0, x1, s0, s1, c):
    """t-interval [t0, t1] on which  max over the bundle of (x + t*s)
    can be >= c, for origin interval [x0, x1] and slope interval
    [s0, s1], t >= 0.  The max trajectory is x1 + t*s1.  Conservative
    (never culls a reachable cluster).  All args broadcast."""
    up = s1 > 0
    dn = s1 < 0
    at0 = x1 >= c
    tc = (c - x1) / jnp.where(s1 == 0, F32(1), s1)
    t0 = jnp.where(at0, F32(0.0), jnp.where(up, tc, BIG))
    t1 = jnp.where(at0 & dn, tc, jnp.where(at0 | up, BIG, -BIG))
    return t0, t1


def _reach_le(x0, x1, s0, s1, c):
    """t-interval on which  min over the bundle of (x + t*s) can be
    <= c.  The min trajectory is x0 + t*s0.  (Mirror of _reach_ge.)"""
    t0, t1 = _reach_ge(-x1, -x0, -s1, -s0, -c)
    return t0, t1


def _bundle_hits_aabb(olo, ohi, dlo, dhi, cl_lo, cl_hi) -> jnp.ndarray:
    """(NC,) bool: could any ray with origin in [olo, ohi] and direction
    in [dlo, dhi] enter cluster AABB [cl_lo, cl_hi] at some t >= 0?

    Per axis the reachable-coordinate envelope over the bundle is
    [olo + t*dlo, ohi + t*dhi]; the slab [lo, hi] is touchable at time t
    iff envelope_max >= lo AND envelope_min <= hi.  Each condition is an
    interval in t; the cluster survives iff the intersection over the
    six conditions (and t >= 0) is nonempty.  Interval arithmetic makes
    this conservative — it can admit extra clusters, never drop one."""
    t0 = jnp.zeros(cl_lo.shape[0], F32)
    t1 = jnp.full((cl_lo.shape[0],), BIG, F32)
    for a in range(3):
        g0, g1 = _reach_ge(olo[a], ohi[a], dlo[a], dhi[a], cl_lo[:, a])
        l0, l1 = _reach_le(olo[a], ohi[a], dlo[a], dhi[a], cl_hi[:, a])
        t0 = jnp.maximum(t0, jnp.maximum(g0, l0))
        t1 = jnp.minimum(t1, jnp.minimum(g1, l1))
    return t0 <= t1


def raycast_bundle_culled(origins, directions, world: Dict, accel: Dict,
                          cap,
                          face_mask: int = rc_mod.FACE_MASK_IGNORE_BACKFACES,
                          tri_mask=None) -> Dict:
    """Drop-in raycast_batch with bundle culling: R rays vs the clusters
    their bundle can reach; identical winners (see module docstring),
    including the lowest-global-index tie rule.

    `cap` is an int or an ascending tuple of ints — a LADDER of static
    cluster capacities.  Each chunk dispatches (lax.switch) to the
    smallest rung that holds its survivor count, so cheap chunks pay a
    small dense block while rare busy chunks climb rungs; a chunk
    exceeding the top rung falls back to raycast_batch.  Exact for ANY
    ladder — rungs are perf knobs; size them from measured survivor
    percentiles (bundle_survivor_count), the way active_cap is sized
    from active_cap_stats.  Inside lax.map/scan chunk loops the switch
    executes only the chosen rung per chunk (the same dynamic-skip
    economics as the K-buffer opaque short-circuit).
    """
    caps = (cap,) if isinstance(cap, int) else tuple(cap)
    o = jnp.asarray(origins, F32)
    d = ml.safe_normalize(jnp.asarray(directions, F32), xp=jnp)
    G = accel["group"]
    nc = accel["n_clusters"]
    caps = tuple(sorted({min(c, nc) for c in caps}))
    max_cap = caps[-1]

    olo = jnp.min(o, axis=0)
    ohi = jnp.max(o, axis=0)
    dlo = jnp.min(d, axis=0)
    dhi = jnp.max(d, axis=0)
    alive = _bundle_hits_aabb(olo, ohi, dlo, dhi,
                              accel["cl_lo"], accel["cl_hi"])

    # Cluster-level visibility: a cluster none of whose triangles pass
    # tri_mask (or that is all padding) can be culled before the dense
    # block — mesh_visible folds into geometry, not just slot masking.
    slot_mask = accel["slot_ok"]
    if tri_mask is not None:
        slot_mask = slot_mask & jnp.take(jnp.asarray(tri_mask, bool),
                                         accel["perm"])
    alive = alive & jnp.any(slot_mask.reshape(nc, G), axis=1)

    n_alive = jnp.sum(alive.astype(I32))

    # Stable compaction of surviving cluster ids to a static prefix (NC
    # is small — tens to hundreds — so a stable bool argsort is cheap
    # and keeps Morton order among survivors).
    sel = jnp.argsort(jnp.logical_not(alive), stable=True
                      ).astype(I32)[:max_cap]
    taken = jnp.arange(max_cap, dtype=I32) < jnp.minimum(n_alive, max_cap)

    def make_rung(cap):
        return lambda _: _culled_mt(o, d, origins, world, accel, slot_mask,
                                    sel[:cap], taken[:cap], face_mask)

    def brute_path(_):
        return rc_mod.raycast_batch(o, d, world, face_mask=face_mask,
                                    tri_mask=tri_mask)

    if len(caps) == 1:
        return jax.lax.cond(n_alive > max_cap, brute_path,
                            make_rung(caps[0]), None)
    # Rung index: first cap >= n_alive, else the brute branch.
    bounds = jnp.asarray(caps, I32)
    idx = jnp.sum((n_alive > bounds).astype(I32))
    branches = [make_rung(c) for c in caps] + [brute_path]
    return jax.lax.switch(idx, branches, None)


def _culled_mt(o, d, origins, world, accel, slot_mask, sel, taken,
               face_mask):
    """The dense Möller–Trumbore block over one rung's selected clusters
    (see raycast_bundle_culled)."""
    G = accel["group"]

    rows = (sel[:, None] * G
            + jnp.arange(G, dtype=I32)[None]).reshape(-1)   # (cap*G,)
    sv0 = jnp.take(accel["v0"], rows, axis=0)
    se1 = jnp.take(accel["e1"], rows, axis=0)
    se2 = jnp.take(accel["e2"], rows, axis=0)
    sgid = jnp.take(accel["perm"], rows)
    sok = jnp.take(slot_mask, rows) & jnp.repeat(taken, G)

    pvec = ml.cross(d[:, None, :], se2[None], xp=jnp)       # (R, K, 3)
    det = ml.dot(se1[None], pvec, xp=jnp)
    ok = jnp.abs(det) >= EPSILON
    if face_mask & rc_mod.FACE_MASK_IGNORE_BACKFACES:
        ok &= det >= EPSILON
    if face_mask & rc_mod.FACE_MASK_IGNORE_FRONTFACES:
        ok &= det <= -EPSILON
    inv_det = F32(1.0) / jnp.where(det == 0, F32(1), det)
    tvec = o[:, None, :] - sv0[None]
    u = ml.dot(tvec, pvec, xp=jnp) * inv_det
    ok &= (u >= 0) & (u <= 1)
    qvec = ml.cross(tvec, se1[None], xp=jnp)
    v = ml.dot(d[:, None, :], qvec, xp=jnp) * inv_det
    ok &= (v >= 0) & (u + v <= 1)
    t = ml.dot(se2[None], qvec, xp=jnp) * inv_det
    ok &= (t >= 0) & sok[None, :]

    t_masked = jnp.where(ok, t, BIG)
    tbest = jnp.min(t_masked, axis=1)                       # (R,)
    # Tie rule: lowest GLOBAL id among hits at tbest (raycast_batch's
    # argmin over the unpermuted axis picks the first == lowest id).
    at_best = ok & (t_masked == tbest[:, None])
    gid_or_big = jnp.where(at_best, sgid[None, :], jnp.int32(2**30))
    wtri = jnp.min(gid_or_big, axis=1)                      # (R,)
    hit = wtri < 2**30
    wtri = jnp.where(hit, wtri, 0).astype(I32)
    # Winner slot (for u/v): first slot matching (tbest, wtri).
    wslot = jnp.argmax(at_best & (gid_or_big == wtri[:, None]), axis=1)
    ub = jnp.take_along_axis(u, wslot[:, None], axis=1)[:, 0]
    vb = jnp.take_along_axis(v, wslot[:, None], axis=1)[:, 0]
    dist = jnp.where(hit, tbest, BIG)

    wb = F32(1.0) - ub - vb
    n0 = jnp.take(world["n0"], wtri, axis=0)
    n1 = jnp.take(world["n1"], wtri, axis=0)
    n2 = jnp.take(world["n2"], wtri, axis=0)
    normal = ml.safe_normalize(
        n0 * wb[:, None] + n1 * ub[:, None] + n2 * vb[:, None], xp=jnp)
    point = jnp.asarray(origins, F32) + d * jnp.where(hit, dist,
                                                      F32(0))[:, None]
    return {
        "hit": hit,
        "distance": dist,
        "point": jnp.where(hit[:, None], point, jnp.zeros_like(point)),
        "normal": jnp.where(hit[:, None], normal,
                            jnp.zeros_like(normal)),
        "tri": wtri,
    }


def _bundles_alive(origins, directions, accel: Dict, slot_mask):
    """(B, NC) bool cluster-survival matrix for B ray bundles (see
    _bundles_alive_entry)."""
    alive, _t0 = _bundles_alive_entry(origins, directions, accel,
                                      slot_mask)
    return alive


def _bundles_alive_entry(origins, directions, accel: Dict, slot_mask):
    """((B, NC) bool survival, (B, NC) f32 conservative ENTRY time).

    Vectorized slab test: per bundle the origin/direction AABBs come from
    min/max over its rays; the interval test itself broadcasts (B, 1)
    against (1, NC).  Clusters with no maskable triangle are dead for
    every bundle.  The entry time t0 (earliest t at which ANY bundle ray
    could touch the cluster) orders survivors front-to-back — the
    kernel's any-hit early exit and, for nearest folds, a locality that
    costs nothing (the fold is order-independent)."""
    o = jnp.asarray(origins, F32)                       # (B, R, 3)
    d = jnp.asarray(directions, F32)
    olo = jnp.min(o, axis=1)                            # (B, 3)
    ohi = jnp.max(o, axis=1)
    dlo = jnp.min(d, axis=1)
    dhi = jnp.max(d, axis=1)
    cl_lo, cl_hi = accel["cl_lo"], accel["cl_hi"]       # (NC, 3)
    B = o.shape[0]
    nc = cl_lo.shape[0]
    t0 = jnp.zeros((B, nc), F32)
    t1 = jnp.full((B, nc), BIG, F32)
    for a in range(3):
        g0, g1 = _reach_ge(olo[:, a:a + 1], ohi[:, a:a + 1],
                           dlo[:, a:a + 1], dhi[:, a:a + 1],
                           cl_lo[None, :, a])
        l0, l1 = _reach_le(olo[:, a:a + 1], ohi[:, a:a + 1],
                           dlo[:, a:a + 1], dhi[:, a:a + 1],
                           cl_hi[None, :, a])
        t0 = jnp.maximum(t0, jnp.maximum(g0, l0))
        t1 = jnp.minimum(t1, jnp.minimum(g1, l1))
    alive = t0 <= t1
    nonempty = jnp.any(slot_mask.reshape(accel["n_clusters"],
                                         accel["group"]), axis=1)
    return alive & nonempty[None, :], t0


def _mt_block(o, d, v0, e1, e2, face_mask):
    """Möller–Trumbore over broadcastable ray/triangle blocks; returns
    (ok, t, u, v).  The same elementwise ops as raycast_batch
    (Physics.cs:136-179 semantics: epsilon/face-mask rules, u, v, t
    bounds); callers add their own slot masks."""
    pvec = ml.cross(d, e2, xp=jnp)
    det = ml.dot(e1, pvec, xp=jnp)
    ok = jnp.abs(det) >= EPSILON
    if face_mask & rc_mod.FACE_MASK_IGNORE_BACKFACES:
        ok &= det >= EPSILON
    if face_mask & rc_mod.FACE_MASK_IGNORE_FRONTFACES:
        ok &= det <= -EPSILON
    inv_det = F32(1.0) / jnp.where(det == 0, F32(1), det)
    tvec = o - v0
    u = ml.dot(tvec, pvec, xp=jnp) * inv_det
    ok &= (u >= 0) & (u <= 1)
    qvec = ml.cross(tvec, e1, xp=jnp)
    v = ml.dot(d, qvec, xp=jnp) * inv_det
    ok &= (v >= 0) & (u + v <= 1)
    t = ml.dot(e2, qvec, xp=jnp) * inv_det
    ok &= t >= 0
    return ok, t, u, v


def _pair_table(alive, pair_cap: int):
    """Stable-compact the (B, NC) survival matrix into a bundle-major
    pair list — the sort-middle idiom of ops/binning.py applied to ray
    bundles.  Returns (pair_bundle (P,), pair_cluster (P,), taken (P,),
    n_pairs scalar).  Pad pairs carry bundle id B (an extra segment the
    caller drops); `n_pairs > pair_cap` means overflow (caller falls
    back to brute — the cap is a perf knob, never a correctness knob)."""
    B, nc = alive.shape
    P = min(int(pair_cap), B * nc)      # can't have more pairs than B·NC
    flat = alive.reshape(-1)
    n_pairs = jnp.sum(flat.astype(I32))
    idx = jnp.argsort(jnp.logical_not(flat), stable=True
                      ).astype(I32)[:P]                 # ascending = b-major
    taken = jnp.arange(P, dtype=I32) < jnp.minimum(n_pairs, P)
    pair_bundle = jnp.where(taken, idx // nc, I32(B))
    pair_cluster = jnp.where(taken, idx % nc, I32(0))
    return pair_bundle, pair_cluster, taken, n_pairs


def _pair_sweep(origins, directions, accel: Dict, slot_mask,
                pair_bundle, pair_cluster, taken, face_mask: int,
                chunk_pairs: int, any_hit: bool,
                origin_shared: bool = False, dir_shared: bool = False):
    """The dense chunked Möller–Trumbore sweep over the pair table.

    Each chunk gathers its pairs' cluster triangles (chunk, G) and its
    pairs' bundle rays (chunk, R), evaluates the (chunk, R, G) block, and
    reduces over G to the per-(pair, ray) best.  Work is proportional to
    LIVE pairs (uniform dense blocks, full VPU utilization) instead of a
    sequential per-tile switch — the structural fix for the round-3
    finding that the tile-loop path was loop-bound, not FLOP-bound.

    Returns (t_pair (P, R) f32, gid_pair (P, R) i32) for nearest mode,
    or occl_pair (P, R) i32 for any-hit (shadow) mode."""
    o = jnp.asarray(origins, F32)
    d = jnp.asarray(directions, F32)
    G = accel["group"]
    P = pair_bundle.shape[0]
    Pc = -(-P // chunk_pairs) * chunk_pairs
    pb = jnp.pad(pair_bundle, (0, Pc - P),
                 constant_values=origins.shape[0])
    pc = jnp.pad(pair_cluster, (0, Pc - P))
    tk = jnp.pad(taken, (0, Pc - P))
    # Pad-bundle rays: one throwaway row appended so gathers stay in
    # bounds for pad pairs (bundle id B).
    o_x = jnp.concatenate([o, jnp.zeros((1,) + o.shape[1:], F32)], axis=0)
    d_x = jnp.concatenate([d, jnp.ones((1,) + d.shape[1:], F32)], axis=0)

    R = o.shape[1]
    C = chunk_pairs

    def step(args):
        pbc, pcc, tkc = args                            # (C,)

        def live(_):
            rows = (pcc[:, None] * G
                    + jnp.arange(G, dtype=I32)[None])   # (C, G)
            sv0 = jnp.take(accel["v0"], rows, axis=0)   # (C, G, 3)
            se1 = jnp.take(accel["e1"], rows, axis=0)
            se2 = jnp.take(accel["e2"], rows, axis=0)
            sgid = jnp.take(accel["perm"], rows)        # (C, G)
            sok = jnp.take(slot_mask, rows) & tkc[:, None]
            # Per-pair ray gathers cost per element: at C·R·3 elements
            # per chunk they dominate the sweep for big frames.
            # Rays shared across every bundle (primary origins = the
            # eye; hard-shadow directions = the light) broadcast
            # instead — declared by the caller via *_shared.
            if origin_shared:
                oc = jnp.broadcast_to(o_x[0, 0], (C,) + o_x.shape[1:])
            else:
                oc = jnp.take(o_x, pbc, axis=0)         # (C, R, 3)
            if dir_shared:
                dc = jnp.broadcast_to(d_x[0, 0], (C,) + d_x.shape[1:])
            else:
                dc = jnp.take(d_x, pbc, axis=0)
            ok, t, _u, _v = _mt_block(
                oc[:, :, None, :], dc[:, :, None, :],
                sv0[:, None], se1[:, None], se2[:, None],
                face_mask)                              # (C, R, G)
            ok &= sok[:, None, :]
            if any_hit:
                return jnp.any(ok, axis=2).astype(I32)  # (C, R)
            t_masked = jnp.where(ok, t, BIG)
            tb = jnp.min(t_masked, axis=2)              # (C, R)
            at_best = ok & (t_masked == tb[:, :, None])
            gid = jnp.min(jnp.where(at_best, sgid[:, None, :], NOTRI),
                          axis=2)                       # (C, R)
            return tb, gid

        def dead(_):
            # Chunks of pure padding (a contiguous suffix, since the
            # table is stable-compacted) skip the dense block — an
            # oversized pair_cap costs one cond per pad chunk, nothing
            # more.
            if any_hit:
                return jnp.zeros((C, R), I32)
            return (jnp.full((C, R), BIG, F32),
                    jnp.full((C, R), NOTRI, I32))

        return jax.lax.cond(jnp.any(tkc), live, dead, None)

    out = jax.lax.map(step, (pb.reshape(-1, chunk_pairs),
                             pc.reshape(-1, chunk_pairs),
                             tk.reshape(-1, chunk_pairs)))
    if any_hit:
        return out.reshape(Pc, -1)[:P]
    tb, gid = out
    return tb.reshape(Pc, -1)[:P], gid.reshape(Pc, -1)[:P]


NOTRI = 2 ** 30  # "no triangle" sentinel (python int: no import-time array)


def raycast_bundles_any(origins, directions, world: Dict, accel: Dict,
                        *, pair_cap: int, chunk_pairs: int = 256,
                        face_mask: int = rc_mod.FACE_MASK_NONE,
                        tri_mask=None, origin_shared: bool = False,
                        dir_shared: bool = False):
    """Occlusion-only bundle raycast: B bundles × R rays, True where ANY
    triangle blocks the ray (t >= 0) — the shadow-ray primitive.  No
    nearest-hit reduction, no tie rules, no winner reconstruction: the
    result of the cheap any-over-pairs fold is identical to
    raycast_batch(...)['hit'] by construction (culling is conservative
    and hit-existence needs no ordering).

    origins/directions: (B, R, 3).  Returns {"hit": (B, R) bool,
    "n_pairs": scalar i32, "overflow": scalar bool}.  On pair_cap
    overflow the result lax.cond-falls back to a chunked brute sweep —
    exact for any cap."""
    o = jnp.asarray(origins, F32)
    d = ml.safe_normalize(jnp.asarray(directions, F32), xp=jnp)
    slot_mask = accel["slot_ok"]
    if tri_mask is not None:
        slot_mask = slot_mask & jnp.take(jnp.asarray(tri_mask, bool),
                                         accel["perm"])
    alive = _bundles_alive(o, d, accel, slot_mask)
    pb, pc, tk, n_pairs = _pair_table(alive, pair_cap)

    def pair_path(_):
        occ = _pair_sweep(o, d, accel, slot_mask, pb, pc, tk,
                          face_mask, chunk_pairs, any_hit=True,
                          origin_shared=origin_shared,
                          dir_shared=dir_shared)                 # (P, R)
        seg = jax.ops.segment_max(occ, pb, num_segments=o.shape[0] + 1,
                                  indices_are_sorted=True)
        return seg[:-1] > 0

    def brute_path(_):
        def one(args):
            ob, db = args
            return rc_mod.raycast_batch(ob, db, world,
                                        face_mask=face_mask,
                                        tri_mask=tri_mask)["hit"]
        return jax.lax.map(one, (o, d))

    hit = jax.lax.cond(n_pairs > pb.shape[0], brute_path, pair_path, None)
    return {"hit": hit, "n_pairs": n_pairs,
            "overflow": n_pairs > pb.shape[0]}


def raycast_bundles_nearest(origins, directions, world: Dict, accel: Dict,
                            *, pair_cap: int, chunk_pairs: int = 256,
                            face_mask: int = rc_mod.FACE_MASK_NONE,
                            tri_mask=None, origin_shared: bool = False,
                            dir_shared: bool = False):
    """Nearest-hit bundle raycast over B bundles × R rays via the pair
    table — the batched replacement for mapping raycast_bundle_culled
    over tiles (which serialized ~600 tiny dense blocks per frame).

    Winner semantics match raycast_batch: nearest t, ties to the LOWEST
    global triangle index.  Per pair the (C, R, G) block reduces to
    (min t, lowest gid at that t); across a bundle's pairs two
    bundle-major segmented folds finish the lexicographic reduction
    (segment_min t, then segment_min of gid masked to t == best) — each
    (ray, triangle) pair lives in exactly ONE cluster, so block-local t
    values are globally consistent.  u/v/normals are reconstructed by
    re-running the single winner triangle through the same Möller–
    Trumbore formulas (fp-tolerance floats, identical winners — the
    rt_accel contract).

    Returns raycast_batch's dict with (B, R) leaves, plus "n_pairs" and
    "overflow" diagnostics.  Overflow lax.cond-falls back to a chunked
    brute sweep (exact for any pair_cap)."""
    B, R = jnp.asarray(origins, F32).shape[:2]
    o = jnp.asarray(origins, F32)
    d = ml.safe_normalize(jnp.asarray(directions, F32), xp=jnp)
    slot_mask = accel["slot_ok"]
    if tri_mask is not None:
        slot_mask = slot_mask & jnp.take(jnp.asarray(tri_mask, bool),
                                         accel["perm"])
    alive = _bundles_alive(o, d, accel, slot_mask)
    pb, pc, tk, n_pairs = _pair_table(alive, pair_cap)

    def pair_path(_):
        tb, gid = _pair_sweep(o, d, accel, slot_mask, pb, pc, tk,
                              face_mask, chunk_pairs, any_hit=False,
                              origin_shared=origin_shared,
                              dir_shared=dir_shared)
        # Lexicographic (t, gid) min per (bundle, ray): two segmented
        # folds over the bundle-major pair axis.
        tbest = jax.ops.segment_min(tb, pb, num_segments=B + 1,
                                    indices_are_sorted=True)[:-1]  # (B, R)
        tb_back = jnp.take(jnp.concatenate(
            [tbest, jnp.full((1, R), BIG, F32)], axis=0), pb, axis=0)
        gid_m = jnp.where(tb == tb_back, gid, NOTRI)
        wtri = jax.ops.segment_min(gid_m, pb, num_segments=B + 1,
                                   indices_are_sorted=True)[:-1]   # (B, R)
        hit = wtri < NOTRI
        wtri = jnp.where(hit, wtri, 0).astype(I32)

        # Winner reconstruction: one MT evaluation on the winning
        # triangle per ray (u/v for the smooth normal; t reuses the
        # sweep's exact fold value).  The packed (T, 18) geom_table
        # (ops/raytrace.build_rt_world) replaces six takes with one
        # row-gather when present (same values bit-for-bit).
        if "geom_table" in world:
            g = jnp.take(world["geom_table"], wtri, axis=0)  # (B, R, 18)
            wv0, we1, we2 = g[..., 0:3], g[..., 3:6], g[..., 6:9]
            n0, n1, n2 = g[..., 9:12], g[..., 12:15], g[..., 15:18]
        else:
            wv0 = jnp.take(world["v0"], wtri, axis=0)       # (B, R, 3)
            we1 = jnp.take(world["v1"], wtri, axis=0) - wv0
            we2 = jnp.take(world["v2"], wtri, axis=0) - wv0
            n0 = jnp.take(world["n0"], wtri, axis=0)
            n1 = jnp.take(world["n1"], wtri, axis=0)
            n2 = jnp.take(world["n2"], wtri, axis=0)
        _ok, _t, u, v = _mt_block(o, d, wv0, we1, we2, face_mask)
        w = F32(1.0) - u - v
        normal = ml.safe_normalize(
            n0 * w[..., None] + n1 * u[..., None] + n2 * v[..., None],
            xp=jnp)
        dist = jnp.where(hit, tbest, BIG)
        point = o + d * jnp.where(hit, dist, F32(0))[..., None]
        return {
            "hit": hit,
            "distance": dist,
            "point": jnp.where(hit[..., None], point,
                               jnp.zeros_like(point)),
            "normal": jnp.where(hit[..., None], normal,
                                jnp.zeros_like(normal)),
            "tri": wtri,
            # winner barycentrics: consumers reuse them instead of
            # re-gathering corner data per ray (gather model)
            "u": u, "v": v,
        }

    def brute_path(_):
        def one(args):
            ob, db = args
            res = rc_mod.raycast_batch(ob, db, world,
                                       face_mask=face_mask,
                                       tri_mask=tri_mask)
            wv0 = jnp.take(world["v0"], res["tri"], axis=0)
            we1 = jnp.take(world["v1"], res["tri"], axis=0) - wv0
            we2 = jnp.take(world["v2"], res["tri"], axis=0) - wv0
            _ok, _t, u, v = _mt_block(ob, ml.safe_normalize(
                jnp.asarray(db, F32), xp=jnp), wv0, we1, we2, face_mask)
            res["u"] = u
            res["v"] = v
            return res
        return jax.lax.map(one, (o, d))

    out = jax.lax.cond(n_pairs > pb.shape[0], brute_path, pair_path, None)
    out["n_pairs"] = n_pairs
    out["overflow"] = n_pairs > pb.shape[0]
    return out


def bundle_pair_count(origins, directions, world: Dict, accel: Dict,
                      tri_mask=None) -> jnp.ndarray:
    """Diagnostic: total live (bundle, cluster) pairs for a (B, R, 3)
    bundle batch — size pair_cap from this (p99.9 × margin), the way
    active_cap sizes from active_cap_stats."""
    o = jnp.asarray(origins, F32)
    d = ml.safe_normalize(jnp.asarray(directions, F32), xp=jnp)
    slot_mask = accel["slot_ok"]
    if tri_mask is not None:
        slot_mask = slot_mask & jnp.take(jnp.asarray(tri_mask, bool),
                                         accel["perm"])
    return jnp.sum(_bundles_alive(o, d, accel, slot_mask).astype(I32))


def bundle_survivor_count(origins, directions, world: Dict, accel: Dict,
                          tri_mask=None) -> jnp.ndarray:
    """Diagnostic: how many clusters this bundle keeps alive (size caps
    from this, the way active_cap sizes from active_cap_stats)."""
    o = jnp.asarray(origins, F32)
    d = ml.safe_normalize(jnp.asarray(directions, F32), xp=jnp)
    alive = _bundle_hits_aabb(jnp.min(o, axis=0), jnp.max(o, axis=0),
                              jnp.min(d, axis=0), jnp.max(d, axis=0),
                              accel["cl_lo"], accel["cl_hi"])
    if tri_mask is not None:
        sm = accel["slot_ok"] & jnp.take(jnp.asarray(tri_mask, bool),
                                         accel["perm"])
        alive = alive & jnp.any(
            sm.reshape(accel["n_clusters"], accel["group"]), axis=1)
    return jnp.sum(alive.astype(I32))
