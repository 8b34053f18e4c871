"""Batched raycast physics: Möller–Trumbore over all triangles at once.

Batched re-design of Physics.cs (/root/reference/Physics.cs): the
reference transforms the whole mesh per call then runs a Parallel.For over
triangles with thread-local nearest-hit reduction (SURVEY.md §2.2 P4);
here R rays × T triangles evaluate as one fused (R, T) tensor op followed
by an argmin — no locks, one kernel.

Faithful semantics (Physics.cs:136-179):
  * epsilon 1e-8; IgnoreBackfaces rejects det < ε, IgnoreFrontfaces rejects
    det > -ε, then |det| < ε rejects
  * u ∈ [0,1], v ≥ 0, u+v ≤ 1, t ≥ 0
  * hit normal = normalize(n0·(1-u-v) + n1·u + n2·v) — smooth interpolated
    vertex normals (Physics.cs:95-101)
  * vertices transformed by the model matrix, normals by
    transpose(inverse(model)) then normalized (Physics.cs:31-49)
  * nearest hit wins; ties pin to the LOWEST triangle index (the reference
    is thread-racy on ties — SURVEY.md §5; sequential order is the parity
    definition)
"""

from __future__ import annotations

from typing import Dict

import jax
import jax.numpy as jnp

from softwarerenderer_tpu.utils import mathlib as ml

F32 = jnp.float32
EPSILON = 1e-8

FACE_MASK_NONE = 0
FACE_MASK_IGNORE_BACKFACES = 1
FACE_MASK_IGNORE_FRONTFACES = 2


def build_collision_world(scene: Dict) -> Dict:
    """World-space triangle soup from packed scene buffers (models.scene).

    Transforms every vertex by its mesh matrix and every normal by the
    mesh's transpose-inverse (Physics.cs:38-49), then gathers per-triangle
    corners.  Jit-friendly: matrices are traced, so moving meshes just
    re-run this cheap batched transform each step.
    """
    mats = jnp.asarray(scene["mesh_matrices"], dtype=F32)       # (M, 4, 4)
    inv, _ok = jax.vmap(lambda m: ml.invert(m, xp=jnp))(mats)
    normal_mat = jnp.swapaxes(inv, -1, -2)

    vm = jnp.asarray(scene["vert_mesh_id"])
    pos = ml.transform_point(jnp.asarray(scene["position"], dtype=F32),
                             jnp.take(mats, vm, axis=0), xp=jnp)
    n4 = ml.transform(
        jnp.concatenate([jnp.asarray(scene["normal"], dtype=F32),
                         jnp.zeros_like(scene["normal"][..., :1])], axis=-1),
        jnp.take(normal_mat, vm, axis=0), xp=jnp)[..., :3]
    normal = ml.safe_normalize(n4, xp=jnp)

    idx = jnp.asarray(scene["indices"], dtype=jnp.int32)        # (T, 3)
    v = jnp.take(pos, idx, axis=0)                              # (T, 3, 3)
    n = jnp.take(normal, idx, axis=0)
    return {
        "v0": v[:, 0], "v1": v[:, 1], "v2": v[:, 2],
        "n0": n[:, 0], "n1": n[:, 1], "n2": n[:, 2],
        "tri_mesh_id": jnp.asarray(scene["tri_mesh_id"], dtype=jnp.int32),
    }


def raycast_batch(origins, directions, world: Dict,
                  face_mask: int = FACE_MASK_IGNORE_BACKFACES,
                  tri_mask=None) -> Dict:
    """R rays vs T triangles; nearest hit per ray.

    origins/directions: (R, 3) (directions are normalized internally, as
    Physics.RaycastInternal does at :68).  tri_mask: optional (T,) bool to
    exclude triangles (e.g. only the map, or only one player's model).

    Returns {"hit": (R,) bool, "distance": (R,), "point": (R, 3),
             "normal": (R, 3), "tri": (R,) i32}.
    Misses report distance = +MaxValue (float.MaxValue semantics).
    """
    o = jnp.asarray(origins, dtype=F32)
    d = ml.safe_normalize(jnp.asarray(directions, dtype=F32), xp=jnp)
    o = o[:, None, :]                                           # (R, 1, 3)
    d = d[:, None, :]

    v0 = world["v0"][None]                                      # (1, T, 3)
    edge1 = (world["v1"] - world["v0"])[None]
    edge2 = (world["v2"] - world["v0"])[None]

    pvec = ml.cross(d, edge2, xp=jnp)                           # (R, T, 3)
    det = ml.dot(edge1, pvec, xp=jnp)                           # (R, T)

    ok = jnp.abs(det) >= EPSILON
    if face_mask & FACE_MASK_IGNORE_BACKFACES:
        ok &= det >= EPSILON
    if face_mask & FACE_MASK_IGNORE_FRONTFACES:
        ok &= det <= -EPSILON

    inv_det = F32(1.0) / jnp.where(det == 0, F32(1), det)
    tvec = o - v0
    u = ml.dot(tvec, pvec, xp=jnp) * inv_det
    ok &= (u >= 0) & (u <= 1)
    qvec = ml.cross(tvec, edge1, xp=jnp)
    v = ml.dot(d, qvec, xp=jnp) * inv_det
    ok &= (v >= 0) & (u + v <= 1)
    t = ml.dot(edge2, qvec, xp=jnp) * inv_det
    ok &= t >= 0
    if tri_mask is not None:
        ok &= jnp.asarray(tri_mask, bool)[None, :]

    big = jnp.finfo(jnp.float32).max
    t_masked = jnp.where(ok, t, big)
    tri = jnp.argmin(t_masked, axis=1)                          # lowest index
    dist = jnp.take_along_axis(t_masked, tri[:, None], axis=1)[:, 0]
    hit = jnp.take_along_axis(ok, tri[:, None], axis=1)[:, 0]

    ub = jnp.take_along_axis(u, tri[:, None], axis=1)[:, 0]
    vb = jnp.take_along_axis(v, tri[:, None], axis=1)[:, 0]
    wb = F32(1.0) - ub - vb
    n0 = jnp.take(world["n0"], tri, axis=0)
    n1 = jnp.take(world["n1"], tri, axis=0)
    n2 = jnp.take(world["n2"], tri, axis=0)
    normal = ml.safe_normalize(
        n0 * wb[:, None] + n1 * ub[:, None] + n2 * vb[:, None], xp=jnp)
    point = jnp.asarray(origins, dtype=F32) + ml.safe_normalize(
        jnp.asarray(directions, dtype=F32), xp=jnp) * dist[:, None]
    return {
        "hit": hit,
        "distance": jnp.where(hit, dist, big),
        "point": jnp.where(hit[:, None], point, jnp.zeros_like(point)),
        "normal": jnp.where(hit[:, None], normal, jnp.zeros_like(normal)),
        "tri": tri.astype(jnp.int32),
    }


def raycast(origin, direction, world: Dict,
            face_mask: int = FACE_MASK_IGNORE_BACKFACES,
            tri_mask=None) -> Dict:
    """Single-ray convenience wrapper (Physics.Raycast shape)."""
    out = raycast_batch(jnp.asarray(origin, F32)[None],
                        jnp.asarray(direction, F32)[None],
                        world, face_mask, tri_mask)
    return {k: v[0] for k, v in out.items()}
