"""Frustum culling on device — Gribb–Hartmann planes + sphere tests.

Re-designs FrustumCuller (/root/reference/FrustumCuller.cs:153-224) as
batched array ops: one plane extraction per frame and ONE vectorized
sphere-vs-6-planes test over all meshes (the reference tests per mesh under
Parallel.ForEach, Renderer.cs:444-446).  Works under numpy and jax.numpy
(xp arg) so the host and the jitted frame share one implementation.

Plane convention matches the reference exactly: for the row-vector
viewProjection = view·projection, plane k coefficients are
(M[0,3]±M[0,k], M[1,3]±M[1,k], M[2,3]±M[2,k], M[3,3]±M[3,k]) normalized by
the xyz magnitude; a sphere is visible when signed distance > -radius
against all six planes (FrustumCuller.cs:201-224).
"""

from __future__ import annotations

import numpy as np

from softwarerenderer_tpu.utils import mathlib as ml

F32 = np.float32


def frustum_planes(view_projection, xp=np):
    """(6, 4) normalized planes [normal_xyz, d]: near, far, left, right,
    top, bottom — the reference's extraction order (FrustumCuller.cs:153-187).
    For the row-vector convention the k-th clip coordinate is v·M[:, k], so
    plane coefficients come from matrix COLUMNS."""
    m = xp.asarray(view_projection, dtype=xp.float32)
    col = lambda k: m[:, k]
    w = col(3)
    raw = xp.stack([
        w + col(2),   # near  (clip z >= 0 for the 0..1 depth projection)
        w - col(2),   # far
        w + col(0),   # left
        w - col(0),   # right
        w + col(1),   # top    (reference's "top" = w + col1, FrustumCuller.cs:177)
        w - col(1),   # bottom
    ])                                           # (6, 4): x,y,z,d
    mag = xp.sqrt(raw[:, 0] ** 2 + raw[:, 1] ** 2 + raw[:, 2] ** 2)
    return raw / mag[:, None]


def spheres_in_frustum(centers, radii, model_matrices, view_projection,
                       xp=np):
    """Vectorized IsSphereInFrustum (FrustumCuller.cs:201-218).

    centers: (M, 3) local-space sphere centers; radii: (M,);
    model_matrices: (M, 4, 4).  Returns (M,) bool visibility.
    World radius scales by the max row-norm of the model matrix's upper 3x3
    (the reference's conservative max-scale).
    """
    centers = xp.asarray(centers, dtype=xp.float32)
    radii = xp.asarray(radii, dtype=xp.float32)
    mm = xp.asarray(model_matrices, dtype=xp.float32)

    world_center = ml.transform_point(centers, mm, xp=xp)      # (M, 3)
    row_norms = xp.sqrt(xp.sum(mm[:, :3, :3] ** 2, axis=-1))   # (M, 3)
    world_radius = radii * xp.max(row_norms, axis=-1)

    planes = frustum_planes(view_projection, xp=xp)            # (6, 4)
    # distance(center) = n·c + d for every (mesh, plane) pair
    dist = ml.matmul(world_center, planes[:, :3].T, xp=xp) \
        + planes[None, :, 3]
    return xp.all(dist > -world_radius[:, None], axis=-1)


def segment_broadcast(values, seg_starts, n: int, element_ids=None, xp=np):
    """Expand per-mesh `values` (M,) to per-element (n,) over CONTIGUOUS
    segments — element i belongs to the last segment whose start <= i.

    A gather-free form of `xp.take(values, element_ids)` for sorted
    `element_ids` (tri_mesh_id / vert_mesh_id, models/scene.py): scatter
    first-order deltas at the segment starts, one integer cumsum
    propagates them across each segment.  The scatter+cumsum form is
    EXACT for bool/int values (integer arithmetic
    throughout — float values would accumulate rounding, so they are
    routed to take).

    Empty segments collapse correctly (coincident starts sum their
    deltas).  On the numpy path (golden/host) this is a plain take via
    `element_ids` (required there).
    """
    values = xp.asarray(values)
    exact = values.dtype == bool or xp.issubdtype(values.dtype, xp.integer)
    if xp is np or not exact:
        if element_ids is None:
            raise ValueError("segment_broadcast needs element_ids for "
                             "the take fallback")
        return xp.take(values, element_ids)
    as_bool = values.dtype == bool
    v = values.astype(xp.int32)
    deltas = xp.concatenate([v[:1], v[1:] - v[:-1]])
    out = xp.cumsum(xp.zeros((n,), xp.int32).at[seg_starts].add(deltas))
    return out > 0 if as_bool else out


def segment_broadcast_bits(values, seg_starts, n: int, element_ids=None,
                           xp=np):
    """Exact gather-free segment broadcast for FLOAT (any 32-bit) per-mesh
    values over contiguous segments — the f32 companion of
    ``segment_broadcast``.

    ``segment_broadcast`` refuses floats because a float delta cumsum
    accumulates rounding.  Bit-reinterpretation sidesteps that: bitcast
    the values to int32, scatter WRAPPING first-order deltas at the
    segment starts, run one int32 cumsum (XLA s32 addition is exact
    two's-complement modular arithmetic, so ``a + (b - a) == b`` holds
    bitwise regardless of overflow), and bitcast back.  The result is
    bitwise identical to ``xp.take(values, element_ids, axis=0)`` for
    sorted ``element_ids`` — this is how per-vertex model matrices reach
    the vertex shader without a (V, 4, 4) per-element gather.

    values: (M, ...) with a 4-byte dtype.  Returns (n, ...).  Empty
    segments collapse correctly (coincident starts sum their wrapping
    deltas).  On the numpy path (golden/host) this is a plain take.
    """
    values = xp.asarray(values)
    if xp is np:
        if element_ids is None:
            raise ValueError("segment_broadcast_bits needs element_ids "
                             "for the take fallback")
        return xp.take(values, element_ids, axis=0)
    if values.dtype.itemsize != 4:
        raise ValueError(f"segment_broadcast_bits needs a 32-bit dtype, "
                         f"got {values.dtype}")
    import jax
    m = values.shape[0]
    trailing = values.shape[1:]
    bits = jax.lax.bitcast_convert_type(
        values.reshape(m, -1), xp.int32)                     # (M, K)
    deltas = xp.concatenate([bits[:1], bits[1:] - bits[:-1]])
    acc = xp.zeros((n,) + bits.shape[1:], xp.int32)
    acc = acc.at[seg_starts].add(deltas)
    out_bits = xp.cumsum(acc, axis=0)                        # wraps: exact
    out = jax.lax.bitcast_convert_type(out_bits, values.dtype)
    return out.reshape((n,) + trailing)


def model_matrices_per_vertex(scene, xp=np):
    """(V, 4, 4) model matrix per packed vertex — every render path's
    vertex-shader ``model`` uniform (the per-mesh transform fan-out the
    reference bakes at load, ModelLoader.cs:159-301, done per frame here
    so mesh_matrices stay live-tunable).

    Uses the gather-free bitcast broadcast when the scene publishes
    ``vert_seg_starts`` (models/scene.py — contiguous sorted
    vert_mesh_id) and the matrices are 32-bit, else falls back to take
    (e.g. float64 mesh_matrices under jax_enable_x64 — the bitcast trick
    only holds for 4-byte lanes).

    Invalidation contract for ``vert_seg_starts``: the key asserts that
    the scene's VERTEX arrays are the exact packed layout the starts
    were built from.  Any future path that slices, pads, or reorders
    vertex arrays (the vertex analog of ``shard_scene_triangles``, which
    pops ``tri_seg_starts`` for the same reason) MUST pop
    ``vert_seg_starts`` or rebuild it — the trace-time guard below makes
    a stale key fail loudly instead of rendering with wrong transforms."""
    n = int(scene["vert_mesh_id"].shape[0])
    if (xp is not np and "vert_seg_starts" in scene
            and xp.asarray(scene["mesh_matrices"]).dtype.itemsize == 4):
        starts = scene["vert_seg_starts"]
        if hasattr(starts, "shape") and starts.shape[0] > 0:
            try:
                last = int(np.asarray(starts[-1]))   # tracers raise here
            except Exception:
                last = None
            if last is not None and last > n:
                raise ValueError(
                    f"vert_seg_starts (last start {last}) is stale for "
                    f"{n} packed vertices — a path that resized vertex "
                    f"arrays must pop or rebuild it (see "
                    f"model_matrices_per_vertex docstring)")
        return segment_broadcast_bits(
            scene["mesh_matrices"], starts, n, xp=xp)
    return xp.take(xp.asarray(scene["mesh_matrices"]),
                   xp.asarray(scene["vert_mesh_id"]), axis=0)
