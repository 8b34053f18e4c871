"""Skeletal (linear-blend) skinning on device.

Beyond the reference: its only animation is the flip-book frame swap
(/root/reference/ModelLoader.cs:331-348).  This module adds glTF-style
skeletal animation — joint hierarchies, inverse bind matrices, per-vertex
(joint, weight) pairs — evaluated INSIDE the jitted frame, driven by the
traced ``uniforms["anim_time"]`` scalar so playback never recompiles or
re-uploads vertex data.

Design:
  * Keyframe tracks are resampled to a UNIFORM clock at import
    (io_host/gltf.py), so on-device sampling is one gather of two frames
    + a lerp (nlerp for rotations) — no per-channel searchsorted.
  * Forward kinematics is LEVEL-SCHEDULED: joints are grouped by
    topological depth at pack time (scene["joint_level_ids"]) and each
    level is one batched 4×4 matmul — sequential cost scales with
    skeleton DEPTH, not joint count, so an N-instance skinned crowd
    pays the same number of steps as one character.  Vertices are many —
    all per-vertex work is one batched matrix blend + one batched point
    transform.
  * Matrices follow the repo's row-vector .NET convention
    (utils/mathlib.py): v' = v @ M, local = S @ R @ T, world_j =
    local_j @ world_parent, skin_j = inverse_bind_j @ world_j.

Normals are transformed by the blended matrix's 3×3 block and
renormalized — exact for rigid joint transforms, the standard
approximation under non-uniform scale.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from softwarerenderer_tpu.utils import mathlib as ml

F32 = np.float32


def quat_matrices(q, xp=np):
    """Batched row-vector rotation matrices from (..., 4) xyzw quats
    (mathlib.matrix_from_quaternion, vectorized)."""
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    two = F32(2.0)
    one = xp.ones_like(x)
    r0 = xp.stack([one - two * (y * y + z * z), two * (x * y + w * z),
                   two * (x * z - w * y)], axis=-1)
    r1 = xp.stack([two * (x * y - w * z), one - two * (x * x + z * z),
                   two * (y * z + w * x)], axis=-1)
    r2 = xp.stack([two * (x * z + w * y), two * (y * z - w * x),
                   one - two * (x * x + y * y)], axis=-1)
    return xp.stack([r0, r1, r2], axis=-2)                 # (..., 3, 3)


def compose_trs(trans, rot, scl, xp=np):
    """(..., 3)/(..., 4)/(..., 3) TRS → (..., 4, 4) row-vector local
    matrices: M = S @ R @ T, i.e. rows = scale·rotation, last row =
    translation."""
    r = quat_matrices(rot, xp=xp)                          # (..., 3, 3)
    rs = r * scl[..., :, None]                             # row i scaled
    m = xp.concatenate([rs, xp.zeros_like(rs[..., :1])], axis=-1)
    last = xp.concatenate([trans, xp.ones_like(trans[..., :1])], axis=-1)
    return xp.concatenate([m, last[..., None, :]], axis=-2)


def sample_tracks(trans, rot, scl, frame, n_frames, xp=np):
    """Sample uniform-clock TRS tracks at fractional ``frame`` (per joint).

    trans (F, J, 3), rot (F, J, 4), scl (F, J, 3); frame (J,) f32;
    n_frames (J,) i32 (loop length per joint's skin).  Returns local joint
    matrices (J, 4, 4).  Rotation uses hemisphere-aligned nlerp — at the
    resampled clock rate adjacent keys are close, where nlerp ≈ slerp.
    """
    nf = xp.maximum(n_frames, 1)
    f0 = xp.floor(frame)
    a = (frame - f0)[..., None].astype(F32)
    i0 = (f0.astype(np.int32) % nf + nf) % nf
    i1 = (i0 + 1) % nf
    j = xp.arange(trans.shape[1])

    def take2(arr):
        return arr[i0, j], arr[i1, j]

    t0, t1 = take2(trans)
    q0, q1 = take2(rot)
    s0, s1 = take2(scl)
    t = t0 + (t1 - t0) * a
    s = s0 + (s1 - s0) * a
    q1 = xp.where((xp.sum(q0 * q1, axis=-1) < 0)[..., None], -q1, q1)
    q = q0 + (q1 - q0) * a
    q = q / xp.sqrt(xp.maximum(xp.sum(q * q, axis=-1, keepdims=True),
                               F32(1e-30)))
    return compose_trs(t, q, s, xp=xp)


def forward_kinematics(local, parent, xp=np):
    """World joint matrices from topologically-ordered locals.

    local (J, 4, 4); parent (J,) i32 with parent[j] < j (or -1 for
    roots).  Sequential over J (joints are few); each step is one 4×4
    matmul: world_j = local_j @ world_parent.
    """
    J = local.shape[0]
    if xp is np:
        world = np.empty_like(local)
        for j in range(J):
            p = parent[j]
            world[j] = local[j] if p < 0 else local[j] @ world[p]
        return world
    import jax
    import jax.numpy as jnp

    eye = jnp.eye(4, dtype=jnp.float32)

    def body(j, world):
        p = parent[j]
        pm = jnp.where(p < 0, eye, world[jnp.maximum(p, 0)])
        return world.at[j].set(ml.matmul(local[j], pm, xp=jnp))

    return jax.lax.fori_loop(0, J, body, jnp.zeros_like(local))


def forward_kinematics_levels(local, parent, level_ids, xp=np):
    """Level-scheduled forward kinematics: one BATCHED 4x4 matmul per
    topological depth level instead of one sequential matmul per joint.

    ``level_ids`` (D, L) int32 groups joint ids by depth (packed by
    models/scene.build_scene_buffers; rows padded with J = out of
    bounds, dropped by the scatter).  Every parent lives at a strictly
    shallower level, so each step only reads finalized rows.  A crowd of
    N identical skeletons has the same D as one skeleton — FK cost
    stops scaling with instance count (J sequential steps -> D).
    Computes exactly local[j] @ world[parent[j]] like
    forward_kinematics, just batched per level.
    """
    if xp is np:
        return forward_kinematics(local, parent, xp=np)
    import jax.numpy as jnp

    J = local.shape[0]
    eye = jnp.eye(4, dtype=jnp.float32)
    world = jnp.zeros_like(local)
    for d in range(level_ids.shape[0]):        # static skeleton depth
        ids = level_ids[d]                     # (L,) padded with J
        idc = jnp.minimum(ids, J - 1)
        loc = jnp.take(local, idc, axis=0)     # (L, 4, 4)
        p = jnp.take(parent, idc, axis=0)
        pm = jnp.where((p < 0)[:, None, None], eye,
                       jnp.take(world, jnp.maximum(p, 0), axis=0))
        world = world.at[ids].set(ml.matmul(loc, pm, xp=jnp), mode="drop")
    return world


def skin_matrices(scene: Dict, uniforms: Dict, xp=np):
    """Per-joint skinning matrices (J, 4, 4) for the packed scene at the
    traced time ``uniforms["anim_time"]`` (seconds; scalar or per-skin
    (S,) vector)."""
    slot = scene["joint_skin_slot"]                        # (J,)
    n_skins = scene["skin_n_frames"].shape[0]
    t = xp.asarray(uniforms.get("anim_time", 0.0), dtype=F32)
    t = xp.broadcast_to(xp.atleast_1d(t), (n_skins,))
    frame = xp.take(t * xp.asarray(scene["skin_rate"], F32), slot)
    nf = xp.take(xp.asarray(scene["skin_n_frames"], np.int32), slot)
    local = sample_tracks(xp.asarray(scene["skin_trans"], F32),
                          xp.asarray(scene["skin_rot"], F32),
                          xp.asarray(scene["skin_scale"], F32),
                          frame, nf, xp=xp)
    parent = xp.asarray(scene["joint_parent"], np.int32)
    if "joint_level_ids" in scene:
        world = forward_kinematics_levels(
            local, parent, xp.asarray(scene["joint_level_ids"], np.int32),
            xp=xp)
    else:
        world = forward_kinematics(local, parent, xp=xp)
    return ml.matmul(xp.asarray(scene["joint_inv_bind"], F32), world, xp=xp)


def apply_skinning(vin: Dict, scene: Dict, uniforms: Dict, xp=np) -> Dict:
    """Replace skinned vertices' position/normal in the packed vertex
    arrays.  All per-vertex work is batched: blend 4 gathered joint
    matrices per vertex, then one (Vs, 4) @ (Vs, 4, 4) transform."""
    mats = skin_matrices(scene, uniforms, xp=xp)           # (J, 4, 4)
    ji = xp.asarray(scene["skin_joints"], np.int32)        # (Vs, 4)
    wt = xp.asarray(scene["skin_weights"], F32)            # (Vs, 4)
    vidx = xp.asarray(scene["skin_vert_index"], np.int32)  # (Vs,)

    gathered = xp.take(mats, ji.reshape(-1), axis=0).reshape(
        ji.shape + (4, 4))                                 # (Vs, 4, 4, 4)
    blend = xp.sum(gathered * wt[..., None, None], axis=1)  # (Vs, 4, 4)

    pos = xp.take(vin["position"], vidx, axis=0)
    nrm = xp.take(vin["normal"], vidx, axis=0)
    ph = xp.concatenate([pos, xp.ones_like(pos[..., :1])], axis=-1)
    new_pos = ml.einsum("vi,vij->vj", ph, blend, xp=xp)[..., :3]
    new_nrm = ml.einsum("vi,vij->vj", nrm, blend[..., :3, :3], xp=xp)
    new_nrm = new_nrm / xp.sqrt(xp.maximum(
        xp.sum(new_nrm * new_nrm, axis=-1, keepdims=True), F32(1e-30)))

    out = dict(vin)
    if xp is np:
        p = np.array(vin["position"]); p[vidx] = new_pos
        n = np.array(vin["normal"]); n[vidx] = new_nrm
        out["position"], out["normal"] = p, n
    else:
        out["position"] = vin["position"].at[vidx].set(new_pos)
        out["normal"] = vin["normal"].at[vidx].set(new_nrm)
    return out


def skinned_positions_np(skin, mesh_positions: np.ndarray,
                         frame: float) -> np.ndarray:
    """Host-side reference: skinned positions of one instance at an exact
    integer/fractional frame of ITS OWN clock.  Used for conservative
    culling bounds at pack time and by tests."""
    J = skin.parent.shape[0]
    local = sample_tracks(skin.trans, skin.rot, skin.scale,
                          np.full(J, frame, F32),
                          np.full(J, skin.trans.shape[0], np.int32), xp=np)
    world = forward_kinematics(local, skin.parent, xp=np)
    mats = skin.inverse_bind.astype(F32) @ world
    gathered = mats[skin.joints.reshape(-1)].reshape(
        skin.joints.shape + (4, 4))
    blend = np.sum(gathered * skin.weights[..., None, None], axis=1)
    ph = np.concatenate([mesh_positions,
                         np.ones_like(mesh_positions[..., :1])], axis=-1)
    return np.einsum("vi,vij->vj", ph, blend)[..., :3]
