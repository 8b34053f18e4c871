"""Row-vector matrix / quaternion math in the reference's conventions.

The reference uses System.Numerics row-vector semantics throughout
(`Vector4.Transform(v, M)` = v·M, `A*B` applies A first; see SURVEY.md §6
note 2 and Renderer.cs:830-846).  Pixel parity requires matching those
conventions bit-for-bit in float32, so every constructor here mirrors the
.NET System.Numerics formulas exactly:

  * ``perspective_fov``       — Matrix4x4.CreatePerspectiveFieldOfView
  * ``look_at``               — Matrix4x4.CreateLookAt (right-handed)
  * ``scale/translation``     — CreateScale / CreateTranslation
  * ``matrix_from_quaternion``— CreateFromQuaternion (row-vector layout)
  * ``quat_from_yaw_pitch_roll`` / ``quat_from_axis_angle`` / Hamilton
    ``quat_mul`` / ``quat_rotate`` (t = 2 q×v; v' = v + w t + q×t) / slerp

All functions are dtype-careful float32 and work with either numpy or
jax.numpy via the ``xp`` keyword (default numpy), so the CPU golden
reference and the device pipeline share one source of truth.

Matrices transform ROW vectors: ``transform(v, M) == v @ M``.  A point is
(x, y, z, 1); ``transform_normal`` uses only the upper-left 3x3.
"""

from __future__ import annotations

import numpy as np

F32 = np.float32


def _f32(x, xp):
    return xp.asarray(x, dtype=xp.float32)


# ---------------------------------------------------------------------------
# Matrix constructors (row-vector, .NET System.Numerics layout)
# ---------------------------------------------------------------------------

def identity(xp=np):
    return xp.eye(4, dtype=xp.float32)


def perspective_fov(fov_radians, aspect, near, far, xp=np):
    """Matrix4x4.CreatePerspectiveFieldOfView: row-vector RH projection.

    ndcZ = z_clip/w_clip runs 0 at `near` to 1 at `far` for view-space
    z = -d (camera looks down -Z); w_clip = d.
    """
    fov = _f32(fov_radians, xp)
    y_scale = F32(1.0) / xp.tan(fov * F32(0.5))
    x_scale = y_scale / _f32(aspect, xp)
    neg_far_range = _f32(far, xp) / (_f32(near, xp) - _f32(far, xp))
    zero = xp.zeros((), dtype=xp.float32)
    one = xp.ones((), dtype=xp.float32)
    m = xp.stack([
        xp.stack([x_scale, zero, zero, zero]),
        xp.stack([zero, y_scale, zero, zero]),
        xp.stack([zero, zero, neg_far_range, -one]),
        xp.stack([zero, zero, _f32(near, xp) * neg_far_range, zero]),
    ])
    return m


def orthographic(width, height, near, far, xp=np):
    """Matrix4x4.CreateOrthographic: row-vector RH ortho projection.

    ndcZ runs 0 at `near` to 1 at `far` for view-space z = -d (same depth
    convention as perspective_fov, so the raster depth semantics match).
    Used by the shadow-map light camera (ops/shadows.py)."""
    zero = xp.zeros((), dtype=xp.float32)
    one = xp.ones((), dtype=xp.float32)
    inv_nf = F32(1.0) / (_f32(near, xp) - _f32(far, xp))
    m = xp.stack([
        xp.stack([F32(2.0) / _f32(width, xp), zero, zero, zero]),
        xp.stack([zero, F32(2.0) / _f32(height, xp), zero, zero]),
        xp.stack([zero, zero, inv_nf, zero]),
        xp.stack([zero, zero, _f32(near, xp) * inv_nf, one]),
    ])
    return m


def look_at(eye, target, up, xp=np):
    """Matrix4x4.CreateLookAt (right-handed): zaxis = normalize(eye-target)."""
    eye = _f32(eye, xp)
    target = _f32(target, xp)
    up = _f32(up, xp)
    zaxis = normalize(eye - target, xp=xp)
    xaxis = normalize(cross(up, zaxis, xp=xp), xp=xp)
    yaxis = cross(zaxis, xaxis, xp=xp)
    neg = xp.stack([
        -dot(xaxis, eye, xp=xp),
        -dot(yaxis, eye, xp=xp),
        -dot(zaxis, eye, xp=xp),
    ])
    one = xp.ones((), dtype=xp.float32)
    zero = xp.zeros((), dtype=xp.float32)
    m = xp.stack([
        xp.stack([xaxis[0], yaxis[0], zaxis[0], zero]),
        xp.stack([xaxis[1], yaxis[1], zaxis[1], zero]),
        xp.stack([xaxis[2], yaxis[2], zaxis[2], zero]),
        xp.stack([neg[0], neg[1], neg[2], one]),
    ])
    return m


def scale(s, xp=np):
    """CreateScale — uniform or (sx, sy, sz)."""
    s = xp.broadcast_to(_f32(s, xp), (3,))
    m = xp.zeros((4, 4), dtype=xp.float32)
    if xp is np:
        m[0, 0], m[1, 1], m[2, 2], m[3, 3] = s[0], s[1], s[2], F32(1)
        return m
    m = m.at[0, 0].set(s[0]).at[1, 1].set(s[1]).at[2, 2].set(s[2])
    return m.at[3, 3].set(1.0)


def translation(t, xp=np):
    """CreateTranslation — translation lives in the last row (row-vector)."""
    t = _f32(t, xp)
    m = xp.eye(4, dtype=xp.float32)
    if xp is np:
        m[3, :3] = t
        return m
    return m.at[3, :3].set(t)


def matrix_from_quaternion(q, xp=np):
    """CreateFromQuaternion in the row-vector layout:
    M11=1-2(y²+z²) M12=2(xy+wz) M13=2(xz-wy), etc."""
    q = _f32(q, xp)
    x, y, z, w = q[0], q[1], q[2], q[3]
    two = F32(2.0)
    one = xp.ones((), dtype=xp.float32)
    zero = xp.zeros((), dtype=xp.float32)
    m = xp.stack([
        xp.stack([one - two * (y * y + z * z), two * (x * y + w * z), two * (x * z - w * y), zero]),
        xp.stack([two * (x * y - w * z), one - two * (x * x + z * z), two * (y * z + w * x), zero]),
        xp.stack([two * (x * z + w * y), two * (y * z - w * x), one - two * (x * x + y * y), zero]),
        xp.stack([zero, zero, zero, one]),
    ])
    return m


def matrix_from_yaw_pitch_roll(yaw, pitch, roll, xp=np):
    """CreateFromYawPitchRoll = CreateFromQuaternion(quat_from_yaw_pitch_roll)."""
    return matrix_from_quaternion(quat_from_yaw_pitch_roll(yaw, pitch, roll, xp=xp), xp=xp)


def invert(m, xp=np):
    """General 4x4 inverse via cofactor expansion (Matrix4x4.Invert).

    Returns (inv, ok) where ok is False for singular matrices (|det| tiny).
    """
    m = _f32(m, xp)
    a = m[0, 0]; b = m[0, 1]; c = m[0, 2]; d = m[0, 3]
    e = m[1, 0]; f = m[1, 1]; g = m[1, 2]; h = m[1, 3]
    i = m[2, 0]; j = m[2, 1]; k = m[2, 2]; l = m[2, 3]
    mm = m[3, 0]; n = m[3, 1]; o = m[3, 2]; p = m[3, 3]

    kp_lo = k * p - l * o
    jp_ln = j * p - l * n
    jo_kn = j * o - k * n
    ip_lm = i * p - l * mm
    io_km = i * o - k * mm
    in_jm = i * n - j * mm

    a11 = f * kp_lo - g * jp_ln + h * jo_kn
    a12 = -(e * kp_lo - g * ip_lm + h * io_km)
    a13 = e * jp_ln - f * ip_lm + h * in_jm
    a14 = -(e * jo_kn - f * io_km + g * in_jm)

    det = a * a11 + b * a12 + c * a13 + d * a14
    ok = xp.abs(det) > F32(1e-12)
    safe_det = xp.where(ok, det, F32(1.0))
    inv_det = xp.where(ok, F32(1.0) / safe_det, F32(0.0))

    gp_ho = g * p - h * o
    fp_hn = f * p - h * n
    fo_gn = f * o - g * n
    ep_hm = e * p - h * mm
    eo_gm = e * o - g * mm
    en_fm = e * n - f * mm

    gl_hk = g * l - h * k
    fl_hj = f * l - h * j
    fk_gj = f * k - g * j
    el_hi = e * l - h * i
    ek_gi = e * k - g * i
    ej_fi = e * j - f * i

    out = xp.stack([
        xp.stack([a11, -(b * kp_lo - c * jp_ln + d * jo_kn),
                  b * gp_ho - c * fp_hn + d * fo_gn,
                  -(b * gl_hk - c * fl_hj + d * fk_gj)]),
        xp.stack([a12, a * kp_lo - c * ip_lm + d * io_km,
                  -(a * gp_ho - c * ep_hm + d * eo_gm),
                  a * gl_hk - c * el_hi + d * ek_gi]),
        xp.stack([a13, -(a * jp_ln - b * ip_lm + d * in_jm),
                  a * fp_hn - b * ep_hm + d * en_fm,
                  -(a * fl_hj - b * el_hi + d * ej_fi)]),
        xp.stack([a14, a * jo_kn - b * io_km + c * in_jm,
                  -(a * fo_gn - b * eo_gm + c * en_fm),
                  a * fk_gj - b * ek_gi + c * ej_fi]),
    ])
    return out * inv_det, ok


# ---------------------------------------------------------------------------
# Vector helpers (last-axis semantics; broadcast-friendly)
# ---------------------------------------------------------------------------

def matmul(a, b, xp=np):
    """a @ b in full float32.  On a GPU a float32 product may otherwise
    run in TF32 (about three decimal digits); the device path pins
    HIGHEST so it matches the host reference."""
    if xp is np:
        return a @ b
    import jax
    return xp.matmul(a, b, precision=jax.lax.Precision.HIGHEST)


def einsum(spec, *operands, xp=np):
    """xp.einsum in full float32 (see matmul)."""
    if xp is np:
        return np.einsum(spec, *operands)
    import jax
    return xp.einsum(spec, *operands, precision=jax.lax.Precision.HIGHEST)


def dot(a, b, xp=np):
    return xp.sum(_f32(a, xp) * _f32(b, xp), axis=-1)


def cross(a, b, xp=np):
    a = _f32(a, xp)
    b = _f32(b, xp)
    return xp.stack([
        a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
    ], axis=-1)


def length(v, xp=np):
    return xp.sqrt(dot(v, v, xp=xp))


def normalize(v, xp=np, eps=0.0):
    v = _f32(v, xp)
    n = length(v, xp=xp)
    if eps:
        n = xp.where(n < eps, xp.ones_like(n), n)
    return v / n[..., None]


def safe_normalize(v, xp=np):
    """Normalize; zero vectors stay zero (no NaN) — for traced code paths."""
    v = _f32(v, xp)
    sq = dot(v, v, xp=xp)
    inv = xp.where(sq > 0, F32(1.0) / xp.sqrt(xp.where(sq > 0, sq, F32(1.0))), F32(0.0))
    return v * inv[..., None]


def transform(v, m, xp=np):
    """Vector4.Transform(v, M) = v·M.  v: (..., 4), m: (..., 4, 4) -> (..., 4).

    Written as explicit left-to-right mul/adds (x·M[0] + y·M[1] + z·M[2] +
    w·M[3]) rather than matmul so the float32 summation order is identical
    to .NET System.Numerics AND identical between the numpy golden reference
    and the XLA device path (a matmul would reassociate, and may run in
    reduced precision on a GPU).
    Supports batched matrices (leading dims broadcast against v's).
    """
    v = _f32(v, xp)
    m = _f32(m, xp)
    return ((v[..., 0:1] * m[..., 0, :] + v[..., 1:2] * m[..., 1, :])
            + v[..., 2:3] * m[..., 2, :]) + v[..., 3:4] * m[..., 3, :]


def transform_point(p, m, xp=np):
    """Vector3.Transform(p, M): (p,1)·M, returns xyz (w not divided —
    matches System.Numerics, which assumes affine M for Vector3).
    Explicit .NET summation order; batched matrices broadcast."""
    p = _f32(p, xp)
    m = _f32(m, xp)
    return ((p[..., 0:1] * m[..., 0, :3] + p[..., 1:2] * m[..., 1, :3])
            + p[..., 2:3] * m[..., 2, :3]) + m[..., 3, :3]


def transform_normal(n, m, xp=np):
    """Vector3.TransformNormal(n, M) = n · M[0:3,0:3] (.NET order; batched)."""
    n = _f32(n, xp)
    m = _f32(m, xp)
    return (n[..., 0:1] * m[..., 0, :3] + n[..., 1:2] * m[..., 1, :3]) \
        + n[..., 2:3] * m[..., 2, :3]


def homogenize(p, xp=np):
    """(..., 3) points -> (..., 4) with w=1."""
    p = _f32(p, xp)
    return xp.concatenate([p, xp.ones(p.shape[:-1] + (1,), dtype=xp.float32)], axis=-1)


# ---------------------------------------------------------------------------
# Quaternions — (x, y, z, w), System.Numerics semantics
# ---------------------------------------------------------------------------

QUAT_IDENTITY = np.array([0.0, 0.0, 0.0, 1.0], dtype=F32)


def quat_from_axis_angle(axis, angle, xp=np):
    axis = _f32(axis, xp)
    half = _f32(angle, xp) * F32(0.5)
    s = xp.sin(half)
    return xp.concatenate([axis * s, xp.cos(half)[None]], axis=-1)


def quat_from_yaw_pitch_roll(yaw, pitch, roll, xp=np):
    """Quaternion.CreateFromYawPitchRoll (yaw about Y, pitch about X, roll about Z)."""
    half_y = _f32(yaw, xp) * F32(0.5)
    half_p = _f32(pitch, xp) * F32(0.5)
    half_r = _f32(roll, xp) * F32(0.5)
    sy, cy = xp.sin(half_y), xp.cos(half_y)
    sp, cp = xp.sin(half_p), xp.cos(half_p)
    sr, cr = xp.sin(half_r), xp.cos(half_r)
    return xp.stack([
        cy * sp * cr + sy * cp * sr,
        sy * cp * cr - cy * sp * sr,
        cy * cp * sr - sy * sp * cr,
        cy * cp * cr + sy * sp * sr,
    ], axis=-1)


def quat_mul(q1, q2, xp=np):
    """Hamilton product q1⊗q2 (System.Numerics operator*): rotation q2 is
    applied first, then q1, under quat_rotate's action."""
    q1 = _f32(q1, xp)
    q2 = _f32(q2, xp)
    x1, y1, z1, w1 = q1[..., 0], q1[..., 1], q1[..., 2], q1[..., 3]
    x2, y2, z2, w2 = q2[..., 0], q2[..., 1], q2[..., 2], q2[..., 3]
    return xp.stack([
        x1 * w2 + x2 * w1 + (y1 * z2 - z1 * y2),
        y1 * w2 + y2 * w1 + (z1 * x2 - x1 * z2),
        z1 * w2 + z2 * w1 + (x1 * y2 - y1 * x2),
        w1 * w2 - (x1 * x2 + y1 * y2 + z1 * z2),
    ], axis=-1)


def quat_conjugate(q, xp=np):
    q = _f32(q, xp)
    return xp.stack([-q[..., 0], -q[..., 1], -q[..., 2], q[..., 3]], axis=-1)


def quat_rotate(v, q, xp=np):
    """Vector3.Transform(v, q): t = 2 (q.xyz × v); v' = v + w·t + q.xyz × t."""
    v = _f32(v, xp)
    q = _f32(q, xp)
    qv = q[..., :3]
    w = q[..., 3:4]
    t = F32(2.0) * cross(qv, v, xp=xp)
    return v + w * t + cross(qv, t, xp=xp)


def quat_slerp(q1, q2, t, xp=np):
    """Quaternion.Slerp with the .NET lerp fallback for near-parallel quats."""
    q1 = _f32(q1, xp)
    q2 = _f32(q2, xp)
    t = _f32(t, xp)
    cos_omega = xp.sum(q1 * q2, axis=-1)
    flip = cos_omega < 0
    cos_omega = xp.abs(cos_omega)
    use_lerp = cos_omega > F32(1.0 - 1e-6)
    omega = xp.arccos(xp.clip(cos_omega, -1.0, 1.0))
    inv_sin = F32(1.0) / xp.where(use_lerp, F32(1.0), xp.sin(omega))
    s1 = xp.where(use_lerp, F32(1.0) - t, xp.sin((F32(1.0) - t) * omega) * inv_sin)
    s2 = xp.where(use_lerp, t, xp.sin(t * omega) * inv_sin)
    s2 = xp.where(flip, -s2, s2)
    return q1 * s1[..., None] + q2 * s2[..., None]


def quat_to_euler_degrees(q, xp=np):
    """Camera.GetEulerAngles (Camera.cs:33-61): returns (pitch_x, yaw_y, roll_z)
    in degrees from a quaternion."""
    q = _f32(q, xp)
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    two = F32(2.0)
    one = F32(1.0)
    # Roll (Z)
    sinr_cosp = two * (w * z + x * y)
    cosr_cosp = one - two * (z * z + x * x)
    roll = xp.arctan2(sinr_cosp, cosr_cosp)
    # Pitch (X) with copysign clamp
    sinp = two * (w * x - y * z)
    pitch = xp.where(
        xp.abs(sinp) >= one,
        xp.sign(sinp) * F32(np.pi / 2),
        xp.arcsin(xp.clip(sinp, -1.0, 1.0)),
    )
    # Yaw (Y)
    siny_cosp = two * (w * y + z * x)
    cosy_cosp = one - two * (x * x + y * y)
    yaw = xp.arctan2(siny_cosp, cosy_cosp)
    rad2deg = F32(180.0 / np.pi)
    return xp.stack([pitch * rad2deg, yaw * rad2deg, roll * rad2deg], axis=-1)


def euler_degrees_to_direction(euler_degrees, xp=np):
    """Renderer.EulerToDirection (Renderer.cs:967-972): -UnitZ rotated by
    CreateFromYawPitchRoll(yawY, pitchX, rollZ), normalized."""
    e = _f32(euler_degrees, xp) * F32(np.pi / 180.0)
    m = matrix_from_yaw_pitch_roll(e[1], e[0], e[2], xp=xp)
    d = transform_normal(xp.asarray([0.0, 0.0, -1.0], dtype=xp.float32), m, xp=xp)
    return normalize(d, xp=xp)
