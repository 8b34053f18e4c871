"""Morph targets (blend shapes) on device.

glTF primitives carry `targets` (per-vertex POSITION/NORMAL deltas) and
animated mesh `weights`; Assimp surfaces them as mesh animations.  The
reference ignores them entirely — its only animation is the flip-book
frame swap (/root/reference/ModelLoader.cs:331-348) — so this is
beyond-reference importer completeness, same tier as skeletal skinning.

The design mirrors ops/skinning.py: deltas pack once as static
scene buffers (vertex-major (Vm, K, 3) so the weight blend is one
broadcast multiply + K-axis reduce, batched over every morphing vertex
in the scene); weights come from a traced source — an override uniform,
a uniform-clock weight track sampled at uniforms["anim_time"] (two-row
gather + lerp, no searchsorted), or the packed defaults — so weight
changes never recompile or re-upload vertex data.  Applied BEFORE
skinning (the glTF order: morph, then skin).
"""

from __future__ import annotations

from typing import Dict

import numpy as np

F32 = np.float32


def morph_weights(scene: Dict, uniforms: Dict, xp=np):
    """(S, K) blend weights per morphing mesh slot.

    Precedence: uniforms["morph_weights"] (traced override, (S, K) or
    broadcastable) > animated weight track sampled at the traced clock
    (slots without a track keep their defaults) > packed defaults.

    The clock is uniforms["morph_time"] (scalar or per-morph-slot (S,))
    when present, else uniforms["anim_time"].  anim_time may also be the
    per-SKIN clock vector (ops/skinning.skin_matrices) whose length is
    unrelated to S — in that case morph slots read its first element
    (one shared clock); pass "morph_time" for per-slot morph clocks."""
    dflt = xp.asarray(scene["morph_default_weights"], F32)   # (S, K)
    S, K = dflt.shape
    if "morph_weights" in uniforms:
        w = xp.asarray(uniforms["morph_weights"], F32)
        return xp.broadcast_to(xp.atleast_2d(w), (S, K))
    w = dflt
    if "morph_weight_tracks" in scene:
        t = uniforms.get("morph_time",
                         uniforms.get("anim_time", 0.0))
        t = xp.asarray(t, F32).reshape(-1)
        t = (xp.broadcast_to(t, (S,)) if t.shape[0] in (1, S)
             else xp.broadcast_to(t[:1], (S,)))
        nf = xp.asarray(scene["morph_track_frames"], np.int32)  # (S,)
        nfc = xp.maximum(nf, 1)
        frame = t * xp.asarray(scene["morph_rate"], F32)
        f0 = xp.floor(frame)
        a = (frame - f0)[..., None].astype(F32)
        i0 = (f0.astype(np.int32) % nfc + nfc) % nfc
        i1 = (i0 + 1) % nfc
        tr = xp.asarray(scene["morph_weight_tracks"], F32)   # (S, Fmax, K)
        s = xp.arange(S)
        anim = tr[s, i0] + (tr[s, i1] - tr[s, i0]) * a
        w = xp.where((nf > 0)[:, None], anim, w)
    return w


def apply_morphs(vin: Dict, scene: Dict, uniforms: Dict, xp=np) -> Dict:
    """Displace morphing vertices' position (and normal, renormalized)
    by the weighted sum of their target deltas."""
    vidx = xp.asarray(scene["morph_vert_index"], np.int32)   # (Vm,)
    slot = xp.asarray(scene["morph_slot"], np.int32)         # (Vm,)
    w = morph_weights(scene, uniforms, xp=xp)                # (S, K)
    wv = xp.take(w, slot, axis=0)                            # (Vm, K)
    dp = xp.asarray(scene["morph_deltas_pos"], F32)          # (Vm, K, 3)
    new_pos = xp.take(vin["position"], vidx, axis=0) \
        + xp.sum(dp * wv[..., None], axis=1)
    out = dict(vin)
    new_nrm = None
    if "morph_deltas_nrm" in scene:
        dn = xp.asarray(scene["morph_deltas_nrm"], F32)
        n = xp.take(vin["normal"], vidx, axis=0) \
            + xp.sum(dn * wv[..., None], axis=1)
        new_nrm = n / xp.sqrt(xp.maximum(
            xp.sum(n * n, axis=-1, keepdims=True), F32(1e-30)))
    if xp is np:
        p = np.array(vin["position"])
        p[vidx] = new_pos
        out["position"] = p
        if new_nrm is not None:
            n = np.array(vin["normal"])
            n[vidx] = new_nrm
            out["normal"] = n
    else:
        out["position"] = vin["position"].at[vidx].set(new_pos)
        if new_nrm is not None:
            out["normal"] = vin["normal"].at[vidx].set(new_nrm)
    return out


def morphed_positions_np(morph: Dict, positions: np.ndarray,
                         weights: np.ndarray) -> np.ndarray:
    """Host-side reference: one instance's morphed positions under
    explicit (K,) weights.  Used for conservative culling bounds and by
    tests."""
    dp = np.asarray(morph["pos"], F32)                       # (K, V, 3)
    w = np.asarray(weights, F32).reshape(-1)[: dp.shape[0]]
    return np.asarray(positions, F32) + np.einsum("kvc,k->vc", dp, w)
