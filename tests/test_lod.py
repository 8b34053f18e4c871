"""Mesh LOD tests (ROADMAP r3 / VERDICT r2 #9): screen-size-driven index
selection — near view bit-identical to the LOD-less scene, far view on
decimated index sets with ≥2× less triangle work."""

import numpy as np

import jax

from softwarerenderer_tpu import RenderParams
from softwarerenderer_tpu.engine import default_frame_uniforms, render_frame
from softwarerenderer_tpu.models import primitives, scene as scene_mod
from softwarerenderer_tpu.ops import lod
from softwarerenderer_tpu.utils import mathlib as ml

W, H = 160, 120
F32 = np.float32


def _sphere_scene(with_lods, z=-1.5):
    base = primitives.uv_sphere(0.8, rings=12, sectors=18)
    mesh = lod.add_lods(base, cells=(6, 3), px=(40.0, 15.0)) \
        if with_lods else base
    return scene_mod.build_scene_buffers(
        [scene_mod.MeshInstance(mesh, ml.translation([0.0, 0.0, z]))])


def test_decimate_indices_reduces_and_stays_valid():
    m = primitives.uv_sphere(1.0, rings=16, sectors=24)
    t0 = m["indices"].shape[0]
    d1 = lod.decimate_indices(m["position"], m["indices"], cells=6)
    d2 = lod.decimate_indices(m["position"], m["indices"], cells=3)
    assert 0 < d2.shape[0] < d1.shape[0] < t0
    assert d1.shape[0] <= t0 // 2
    assert d1.min() >= 0 and d1.max() < m["position"].shape[0]


def test_near_view_identical_to_lodless():
    """Projected radius 0.8/1.5·60 = 32 px… > level-1 threshold? 32 < 40
    selects level 1 — so use a closer camera: dist 1.0 → 48 px → level 0
    → the LOD scene's frame is EXACTLY the LOD-less frame."""
    params = RenderParams(width=W, height=H)
    u = default_frame_uniforms(W, H)
    u["camera_position"] = np.float32([0.0, 0.0, -0.5])   # dist 1.0
    c0, d0 = jax.jit(lambda s, u: render_frame(s, u, params))(
        _sphere_scene(False), u)
    scene = _sphere_scene(True)
    mask = np.asarray(lod.lod_tri_mask(scene, u, H, xp=np))
    lvl = np.asarray(scene["tri_lod_level"])
    assert (lvl[mask] == 0).all()            # full detail selected
    c1, d1 = jax.jit(lambda s, u: render_frame(s, u, params))(scene, u)
    np.testing.assert_array_equal(np.asarray(c0), np.asarray(c1))
    np.testing.assert_array_equal(np.asarray(d0), np.asarray(d1))


def test_far_view_cuts_triangle_work_2x():
    scene = _sphere_scene(True)
    u = default_frame_uniforms(W, H)
    u["camera_position"] = np.float32([0.0, 0.0, 20.0])   # dist 21.5
    mask = np.asarray(lod.lod_tri_mask(scene, u, H, xp=np))
    lvl = np.asarray(scene["tri_lod_level"])
    assert (lvl[mask] == 2).all()            # coarsest level selected
    assert mask.sum() * 2 <= (lvl == 0).sum(), \
        (mask.sum(), (lvl == 0).sum())
    # and the decimated sphere still renders
    params = RenderParams(width=W, height=H)
    c, d = jax.jit(lambda s, u: render_frame(s, u, params))(scene, u)
    assert (np.asarray(d) > -1e30).sum() > 4


def test_mid_distance_selects_middle_level():
    scene = _sphere_scene(True)
    u = default_frame_uniforms(W, H)
    u["camera_position"] = np.float32([0.0, 0.0, 0.5])    # dist 2 → 24 px
    mask = np.asarray(lod.lod_tri_mask(scene, u, H, xp=np))
    lvl = np.asarray(scene["tri_lod_level"])
    assert (lvl[mask] == 1).all()


def test_lod_jit_selection_is_traced():
    """Moving the camera switches levels without recompiling."""
    scene = _sphere_scene(True)
    params = RenderParams(width=W, height=H)
    fn = jax.jit(lambda s, u: render_frame(s, u, params))
    u = default_frame_uniforms(W, H)
    u["camera_position"] = np.float32([0.0, 0.0, -0.5])
    fn(scene, u)
    n0 = fn._cache_size()
    u["camera_position"] = np.float32([0.0, 0.0, 30.0])
    fn(scene, u)
    assert fn._cache_size() == n0


def test_lod_sharded_matches_single_device():
    """The LOD mask applies identically under fb/tri sharding (the level
    selector runs replicated per shard)."""
    from softwarerenderer_tpu.parallel import (make_mesh,
                                               render_frame_sharded,
                                               shard_scene_triangles)

    params = RenderParams(width=128, height=96, tile_h=8, tile_w=64,
                          tile_group=4, chunk=16)
    scene = _sphere_scene(True, z=-8.0)       # mid LOD at this distance
    u = default_frame_uniforms(128, 96)
    u["camera_position"] = np.float32([0.0, 0.0, 0.0])

    ref_c, ref_d = map(np.asarray, jax.jit(
        lambda s, u: render_frame(s, u, params.replace(width=128,
                                                       height=96)))(
        scene, u))
    sscene = shard_scene_triangles(scene, 2)
    mesh = make_mesh(2, 2)
    with mesh:
        c, d = map(np.asarray, jax.jit(
            lambda s, u: render_frame_sharded(
                s, u, params.replace(width=128, height=96), mesh))(
            sscene, u))
    assert (np.abs(c - ref_c).max(axis=-1) <= 1e-6).all()
    assert (np.abs(d - ref_d) <= 1e-6).all()


def test_active_cap_exact_with_suggested_bound():
    """Compaction (geometry.compact_triangles via params.active_cap) at
    the static suggested_active_cap bound is EXACTLY the uncompacted
    frame — the stable partition preserves submission order, and the
    lexicographic fold is invariant under the index remap."""
    scene = _sphere_scene(True)
    cap = lod.suggested_active_cap(scene)
    n_slots = 2 * scene["tri_mesh_id"].shape[0]
    assert cap < n_slots                      # LOD levels compact away
    u = default_frame_uniforms(W, H)
    u["camera_position"] = np.float32([0.0, 0.0, 0.5])   # mid level
    p0 = RenderParams(width=W, height=H)
    c0, d0 = jax.jit(lambda s, u: render_frame(s, u, p0))(scene, u)
    p1 = p0.replace(active_cap=cap)
    c1, d1 = jax.jit(lambda s, u: render_frame(s, u, p1))(scene, u)
    # Cross-COMPILATION comparison (two different XLA programs): FMA
    # contraction may wobble depth by an ulp on edge pixels (PARITY.md
    # D4), so the assert is the same ≤1e-6 used by the sharded-parity
    # tests, not bit equality.
    assert (np.abs(np.asarray(c0) - np.asarray(c1)).max(axis=-1)
            <= 1e-6).all()
    assert (np.abs(np.asarray(d0) - np.asarray(d1)) <= 1e-6).all()


def test_suggested_cap_is_sound():
    """The bound covers the frame's valid slots at every distance (one
    level active per mesh ⇒ can never overflow)."""
    scene = _sphere_scene(True)
    cap = lod.suggested_active_cap(scene)
    u = default_frame_uniforms(W, H)
    for z in (-0.5, 0.5, 20.0):
        u["camera_position"] = np.float32([0.0, 0.0, z])
        mask = np.asarray(lod.lod_tri_mask(scene, u, H, xp=np))
        assert 2 * mask.sum() <= cap


def test_suggested_cap_without_lods_is_all_slots():
    scene = _sphere_scene(False)
    assert lod.suggested_active_cap(scene) \
        == 2 * scene["tri_mesh_id"].shape[0]


def test_active_cap_overflow_drops_last_submitted():
    """cap smaller than the valid count deterministically drops the
    LAST-submitted triangles (documented contract)."""
    from softwarerenderer_tpu.models.scene import MeshInstance
    # two stacked planes: red behind (submitted first), green in front
    red = dict(plane_colored([1.0, 0.0, 0.0, 1.0]))
    green = dict(plane_colored([0.0, 1.0, 0.0, 1.0]))
    sc = scene_mod.build_scene_buffers([
        MeshInstance(red, ml.translation([0.0, 0.0, -3.0])),
        MeshInstance(green, ml.translation([0.0, 0.0, -2.0])),
    ])
    sc_red = scene_mod.build_scene_buffers([
        MeshInstance(red, ml.translation([0.0, 0.0, -3.0])),
    ])
    from softwarerenderer_tpu.config import CullMode
    u = default_frame_uniforms(W, H)
    p_full = RenderParams(width=W, height=H, cull_mode=CullMode.NONE)
    c_full, d_full = jax.jit(lambda s, u: render_frame(s, u, p_full))(
        sc, u)
    c_red, d_red = jax.jit(lambda s, u: render_frame(s, u, p_full))(
        sc_red, u)
    assert np.abs(np.asarray(c_full) - np.asarray(c_red)).max() > 0.1
    # cap = 2 slots = the red plane's two triangles only: the frame is
    # the red-only scene's frame (green, submitted later, is dropped)
    p_cap = p_full.replace(active_cap=2)
    c_cap, d_cap = jax.jit(lambda s, u: render_frame(s, u, p_cap))(sc, u)
    assert (np.abs(np.asarray(c_cap) - np.asarray(c_red)).max(axis=-1)
            <= 1e-6).all()
    assert (np.abs(np.asarray(d_cap) - np.asarray(d_red)) <= 1e-6).all()


def plane_colored(rgba):
    """An xy-facing two-triangle quad with a flat vertex color."""
    pos = np.float32([[-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0]])
    return {
        "name": "quad",
        "position": pos,
        "uv": np.zeros((4, 2), np.float32),
        "normal": np.tile(np.float32([[0, 0, 1]]), (4, 1)),
        "color": np.tile(np.float32(rgba), (4, 1)),
        "indices": np.int32([[0, 2, 1], [0, 3, 2]]),
        "bounds_center": np.zeros(3, np.float32),
        "bounds_radius": 1.5,
    }


def test_active_cap_sharded_and_ring_parity():
    """params.active_cap composes with BOTH scale-out modes: the (fb, tri)
    sharded path and the ring pass match the compacted single-device frame
    to 1e-6 (compaction is per-shard order-preserving, so the global
    lexicographic winner is unchanged)."""
    from softwarerenderer_tpu.parallel import (make_mesh,
                                               render_frame_sharded,
                                               shard_scene_triangles)
    from softwarerenderer_tpu.parallel.ring import (make_ring_mesh,
                                                    render_frame_ring)

    scene = _sphere_scene(True, z=-8.0)
    cap = lod.suggested_active_cap(scene)
    params = RenderParams(width=128, height=96, tile_h=8, tile_w=64,
                          tile_group=4, chunk=16, active_cap=cap)
    u = default_frame_uniforms(128, 96)
    u["camera_position"] = np.float32([0.0, 0.0, 0.0])

    ref_c, ref_d = map(np.asarray, jax.jit(
        lambda s, u: render_frame(s, u, params))(scene, u))

    sscene = shard_scene_triangles(scene, 2)
    mesh = make_mesh(2, 2)
    with mesh:
        c, d = map(np.asarray, jax.jit(
            lambda s, u: render_frame_sharded(s, u, params, mesh))(
            sscene, u))
    assert (np.abs(c - ref_c).max(axis=-1) <= 1e-6).all()
    assert (np.abs(d - ref_d) <= 1e-6).all()

    rmesh = make_ring_mesh(2)
    rscene = shard_scene_triangles(scene, 2)
    with rmesh:
        c, d = map(np.asarray, jax.jit(
            lambda s, u: render_frame_ring(s, u, params, rmesh))(
            rscene, u))
    assert (np.abs(c - ref_c).max(axis=-1) <= 1e-6).all()
    assert (np.abs(d - ref_d) <= 1e-6).all()


def test_active_cap_stats_overflow_counter():
    """active_cap_stats returns the traced dropped-slot count: 0 at the
    sound bound (frame exact), positive under a too-tight cap."""
    scene = _sphere_scene(True)
    u = default_frame_uniforms(W, H)
    u["camera_position"] = np.float32([0.0, 0.0, 0.5])
    cap = lod.suggested_active_cap(scene)
    p_ok = RenderParams(width=W, height=H, active_cap=cap,
                        active_cap_stats=True)
    c, d, stats = jax.jit(lambda s, u: render_frame(s, u, p_ok))(scene, u)
    assert int(stats["active_cap_overflow"]) == 0
    p_tight = p_ok.replace(active_cap=64)
    _, _, stats = jax.jit(lambda s, u: render_frame(s, u, p_tight))(
        scene, u)
    assert int(stats["active_cap_overflow"]) > 0
    # stats without a cap is MEASUREMENT mode: live_pairs only
    _, _, stats = jax.jit(lambda s, u: render_frame(
        s, u, RenderParams(width=W, height=H, active_cap_stats=True)))(
        scene, u)
    assert int(stats["live_pairs"]) > 0
    assert "active_cap_overflow" not in stats
    # but stats still refuses to compose with ssaa/post-fx
    import pytest
    with pytest.raises(ValueError):
        render_frame(scene, u, RenderParams(width=W, height=H, ssaa=2,
                                            active_cap_stats=True))


def test_active_cap_through_pallas_interpret():
    """Compaction feeds the Pallas tile kernel (interpret mode on CPU —
    the kernel code path): compacted == uncompacted through the SAME
    compilation family, bit-exact."""
    scene = _sphere_scene(True)
    cap = lod.suggested_active_cap(scene)
    u = default_frame_uniforms(W, H)
    u["camera_position"] = np.float32([0.0, 0.0, 0.5])
    p0 = RenderParams(width=W, height=H, pallas_interpret=True)
    c0, d0 = jax.jit(lambda s, u: render_frame(s, u, p0))(scene, u)
    p1 = p0.replace(active_cap=cap)
    c1, d1 = jax.jit(lambda s, u: render_frame(s, u, p1))(scene, u)
    assert (np.abs(np.asarray(c0) - np.asarray(c1)).max(axis=-1)
            <= 1e-6).all()
    assert (np.abs(np.asarray(d0) - np.asarray(d1)) <= 1e-6).all()


def test_pair_cap_engine_exact_with_stats():
    """params.pair_cap (live-pair table truncation) composes with
    active_cap in render_frame: with fitting caps the frame matches the
    uncapped one to 1e-6 and both overflow counters read 0; a starved
    pair_cap reports a positive pair_cap_overflow."""
    scene = _sphere_scene(True, z=-3.0)
    u = default_frame_uniforms(W, H)
    p0 = RenderParams(width=W, height=H)
    c0, d0 = jax.jit(lambda s, u: render_frame(s, u, p0))(scene, u)
    cap = lod.suggested_active_cap(scene)
    p1 = p0.replace(active_cap=cap, pair_cap=cap * p0.span_cap // 2,
                    active_cap_stats=True)
    c1, d1, stats = jax.jit(lambda s, u: render_frame(s, u, p1))(scene, u)
    assert int(stats["active_cap_overflow"]) == 0
    assert int(stats["pair_cap_overflow"]) == 0
    assert int(stats["live_pairs"]) > 0
    assert int(stats["live_pairs"]) <= p1.pair_cap
    assert (np.abs(np.asarray(c0) - np.asarray(c1)).max(axis=-1)
            <= 1e-6).all()
    assert (np.abs(np.asarray(d0) - np.asarray(d1)) <= 1e-6).all()
    # starved pair table: the counter reports the dropped pairs
    p2 = p1.replace(pair_cap=64)
    _, _, stats2 = jax.jit(lambda s, u: render_frame(s, u, p2))(scene, u)
    assert int(stats2["pair_cap_overflow"]) > 0
    assert int(stats2["pair_cap_overflow"]) == \
        int(stats2["live_pairs"]) - 64
    # measurement mode: stats without any cap set reports live_pairs
    p3 = p0.replace(active_cap_stats=True)
    _, _, stats3 = jax.jit(lambda s, u: render_frame(s, u, p3))(scene, u)
    assert int(stats3["live_pairs"]) == int(stats["live_pairs"])
    assert "active_cap_overflow" not in stats3
    assert "pair_cap_overflow" not in stats3


def test_compaction_caps_pallas_interpret_exact():
    """active_cap + pair_cap through the tile-kernel code path
    (interpret mode) on a scene whose multi-tile triangles go GLOBAL:
    the overflow counters read 0 and the frame is bit-identical to the
    uncapped kernel frame."""
    scene = _sphere_scene(True)
    cap = lod.suggested_active_cap(scene)
    u = default_frame_uniforms(W, H)
    u["camera_position"] = np.float32([0.0, 0.0, 0.5])
    # span_cap=1 forces multi-tile triangles GLOBAL so the kernel's
    # global walk carries rows at this tiny frame size (default span_cap
    # 8 == the whole 2x4 tile grid: nothing is ever global there).
    base = RenderParams(width=W, height=H, pallas_interpret=True,
                        span_cap=1)
    c0, d0 = jax.jit(lambda s, u: render_frame(s, u, base))(scene, u)
    p2 = base.replace(active_cap=cap, pair_cap=-(-cap * 2 // 128) * 128,
                      active_cap_stats=True)
    c2, d2, stats = jax.jit(lambda s, u: render_frame(s, u, p2))(scene, u)
    assert int(stats["active_cap_overflow"]) == 0
    assert int(stats["pair_cap_overflow"]) == 0
    assert int(stats["live_globals"]) > 0
    np.testing.assert_array_equal(np.asarray(c0), np.asarray(c2))
    np.testing.assert_array_equal(np.asarray(d0), np.asarray(d2))


def test_geom_cap_exact_with_suggested_bound():
    """Pre-geometry compaction (params.geom_cap): the build stage runs on
    the masked-in input triangles only, and at the sound bound
    (lod.suggested_geom_cap) the frame matches the uncapped one — alone
    and composed with active_cap."""
    scene = _sphere_scene(True)
    gcap = lod.suggested_geom_cap(scene)
    assert gcap < scene["tri_mesh_id"].shape[0]   # LOD levels compact away
    assert gcap == lod.suggested_active_cap(scene) // 2
    u = default_frame_uniforms(W, H)
    u["camera_position"] = np.float32([0.0, 0.0, 0.5])   # mid level
    p0 = RenderParams(width=W, height=H)
    c0, d0 = jax.jit(lambda s, u: render_frame(s, u, p0))(scene, u)
    p1 = p0.replace(geom_cap=gcap)
    c1, d1 = jax.jit(lambda s, u: render_frame(s, u, p1))(scene, u)
    assert (np.abs(np.asarray(c0) - np.asarray(c1)).max(axis=-1)
            <= 1e-6).all()
    assert (np.abs(np.asarray(d0) - np.asarray(d1)) <= 1e-6).all()
    # composed with active_cap (which now compacts the post-cull set of
    # the ALREADY pre-compacted slots) through the kernel code path
    p2 = p1.replace(active_cap=lod.suggested_active_cap(scene),
                    pallas_interpret=True)
    c2, d2 = jax.jit(lambda s, u: render_frame(s, u, p2))(scene, u)
    assert (np.abs(np.asarray(c0) - np.asarray(c2)).max(axis=-1)
            <= 1e-6).all()
    assert (np.abs(np.asarray(d0) - np.asarray(d2)) <= 1e-6).all()


def test_geom_cap_overflow_counter_and_order():
    """geom_cap overflow: the counter reads 0 at the sound bound and
    positive under a starved cap; dropped triangles are the LAST
    submitted (deterministic), mirroring active_cap's contract."""
    from softwarerenderer_tpu.config import CullMode
    from softwarerenderer_tpu.models.scene import MeshInstance
    scene = _sphere_scene(True)
    u = default_frame_uniforms(W, H)
    u["camera_position"] = np.float32([0.0, 0.0, 0.5])
    p_ok = RenderParams(width=W, height=H,
                        geom_cap=lod.suggested_geom_cap(scene),
                        active_cap_stats=True)
    _, _, stats = jax.jit(lambda s, u: render_frame(s, u, p_ok))(scene, u)
    assert int(stats["geom_cap_overflow"]) == 0
    p_tight = p_ok.replace(geom_cap=32)
    _, _, stats = jax.jit(lambda s, u: render_frame(s, u, p_tight))(
        scene, u)
    assert int(stats["geom_cap_overflow"]) > 0
    # drop order: red (submitted first) survives a 2-triangle cap
    red = dict(plane_colored([1.0, 0.0, 0.0, 1.0]))
    green = dict(plane_colored([0.0, 1.0, 0.0, 1.0]))
    sc = scene_mod.build_scene_buffers([
        MeshInstance(red, ml.translation([0.0, 0.0, -3.0])),
        MeshInstance(green, ml.translation([0.0, 0.0, -2.0])),
    ])
    sc_red = scene_mod.build_scene_buffers([
        MeshInstance(red, ml.translation([0.0, 0.0, -3.0])),
    ])
    u2 = default_frame_uniforms(W, H)
    p_full = RenderParams(width=W, height=H, cull_mode=CullMode.NONE)
    c_red, d_red = jax.jit(lambda s, u: render_frame(s, u, p_full))(
        sc_red, u2)
    p_cap = p_full.replace(geom_cap=2)
    c_cap, d_cap = jax.jit(lambda s, u: render_frame(s, u, p_cap))(sc, u2)
    assert (np.abs(np.asarray(c_cap) - np.asarray(c_red)).max(axis=-1)
            <= 1e-6).all()
    assert (np.abs(np.asarray(d_cap) - np.asarray(d_red)) <= 1e-6).all()


def test_geom_cap_sharded_and_ring_parity():
    """params.geom_cap composes with BOTH scale-out modes: per-shard
    pre-geometry compaction is order-preserving inside each shard's
    global-offset window, so the (fb, tri) sharded path and the ring
    pass match the single-device frame to 1e-6."""
    from softwarerenderer_tpu.parallel import (make_mesh,
                                               render_frame_sharded,
                                               shard_scene_triangles)
    from softwarerenderer_tpu.parallel.ring import (make_ring_mesh,
                                                    render_frame_ring)

    scene = _sphere_scene(True, z=-8.0)
    gcap = lod.suggested_geom_cap(scene)   # global bound ≥ any shard's
    params = RenderParams(width=128, height=96, tile_h=8, tile_w=64,
                          tile_group=4, chunk=16, geom_cap=gcap,
                          active_cap=lod.suggested_active_cap(scene))
    u = default_frame_uniforms(128, 96)
    u["camera_position"] = np.float32([0.0, 0.0, 0.0])

    ref_c, ref_d = map(np.asarray, jax.jit(
        lambda s, u: render_frame(
            s, u, params.replace(geom_cap=0, active_cap=0)))(scene, u))

    sscene = shard_scene_triangles(scene, 2)
    mesh = make_mesh(2, 2)
    with mesh:
        c, d = map(np.asarray, jax.jit(
            lambda s, u: render_frame_sharded(s, u, params, mesh))(
            sscene, u))
    assert (np.abs(c - ref_c).max(axis=-1) <= 1e-6).all()
    assert (np.abs(d - ref_d) <= 1e-6).all()

    rmesh = make_ring_mesh(2)
    rscene = shard_scene_triangles(scene, 2)
    with rmesh:
        c, d = map(np.asarray, jax.jit(
            lambda s, u: render_frame_ring(s, u, params, rmesh))(
            rscene, u))
    assert (np.abs(c - ref_c).max(axis=-1) <= 1e-6).all()
    assert (np.abs(d - ref_d) <= 1e-6).all()


def test_geom_cap_with_mipmaps_and_texture():
    """geom_cap re-routes every per-triangle consumer (texture ids, mip
    uv-cross, material channels): a textured + mipped LOD scene matches
    its uncapped frame."""
    import functools
    from softwarerenderer_tpu.ops import texture as tex_ops
    checker = np.asarray(tex_ops.checkerboard(64, 8)["data"])
    base = primitives.uv_sphere(0.8, rings=12, sectors=18)
    mesh = lod.add_lods(base, cells=(6, 3), px=(40.0, 15.0))
    insts = [scene_mod.MeshInstance(
        mesh, ml.translation([dx, 0.0, -2.5]), texture=checker)
        for dx in (-1.2, 1.2)]
    scene = scene_mod.build_scene_buffers(insts)
    u = default_frame_uniforms(W, H)
    p0 = RenderParams(width=W, height=H, use_mipmaps=True)
    c0, d0 = jax.jit(functools.partial(render_frame, params=p0))(scene, u)
    p1 = p0.replace(geom_cap=lod.suggested_geom_cap(scene))
    c1, d1 = jax.jit(functools.partial(render_frame, params=p1))(scene, u)
    assert (np.abs(np.asarray(c0) - np.asarray(c1)).max(axis=-1)
            <= 1e-6).all()
    assert (np.abs(np.asarray(d0) - np.asarray(d1)) <= 1e-6).all()


def test_segment_broadcast_matches_take():
    """culling.segment_broadcast: the gather-free mesh->tri broadcast is
    exact for bool/int values, including EMPTY segments (coincident
    starts), and the scene pack publishes consistent tri_seg_starts."""
    import jax.numpy as jnp
    from softwarerenderer_tpu.ops import culling

    counts = [3, 0, 2, 4, 1, 0, 0, 5]
    ids = np.repeat(np.arange(len(counts)), counts).astype(np.int32)
    starts = jnp.asarray(np.searchsorted(ids, np.arange(len(counts))),
                         jnp.int32)
    rng = np.random.default_rng(11)
    ivals = rng.integers(-7, 7, len(counts)).astype(np.int32)
    bvals = ivals > 0
    for vals in (ivals, bvals):
        got = culling.segment_broadcast(jnp.asarray(vals), starts,
                                        len(ids), xp=jnp)
        np.testing.assert_array_equal(np.asarray(got),
                                      np.take(vals, ids))
        assert np.asarray(got).dtype == vals.dtype
    # numpy path = plain take (needs element_ids)
    np.testing.assert_array_equal(
        culling.segment_broadcast(ivals, np.asarray(starts), len(ids),
                                  element_ids=ids, xp=np),
        np.take(ivals, ids))


def test_segment_broadcast_bits_matches_take_bitwise():
    """culling.segment_broadcast_bits: the int32-bitcast delta-cumsum
    float broadcast is BITWISE equal to take — including -0.0, denormals,
    inf and NaN payloads (wrapping s32 arithmetic is exact modular, so
    the bit pattern round-trips regardless of float semantics), empty
    segments, and trailing dims (the (M, 4, 4) model-matrix shape)."""
    import jax.numpy as jnp
    from softwarerenderer_tpu.ops import culling

    counts = [2, 0, 3, 1, 0, 4]
    ids = np.repeat(np.arange(len(counts)), counts).astype(np.int32)
    starts = np.searchsorted(ids, np.arange(len(counts))).astype(np.int32)
    rng = np.random.default_rng(5)
    vals = rng.standard_normal((len(counts), 4, 4)).astype(np.float32)
    vals[0, 0, 0] = -0.0
    vals[2, 1, 2] = np.inf
    vals[3, 3, 3] = np.float32(1e-42)            # denormal
    vals[5, 0, 1] = np.nan
    got = np.asarray(culling.segment_broadcast_bits(
        jnp.asarray(vals), jnp.asarray(starts), len(ids), xp=jnp))
    want = np.take(vals, ids, axis=0)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    # numpy path = plain take
    np.testing.assert_array_equal(
        culling.segment_broadcast_bits(vals, starts, len(ids),
                                       element_ids=ids, xp=np),
        want)


def test_model_matrices_per_vertex_exact():
    """build_scene_buffers publishes vert_seg_starts consistent with
    vert_mesh_id, and model_matrices_per_vertex (the gather-free path
    every render path now uses) is bitwise equal to the take it
    replaces."""
    import jax.numpy as jnp
    from softwarerenderer_tpu.ops import culling

    insts = [scene_mod.MeshInstance(
        primitives.uv_sphere(0.4, rings=6, sectors=8),
        ml.translation([dx, 0.2 * dx, -3.0]))
        for dx in (-1.0, 0.0, 1.0, 2.0)]
    scene = scene_mod.build_scene_buffers(insts)
    assert "vert_seg_starts" in scene
    np.testing.assert_array_equal(
        np.searchsorted(scene["vert_mesh_id"],
                        np.arange(scene["mesh_matrices"].shape[0])),
        scene["vert_seg_starts"])
    dev = {k: jnp.asarray(v) for k, v in scene.items()}
    got = np.asarray(culling.model_matrices_per_vertex(dev, xp=jnp))
    want = np.take(np.asarray(scene["mesh_matrices"]),
                   np.asarray(scene["vert_mesh_id"]), axis=0)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_scene_pack_seg_starts_and_lod_mask_parity():
    """build_scene_buffers publishes tri_seg_starts that reproduce
    tri_mesh_id, and lod_tri_mask's broadcast path equals its take path."""
    import jax
    import jax.numpy as jnp

    base = primitives.uv_sphere(0.6, rings=10, sectors=14)
    mesh = lod.add_lods(base, cells=(6, 3), px=(40.0, 15.0))
    insts = [scene_mod.MeshInstance(mesh, ml.translation([dx, 0.0, -3.0]))
             for dx in (-1.5, 0.0, 1.5)]
    scene = scene_mod.build_scene_buffers(insts)
    assert "tri_seg_starts" in scene
    tmi = np.asarray(scene["tri_mesh_id"])
    ss = np.asarray(scene["tri_seg_starts"])
    np.testing.assert_array_equal(ss, np.searchsorted(tmi, np.arange(3)))

    u = default_frame_uniforms(W, H)
    with_starts = jax.jit(
        lambda s, uu: lod.lod_tri_mask(s, uu, H, xp=jnp))(scene, u)
    no_starts = jax.jit(
        lambda s, uu: lod.lod_tri_mask(s, uu, H, xp=jnp))(
            {k: v for k, v in scene.items() if k != "tri_seg_starts"}, u)
    np.testing.assert_array_equal(np.asarray(with_starts),
                                  np.asarray(no_starts))
