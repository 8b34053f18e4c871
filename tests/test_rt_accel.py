"""Bundle-culled raycast (ops/rt_accel.py): bitwise agreement with the
brute-force raycast, conservative culling, overflow fallback, tie rule."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np

from softwarerenderer_tpu.models import primitives, scene as scene_mod
from softwarerenderer_tpu.ops import rt_accel
from softwarerenderer_tpu.utils import mathlib as ml

rc = importlib.import_module("softwarerenderer_tpu.sim.raycast")


def _soup_world(n=403, seed=0):
    """Random triangle soup scattered in a 20^3 box."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(-10, 10, (n, 3)).astype(np.float32)
    v = base[:, None, :] + rng.uniform(-0.8, 0.8, (n, 3, 3)).astype(
        np.float32)
    pos = v.reshape(-1, 3)
    nrm = np.tile(np.asarray([[0, 1, 0]], np.float32), (3 * n, 1))
    idx = np.arange(3 * n, dtype=np.int32).reshape(n, 3)
    scene = {
        "mesh_matrices": np.eye(4, dtype=np.float32)[None],
        "vert_mesh_id": np.zeros((3 * n,), np.int32),
        "position": pos, "normal": nrm, "indices": idx,
        "tri_mesh_id": np.zeros((n,), np.int32),
    }
    return rc.build_collision_world(scene)


def _coherent_rays(m=64, seed=1):
    """A tight bundle: origins in a small box, directions in a narrow
    cone around +x-ish."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-0.5, 0.5, (m, 3)).astype(np.float32) + [-12, 0, 0]
    d = (np.asarray([1.0, 0.0, 0.0], np.float32)
         + rng.uniform(-0.2, 0.2, (m, 3)).astype(np.float32))
    return jnp.asarray(o), jnp.asarray(d)


def _assert_same(a, b):
    """Winner identity (hit, tri) must be EXACT; derived floats agree to
    fp tolerance — XLA's FMA contraction differs between the two program
    shapes, so last-ulp drift in t/point/normal is expected (the same
    cross-compilation caveat as PARITY.md's constant-folded camera note)."""
    np.testing.assert_array_equal(np.asarray(a["hit"]), np.asarray(b["hit"]))
    np.testing.assert_array_equal(np.asarray(a["tri"]), np.asarray(b["tri"]))
    big = np.finfo(np.float32).max
    for k in ("distance", "point", "normal"):
        av, bv = np.asarray(a[k]), np.asarray(b[k])
        # miss sentinels (float.MaxValue distances) must agree exactly
        np.testing.assert_array_equal(av == big, bv == big, err_msg=k)
        fin = av != big
        np.testing.assert_allclose(np.where(fin, av, 0.0),
                                   np.where(fin, bv, 0.0),
                                   rtol=3e-6, atol=1e-5, err_msg=k)


def test_culled_matches_brute_bitwise():
    world = _soup_world()
    accel = rt_accel.build_rt_accel(world, group=16)
    o, d = _coherent_rays()
    for fm in (rc.FACE_MASK_NONE, rc.FACE_MASK_IGNORE_BACKFACES,
               rc.FACE_MASK_IGNORE_FRONTFACES):
        brute = rc.raycast_batch(o, d, world, face_mask=fm)
        culled = rt_accel.raycast_bundle_culled(
            o, d, world, accel, cap=accel["n_clusters"], face_mask=fm)
        _assert_same(culled, brute)


def test_culled_matches_brute_with_tight_cap():
    """A narrow bundle through a big soup keeps few clusters; a tight
    (but sufficient) cap still reproduces brute bitwise."""
    world = _soup_world(n=1009)
    accel = rt_accel.build_rt_accel(world, group=32)
    o, d = _coherent_rays()
    surv = int(rt_accel.bundle_survivor_count(o, d, world, accel))
    assert surv < accel["n_clusters"]  # culling actually culls
    brute = rc.raycast_batch(o, d, world)
    culled = rt_accel.raycast_bundle_culled(o, d, world, accel, cap=surv)
    _assert_same(culled, brute)


def test_overflow_falls_back_to_brute():
    """cap smaller than the survivor count must still be exact (the
    lax.cond fallback) — the cap is a perf knob, not a correctness knob."""
    world = _soup_world()
    accel = rt_accel.build_rt_accel(world, group=16)
    o, d = _coherent_rays()
    assert int(rt_accel.bundle_survivor_count(o, d, world, accel)) > 1
    brute = rc.raycast_batch(o, d, world)
    culled = rt_accel.raycast_bundle_culled(o, d, world, accel, cap=1)
    _assert_same(culled, brute)


def test_tri_mask_and_tie_rule():
    """tri_mask excludes geometry before culling, and exact-duplicate
    triangles resolve to the LOWEST global index, as raycast_batch."""
    tri = np.asarray([[0, 0, 0], [2, 0, 0], [0, 2, 0]], np.float32)
    pos = np.concatenate([tri, tri], axis=0)  # two identical triangles
    scene = {
        "mesh_matrices": np.eye(4, dtype=np.float32)[None],
        "vert_mesh_id": np.zeros((6,), np.int32),
        "position": pos,
        "normal": np.tile(np.asarray([[0, 0, 1]], np.float32), (6, 1)),
        "indices": np.asarray([[0, 1, 2], [3, 4, 5]], np.int32),
        "tri_mesh_id": np.zeros((2,), np.int32),
    }
    world = rc.build_collision_world(scene)
    accel = rt_accel.build_rt_accel(world, group=2)
    o = jnp.asarray([[0.4, 0.4, 5.0]], jnp.float32)
    d = jnp.asarray([[0.0, 0.0, -1.0]], jnp.float32)

    hit = rt_accel.raycast_bundle_culled(o, d, world, accel, cap=1,
                                         face_mask=rc.FACE_MASK_NONE)
    assert bool(hit["hit"][0]) and int(hit["tri"][0]) == 0

    masked = rt_accel.raycast_bundle_culled(
        o, d, world, accel, cap=1, face_mask=rc.FACE_MASK_NONE,
        tri_mask=jnp.asarray([False, True]))
    assert bool(masked["hit"][0]) and int(masked["tri"][0]) == 1


def test_cluster_aabbs_contain_triangles():
    world = _soup_world(n=97)
    accel = rt_accel.build_rt_accel(world, group=16)
    G, nc = accel["group"], accel["n_clusters"]
    for key in ("v0",):
        pts = np.asarray(accel[key]).reshape(nc, G, 3)
        ok = np.asarray(accel["slot_ok"]).reshape(nc, G)
        lo = np.asarray(accel["cl_lo"])[:, None]
        hi = np.asarray(accel["cl_hi"])[:, None]
        sel = np.broadcast_to(ok[..., None], pts.shape)
        assert np.all(pts[sel] >= np.broadcast_to(lo, pts.shape)[sel] - 1e-4)
        assert np.all(pts[sel] <= np.broadcast_to(hi, pts.shape)[sel] + 1e-4)


def test_scene_world_roundtrip():
    """The accel path agrees with brute on a real packed scene (cube +
    ground) with a scattered ray fan — the physics-shaped workload."""
    insts = [
        scene_mod.MeshInstance(primitives.cube(1.0),
                               ml.translation([0.0, 0.0, -3.0])),
        scene_mod.MeshInstance(primitives.plane(20.0),
                               ml.translation([0.0, -1.0, 0.0])),
    ]
    sc = scene_mod.build_scene_buffers(insts)
    world = rc.build_collision_world(sc)
    accel = rt_accel.build_rt_accel(world, group=8)
    rng = np.random.default_rng(7)
    o = jnp.asarray(rng.uniform(-0.2, 0.2, (33, 3)), jnp.float32)
    d = jnp.asarray(
        np.asarray([0, -0.4, -1.0], np.float32)
        + rng.uniform(-0.3, 0.3, (33, 3)).astype(np.float32))
    brute = rc.raycast_batch(o, d, world, face_mask=rc.FACE_MASK_NONE)
    culled = rt_accel.raycast_bundle_culled(
        o, d, world, accel, cap=accel["n_clusters"],
        face_mask=rc.FACE_MASK_NONE)
    _assert_same(culled, brute)


def test_full_frame_culled_matches_brute():
    """render_frame_raytraced with cluster_cap reproduces the brute
    frame: identical coverage, colors/depth to fp tolerance — across
    hard shadows, soft shadows, and reflections, at non-tile-divisible
    dimensions."""
    from softwarerenderer_tpu import RenderParams
    from softwarerenderer_tpu.engine.renderer import default_frame_uniforms
    from softwarerenderer_tpu.ops import texture as tex_ops
    from softwarerenderer_tpu.ops.raster import DEPTH_CLEAR
    from softwarerenderer_tpu.ops.raytrace import render_frame_raytraced

    checker = np.asarray(tex_ops.checkerboard(16, 4)["data"])
    insts = [
        scene_mod.MeshInstance(primitives.cube(1.0),
                               ml.translation([0.0, 0.0, -3.0]),
                               texture=checker),
        scene_mod.MeshInstance(primitives.plane(20.0),
                               ml.translation([0.0, -1.0, 0.0])),
    ]
    sc = scene_mod.build_scene_buffers(insts)
    W, H = 70, 46  # not multiples of the tile shape
    params = RenderParams(width=W, height=H)
    u = default_frame_uniforms(W, H)
    u["camera_position"] = np.asarray([0.0, 0.5, 1.0], np.float32)

    for kw in ({"shadows": True},
               {"shadows": True, "shadow_samples": 2},
               {"shadows": False, "reflections": True}):
        if kw.get("shadow_samples"):
            u["rt_light_radius"] = np.float32(0.3)
        bc, bdep = jax.jit(lambda s, uu, kw=kw: render_frame_raytraced(
            s, uu, params, chunk=256, **kw))(sc, u)
        cc, cdep = jax.jit(lambda s, uu, kw=kw: render_frame_raytraced(
            s, uu, params, chunk=256, cluster_cap=6, cluster_group=16,
            **kw))(sc, u)
        bc, bdep = np.asarray(bc), np.asarray(bdep)
        cc, cdep = np.asarray(cc), np.asarray(cdep)
        # coverage = winner identity: exact
        np.testing.assert_array_equal(bdep == DEPTH_CLEAR,
                                      cdep == DEPTH_CLEAR, err_msg=str(kw))
        cov = bdep != DEPTH_CLEAR
        np.testing.assert_allclose(cdep[cov], bdep[cov], rtol=0,
                                   atol=1e-5, err_msg=str(kw))
        # colors: same shader at fp-tolerance barycentrics; allow rare
        # nearest-texel flips at checker boundaries
        diff = np.abs(cc - bc).max(axis=-1)
        assert (diff < 1e-3).mean() > 0.995, (kw, diff.max())


def test_cap_ladder_exact():
    """A ladder of rungs dispatches per-bundle and stays exact, including
    bundles that overflow every rung (brute branch of the switch)."""
    world = _soup_world(n=1009)
    accel = rt_accel.build_rt_accel(world, group=32)
    o, d = _coherent_rays()
    brute = rc.raycast_batch(o, d, world)
    for ladder in ((1, 2), (2, 8, 64), (1, accel["n_clusters"])):
        culled = rt_accel.raycast_bundle_culled(o, d, world, accel,
                                                cap=ladder)
        _assert_same(culled, brute)
