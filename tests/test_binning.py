"""Binned visibility must agree with the brute-force reducer.

The brute-force path is itself golden-tested against ref_cpu
(test_device_raster.py), so brute == binned closes the loop.  Winner ids
must match everywhere except genuine depth ties (near-coplanar overlaps);
depth values may differ by ~1 ulp because XLA fuses the two program shapes
differently (FMA formation).
"""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from softwarerenderer_tpu import DepthTest, RenderParams
from softwarerenderer_tpu.models import primitives
from softwarerenderer_tpu import shaders
from softwarerenderer_tpu.ops import binning, geometry, raster
from softwarerenderer_tpu.utils import mathlib as ml

W, H = 200, 150  # deliberately not tile-aligned


def make_uniforms():
    return {
        "model": np.eye(4, dtype=np.float32),
        "view": ml.look_at(np.float32([0, 0, 3]), [0, 0, 0], [0, 1, 0]),
        "projection": ml.perspective_fov(np.deg2rad(60.0), W / H, 0.1, 100.0),
        "near_clip": np.float32(0.1),
    }


def run_both(mesh, depth_test=DepthTest.LESS_EQUAL, **bin_kw):
    u = make_uniforms()
    params = RenderParams(width=W, height=H, cull_mode=0,
                          depth_test=depth_test)
    vin = shaders.make_vertex_input(mesh["position"], mesh["uv"],
                                    mesh["normal"], mesh["color"])
    kw = dict(tile_h=16, tile_w=32, span_cap=6, tile_group=4)
    kw.update(bin_kw)

    def vis_pair(vin, idx, u):
        tris = geometry.build_triangles(
            shaders.default_vertex_shader, vin, idx, u,
            width=W, height=H, cull_mode=params.cull_mode)
        db, ib = raster.visibility_brute_force(tris, params, 32)
        dn, i_n = binning.make_binned_visibility(**kw)(tris, params, 32)
        return db, ib, dn, i_n

    return map(np.asarray, jax.jit(vis_pair)(vin, mesh["indices"], u))


def assert_equivalent(mesh, **kw):
    db, ib, dn, i_n = run_both(mesh, **kw)
    id_mismatch = (ib != i_n).mean()
    assert id_mismatch < 1e-3, f"{(ib != i_n).sum()} winner-id mismatches"
    both = (ib == i_n) & (ib != -1)
    if both.any():  # GREATER_* vs a MinValue-cleared buffer draws nothing
        assert np.abs(db[both] - dn[both]).max() < 1e-6


def test_soup():
    assert_equivalent(primitives.random_triangle_soup(120, seed=4))


def test_near_clip_scene():
    assert_equivalent(primitives.random_triangle_soup(
        50, seed=5, z_range=(-4.0, 1.0)))


def test_big_plane_goes_global():
    # A 50-unit plane's two triangles span far more than span_cap tiles and
    # must be handled by the capacity-free global list.
    assert_equivalent(primitives.plane(50.0, y=-1.0))


def test_mixed_global_and_binned():
    soup = primitives.random_triangle_soup(60, seed=8)
    plane = primitives.plane(40.0, y=-1.5)
    n = soup["position"].shape[0]
    mesh = {
        "position": np.concatenate([soup["position"], plane["position"]]),
        "uv": np.concatenate([soup["uv"], plane["uv"]]),
        "normal": np.concatenate([soup["normal"], plane["normal"]]),
        "color": np.concatenate([soup["color"], plane["color"]]),
        "indices": np.concatenate([soup["indices"], plane["indices"] + n]),
    }
    assert_equivalent(mesh)


@pytest.mark.parametrize("depth_test", [
    DepthTest.LESS, DepthTest.GREATER_EQUAL, DepthTest.ALWAYS])
def test_depth_modes(depth_test):
    assert_equivalent(primitives.random_triangle_soup(60, seed=6),
                      depth_test=depth_test)


@pytest.mark.parametrize("tile", [(8, 8), (32, 128), (16, 64)])
def test_tile_shapes(tile):
    assert_equivalent(primitives.random_triangle_soup(60, seed=7),
                      tile_h=tile[0], tile_w=tile[1])


def test_empty_scene():
    mesh = primitives.random_triangle_soup(4, seed=1, z_range=(5.0, 8.0))
    db, ib, dn, i_n = run_both(mesh)  # fully behind camera
    assert (i_n == -1).all() and (ib == -1).all()


def test_shade_binned_fused_matches_render_binned_fused():
    """visibility_binned + shade_binned_fused (the sharded shading path)
    == render_binned_fused's fused fold+resolve, pixel for pixel."""
    mesh = primitives.uv_sphere(1.0, rings=10, sectors=14)
    u = make_uniforms()
    u["light_direction"] = np.float32([0.5, -1.0, -0.3])
    u["light_color"] = np.ones(4, np.float32)
    u["fog_color"] = np.float32([0.4, 0.5, 0.6, 1.0])
    u["fog_start"] = np.float32(40.0)
    u["fog_end"] = np.float32(100.0)
    params = RenderParams(width=W, height=H, cull_mode=0,
                          tile_h=16, tile_w=32, span_cap=6, tile_group=4)
    vin = shaders.make_vertex_input(mesh["position"], mesh["uv"],
                                    mesh["normal"], mesh["color"])
    fb_c = jnp.broadcast_to(jnp.float32([0.1, 0.2, 0.3, 1.0]), (H, W, 4))
    fb_d = jnp.full((H, W), raster.DEPTH_CLEAR, jnp.float32)
    extra = {"tag": np.arange(2 * mesh["indices"].shape[0],
                              dtype=np.int32) % 7}

    def both(vin, idx, u):
        tris = geometry.build_triangles(
            shaders.default_vertex_shader, vin, idx, u,
            width=W, height=H, cull_mode=params.cull_mode)
        c1, d1 = binning.render_binned_fused(
            tris, shaders.default_fragment_shader, u, params, fb_c, fb_d,
            per_tri_extra=extra)
        dv, iv = binning.visibility_binned(
            tris, params, params.chunk, tile_h=params.tile_h,
            tile_w=params.tile_w, span_cap=params.span_cap,
            tile_group=params.tile_group)
        c2, d2 = binning.shade_binned_fused(
            tris, dv, iv, shaders.default_fragment_shader, u, params,
            fb_c, fb_d, per_tri_extra=extra)
        return c1, d1, c2, d2

    c1, d1, c2, d2 = map(np.asarray,
                         jax.jit(both)(vin, mesh["indices"], u))
    np.testing.assert_allclose(c2, c1, atol=2e-6)
    np.testing.assert_allclose(d2, d1, atol=2e-6)


def _vin_idx(mesh):
    return shaders.make_vertex_input(
        mesh["position"], mesh["uv"], mesh["normal"],
        mesh["color"]), mesh["indices"]


def _build_tris(vin, idx, u):
    return geometry.build_triangles(
        shaders.default_vertex_shader, vin, idx, u,
        width=W, height=H, cull_mode=0)


def test_pair_cap_exact_when_pairs_fit():
    """Pair-table truncation (params.pair_cap) with a sufficient cap is
    EXACT: live pairs stable-compact to the prefix before the sort, so
    the truncated table's sorted live section equals the full table's."""
    vin, idx = _vin_idx(primitives.random_triangle_soup(120, seed=4))
    u = make_uniforms()
    kw = dict(tile_h=16, tile_w=32, span_cap=6)

    def vis(vin, idx, u, pair_cap):
        tris = _build_tris(vin, idx, u)
        p = RenderParams(width=W, height=H, cull_mode=0, pair_cap=pair_cap)
        bins = binning.bin_triangles(tris, p, 16, 32, 6)
        d, i = binning.visibility_binned(tris, p, 32, tile_group=4, **kw)
        over = binning.pair_cap_overflow(tris, p, **kw) if pair_cap \
            else jnp.int32(0)
        return bins["sorted_tri"], bins["counts"], d, i, over

    st0, cn0, d0, i0, _ = jax.jit(
        functools.partial(vis, pair_cap=0))(vin, idx, u)
    live = int(np.asarray(cn0).sum())
    cap = -(-live // 128) * 128 + 128
    st1, cn1, d1, i1, over = jax.jit(
        functools.partial(vis, pair_cap=cap))(vin, idx, u)
    assert int(over) == 0
    np.testing.assert_array_equal(np.asarray(cn0), np.asarray(cn1))
    np.testing.assert_array_equal(np.asarray(st0)[:live],
                                  np.asarray(st1)[:live])
    np.testing.assert_array_equal(np.asarray(i0), np.asarray(i1))
    np.testing.assert_array_equal(np.asarray(d0), np.asarray(d1))


def test_pair_cap_overflow_counter_and_determinism():
    """A too-small pair_cap reports the exact dropped-pair count and
    drops deterministically (two runs identical)."""
    vin, idx = _vin_idx(primitives.random_triangle_soup(120, seed=4))
    u = make_uniforms()
    kw = dict(tile_h=16, tile_w=32, span_cap=6)

    def vis(vin, idx, u, pair_cap):
        tris = _build_tris(vin, idx, u)
        p = RenderParams(width=W, height=H, cull_mode=0, pair_cap=pair_cap)
        bins = binning.bin_triangles(tris, p, 16, 32, 6)
        d, i = binning.visibility_binned(tris, p, 32, tile_group=4, **kw)
        return jnp.sum(bins["counts"]), d, i, \
            binning.pair_cap_overflow(tris, p, **kw)

    total0, _, _, _ = jax.jit(
        functools.partial(vis, pair_cap=0))(vin, idx, u)
    live = int(total0)
    cap = max(32, live // 2)
    f = jax.jit(functools.partial(vis, pair_cap=cap))
    tot_a, d_a, i_a, over_a = f(vin, idx, u)
    tot_b, d_b, i_b, over_b = f(vin, idx, u)
    assert int(over_a) == live - cap == int(over_b)
    assert int(tot_a) == cap
    np.testing.assert_array_equal(np.asarray(i_a), np.asarray(i_b))
    np.testing.assert_array_equal(np.asarray(d_a), np.asarray(d_b))


def test_global_partition_matches_stable_argsort():
    """bin_triangles' cumsum+scatter order == the stable argsort it
    replaced: global ids first in submission order, then the rest."""
    soup = primitives.random_triangle_soup(60, seed=8)
    plane = primitives.plane(40.0, y=-1.5)
    n = soup["position"].shape[0]
    mesh = {k: np.concatenate([soup[k], plane[k]])
            for k in ("position", "uv", "normal", "color")}
    mesh["indices"] = np.concatenate([soup["indices"],
                                      plane["indices"] + n])
    vin, idx = _vin_idx(mesh)
    u = make_uniforms()

    def bins_of(vin, idx, u):
        tris = _build_tris(vin, idx, u)
        p = RenderParams(width=W, height=H, cull_mode=0)
        b = binning.bin_triangles(tris, p, 16, 32, 6)
        return b["order"], b["n_global"], tris["valid"], tris["bbox"]

    order, n_global, valid, bbox = map(
        np.asarray, jax.jit(bins_of)(vin, idx, u))
    # recompute the classification in NumPy
    tx0, ty0 = bbox[:, 0] // 32, np.clip(bbox[:, 1], 0, H - 1) // 16
    tx1, ty1 = bbox[:, 2] // 32, np.clip(bbox[:, 3], 0, H - 1) // 16
    span = (tx1 - tx0 + 1) * (ty1 - ty0 + 1)
    is_global = valid & (span > 6)
    ref = np.argsort(np.where(is_global, 0, 1), kind="stable")
    assert int(n_global) == int(is_global.sum()) > 0
    np.testing.assert_array_equal(order, ref)


def test_defer_attrs_bit_exact_incl_clipping():
    """build_triangles(defer_attrs=True) + materialize_attrs reproduces
    the eager varyings BIT-exactly on every valid slot — including
    near-plane-clipped fan slots, whose vertices are lerps the deferred
    path re-applies from (ia, ib, t) decompositions."""
    soup = primitives.random_triangle_soup(80, seed=11)
    # a triangle straddling the camera plane (camera z=3, looking -z):
    # one vertex behind the camera -> some-but-not-all w <= 0 -> clipped
    n = soup["position"].shape[0]
    mesh = {
        "position": np.concatenate([soup["position"], np.float32(
            [[-1.0, -0.5, 0.0], [1.0, -0.5, 0.0], [0.0, 0.8, 4.0]])]),
        "uv": np.concatenate([soup["uv"], np.float32(
            [[0, 0], [1, 0], [0.5, 1]])]),
        "normal": np.concatenate([soup["normal"], np.float32(
            [[0, 0, 1]] * 3)]),
        "color": np.concatenate([soup["color"],
                                 np.ones((3, 4), np.float32)]),
        "indices": np.concatenate([soup["indices"],
                                   np.int32([[n, n + 1, n + 2]])]),
    }
    vin, idx = _vin_idx(mesh)
    u = make_uniforms()

    def both(vin, idx, u):
        e = geometry.build_triangles(
            shaders.default_vertex_shader, vin, idx, u,
            width=W, height=H, cull_mode=0)
        d = geometry.build_triangles(
            shaders.default_vertex_shader, vin, idx, u,
            width=W, height=H, cull_mode=0, defer_attrs=True)
        d = geometry.materialize_attrs(d)
        return e, d

    e, d = jax.jit(both)(vin, idx, u)
    valid = np.asarray(e["valid"])
    assert valid.any()
    # clipping actually happened: some second fan slot is live
    assert valid[1::2].any()
    for k in ("screen", "depth", "bbox", "valid", "inv_area"):
        np.testing.assert_array_equal(np.asarray(e[k]), np.asarray(d[k]))
    assert set(e["attrs"]) == set(d["attrs"])
    for k in e["attrs"]:
        np.testing.assert_array_equal(
            np.asarray(e["attrs"][k])[valid],
            np.asarray(d["attrs"][k])[valid], err_msg=k)


def test_global_count_matches_bins():
    """binning.global_count (the live_globals counter) recomputes
    exactly the global classification bin_triangles makes."""
    soup = primitives.random_triangle_soup(60, seed=8)
    plane = primitives.plane(40.0, y=-1.5)
    n = soup["position"].shape[0]
    mesh = {k: np.concatenate([soup[k], plane[k]])
            for k in ("position", "uv", "normal", "color")}
    mesh["indices"] = np.concatenate([soup["indices"],
                                      plane["indices"] + n])
    vin, idx = _vin_idx(mesh)
    u = make_uniforms()

    def counts(vin, idx, u):
        tris = _build_tris(vin, idx, u)
        p = RenderParams(width=W, height=H, cull_mode=0)
        b = binning.bin_triangles(tris, p, 16, 32, 6)
        return b["n_global"], binning.global_count(
            tris, p, tile_h=16, tile_w=32, span_cap=6)

    n_global, counted = jax.jit(counts)(vin, idx, u)
    assert int(counted) == int(n_global) > 0
