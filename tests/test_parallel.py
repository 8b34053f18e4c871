"""Multi-chip sharding tests on the virtual 8-device CPU mesh.

Sharded rendering (fb rows × triangle shards with lexicographic winner
all-reduce) must reproduce the single-device frame.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from softwarerenderer_tpu import RenderParams
from softwarerenderer_tpu.engine import default_frame_uniforms, render_frame
from softwarerenderer_tpu.models import primitives, scene as scene_mod
from softwarerenderer_tpu.ops import texture as tex_ops
from softwarerenderer_tpu.parallel import (
    make_mesh,
    render_frame_sharded,
    shard_scene_triangles,
)
from softwarerenderer_tpu.utils import mathlib as ml

W, H = 128, 96


def small_scene():
    checker = np.asarray(tex_ops.checkerboard(16, 4)["data"])
    insts = [scene_mod.MeshInstance(primitives.plane(20.0),
                                    ml.translation([0.0, -1.0, 0.0]),
                                    texture=checker)]
    rng = np.random.default_rng(3)
    for _ in range(5):
        pos = rng.uniform(-4, 4, 3).astype(np.float32)
        pos[1] = rng.uniform(-0.5, 1.0)
        pos[2] = rng.uniform(-6, -2)
        insts.append(scene_mod.MeshInstance(primitives.cube(0.8),
                                            ml.translation(pos),
                                            texture=checker))
    return scene_mod.build_scene_buffers(insts)


def uniforms():
    u = default_frame_uniforms(W, H)
    u["camera_position"] = np.float32([0.0, 0.5, 3.0])
    return u


@pytest.mark.parametrize("n_fb,n_tri", [(8, 1), (4, 2), (2, 4), (1, 8)])
def test_sharded_matches_single_device(n_fb, n_tri):
    params = RenderParams(width=W, height=H, tile_h=8, tile_w=64,
                          tile_group=4, chunk=16)
    scene = small_scene()
    u = uniforms()

    ref_c, ref_d = jax.jit(
        lambda s, u: render_frame(s, u, params=params))(scene, u)
    ref_c, ref_d = np.asarray(ref_c), np.asarray(ref_d)

    sscene = shard_scene_triangles(scene, n_tri)
    mesh = make_mesh(n_fb, n_tri)
    with mesh:
        c, d = jax.jit(lambda s, u: render_frame_sharded(
            s, u, params, mesh))(sscene, u)
    c, d = np.asarray(c), np.asarray(d)

    # EXACT parity: the sharded fold reduces the same lexicographic
    # (depth, global submission index) key as single-device (PARITY.md),
    # so every pixel's winner — and therefore its color — is identical.
    assert (np.abs(c - ref_c).max(axis=-1) <= 1e-6).all()
    assert (np.abs(d - ref_d) <= 1e-6).all()


def test_triangle_padding_is_masked():
    # shard_scene_triangles pads the triangle list; padded slots must not
    # render (tri_valid mask).
    scene = small_scene()
    n = scene["indices"].shape[0]
    sscene = shard_scene_triangles(scene, 8)
    assert sscene["indices"].shape[0] % 8 == 0
    assert sscene["tri_valid"].sum() == n


def test_dryrun_multichip_entrypoint():
    import __graft_entry__ as ge
    ge.dryrun_multichip(8)


def test_entry_compiles():
    import __graft_entry__ as ge
    fn, args = ge.entry()
    c, d = jax.jit(fn)(*args)
    assert c.shape == (192, 256, 4)
    assert np.isfinite(np.asarray(c)).all()


@pytest.mark.parametrize("n", [4, 8])
def test_ring_matches_single_device(n):
    from softwarerenderer_tpu.parallel import make_ring_mesh, \
        render_frame_ring
    params = RenderParams(width=W, height=H)
    scene = small_scene()
    u = uniforms()
    ref_c, ref_d = jax.jit(
        lambda s, u: render_frame(s, u, params=params))(scene, u)
    ref_c, ref_d = np.asarray(ref_c), np.asarray(ref_d)

    sscene = shard_scene_triangles(scene, n)
    mesh = make_ring_mesh(n)
    with mesh:
        c, d = jax.jit(lambda s, u: render_frame_ring(
            s, u, params, mesh))(sscene, u)
    c, d = np.asarray(c), np.asarray(d)
    # EXACT parity (see test_sharded_matches_single_device).
    assert (np.abs(c - ref_c).max(axis=-1) <= 1e-6).all()
    assert (np.abs(d - ref_d) <= 1e-6).all()


def bottom_heavy_scene():
    """Dust2-shaped load: the floor field fills the lower two thirds of the
    frame while the sky rows are empty — contiguous fb bands idle the top
    devices."""
    checker = np.asarray(tex_ops.checkerboard(16, 4)["data"])
    insts = [scene_mod.MeshInstance(primitives.plane(30.0),
                                    ml.translation([0.0, -1.0, 0.0]),
                                    texture=checker)]
    for zi in range(14):
        for xi in range(8):
            pos = np.float32([-5.25 + 1.5 * xi, -0.7, -0.8 - 0.9 * zi])
            insts.append(scene_mod.MeshInstance(primitives.cube(0.45),
                                                ml.translation(pos),
                                                texture=checker))
    return scene_mod.build_scene_buffers(insts)


def downward_uniforms(w, h):
    u = default_frame_uniforms(w, h)
    u["camera_position"] = np.float32([0.3, 2.5, 2.0])
    u["camera_rotation"] = ml.quat_from_yaw_pitch_roll(
        np.float32(0.0), np.float32(-0.6), np.float32(0.0))
    return u


def test_balanced_sharding_matches_and_balances():
    """Load-balanced fb sharding: exact parity with single-device AND a
    per-device fold-work spread far below the contiguous-band split on a
    bottom-heavy scene (VERDICT r1 next #8)."""
    import functools
    from softwarerenderer_tpu.engine import (camera_matrices,
                                             scene_fragment_shader,
                                             scene_vertex_shader)
    from softwarerenderer_tpu.ops import binning, culling, geometry

    BW, BH = 128, 256
    params = RenderParams(width=BW, height=BH, tile_h=8, tile_w=64,
                          tile_group=4, chunk=16)
    scene = bottom_heavy_scene()
    u = downward_uniforms(BW, BH)

    ref_c, ref_d = jax.jit(
        lambda s, u: render_frame(s, u, params=params))(scene, u)
    ref_c, ref_d = np.asarray(ref_c), np.asarray(ref_d)

    n_fb = 4
    sscene = shard_scene_triangles(scene, 1)
    mesh = make_mesh(n_fb, 1)
    with mesh:
        c, d = jax.jit(functools.partial(
            render_frame_sharded, params=params, mesh=mesh,
            balanced=True))(sscene, u)
    c, d = np.asarray(c), np.asarray(d)
    assert (np.abs(c - ref_c).max(axis=-1) <= 1e-6).all()
    assert (np.abs(d - ref_d) <= 1e-6).all()

    # Measure per-device fold work (sum of owned tiles' segment lengths)
    # for contiguous bands vs the occupancy-serpentine assignment.
    def tris_of(scene, u):
        view, proj = camera_matrices(u, BW, BH)
        vp = ml.transform(view, proj, xp=jnp)
        visible = culling.spheres_in_frustum(
            scene["bounds_center"], scene["bounds_radius"],
            scene["mesh_matrices"], vp, xp=jnp)
        tri_mask = jnp.take(visible, scene["tri_mesh_id"])
        model_pv = jnp.take(scene["mesh_matrices"], scene["vert_mesh_id"],
                            axis=0)
        uu = dict(u)
        uu.update(model=model_pv, view=view, projection=proj)
        vin = {k: scene[k] for k in ("position", "uv", "normal", "color")}
        return geometry.build_triangles(
            scene_vertex_shader, vin, scene["indices"], uu, width=BW,
            height=BH, near_clip=uu["near_clip"], tri_mask=tri_mask,
            keep_varyings=scene_fragment_shader.varyings)

    tris = jax.jit(tris_of)(scene, u)
    bins = jax.jit(lambda t: binning.bin_triangles(
        t, params, params.tile_h, params.tile_w, params.span_cap))(tris)
    counts = np.asarray(bins["counts"])
    ntx = bins["ntx"]
    row_load = counts.reshape(-1, ntx).sum(axis=1)      # per tile row
    n_rows = row_load.shape[0]
    bands = row_load.reshape(n_fb, n_rows // n_fb).sum(axis=1)

    # greedy LPT under the equal-rows-per-device constraint (the product's
    # assignment, parallel/sharding.py)
    order = np.argsort(-row_load)
    per_dev = np.zeros(n_fb)
    cnt = np.zeros(n_fb, int)
    cap = n_rows // n_fb
    for r in order:
        avail = np.where(cnt < cap, per_dev, np.inf)
        k = int(np.argmin(avail))
        per_dev[k] += row_load[r]
        cnt[k] += 1

    def spread(loads):
        return (loads.max() - loads.min()) / max(loads.mean(), 1e-9)

    assert spread(per_dev) <= 0.15, f"balanced spread {spread(per_dev):.2f}"
    assert spread(per_dev) < spread(bands), \
        f"balanced {spread(per_dev):.2f} !< contiguous {spread(bands):.2f}"


def test_tile_balanced_sharding_matches_and_splits_hot_rows():
    """balanced='tiles': exact parity with single-device, AND a per-device
    fold-work spread at least as tight as row-level balance can achieve —
    individual tiles of a hot row split across devices (ROADMAP #9)."""
    import functools
    from softwarerenderer_tpu.engine import (camera_matrices,
                                             scene_fragment_shader,
                                             scene_vertex_shader)
    from softwarerenderer_tpu.ops import binning, culling, geometry

    BW, BH = 128, 256
    params = RenderParams(width=BW, height=BH, tile_h=8, tile_w=64,
                          tile_group=4, chunk=16)
    scene = bottom_heavy_scene()
    u = downward_uniforms(BW, BH)

    ref_c, ref_d = jax.jit(
        lambda s, u: render_frame(s, u, params=params))(scene, u)
    ref_c, ref_d = np.asarray(ref_c), np.asarray(ref_d)

    n_fb = 4
    sscene = shard_scene_triangles(scene, 1)
    mesh = make_mesh(n_fb, 1)
    with mesh:
        c, d = jax.jit(functools.partial(
            render_frame_sharded, params=params, mesh=mesh,
            balanced="tiles"))(sscene, u)
    c, d = np.asarray(c), np.asarray(d)
    assert (np.abs(c - ref_c).max(axis=-1) <= 1e-6).all()
    assert (np.abs(d - ref_d) <= 1e-6).all()

    # Tile-level LPT load spread <= row-level LPT spread on the same scene.
    def tris_of(scene, u):
        view, proj = camera_matrices(u, BW, BH)
        vp = ml.transform(view, proj, xp=jnp)
        visible = culling.spheres_in_frustum(
            scene["bounds_center"], scene["bounds_radius"],
            scene["mesh_matrices"], vp, xp=jnp)
        tri_mask = jnp.take(visible, scene["tri_mesh_id"])
        model_pv = jnp.take(scene["mesh_matrices"], scene["vert_mesh_id"],
                            axis=0)
        uu = dict(u)
        uu.update(model=model_pv, view=view, projection=proj)
        vin = {k: scene[k] for k in ("position", "uv", "normal", "color")}
        return geometry.build_triangles(
            scene_vertex_shader, vin, scene["indices"], uu, width=BW,
            height=BH, near_clip=uu["near_clip"], tri_mask=tri_mask,
            keep_varyings=scene_fragment_shader.varyings)

    tris = jax.jit(tris_of)(scene, u)
    bins = jax.jit(lambda t: binning.bin_triangles(
        t, params, params.tile_h, params.tile_w, params.span_cap))(tris)
    counts = np.asarray(bins["counts"])
    ntx = bins["ntx"]
    ntiles = counts.shape[0]

    def lpt(loads, n_dev):
        cap = -(-loads.shape[0] // n_dev)
        order = np.argsort(-loads)
        per_dev = np.zeros(n_dev)
        cnt = np.zeros(n_dev, int)
        for r in order:
            avail = np.where(cnt < cap, per_dev, np.inf)
            k = int(np.argmin(avail))
            per_dev[k] += loads[r]
            cnt[k] += 1
        return per_dev

    def spread(loads):
        return (loads.max() - loads.min()) / max(loads.mean(), 1e-9)

    tile_dev = lpt(counts.astype(float), n_fb)
    row_dev = lpt(counts.reshape(-1, ntx).sum(axis=1).astype(float), n_fb)
    assert spread(tile_dev) <= spread(row_dev) + 1e-9, \
        f"tile {spread(tile_dev):.3f} !<= row {spread(row_dev):.3f}"
    assert spread(tile_dev) <= 0.15, f"tile spread {spread(tile_dev):.3f}"


def test_sharded_ssaa_matches_single_device():
    """SSAA composes with fb sharding: the sharded ssaa=2 frame equals
    the single-device ssaa=2 frame exactly (downsample runs after the
    order-restoring gather)."""
    params = RenderParams(width=W, height=H, tile_h=8, tile_w=64,
                          tile_group=4, chunk=16, ssaa=2)
    scene = small_scene()
    u = uniforms()
    ref_c, ref_d = jax.jit(
        lambda s, u: render_frame(s, u, params=params))(scene, u)
    sscene = shard_scene_triangles(scene, 1)
    mesh = make_mesh(4, 1)
    with mesh:
        c, d = jax.jit(lambda s, u: render_frame_sharded(
            s, u, params, mesh))(sscene, u)
    assert (np.abs(np.asarray(c) - np.asarray(ref_c)).max(axis=-1)
            <= 1e-6).all()
    assert (np.abs(np.asarray(d) - np.asarray(ref_d)) <= 1e-6).all()


@pytest.mark.parametrize("n_fb,n_tri", [(4, 1), (2, 2)])
def test_sharded_pallas_kernel_matches_single_device(n_fb, n_tri):
    """The tile kernel under shard_map: per-shard fold (interpret mode
    on this CPU mesh), lexicographic all-reduce across the tri axis, one
    gather-shading pass — must reproduce the single-device KERNEL frame
    bit for bit.  (The reference is the unsharded kernel, not the XLA
    fused path: interpret vs fused can differ by an FMA ulp on borderline
    edge pixels; chip_smoke.py checks kernel vs XLA on the card.)"""
    params = RenderParams(width=W, height=H, tile_h=8, tile_w=64,
                          tile_group=4, chunk=16, pallas_interpret=True)
    scene = small_scene()
    u = uniforms()

    ref_c, ref_d = jax.jit(
        lambda s, u: render_frame(s, u, params=params))(scene, u)
    ref_c, ref_d = np.asarray(ref_c), np.asarray(ref_d)

    sscene = shard_scene_triangles(scene, n_tri)
    mesh = make_mesh(n_fb, n_tri)
    with mesh:
        c, d = jax.jit(lambda s, u: render_frame_sharded(
            s, u, params, mesh))(sscene, u)
    c, d = np.asarray(c), np.asarray(d)

    assert (np.abs(c - ref_c).max(axis=-1) <= 1e-6).all()
    assert (np.abs(d - ref_d) <= 1e-6).all()


@pytest.mark.parametrize("use_pallas", [False, True])
def test_sharded_kbuffer_matches_single_device(use_pallas):
    """Ordered translucency under fb sharding (contiguous bands,
    replicated triangles): K-layer replay per band == single device."""
    params = RenderParams(width=W, height=H, tile_h=8, tile_w=64,
                          tile_group=4, chunk=16, kbuffer=3, cull_mode=0,
                          use_pallas=use_pallas,
                          pallas_interpret=use_pallas)
    scene = small_scene()
    u = uniforms()

    ref_c, ref_d = jax.jit(
        lambda s, u: render_frame(s, u, params=params))(scene, u)
    ref_c, ref_d = np.asarray(ref_c), np.asarray(ref_d)

    sscene = shard_scene_triangles(scene, 1)
    mesh = make_mesh(4, 1)
    with mesh:
        c, d = jax.jit(lambda s, u: render_frame_sharded(
            s, u, params, mesh))(sscene, u)
    c, d = np.asarray(c), np.asarray(d)

    assert (np.abs(c - ref_c).max(axis=-1) <= 1e-6).all()
    assert (np.abs(d - ref_d) <= 1e-6).all()


@pytest.mark.parametrize("n_fb,n_tri", [(4, 1), (2, 2)])
def test_balanced_rows_pallas_kernel_matches(n_fb, n_tri):
    """balanced='rows' launches the tile kernel per shard: full-frame
    binning, owned tiles' segments gathered, per-tile pixel-row origins
    — must reproduce
    the single-device KERNEL frame bit for bit on a bottom-heavy scene
    (the workload balancing exists for), across (fb, tri) layouts."""
    BW, BH = 128, 256
    params = RenderParams(width=BW, height=BH, tile_h=8, tile_w=64,
                          tile_group=4, chunk=16, pallas_interpret=True)
    scene = bottom_heavy_scene()
    u = downward_uniforms(BW, BH)

    ref_c, ref_d = jax.jit(
        lambda s, u: render_frame(s, u, params=params))(scene, u)
    ref_c, ref_d = np.asarray(ref_c), np.asarray(ref_d)

    sscene = shard_scene_triangles(scene, n_tri)
    mesh = make_mesh(n_fb, n_tri)
    with mesh:
        c, d = jax.jit(lambda s, u: render_frame_sharded(
            s, u, params, mesh, balanced=True))(sscene, u)
    c, d = np.asarray(c), np.asarray(d)

    assert (np.abs(c - ref_c).max(axis=-1) <= 1e-6).all()
    assert (np.abs(d - ref_d) <= 1e-6).all()


def test_sharded_kbuffer_balanced_rows_matches():
    """The sharded K-buffer's contiguous-band restriction is lifted for
    balanced='rows' through the kernel's tile-row map: each shard peels
    its owned global tile rows; the gather restores row order —
    bit-identical to the single-device kernel K-buffer frame."""
    BW, BH = 128, 256
    params = RenderParams(width=BW, height=BH, tile_h=8, tile_w=64,
                          tile_group=4, chunk=16, kbuffer=3, cull_mode=0,
                          use_pallas=True, pallas_interpret=True)
    scene = bottom_heavy_scene()
    u = downward_uniforms(BW, BH)

    ref_c, ref_d = jax.jit(
        lambda s, u: render_frame(s, u, params=params))(scene, u)
    ref_c, ref_d = np.asarray(ref_c), np.asarray(ref_d)

    sscene = shard_scene_triangles(scene, 1)
    mesh = make_mesh(4, 1)
    with mesh:
        c, d = jax.jit(lambda s, u: render_frame_sharded(
            s, u, params, mesh, balanced=True))(sscene, u)
    c, d = np.asarray(c), np.asarray(d)

    assert (np.abs(c - ref_c).max(axis=-1) <= 1e-6).all()
    assert (np.abs(d - ref_d) <= 1e-6).all()


def test_sharded_kbuffer_rejects_tri_sharding():
    params = RenderParams(width=W, height=H, kbuffer=2)
    scene = shard_scene_triangles(small_scene(), 2)
    mesh = make_mesh(2, 2)
    with pytest.raises(NotImplementedError, match="sharded K-buffer"):
        with mesh:
            render_frame_sharded(scene, uniforms(), params, mesh)


def test_sharded_applies_vertex_updates():
    """Skinning AND particle billboards reach the sharded + ring paths
    (engine.renderer.apply_vertex_updates is shared by every render
    path): a sharded animated frame matches the single-device frame, and
    both differ from the un-animated scene."""
    from softwarerenderer_tpu.models.scene import MeshInstance
    from softwarerenderer_tpu.parallel.ring import (make_ring_mesh,
                                                    render_frame_ring)
    from softwarerenderer_tpu.sim import particles as P
    from tests.test_skinning import arm_mesh, two_bone_skin

    arm = arm_mesh()
    np_cap = 16
    insts = [
        scene_mod.MeshInstance(arm, skin=two_bone_skin(arm["position"])),
        scene_mod.MeshInstance(P.particles_mesh(np_cap, extent=20.0),
                               particles=np_cap,
                               texture=P.soft_disc_texture(8)),
    ]
    scene = scene_mod.build_scene_buffers(insts)
    params = RenderParams(width=W, height=H, tile_h=8, tile_w=64,
                          tile_group=4, chunk=16)
    u = uniforms()
    u["anim_time"] = np.float32(0.5)        # mid-sweep skin pose
    st = P.initial_particle_state(np_cap, seed=3)
    em = P.default_emitter_params()
    em["origin"] = np.float32([0.0, 0.5, -3.0])
    for _ in range(4):
        st = P.particle_step(st, em, 1 / 30)
    u.update(jax.device_get(P.particle_uniforms(st, em)))

    ref_c, ref_d = map(np.asarray, jax.jit(
        lambda s, u: render_frame(s, u, params=params))(scene, u))
    # animation actually moves pixels vs t=0 with no live particles
    u0 = dict(u)
    u0["anim_time"] = np.float32(0.0)
    u0["particle_size"] = np.zeros(np_cap, np.float32)
    u0["particle_color"] = np.zeros((np_cap, 4), np.float32)
    base_c, _ = map(np.asarray, jax.jit(
        lambda s, u: render_frame(s, u, params=params))(scene, u0))
    assert np.abs(ref_c - base_c).max() > 0.05

    sscene = shard_scene_triangles(scene, 2)
    mesh = make_mesh(2, 2)
    with mesh:
        c, d = map(np.asarray, jax.jit(lambda s, u: render_frame_sharded(
            s, u, params, mesh))(sscene, u))
    assert (np.abs(c - ref_c).max(axis=-1) <= 1e-6).all()
    assert (np.abs(d - ref_d) <= 1e-6).all()

    rmesh = make_ring_mesh(2)
    rscene = shard_scene_triangles(scene, 2)
    with rmesh:
        c, d = map(np.asarray, jax.jit(lambda s, u: render_frame_ring(
            s, u, params, rmesh))(rscene, u))
    assert (np.abs(c - ref_c).max(axis=-1) <= 1e-6).all()
    assert (np.abs(d - ref_d) <= 1e-6).all()


def test_sharded_post_fx_matches_single_device():
    """The post-FX data pipeline (sky → ssao → bloom → tonemap) composes
    with sharding: a sharded frame with the full chain equals the
    single-device frame to 1e-6 (the chain applies to the gathered
    full frame after the order-restoring collectives)."""
    scene = small_scene()
    params = RenderParams(width=W, height=H, tile_h=8, tile_w=64,
                          tile_group=4, chunk=16,
                          ssao=True, bloom=True, tonemap="aces")
    u = uniforms()
    pano = np.zeros((32, 64, 4), np.float32)
    pano[:16] = [0.9, 0.3, 0.1, 1]
    pano[16:] = [0.1, 0.3, 0.9, 1]
    u["sky_panorama"] = pano

    ref_c, ref_d = map(np.asarray, jax.jit(
        lambda s, u: render_frame(s, u, params=params))(scene, u))
    # the chain visibly changed the frame vs the plain params
    plain_c, _ = map(np.asarray, jax.jit(lambda s, u: render_frame(
        s, u, params=RenderParams(width=W, height=H, tile_h=8, tile_w=64,
                                  tile_group=4, chunk=16)))(
        scene, {k: v for k, v in u.items() if k != "sky_panorama"}))
    assert np.abs(ref_c - plain_c).max() > 0.05

    sscene = shard_scene_triangles(scene, 2)
    mesh = make_mesh(2, 2)
    with mesh:
        c, d = map(np.asarray, jax.jit(lambda s, u: render_frame_sharded(
            s, u, params, mesh))(sscene, u))
    assert (np.abs(c - ref_c).max(axis=-1) <= 1e-6).all()
    assert (np.abs(d - ref_d) <= 1e-6).all()


def test_sharded_post_fx_fxaa_and_user_callable():
    """fxaa and USER-CALLABLE post-fx stages compose with sharding: the
    sharded chain equals the single-device chain to 1e-6.  (Also a
    regression test: the sharded base render must strip fxaa and
    callables or it recurses forever.)"""
    def dim(color, depth, uniforms):
        return color * jnp.float32(0.75), depth

    scene = small_scene()
    params = RenderParams(width=W, height=H, tile_h=8, tile_w=64,
                          tile_group=4, chunk=16, fxaa=True,
                          tonemap="aces",
                          post_fx=("sky", "ssao", "bloom", "tonemap",
                                   "fxaa", dim))
    u = uniforms()

    ref_c, ref_d = map(np.asarray, jax.jit(
        lambda s, u: render_frame(s, u, params=params))(scene, u))

    sscene = shard_scene_triangles(scene, 2)
    mesh = make_mesh(2, 2)
    with mesh:
        c, d = map(np.asarray, jax.jit(lambda s, u: render_frame_sharded(
            s, u, params, mesh))(sscene, u))
    assert (np.abs(c - ref_c).max(axis=-1) <= 1e-6).all()
    assert (np.abs(d - ref_d) <= 1e-6).all()


def test_sharded_applies_morphs():
    """Morph targets (round-3 vertex stage) reach the sharded + ring
    paths through the shared apply_vertex_updates: a morphing frame with
    an animated weight track matches single-device exactly."""
    from softwarerenderer_tpu.parallel.ring import (make_ring_mesh,
                                                    render_frame_ring)
    from tests.test_morph import quad_mesh, two_target_morph

    track = np.asarray([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0]], np.float32)
    insts = [
        scene_mod.MeshInstance(
            quad_mesh(), morph=two_target_morph(weight_track=track,
                                                rate=1.0)),
        scene_mod.MeshInstance(quad_mesh(),
                               np.asarray(ml.translation([1.5, 0, -1]),
                                          np.float32)),
    ]
    scene = scene_mod.build_scene_buffers(insts)
    params = RenderParams(width=W, height=H, tile_h=8, tile_w=64,
                          tile_group=4, chunk=16)
    u = uniforms()
    u["camera_position"] = np.float32([0.5, 0.5, 4.0])
    u["anim_time"] = np.float32(0.5)        # mid-lerp of the track

    ref_c, ref_d = map(np.asarray, jax.jit(
        lambda s, u: render_frame(s, u, params=params))(scene, u))
    u0 = dict(u)
    u0["morph_weights"] = np.zeros((1, 2), np.float32)  # defeat the track
    base_c, _ = map(np.asarray, jax.jit(
        lambda s, u: render_frame(s, u, params=params))(scene, u0))
    assert np.abs(ref_c - base_c).max() > 0.05, "morph did not move pixels"

    sscene = shard_scene_triangles(scene, 2)
    mesh = make_mesh(2, 2)
    with mesh:
        c, d = map(np.asarray, jax.jit(lambda s, u: render_frame_sharded(
            s, u, params, mesh))(sscene, u))
    assert (np.abs(c - ref_c).max(axis=-1) <= 1e-6).all()
    assert (np.abs(d - ref_d) <= 1e-6).all()

    rmesh = make_ring_mesh(2)
    rscene = shard_scene_triangles(scene, 2)
    with rmesh:
        c, d = map(np.asarray, jax.jit(lambda s, u: render_frame_ring(
            s, u, params, rmesh))(rscene, u))
    assert (np.abs(c - ref_c).max(axis=-1) <= 1e-6).all()
    assert (np.abs(d - ref_d) <= 1e-6).all()


def test_view_parallel_matches_solo_renders():
    """View-parallel scale-out (parallel/multiview.py): each device on a
    ("view",) mesh renders a COMPLETE frame for its own camera; every
    view matches the solo single-device render of that camera."""
    from softwarerenderer_tpu.parallel import (make_view_mesh,
                                               render_frame_views,
                                               stack_views)

    scene = small_scene()
    params = RenderParams(width=W, height=H, tile_h=8, tile_w=64,
                          tile_group=4, chunk=16)
    u = uniforms()
    views = (
        {"camera_position": np.float32([0.0, 1.0, 2.0])},
        {"camera_position": np.float32([2.0, 2.0, 2.0])},
        {"camera_position": np.float32([-2.0, 0.5, 3.0])},
        {"camera_position": np.float32([0.0, 4.0, 0.5])},
    )
    vs = stack_views(views)
    mesh = make_view_mesh(4)
    with mesh:
        c, d = map(np.asarray, jax.jit(
            lambda s, u, v: render_frame_views(s, u, params, v, mesh))(
                scene, u, vs))
    assert c.shape == (4, H, W, 4) and d.shape == (4, H, W)
    for i, ov in enumerate(views):
        ui = dict(u)
        ui.update(ov)
        ci, di = map(np.asarray, jax.jit(
            lambda s, u: render_frame(s, u, params=params))(scene, ui))
        assert (np.abs(c[i] - ci).max(axis=-1) <= 1e-6).all(), f"view {i}"
        assert (np.abs(d[i] - di) <= 1e-6).all(), f"view {i}"
    # the cameras genuinely disagree
    assert np.any(c[0] != c[1])

    # mismatched stacking is rejected loudly
    import pytest as _pytest
    with _pytest.raises(ValueError):
        stack_views(({"camera_position": np.zeros(3, np.float32)},
                     {"fov_degrees": np.float32(60.0)}))
    with _pytest.raises(ValueError):
        render_frame_views(scene, u, params,
                           {"camera_position": np.zeros((3, 3),
                                                        np.float32)},
                           mesh)


@pytest.mark.parametrize("n_fb", [2, 8])
def test_raytraced_sharded_matches_single_device(n_fb):
    """fb-row-sharded ray tracing is bit-identical to the single-device
    frame (global ray ids seed the soft-shadow jitter, so even
    stochastic penumbrae reproduce exactly)."""
    import functools

    from softwarerenderer_tpu.ops.raytrace import render_frame_raytraced
    from softwarerenderer_tpu.parallel import (
        render_frame_raytraced_sharded,
    )

    sc = small_scene()
    params = RenderParams(width=W, height=H)
    u = uniforms()
    u["rt_light_radius"] = np.float32(0.3)

    solo = jax.jit(functools.partial(
        render_frame_raytraced, params=params, chunk=256,
        shadow_samples=2, reflections=True))
    c0, d0 = solo(sc, u)

    mesh = make_mesh(n_fb, 1)
    # flatten the (fb, tri) mesh to the ("fb",) axis the tracer shards
    from jax.sharding import Mesh
    fb_mesh = Mesh(np.asarray(mesh.devices).reshape(-1), ("fb",))
    shard = jax.jit(functools.partial(
        render_frame_raytraced_sharded, params=params, mesh=fb_mesh,
        chunk=256, shadow_samples=2, reflections=True),
        static_argnames=())
    c1, d1 = shard(sc, u)

    np.testing.assert_array_equal(np.asarray(c1), np.asarray(c0))
    np.testing.assert_array_equal(np.asarray(d1), np.asarray(d0))


def test_raytraced_sharded_with_cluster_cap_matches_solo():
    """fb-sharded ray tracing WITH bundle culling (ops/rt_accel.py) is
    bit-identical to the single-device culled frame when the pixel-tile
    grid aligns across bands (chunk 128 -> 4-row tiles; 96/2 = 48 rows
    per band, 48 % 4 == 0), and winner-exact vs brute force."""
    import functools

    from softwarerenderer_tpu.ops.raster import DEPTH_CLEAR
    from softwarerenderer_tpu.ops.raytrace import render_frame_raytraced
    from softwarerenderer_tpu.parallel import (
        render_frame_raytraced_sharded,
    )

    sc = small_scene()
    params = RenderParams(width=W, height=H)
    u = uniforms()

    solo = jax.jit(functools.partial(
        render_frame_raytraced, params=params, chunk=128,
        cluster_cap=(2, 8), cluster_group=16))
    c0, d0 = solo(sc, u)

    mesh2 = make_mesh(2, 1)
    from jax.sharding import Mesh
    fb_mesh = Mesh(np.asarray(mesh2.devices).reshape(-1), ("fb",))
    shard = jax.jit(functools.partial(
        render_frame_raytraced_sharded, params=params, mesh=fb_mesh,
        chunk=128, cluster_cap=(2, 8), cluster_group=16))
    c1, d1 = shard(sc, u)

    np.testing.assert_array_equal(np.asarray(c1), np.asarray(c0))
    np.testing.assert_array_equal(np.asarray(d1), np.asarray(d0))

    brute = jax.jit(functools.partial(
        render_frame_raytraced, params=params, chunk=128))
    cb, db = brute(sc, u)
    np.testing.assert_array_equal(np.asarray(d1) == DEPTH_CLEAR,
                                  np.asarray(db) == DEPTH_CLEAR)
