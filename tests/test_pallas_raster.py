"""The Triton tile kernel (ops/tile_fold) in Pallas interpret mode on the
CPU: its fold against the XLA binned reducer, its frames against the XLA
fused path, the route chooser, and the float32 precision of every device
matmul.  Compiled for the card, the same checks run in chip_smoke.py."""

import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.extend.core as jax_core
import jax.numpy as jnp

from softwarerenderer_tpu import RenderParams
from softwarerenderer_tpu.config import DebugMode, DepthTest
from softwarerenderer_tpu.models import primitives
from softwarerenderer_tpu import shaders
from softwarerenderer_tpu.ops import binning, geometry, tile_fold
from softwarerenderer_tpu.utils import mathlib as ml

W, H = 200, 150
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def uniforms(w=W, h=H):
    return {
        "model": np.eye(4, dtype=np.float32),
        "view": ml.look_at(np.float32([0, 0, 3]), [0, 0, 0], [0, 1, 0]),
        "projection": ml.perspective_fov(np.deg2rad(60.0), w / h, 0.1, 100.0),
        "near_clip": np.float32(0.1),
    }


def _fold_pair(mesh, params, indices=None, xla_span_cap=None):
    """(XLA binned winners, kernel winners) on one mesh."""
    vin = shaders.make_vertex_input(mesh["position"], mesh["uv"],
                                    mesh["normal"], mesh["color"])
    w, h = params.width, params.height

    def pair(vin, idx, u):
        tris = geometry.build_triangles(
            shaders.default_vertex_shader, vin, idx, u,
            width=w, height=h, cull_mode=0)
        db, ib = binning.make_binned_visibility(
            tile_h=params.tile_h, tile_w=params.tile_w,
            span_cap=xla_span_cap or params.span_cap, tile_group=4)(
                tris, params, 32)
        dk, ik = tile_fold.fold_visibility(tris, params, interpret=True)
        return db, ib, dk, ik

    idx = mesh["indices"] if indices is None else indices
    return map(np.asarray, jax.jit(pair)(vin, idx, uniforms(w, h)))


def _edge_mesh(case):
    if case == "nan_degenerate":
        m = dict(primitives.random_triangle_soup(60, seed=9))
        pos = np.array(m["position"])
        pos[0:3] = np.nan                      # a NaN triangle
        pos[3:6] = pos[3]                      # zero-area (one point)
        pos[7] = 0.5 * (pos[6] + pos[8])       # collinear
        m["position"] = pos
        return m, None
    if case == "equal_depth_ties":
        m = primitives.random_triangle_soup(40, seed=2)
        idx = np.asarray(m["indices"])
        return m, np.concatenate([idx, idx])   # every triangle twice
    if case == "empty":
        m = primitives.random_triangle_soup(8, seed=1)
        m = dict(m, position=np.asarray(m["position"]) + [0, 0, 50])
        return m, None                        # all behind the camera
    return primitives.random_triangle_soup(120, seed=4), None


@pytest.mark.parametrize("case,tile,span_cap,size", [
    ("padding", (16, 64), 6, (W, H)),          # W, H not tile multiples
    ("empty", (16, 16), 6, (64, 48)),          # no triangle, empty tiles
    ("globals_only", (8, 32), 0, (96, 64)),    # span_cap 0: all global
    ("nan_degenerate", (16, 32), 6, (W, H)),
    ("equal_depth_ties", (16, 16), 6, (96, 64)),
])
def test_kernel_wrapper_matches_binned(case, tile, span_cap, size):
    """fold_visibility (interpret) == binning.visibility_binned winners,
    across the wrapper's padding, empty tiles, a globals-only frame
    (against the XLA fold's binned partition: the fold is
    order-independent), NaN/degenerate input and equal-depth ties."""
    mesh, idx = _edge_mesh(case)
    params = RenderParams(width=size[0], height=size[1], cull_mode=0,
                          tile_h=tile[0], tile_w=tile[1],
                          span_cap=span_cap)
    db, ib, dk, ik = _fold_pair(mesh, params, idx, xla_span_cap=6)
    assert ik.shape == (size[1], size[0])
    if case == "equal_depth_ties":
        # Each triangle twice, with identical setup: the kernel must pick
        # the later copy at every covered pixel (clip-fan slot ids of the
        # second copy are the upper half).  The XLA fold is checked on
        # coverage only — its vectorised and scalar loops may contract
        # the depth expression differently and split a tie.
        n = np.asarray(idx).shape[0] // 2
        np.testing.assert_array_equal(ik >= 0, ib >= 0)
        assert (ik >= 0).any()
        assert (ik[ik >= 0] >= 2 * n).all()
        return
    np.testing.assert_array_equal(ik, ib)
    np.testing.assert_allclose(np.where(ik >= 0, dk, 0),
                               np.where(ib >= 0, db, 0), rtol=0, atol=1e-6)
    if case == "empty":
        assert (ik == -1).all()


@pytest.mark.parametrize("platform,interpret,params_kw,want", [
    ("gpu", False, {}, "kernel"),
    ("cpu", False, {}, "xla"),
    ("cpu", True, {}, "interpret"),
    ("gpu", True, {}, "interpret"),
    ("gpu", False, {"tile_w": 96}, "xla"),
    ("gpu", False, {"depth_test": DepthTest.GREATER}, "xla"),
    ("gpu", False, {"debug_mode": DebugMode.WIREFRAME}, "xla"),
    ("gpu", False, {"use_pallas": False}, "xla"),
])
def test_fold_route(platform, interpret, params_kw, want):
    """One function picks the fold: the kernel on the GPU, XLA on the CPU
    and for every configuration the kernel does not serve, interpret mode
    only when asked."""
    p = RenderParams(width=64, height=32, pallas_interpret=interpret,
                     **params_kw)
    assert tile_fold.fold_route(p, platform) == want


def _tile_kernel_scene():
    from softwarerenderer_tpu.models import scene as scene_mod
    from softwarerenderer_tpu.ops import texture as tex_ops

    checker = np.asarray(tex_ops.checkerboard(16, 4)["data"])
    insts = [scene_mod.MeshInstance(primitives.plane(20.0),
                                    ml.translation([0, -1, 0]),
                                    texture=checker),
             scene_mod.MeshInstance(primitives.cube(0.8),
                                    ml.translation([0, 0, -3]),
                                    texture=checker)]
    rng = np.random.default_rng(0)
    for _ in range(10):
        pos = rng.uniform(-4, 4, 3).astype(np.float32)
        pos[1] = rng.uniform(-0.5, 1.5)
        insts.append(scene_mod.MeshInstance(primitives.cube(0.5),
                                            ml.translation(pos),
                                            texture=checker))
    return scene_mod.build_scene_buffers(insts)


def _render_tile_vs_fused(params):
    """Render via the tile kernel (interpret) and the XLA fused path on
    the same scene; return both frames."""
    import functools
    from softwarerenderer_tpu.engine import (camera_matrices,
                                             default_frame_uniforms,
                                             render_frame,
                                             scene_fragment_shader,
                                             scene_vertex_shader)
    from softwarerenderer_tpu.ops import culling, raster

    sc = _tile_kernel_scene()
    w, h = params.width, params.height
    u0 = default_frame_uniforms(w, h)
    u0["camera_position"] = np.float32([0, 0.5, 3.0])

    def pt(scene, u):
        view, proj = camera_matrices(u, w, h)
        vp = ml.transform(view, proj, xp=jnp)
        visible = culling.spheres_in_frustum(
            scene["bounds_center"], scene["bounds_radius"],
            scene["mesh_matrices"], vp, xp=jnp)
        tri_mask = jnp.take(visible, scene["tri_mesh_id"])
        model_pv = jnp.take(scene["mesh_matrices"], scene["vert_mesh_id"],
                            axis=0)
        uu = dict(u)
        uu.update(model=model_pv, view=view, projection=proj,
                  atlas_data=scene["atlas_data"],
                  atlas_offsets=scene["atlas_offsets"],
                  atlas_sizes=scene["atlas_sizes"],
                  base_color=scene["base_color"])
        vin = {k: scene[k] for k in ("position", "uv", "normal", "color")}
        tris = geometry.build_triangles(
            scene_vertex_shader, vin, scene["indices"], uu, width=w,
            height=h, near_clip=uu["near_clip"], tri_mask=tri_mask,
            keep_varyings=scene_fragment_shader.varyings)
        tid2 = jnp.repeat(scene["tri_texture_id"], 2)
        aoff = jnp.asarray(scene["atlas_offsets"], jnp.int32)
        asiz = jnp.asarray(scene["atlas_sizes"], jnp.int32)
        per_tri = {"tex_id": tid2,
                   "mesh_id": jnp.repeat(scene["tri_mesh_id"], 2),
                   "tex_oy": jnp.take(aoff[:, 0], tid2),
                   "tex_ox": jnp.take(aoff[:, 1], tid2),
                   "tex_h": jnp.take(asiz[:, 0], tid2),
                   "tex_w": jnp.take(asiz[:, 1], tid2)}
        clear = jnp.asarray(u["clear_color"], jnp.float32)
        fbc = jnp.broadcast_to(clear, (h, w, 4))
        fbd = jnp.full((h, w), raster.DEPTH_CLEAR, jnp.float32)
        return tile_fold.render_tile_kernel(
            tris, scene_fragment_shader, uu, params, fbc, fbd,
            per_tri_extra=per_tri, interpret=True)

    cg, dg = jax.jit(pt)(sc, u0)
    xla_params = params.replace(use_pallas=False)
    cf, df = jax.jit(functools.partial(render_frame, params=xla_params))(
        sc, u0)
    return map(np.asarray, (cg, dg, cf, df))


def test_tile_kernel_matches_fused():
    """Tile kernel (interpret) must be pixel-exact vs the XLA fused path:
    same winners, same interpolation, same shading."""
    params = RenderParams(width=136, height=92, tile_h=16, tile_w=128,
                          tile_group=4, chunk=16, span_cap=6)
    cg, dg, cf, df = _render_tile_vs_fused(params)
    assert (np.abs(cg - cf).max(axis=-1) > 1e-5).mean() == 0
    assert (np.abs(dg - df) > 1e-5).mean() == 0


def test_tile_kernel_global_tail():
    """span_cap=1 sends most triangles to the global list, which every
    tile walks before its own segment: still pixel-exact vs fused."""
    params = RenderParams(width=136, height=92, tile_h=16, tile_w=128,
                          tile_group=4, chunk=16, span_cap=1)  # many globals
    cg, dg, cf, df = _render_tile_vs_fused(params)
    assert (np.abs(cg - cf).max(axis=-1) > 1e-5).mean() == 0
    assert (np.abs(dg - df) > 1e-5).mean() == 0


def test_shade_rate_contract():
    """shade_rate=2 (opt-in APPROXIMATE mode, its own contract — never a
    parity path): anchor ROWS match full-rate (depth exactly, color to
    1 ulp); other rows replicate their anchor row wherever both were
    written."""
    import functools

    from softwarerenderer_tpu.engine.renderer import (
        default_frame_uniforms,
        render_frame,
    )
    from softwarerenderer_tpu.models import scene as scene_mod
    from softwarerenderer_tpu.ops import texture as tex_ops

    checker = np.asarray(tex_ops.checkerboard(32, 4)["data"])
    insts = [scene_mod.MeshInstance(
        primitives.plane(30.0), ml.translation([0.0, -1.0, 0.0]),
        texture=checker)]
    rng = np.random.default_rng(0)
    for i in range(6):
        pos = rng.uniform(-4, 4, 3).astype(np.float32)
        pos[1] = rng.uniform(-0.5, 1.5)
        insts.append(scene_mod.MeshInstance(
            primitives.cube(0.9), ml.translation(pos), texture=checker))
    scene = scene_mod.build_scene_buffers(insts)
    params = RenderParams(width=128, height=64, tile_h=16, tile_w=128,
                          tile_group=4, chunk=16, span_cap=6,
                          pallas_interpret=True)
    u = default_frame_uniforms(params.width, params.height)
    u["camera_position"] = np.float32([0.0, 1.0, 8.0])

    full_c, full_d = map(np.asarray, jax.jit(functools.partial(
        render_frame, params=params))(scene, u))
    half_c, half_d = map(np.asarray, jax.jit(functools.partial(
        render_frame, params=params.replace(shade_rate=2)))(scene, u))

    # anchors (even, even) match depth exactly and color to 1 ulp (the
    # subsampled shader compiles with different fusion/FMA contraction —
    # the PARITY.md cross-compilation note); other positions follow
    # their anchor's write/discard decision, so only a thin silhouette
    # band may differ in depth.
    np.testing.assert_array_equal(half_d[::2, ::2], full_d[::2, ::2])
    np.testing.assert_allclose(half_c[::2, ::2], full_c[::2, ::2],
                               atol=1e-6)
    assert (half_d != full_d).mean() < 0.02
    # replication: wherever an odd row's pixel and its anchor-row pixel
    # were both written, the color is the anchor's (unwritten pixels
    # keep the clear color / previous framebuffer)
    from softwarerenderer_tpu.ops.raster import DEPTH_CLEAR
    m = (half_d[::2] != DEPTH_CLEAR) & (half_d[1::2] != DEPTH_CLEAR)
    np.testing.assert_array_equal(half_c[1::2][m], half_c[::2][m])
    # and it is a real approximation somewhere (blocks differ from exact)
    assert (np.abs(half_c - full_c) > 1e-6).any()

    # guarded: only the tile-kernel opaque route implements it
    with pytest.raises(ValueError):
        render_frame(scene, u, params.replace(shade_rate=2,
                                              use_pallas=False))


def _dot_precisions(jaxpr):
    """Precision config of every dot_general in a (closed) jaxpr,
    sub-jaxprs included."""
    found = []

    def walk(jx):
        for eqn in jx.eqns:
            if eqn.primitive.name == "dot_general":
                found.append(eqn.params["precision"])
            for v in eqn.params.values():
                for sub in (v if isinstance(v, (tuple, list)) else (v,)):
                    if isinstance(sub, jax_core.ClosedJaxpr):
                        walk(sub.jaxpr)
                    elif isinstance(sub, jax_core.Jaxpr):
                        walk(sub)
    walk(jaxpr.jaxpr)
    return found


def _frame_fused_kslot(kbuffer):
    from softwarerenderer_tpu.engine import default_frame_uniforms, \
        render_frame
    sc = _tile_kernel_scene()
    p = RenderParams(width=64, height=32, tile_h=16, tile_w=64,
                     kbuffer=kbuffer)
    u = default_frame_uniforms(64, 32)
    return jax.make_jaxpr(lambda s, u: render_frame(s, u, p))(sc, u)


def _frame_skinning():
    from softwarerenderer_tpu.models.scene import (MeshInstance,
                                                   build_scene_buffers)
    from softwarerenderer_tpu.ops import skinning
    from test_skinning import arm_mesh, two_bone_skin
    mesh = arm_mesh()
    scene = build_scene_buffers([MeshInstance(
        mesh, skin=two_bone_skin(mesh["position"]))])
    vin = {k: jnp.asarray(scene[k]) for k in ("position", "normal")}
    sk = {k: jnp.asarray(v) for k, v in scene.items()
          if k.startswith(("skin_", "joint_"))}
    return jax.make_jaxpr(lambda v, s, t: skinning.apply_skinning(
        v, s, {"anim_time": t}, xp=jnp))(vin, sk, np.float32(0.5))


def _frame_ring():
    from softwarerenderer_tpu.engine import default_frame_uniforms
    from softwarerenderer_tpu.parallel import make_ring_mesh, \
        render_frame_ring, shard_scene_triangles
    sc = shard_scene_triangles(_tile_kernel_scene(), 4)
    p = RenderParams(width=64, height=32, tile_h=16, tile_w=64)
    mesh = make_ring_mesh(4)
    u = default_frame_uniforms(64, 32)
    with mesh:
        return jax.make_jaxpr(lambda s, u: render_frame_ring(
            s, u, p, mesh))(sc, u)


@pytest.mark.parametrize("frame", ["fused", "kslot", "skinning", "ring"])
def test_device_matmuls_pin_highest(frame):
    """Every float32 dot_general on the device frames carries HIGHEST:
    on a GPU an unpinned f32 product may run in TF32, which rounds the
    one-hot resolve's payload (screen vertices, varyings, integer atlas
    offsets) to about three decimal digits."""
    jaxpr = {"fused": lambda: _frame_fused_kslot(0),
             "kslot": lambda: _frame_fused_kslot(3),
             "skinning": _frame_skinning,
             "ring": _frame_ring}[frame]()
    precs = _dot_precisions(jaxpr)
    assert precs, f"no dot_general found in the {frame} frame"
    hi = jax.lax.Precision.HIGHEST
    assert all(p is not None and all(x == hi for x in p) for p in precs), \
        precs


@pytest.mark.parametrize("env_dir", [None, "custom"])
def test_compile_cache_dir(env_dir, tmp_path, monkeypatch):
    """The compile-cache helper honours JAX_COMPILATION_CACHE_DIR and
    otherwise uses <checkout>/.jax_cache, which .gitignore lists."""
    from softwarerenderer_tpu.utils import compile_cache
    if env_dir is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        want = os.path.join(REPO, ".jax_cache")
        with open(os.path.join(REPO, ".gitignore")) as f:
            assert ".jax_cache/" in f.read().split()
    else:
        want = str(tmp_path / env_dir)
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", want)
    old = jax.config.jax_compilation_cache_dir
    try:
        assert compile_cache.enable_compile_cache() == want
        assert jax.config.jax_compilation_cache_dir == want
    finally:
        jax.config.update("jax_compilation_cache_dir", old)


def test_chip_smoke_refuses_cpu():
    """chip_smoke.py exits non-zero and prints no ok line when JAX finds
    no GPU."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
