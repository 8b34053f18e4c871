#!/usr/bin/env python
"""Generate golden PNGs for the 5 BASELINE configs into tests/goldens/.

Renders each config's scene at a reduced (aspect-preserving) resolution on
the deterministic CPU backend and writes PNGs that pin the images across
rounds.  tests/test_goldens.py re-renders the same frames and gates on a
pixel tolerance.

    python scripts/make_goldens.py
"""

import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

GOLDEN_DIR = os.path.join(REPO, "tests", "goldens")

# (config, width, height): aspect-preserving reductions of the BASELINE
# resolutions, small enough for fast CPU renders and small PNGs.
GOLDEN_SIZES = {1: (320, 240), 2: (320, 180), 3: (480, 270),
                4: (320, 180), 5: (480, 270)}
# Feature-path goldens (ROADMAP #11): wireframe, K-buffer translucency,
# shadow maps, mip-mapped sampling.
FEATURES = ("wireframe", "kbuffer", "shadows", "mips",
            "point_shadows", "spot_shadows", "skinning", "ssaa",
            "trilinear", "ssao")


def _pin_cpu():
    """Goldens are rendered on the deterministic CPU backend."""
    os.environ["JAX_PLATFORMS"] = "cpu"
    from softwarerenderer_tpu.utils import compile_cache
    compile_cache.enable_compile_cache()


def render_golden(n: int):
    """Render BASELINE config n's golden frame (uint8 RGB) at golden size."""
    import numpy as np
    from softwarerenderer_tpu.models import workloads as wl
    from softwarerenderer_tpu import RenderParams
    from softwarerenderer_tpu.engine import (Engine,
                                             default_frame_uniforms)
    w, h = GOLDEN_SIZES[n]
    if n == 4:
        # Physics-coupled config: the render half on the dust2 scene with
        # the pinned bench camera (one representative frame; the physics
        # step itself is covered by test_sim.py).
        from softwarerenderer_tpu.models import scene as scene_mod
        scene = wl.stand_in_scene()
        eng = Engine(scene, RenderParams(width=w, height=h))
        u = wl.camera_uniforms(eng.uniforms, frame_idx=0)
        return eng.present(u)
    insts, _, _, ufn, ekw = wl.config_workload(n)
    from softwarerenderer_tpu.models import scene as scene_mod
    scene = scene_mod.build_scene_buffers(insts)
    eng = Engine(scene, RenderParams(width=w, height=h), **ekw)
    u = dict(eng.uniforms)
    if ufn:
        ufn(u, scene)
    return eng.present(u)


def render_feature(name: str):
    import functools
    import numpy as np
    import jax
    from softwarerenderer_tpu import CullMode, DebugMode, RenderParams
    from softwarerenderer_tpu.engine import (Engine, default_frame_uniforms,
                                             render_frame_with_shadows,
                                             to_rgb8)
    from softwarerenderer_tpu.models import primitives, scene as scene_mod
    from softwarerenderer_tpu.ops import texture as tex_ops
    from softwarerenderer_tpu.utils import mathlib as ml

    checker = np.asarray(tex_ops.checkerboard(32, 4)["data"])
    if name == "wireframe":
        insts = [scene_mod.MeshInstance(primitives.cube(1.2),
                                        ml.translation([0, 0, -3]),
                                        texture=checker),
                 scene_mod.MeshInstance(
                     primitives.uv_sphere(0.7, rings=10, sectors=16),
                     ml.translation([1.4, 0.3, -4]))]
        eng = Engine(scene_mod.build_scene_buffers(insts),
                     RenderParams(width=320, height=240,
                                  debug_mode=DebugMode.WIREFRAME))
        return eng.present(eng.uniforms)
    if name == "kbuffer":
        glass = np.zeros((8, 8, 4), np.float32)
        glass[...] = (0.3, 0.5, 1.0, 0.45)
        insts = [scene_mod.MeshInstance(primitives.plane(20.0),
                                        ml.translation([0, -1, 0]),
                                        texture=checker),
                 scene_mod.MeshInstance(primitives.cube(1.0),
                                        ml.translation([0, 0, -4]),
                                        texture=checker),
                 scene_mod.MeshInstance(primitives.cube(1.4),
                                        ml.translation([0, 0, -2.2]),
                                        texture=glass)]
        eng = Engine(scene_mod.build_scene_buffers(insts),
                     RenderParams(width=320, height=240, kbuffer=4,
                                  cull_mode=CullMode.BACK))
        u = dict(eng.uniforms)
        u["camera_position"] = np.float32([0, 0.8, 2.0])
        return eng.present(u)
    if name == "shadows":
        insts = [scene_mod.MeshInstance(primitives.plane(20.0),
                                        ml.translation([0, -1, 0]),
                                        texture=checker),
                 scene_mod.MeshInstance(primitives.cube(1.0),
                                        ml.translation([0, 0.2, -4]),
                                        texture=checker)]
        sc = scene_mod.build_scene_buffers(insts)
        params = RenderParams(width=320, height=240)
        u = default_frame_uniforms(320, 240)
        u["camera_position"] = np.float32([2.5, 2.0, 0.5])
        u["camera_rotation"] = ml.quat_from_yaw_pitch_roll(
            np.float32(0.55), np.float32(-0.35), np.float32(0))
        c, _ = jax.jit(functools.partial(render_frame_with_shadows,
                                         params=params,
                                         shadow_size=256))(sc, u)
        return np.asarray(jax.jit(to_rgb8)(c))
    if name == "point_shadows":
        from softwarerenderer_tpu.engine import (
            render_frame_with_point_shadows,
        )
        insts = [scene_mod.MeshInstance(primitives.plane(20.0),
                                        ml.translation([0, -1, 0]),
                                        texture=checker),
                 scene_mod.MeshInstance(primitives.cube(0.8),
                                        ml.translation([0, 0.6, -4]),
                                        texture=checker),
                 scene_mod.MeshInstance(
                     primitives.uv_sphere(0.5, rings=16, sectors=24),
                     ml.translation([1.8, 0.0, -5]), texture=checker)]
        sc = scene_mod.build_scene_buffers(insts)
        params = RenderParams(width=320, height=240)
        u = default_frame_uniforms(320, 240)
        u["camera_position"] = np.float32([2.5, 2.0, -0.5])
        u["camera_rotation"] = ml.quat_from_yaw_pitch_roll(
            np.float32(0.55), np.float32(-0.35), np.float32(0))
        u["point_light_position"] = np.float32([0.0, 3.0, -4.0])
        u["point_light_color"] = np.ones(4, np.float32)
        u["point_light_range"] = np.float32(40.0)
        c, _ = jax.jit(functools.partial(render_frame_with_point_shadows,
                                         params=params,
                                         shadow_size=256))(sc, u)
        return np.asarray(jax.jit(to_rgb8)(c))
    if name == "spot_shadows":
        from softwarerenderer_tpu.engine import (
            render_frame_with_spot_shadow,
        )
        insts = [scene_mod.MeshInstance(primitives.plane(20.0),
                                        ml.translation([0, -1, 0]),
                                        texture=checker),
                 scene_mod.MeshInstance(primitives.cube(0.8),
                                        ml.translation([0, 0.2, -4]),
                                        texture=checker)]
        sc = scene_mod.build_scene_buffers(insts)
        params = RenderParams(width=320, height=240)
        u = default_frame_uniforms(320, 240)
        u["camera_position"] = np.float32([2.5, 2.0, -0.5])
        u["camera_rotation"] = ml.quat_from_yaw_pitch_roll(
            np.float32(0.55), np.float32(-0.35), np.float32(0))
        u["spot_position"] = np.float32([1.5, 3.0, -2.0])
        d = np.float32([-0.35, -1.0, -0.55])
        u["spot_direction"] = d / np.linalg.norm(d)
        u["spot_inner"] = np.float32(0.35)
        u["spot_outer"] = np.float32(0.6)
        u["spot_color"] = np.ones(4, np.float32)
        u["spot_range"] = np.float32(40.0)
        c, _ = jax.jit(functools.partial(render_frame_with_spot_shadow,
                                         params=params,
                                         shadow_size=256))(sc, u)
        return np.asarray(jax.jit(to_rgb8)(c))
    if name == "skinning":
        sys.path.insert(0, os.path.join(REPO, "examples"))
        from skeletal_animation import tentacle_mesh, tentacle_skin
        mesh = tentacle_mesh()
        skin = tentacle_skin(mesh["position"])
        insts = [scene_mod.MeshInstance(mesh,
                                        ml.translation([0, -1.2, 0]),
                                        texture=checker, skin=skin),
                 scene_mod.MeshInstance(primitives.plane(12.0),
                                        ml.translation([0, -1.2, 0]),
                                        texture=checker)]
        eng = Engine(scene_mod.build_scene_buffers(insts),
                     RenderParams(width=320, height=240))
        u = dict(eng.uniforms)
        u["camera_position"] = np.float32([0, 0.6, 4.5])
        u["anim_time"] = np.float32(0.6)
        return eng.present(u)
    if name == "ssaa":
        insts = [scene_mod.MeshInstance(primitives.plane(20.0),
                                        ml.translation([0, -1, 0]),
                                        texture=checker),
                 scene_mod.MeshInstance(
                     primitives.cube(1.0),
                     (ml.matrix_from_yaw_pitch_roll(
                         np.float32(0.6), 0.3, 0.0)
                      @ ml.translation([0, 0.2, -3.0])).astype(np.float32),
                     texture=checker)]
        eng = Engine(scene_mod.build_scene_buffers(insts),
                     RenderParams(width=320, height=240, ssaa=4))
        u = dict(eng.uniforms)
        u["camera_position"] = np.float32([0, 0.6, 1.5])
        return eng.present(u)
    if name == "trilinear":
        from softwarerenderer_tpu.engine import (
            scene_fragment_shader_trilinear,
        )
        insts = []
        for zi in range(24):
            strip = primitives.plane(16.0)
            strip["uv"] = strip["uv"] * np.float32(16.0)
            insts.append(scene_mod.MeshInstance(
                strip, ml.translation([0, -1, -8.0 - 16.0 * zi]),
                texture=np.asarray(tex_ops.checkerboard(64, 32)["data"])))
        eng = Engine(scene_mod.build_scene_buffers(insts),
                     RenderParams(width=320, height=240,
                                  use_mipmaps="trilinear"),
                     fragment_shader=scene_fragment_shader_trilinear)
        u = dict(eng.uniforms)
        u["camera_position"] = np.float32([0, 0.5, 0])
        u["far_clip"] = np.float32(2000.0)
        return eng.present(u)
    if name == "ssao":
        gray = np.asarray(tex_ops.checkerboard(
            32, 4, (0.85, 0.85, 0.85, 1.0), (0.7, 0.7, 0.7, 1.0))["data"])
        insts = [scene_mod.MeshInstance(primitives.plane(20.0),
                                        ml.translation([0, -1, 0]),
                                        texture=gray),
                 scene_mod.MeshInstance(primitives.cube(1.4),
                                        ml.translation([-0.9, -0.3, -4.0]),
                                        texture=gray),
                 scene_mod.MeshInstance(primitives.cube(0.9),
                                        ml.translation([1.1, -0.55, -3.2]),
                                        texture=gray)]
        eng = Engine(scene_mod.build_scene_buffers(insts),
                     RenderParams(width=320, height=240, ssao=True))
        u = dict(eng.uniforms)
        u["camera_position"] = np.float32([0, 0.8, 0.0])
        u["camera_rotation"] = np.asarray(
            ml.quat_from_axis_angle([1.0, 0, 0], -0.25), np.float32)
        return eng.present(u)
    if name == "mips":
        insts = []
        for zi in range(24):
            strip = primitives.plane(16.0)
            strip["uv"] = strip["uv"] * np.float32(16.0)
            insts.append(scene_mod.MeshInstance(
                strip, ml.translation([0, -1, -8.0 - 16.0 * zi]),
                texture=np.asarray(tex_ops.checkerboard(64, 32)["data"])))
        eng = Engine(scene_mod.build_scene_buffers(insts),
                     RenderParams(width=320, height=240, use_mipmaps=True))
        u = dict(eng.uniforms)
        u["camera_position"] = np.float32([0, 0.5, 0])
        u["far_clip"] = np.float32(2000.0)
        return eng.present(u)
    raise ValueError(name)


def save_png(path, rgb):
    from PIL import Image
    Image.fromarray(rgb).save(path)


def main():
    _pin_cpu()
    os.makedirs(GOLDEN_DIR, exist_ok=True)
    for n in sorted(GOLDEN_SIZES):
        rgb = render_golden(n)
        path = os.path.join(GOLDEN_DIR, f"config{n}.png")
        save_png(path, rgb)
        print(f"wrote {path} {rgb.shape}")
    for name in FEATURES:
        rgb = render_feature(name)
        path = os.path.join(GOLDEN_DIR, f"feature_{name}.png")
        save_png(path, rgb)
        print(f"wrote {path} {rgb.shape}")


if __name__ == "__main__":
    main()
