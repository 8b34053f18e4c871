"""Seeded benchmark workloads: scenes and cameras shared by bench.py,
chip_smoke.py, scripts/ and the golden-image generator.

Everything is generated from fixed seeds inside the package, so a run
needs no asset files.  The headline scene is a stand-in for the reference
game's Dust2 map (not shipped): a random soup with the map's triangle
count (9,061) under a camera aimed the way the map was framed.
"""

from __future__ import annotations

import numpy as np

STAND_IN_TRIANGLES = 9061


def _sand_checker():
    from softwarerenderer_tpu.ops import texture as tex_ops
    return np.asarray(tex_ops.checkerboard(
        64, 8, (0.8, 0.75, 0.6, 1.0), (0.55, 0.5, 0.4, 1.0))["data"])


def stand_in_instances():
    """The headline workload's mesh instances (one textured soup)."""
    from softwarerenderer_tpu.models import primitives, scene as scene_mod
    return [scene_mod.MeshInstance(
        primitives.random_triangle_soup(STAND_IN_TRIANGLES, seed=0),
        texture=_sand_checker())]


def stand_in_scene():
    """Packed scene buffers of the headline workload."""
    from softwarerenderer_tpu.models import scene as scene_mod
    return scene_mod.build_scene_buffers(stand_in_instances())


def camera_uniforms(uniforms, frame_idx=0):
    """The headline camera; frame_idx sweeps the yaw slowly."""
    from softwarerenderer_tpu.utils import mathlib as ml
    u = dict(uniforms)
    u["camera_position"] = np.float32([0.0, 2.5, 6.0])
    u["camera_rotation"] = ml.quat_from_yaw_pitch_roll(
        np.float32(0.6 + 0.01 * frame_idx), np.float32(-0.15), np.float32(0))
    return u


def translucent_scene(alpha=0.5, panes=6):
    """The stand-in plus a band of `panes` coloured glass panes of vertex
    alpha `alpha` in front of the headline camera — the K-buffer workload
    (alpha 1.0 gives its opaque control)."""
    from softwarerenderer_tpu.models import primitives, scene as scene_mod
    from softwarerenderer_tpu.utils import mathlib as ml
    insts = stand_in_instances()
    rng = np.random.default_rng(3)
    for i in range(panes):
        pane = dict(primitives.plane(1.6))
        col = np.ones((pane["position"].shape[0], 4), np.float32)
        col[:, 3] = alpha
        col[:, :3] = rng.uniform(0.4, 1.0, 3)
        pane["color"] = col
        m = (ml.matrix_from_yaw_pitch_roll(0.0, np.pi / 2, 0.0)
             @ ml.translation([-3.0 + 1.4 * i, 2.0,
                               2.0 + 0.4 * (i % 3)])).astype(np.float32)
        insts.append(scene_mod.MeshInstance(pane, m))
    return scene_mod.build_scene_buffers(insts)


def config_workload(n: int):
    """Scene + camera for BASELINE config n (1, 2, 3, 5).  Returns
    (instances, width, height, uniforms_fn, engine_kwargs)."""
    from softwarerenderer_tpu.models import primitives, scene as scene_mod
    from softwarerenderer_tpu.ops import texture as tex_ops
    from softwarerenderer_tpu.utils import mathlib as ml

    checker = np.asarray(tex_ops.checkerboard(64, 8)["data"])
    if n == 1:    # textured cube + directional light, 640x480
        insts = [scene_mod.MeshInstance(
            primitives.cube(1.5), ml.matrix_from_yaw_pitch_roll(0.5, 0.3, 0)
            @ ml.translation([0, 0, -3]), texture=checker)]
        return insts, 640, 480, None, {}
    if n == 2:    # OBJ mesh + texture sampling + z-buffer, 1280x720
        import tempfile
        from softwarerenderer_tpu.io_host import model_loader
        sph = primitives.uv_sphere(1.0, rings=24, sectors=48)
        with tempfile.NamedTemporaryFile("w", suffix=".obj",
                                         delete=False) as f:
            for p in sph["position"]:
                f.write(f"v {p[0]} {p[1]} {p[2]}\n")
            for t in sph["uv"]:
                f.write(f"vt {t[0]} {1.0 - t[1]}\n")
            for nn in sph["normal"]:
                f.write(f"vn {nn[0]} {nn[1]} {nn[2]}\n")
            for a, b, c in sph["indices"] + 1:
                f.write(f"f {a}/{a}/{a} {b}/{b}/{b} {c}/{c}/{c}\n")
            path = f.name
        try:
            model = model_loader.load_model(path)
        finally:
            import os
            os.unlink(path)
        insts = model_loader.model_instances(
            model, ml.translation([0.0, 0.0, -3.0]),
            texture_override=checker)
        return insts, 1280, 720, None, {}
    if n == 3:    # multi-object frustum-culled multi-light, 1080p
        from softwarerenderer_tpu.models.scene import Light, LightType
        from softwarerenderer_tpu.ops.lighting import (
            lit_scene_vertex_shader, multi_light_fragment_shader,
            pack_lights)
        rng = np.random.default_rng(0)
        insts = [scene_mod.MeshInstance(
            primitives.plane(60.0), ml.translation([0, -1, 0]),
            texture=checker)]
        for _ in range(40):
            pos = rng.uniform(-25, 25, 3).astype(np.float32)
            pos[1] = rng.uniform(0, 2)
            insts.append(scene_mod.MeshInstance(
                primitives.cube(1.0), ml.translation(pos), texture=checker))
        lights = [Light(light_type=LightType.DIRECTIONAL,
                        direction=(0.4, -1.0, -0.3), color=(0.8, 0.8, 0.7)),
                  Light(light_type=LightType.POINT, position=(0, 3, -5),
                        color=(4, 1, 1), attenuation_linear=0.3),
                  Light(light_type=LightType.POINT, position=(8, 2, 4),
                        color=(1, 1, 5), attenuation_quadratic=0.1),
                  Light(light_type=LightType.SPOT, position=(-5, 6, 0),
                        direction=(0, -1, 0), color=(3, 3, 3),
                        spot_inner=0.4, spot_outer=0.7)]

        def add_lights(u, scene):
            u.update(pack_lights(lights))
            u["camera_position"] = np.float32([0, 2, 10])
        return insts, 1920, 1080, add_lights, dict(
            vertex_shader=lit_scene_vertex_shader,
            fragment_shader=multi_light_fragment_shader)
    if n == 5:    # 1000+ instanced meshes, binned raster, 4K
        rng = np.random.default_rng(1)
        insts = []
        for i in range(1100):
            pos = rng.uniform(-40, 40, 3).astype(np.float32)
            pos[1] = rng.uniform(-2, 6)
            insts.append(scene_mod.MeshInstance(
                primitives.cube(1.2),
                (ml.matrix_from_yaw_pitch_roll(
                    float(rng.uniform(0, 3)), 0.0, 0.0)
                 @ ml.translation(pos)).astype(np.float32),
                texture=checker))

        def cam(u, scene):
            u["camera_position"] = np.float32([0, 2, 55])
            u["far_clip"] = np.float32(300.0)
        return insts, 3840, 2160, cam, {}
    raise ValueError(f"unknown workload config {n}")


def lod_crowd_instances(with_lod: bool = True):
    """The 4K LOD-crowd workload: a 24×24 grid of 532-triangle spheres
    receding from the camera, with screen-size LOD levels (ops/lod.py)
    when with_lod — identical placement either way."""
    from softwarerenderer_tpu.models import primitives, scene as scene_mod
    from softwarerenderer_tpu.ops import lod
    from softwarerenderer_tpu.utils import mathlib as ml

    mesh = primitives.uv_sphere(0.45, rings=14, sectors=20)
    if with_lod:
        mesh = lod.add_lods(mesh, cells=(8, 4), px=(60.0, 24.0))
    rng = np.random.default_rng(7)
    insts = []
    for gz in range(24):
        for gx in range(24):
            x = (gx - 11.5) * 2.2 + rng.uniform(-0.4, 0.4)
            z = -4.0 - gz * 2.6 + rng.uniform(-0.4, 0.4)
            y = rng.uniform(-0.5, 0.5)
            insts.append(scene_mod.MeshInstance(
                mesh, ml.translation([x, y, z])))
    return insts
