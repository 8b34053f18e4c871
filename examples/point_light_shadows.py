"""Example: point-light cube shadows.

Six depth-only passes from the light position (one per cube face) build a
(6, S, S) shadow map inside the same jitted frame; the fragment shader
picks the face by the dominant axis of (fragment - light) and compares
depth (ops/shadows.py).  The reference imports point lights from scenes
but never consumes them (Light.cs:19-32) — this is the framework's
extension on top of that data.

    python examples/point_light_shadows.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import functools

import numpy as np

import jax

from softwarerenderer_tpu import RenderParams
from softwarerenderer_tpu.engine import (default_frame_uniforms,
                                         render_frame_with_point_shadows,
                                         to_rgb8)
from softwarerenderer_tpu.models import primitives, scene
from softwarerenderer_tpu.ops import texture as tex_ops
from softwarerenderer_tpu.utils import mathlib as ml


def main():
    checker = np.asarray(tex_ops.checkerboard(64, 8)["data"])
    insts = [scene.MeshInstance(primitives.plane(20.0),
                                ml.translation([0, -1, 0]),
                                texture=checker),
             scene.MeshInstance(primitives.cube(0.8),
                                ml.translation([0, 0.6, -4]),
                                texture=checker),
             scene.MeshInstance(primitives.uv_sphere(0.5, rings=16,
                                                     sectors=24),
                                ml.translation([1.8, 0.0, -5]),
                                texture=checker)]
    sc = scene.build_scene_buffers(insts)
    params = RenderParams(width=640, height=480)
    u = default_frame_uniforms(640, 480)
    u["camera_position"] = np.float32([2.5, 2.0, -0.5])
    u["camera_rotation"] = ml.quat_from_yaw_pitch_roll(
        np.float32(0.55), np.float32(-0.35), np.float32(0))
    u["point_light_position"] = np.float32([0.0, 3.0, -4.0])
    u["point_light_color"] = np.ones(4, np.float32)
    u["point_light_range"] = np.float32(40.0)

    color, _depth = jax.jit(functools.partial(
        render_frame_with_point_shadows, params=params,
        shadow_size=256))(sc, u)
    rgb = np.asarray(jax.jit(to_rgb8)(color))

    try:
        from PIL import Image
        Image.fromarray(rgb).save("point_shadows_example.png")
        print("wrote point_shadows_example.png", rgb.shape)
    except ImportError:
        print("rendered", rgb.shape, "mean", float(rgb.mean()))


if __name__ == "__main__":
    main()
