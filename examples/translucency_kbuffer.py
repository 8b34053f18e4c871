"""Example: order-correct translucency + alpha-cutout via the K-buffer.

Winner-only deferred shading is exact for opaque scenes but wrong when a
discarded fragment should reveal geometry behind it, or when translucent
layers must blend in submission order.  RenderParams(kbuffer=K) keeps the
K best fragments per pixel and replays the reference's sequential
shade-blend over them (Rasterizer.cs:509-523).  On a GPU this routes
through the depth-peeled tile kernel (ops/tile_fold.py); elsewhere
through the XLA K-slot fold.

    python examples/translucency_kbuffer.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import numpy as np

from softwarerenderer_tpu import CullMode, RenderParams
from softwarerenderer_tpu.engine import Engine, to_rgb8
from softwarerenderer_tpu.models import primitives, scene
from softwarerenderer_tpu.ops import texture as tex_ops
from softwarerenderer_tpu.utils import mathlib as ml


def main():
    checker = np.asarray(tex_ops.checkerboard(32, 4)["data"])
    glass_blue = np.zeros((8, 8, 4), np.float32)
    glass_blue[...] = (0.3, 0.5, 1.0, 0.45)
    glass_red = np.zeros((8, 8, 4), np.float32)
    glass_red[...] = (1.0, 0.3, 0.3, 0.4)

    insts = [
        # opaque backdrop
        scene.MeshInstance(primitives.plane(20.0),
                           ml.translation([0, -1, 0]), texture=checker),
        scene.MeshInstance(primitives.cube(1.0),
                           ml.translation([0, 0, -5]), texture=checker),
        # two translucent layers in front, submitted back-to-front
        scene.MeshInstance(primitives.cube(1.6),
                           ml.translation([0.3, 0, -3.4]),
                           texture=glass_red),
        scene.MeshInstance(primitives.cube(1.2),
                           ml.translation([-0.3, 0.1, -2.2]),
                           texture=glass_blue),
    ]
    eng = Engine(scene.build_scene_buffers(insts),
                 RenderParams(width=640, height=480, kbuffer=4,
                              cull_mode=CullMode.BACK))
    u = dict(eng.uniforms)
    u["camera_position"] = np.float32([0.0, 0.8, 1.5])
    rgb = eng.present(u)

    try:
        from PIL import Image
        Image.fromarray(np.asarray(rgb)).save("kbuffer_example.png")
        print("wrote kbuffer_example.png", rgb.shape)
    except ImportError:
        print("rendered", rgb.shape, "mean", float(np.mean(rgb)))


if __name__ == "__main__":
    main()
