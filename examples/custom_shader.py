"""Example: a custom fragment shader + a custom post-FX stage (the
programmable-pipeline features).

Shaders are plain functions over arrays — the same function runs under
NumPy in the golden reference and under jit on the device.  This one renders
UV-space stripes modulated by the world normal, then applies a USER
post-FX stage (a vignette) slotted into params.post_fx — the
post-pipeline analog of the shader ABI, traced into the same jitted
frame.

    python examples/custom_shader.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import numpy as np

from softwarerenderer_tpu import RenderParams
from softwarerenderer_tpu.engine import Engine
from softwarerenderer_tpu.models import primitives, scene
from softwarerenderer_tpu.utils import mathlib as ml


def stripes_shader(frag, uniforms, xp):
    """10 UV stripes, lit by the world normal's upness, fogged like the
    game shader."""
    stripe = (xp.sin(frag["uv"][..., 0:1] * 31.4) * 0.5 + 0.5)
    up = xp.maximum(0.2, frag["data"]["world_normal"][..., 1:2])
    rgb = xp.concatenate(
        [stripe * up, 0.3 + 0.5 * up, 1.0 - stripe * up], axis=-1)
    return xp.concatenate([rgb, xp.ones_like(stripe)], axis=-1)


# declare the varyings it reads so the raster payload stays minimal
stripes_shader.varyings = ("uv", "data.world_normal")


def vignette(color, depth, uniforms):
    """User post-FX stage: darken toward the frame corners.  Reads the
    traced uniforms (strength is tunable without recompiling)."""
    import jax.numpy as jnp
    h, w = color.shape[:2]
    ys = jnp.linspace(-1.0, 1.0, h)[:, None]
    xs = jnp.linspace(-1.0, 1.0, w)[None, :]
    fade = 1.0 - uniforms.get("vignette_strength", 0.7) * \
        jnp.clip(ys * ys + xs * xs, 0.0, 1.0)
    return color * fade[..., None], depth


def main():
    sc = scene.build_scene_buffers([
        scene.MeshInstance(primitives.uv_sphere(1.0, rings=24, sectors=48),
                           ml.translation([0.0, 0.0, -3.0])),
        scene.MeshInstance(primitives.plane(10.0),
                           ml.translation([0.0, -1.2, 0.0])),
    ])
    eng = Engine(sc, RenderParams(
        width=640, height=480,
        post_fx=("sky", "ssao", "bloom", "tonemap", "fxaa", vignette)),
        fragment_shader=stripes_shader)
    eng.uniforms["vignette_strength"] = np.float32(0.7)
    rgb = eng.present()
    from PIL import Image
    Image.fromarray(rgb).save("/tmp/custom_shader.png")
    print("wrote /tmp/custom_shader.png")


if __name__ == "__main__":
    main()
