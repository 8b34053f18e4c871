"""Translucent-content throughput: the stand-in scene plus a band of glass
panes, K-buffer frames at 1080p (tile-kernel depth peel where the route
picks it, else the XLA K-slot fold).

Usage: python scripts/profile_translucent.py [--frames 20] [--panes 6]
           [--kbuffer 4] [--opaque-baseline]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from softwarerenderer_tpu.utils import compile_cache  # noqa: E402

compile_cache.enable_compile_cache()



def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=20)
    ap.add_argument("--panes", type=int, default=6)
    ap.add_argument("--kbuffer", type=int, default=4)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--opaque-baseline", action="store_true",
                    help="also time the same scene with opaque panes")
    args = ap.parse_args()

    import jax

    from softwarerenderer_tpu import RenderParams
    from softwarerenderer_tpu.engine import Engine
    from softwarerenderer_tpu.models import workloads as wl
    from softwarerenderer_tpu.utils.profiling import timed_frames

    def build(alpha):
        return wl.translucent_scene(alpha, panes=args.panes)

    params = RenderParams(width=args.width, height=args.height,
                          kbuffer=args.kbuffer, cull_mode=0)

    def run(label, alpha):
        scene = jax.device_put(build(alpha))
        eng = Engine(scene, params)
        spf = timed_frames(
            lambda i: eng.render(wl.camera_uniforms(eng.uniforms, i)),
            args.frames, timeout_s=600)
        print(f"{label:34s} {spf * 1e3:7.2f} ms/frame "
              f"({1.0 / spf:6.1f} fps)", flush=True)
        return spf

    print(f"stand-in + {args.panes} panes, K={args.kbuffer}, "
          f"{args.width}x{args.height}, {args.frames}f")
    run("glass panes (alpha 0.5)", 0.5)
    if args.opaque_baseline:
        run("same panes opaque (alpha 1.0)", 1.0)


if __name__ == "__main__":
    main()
