#!/usr/bin/env python
"""Benchmark: Mpixels/s shaded at 1080p on the headline scene, one GPU.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", "extra"};
extra["device"] records the platform, device kind and device count.
vs_baseline = device Mpixels/s ÷ the CPU golden reference's Mpixels/s on
the same scene (the reference publishes no numbers — BASELINE.md).
Refuses to run when JAX finds no GPU.

Usage:
  python bench.py            # full: 1080p stand-in scene
  python bench.py --small    # quick smoke: 320x240, fewer frames
"""

import argparse
import json
import os
import sys
import time

import numpy as np

from softwarerenderer_tpu.models.workloads import (  # noqa: F401
    camera_uniforms,
    config_workload,
)


DUST2 = "/root/reference/OutputAssets/Assets/dust2/scene.gltf"


def build_scene():
    from softwarerenderer_tpu.io_host import model_loader
    from softwarerenderer_tpu.models import scene as scene_mod
    from softwarerenderer_tpu.ops import texture as tex_ops

    fallback = np.asarray(tex_ops.checkerboard(
        64, 8, (0.8, 0.75, 0.6, 1.0), (0.55, 0.5, 0.4, 1.0))["data"])
    if os.path.exists(DUST2):
        model = model_loader.load_model(DUST2)
        insts = model_loader.model_instances(model,
                                             fallback_texture=fallback)
    else:  # the seeded stand-in with the same triangle count
        from softwarerenderer_tpu.models import workloads
        return workloads.stand_in_scene()
    return scene_mod.build_scene_buffers(insts)


# Watchdog window per device sync: a wedged device turns into a loud
# DeviceSyncTimeout + thread dump instead of a silently hung bench.
# Compiles are charged to the first sync, hence the generous default;
# override with SRT_SYNC_TIMEOUT_S.
SYNC_TIMEOUT_S = float(os.environ.get("SRT_SYNC_TIMEOUT_S", "600"))


def _progress(msg: str) -> None:
    """Stage progress on stderr (stdout carries only the JSON line) so a
    hang is attributable to a named stage in seconds."""
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def bench_device(width, height, frames, use_pallas=None):
    from softwarerenderer_tpu import RenderParams
    from softwarerenderer_tpu.engine import Engine
    from softwarerenderer_tpu.utils.profiling import timed_frames

    _progress(f"building the headline scene ({width}x{height})")
    scene = build_scene()
    params = RenderParams(width=width, height=height)
    if use_pallas is not None:
        params = params.replace(use_pallas=use_pallas)
    eng = Engine(scene, params)

    # Pipeline N frames with varied uniforms, sync ONCE via a
    # data-dependent scalar readback (utils.profiling.timed_frames).
    _progress(f"timing {frames} device frames (compile on first)")
    spf = timed_frames(
        lambda i: eng.render(camera_uniforms(eng.uniforms, i)), frames,
        timeout_s=SYNC_TIMEOUT_S)
    _progress(f"device frame: {spf * 1e3:.2f} ms")
    return width * height / spf / 1e6, 1.0 / spf


def bench_game_loop(width, height, frames, bots=0, network=False,
                    present=True, raytrace=0):
    """The PLAYABLE dust2 loop end-to-end: input
    script, physics, bots, decals, HUD, pipelined present — everything
    apps/dust2.Dust2Game.step does per frame, headless, timed on the
    host wall clock (the reference's one lived metric, the ImGui FPS
    counter, /root/reference/Renderer.cs:664).  network=True runs the
    real UDP stack against localhost (this instance elects itself host
    and streams Update RPCs); False skips sockets entirely."""
    from softwarerenderer_tpu.apps.dust2 import Dust2Game

    _progress(f"game-loop: starting headless dust2 {width}x{height} "
              f"bots={bots} network={'loopback-host' if network else 'off'}"
              + (f" raytrace={raytrace}" if raytrace else ""))
    game = Dust2Game(width=width, height=height, render_scale=1.0,
                     headless=True, offline=not network, seed=0,
                     bots=bots, port=17845, raytrace=raytrace)
    game.mouse_locked = True
    # Fetch pipeline depth (frames in flight between the device and the
    # present); one more than the app's default.
    game.present_depth = int(os.environ.get("SRT_PRESENT_DEPTH", 3))

    if not present:
        # present=False: the frame stays on device except every 8th
        # (backpressure + an honest sync), isolating the host loop from
        # the frame-sized device→host transfer.  The fused step's aux
        # vector (pose/bot outputs) still fetches every frame.
        game._present_nth = 8

    def scripted(i):
        # Deterministic play: strafe-run with a slow look sweep and a
        # shot every 1.5 s — touches movement, physics, recoil, decals.
        keys = {"w", "d"} if (i // 45) % 2 == 0 else {"w", "a"}
        if i % 120 == 15:
            keys = keys | {"space"}
        return {"quit": False, "keys": keys,
                "mouse_delta": (1.5 if (i // 90) % 2 == 0 else -1.5, 0.2),
                "mouse_down": i % 90 == 5, "chars": "", "gamepad": None}

    # Warmup must cover one full script period (120 frames) so every
    # program the script can trigger — frame, character step, particle
    # step, the shoot raycast, the jump variant — compiles OUTSIDE the
    # timed window.
    warmup = 130
    for i in range(warmup):
        game.step(1 / 60, inputs=scripted(i))
    _progress("game-loop: warmup done, timing")
    t0 = time.perf_counter()
    for i in range(frames):
        game.step(1 / 60, inputs=scripted(warmup + i))
    dt = time.perf_counter() - t0
    game.close()
    fps = frames / dt
    _progress(f"game-loop: {1e3 * dt / frames:.2f} ms/frame ({fps:.1f} fps)")
    return width * height * fps / 1e6, fps


def bench_sharded(width, height, frames, n_fb):
    """The multi-device frame: the SAME render_frame_sharded program that
    the CPU-mesh tests prove exact, timed over an fb=n_fb device mesh.
    On a one-card host this measures the Mesh((1,1)) overhead."""
    import jax

    from softwarerenderer_tpu import RenderParams
    from softwarerenderer_tpu.parallel import (
        make_mesh,
        render_frame_sharded,
        shard_scene_triangles,
    )
    from softwarerenderer_tpu.utils.profiling import timed_frames

    n_dev = len(jax.devices())
    if n_dev < n_fb:
        raise SystemExit(
            f"--mesh-fb {n_fb} needs {n_fb} devices, have {n_dev} "
            f"(the CPU-mesh correctness twin runs in tests/test_parallel)")
    _progress(f"sharded: building scene, fb={n_fb} mesh over "
              f"{n_dev} device(s)")
    scene = build_scene()
    params = RenderParams(width=width, height=height)
    sscene = jax.device_put(shard_scene_triangles(scene, 1))
    mesh = make_mesh(n_fb, 1)

    from softwarerenderer_tpu.engine import default_frame_uniforms
    base_u = camera_uniforms(default_frame_uniforms(width, height))

    with mesh:
        fn = jax.jit(lambda s, u: render_frame_sharded(s, u, params, mesh))

        def step(i):
            u = camera_uniforms(base_u, i)
            return fn(sscene, u)

        _progress(f"sharded: timing {frames} frames")
        spf = timed_frames(step, frames, timeout_s=SYNC_TIMEOUT_S)
    _progress(f"sharded frame: {spf * 1e3:.2f} ms")
    return width * height / spf / 1e6, 1.0 / spf


def bench_cpu_reference(width, height, frames=1, repeats=3,
                        budget_s=240.0):
    """Median of up to `repeats` runs of the golden NumPy implementation
    on the pinned dust2 workload AT THE SAME RESOLUTION as the device
    measurement; the repeat loop stops once `budget_s` elapses (median of
    whatever completed)."""
    runs = []
    t0 = time.perf_counter()
    for _ in range(repeats):
        runs.append(_cpu_reference_once(width, height, frames))
        if time.perf_counter() - t0 > budget_s:
            break
    runs.sort()
    return runs[len(runs) // 2]


def _cpu_reference_once(width, height, frames=1):
    from softwarerenderer_tpu import shaders
    from softwarerenderer_tpu.engine import camera_matrices, \
        default_frame_uniforms
    from softwarerenderer_tpu.io_host import model_loader
    from softwarerenderer_tpu.ops import texture as tex_ops
    from softwarerenderer_tpu.ref_cpu import rasterizer as ref

    u = camera_uniforms(default_frame_uniforms(width, height))
    view, proj = camera_matrices(u, width, height, xp=np)
    fallback = {"data": np.asarray(tex_ops.checkerboard(
        64, 8, (0.8, 0.75, 0.6, 1.0), (0.55, 0.5, 0.4, 1.0))["data"])}
    meshes = (model_loader.load_model(DUST2).meshes
              if os.path.exists(DUST2) else [])
    t0 = time.perf_counter()
    for _ in range(frames):
        fb = ref.Framebuffer(width, height)
        fb.clear_color(u["clear_color"])
        for mesh in meshes:
            mu = dict(u)
            mu.update(model=np.eye(4, dtype=np.float32), view=view,
                      projection=proj, texture=fallback)
            vin = shaders.make_vertex_input(mesh["position"], mesh["uv"],
                                            mesh["normal"], mesh["color"])
            ref.render_mesh(fb, vin, mesh["indices"], mu,
                            shaders.default_vertex_shader,
                            shaders.default_fragment_shader)
    dt = time.perf_counter() - t0
    return width * height * frames / dt / 1e6


def _bench_engine(insts, width, height, frames, uniforms_fn=None,
                  use_pallas=None, **ekw):
    from softwarerenderer_tpu import RenderParams
    from softwarerenderer_tpu.engine import Engine
    from softwarerenderer_tpu.models import scene as scene_mod
    from softwarerenderer_tpu.utils.profiling import timed_frames

    scene = scene_mod.build_scene_buffers(insts)
    params = RenderParams(width=width, height=height)
    if use_pallas is not None:
        params = params.replace(use_pallas=use_pallas)
    eng = Engine(scene, params, **ekw)
    u = dict(eng.uniforms)
    if uniforms_fn:
        uniforms_fn(u, scene)

    def step(i):
        u["fov_degrees"] = np.float32(90.0 + 0.01 * i)  # defeat caching
        return eng.render(u)

    spf = timed_frames(step, frames, timeout_s=SYNC_TIMEOUT_S)
    return width * height / spf / 1e6, 1.0 / spf


def bench_config(n: int, frames: int = 20):
    """The 5 BASELINE.json benchmark configs."""
    if n in (1, 2, 3, 5):
        insts, w, h, ufn, ekw = config_workload(n)
        if n == 5:
            frames = max(frames // 2, 5)
        return _bench_engine(insts, w, h, frames, uniforms_fn=ufn, **ekw)
    if n == 4:    # physics-coupled character+render in ONE jitted step
        import functools
        import jax
        import jax.numpy as jnp
        from softwarerenderer_tpu import RenderParams
        from softwarerenderer_tpu.engine import render_frame
        from softwarerenderer_tpu.sim import (build_collision_world,
                                              character_step,
                                              default_character_params,
                                              initial_character_state)
        scene = build_scene()
        width, height = 1280, 720
        params = RenderParams(width=width, height=height)
        cp = default_character_params()

        @functools.partial(jax.jit, static_argnames=())
        def step(state, scene, u):
            world = build_collision_world(scene)
            state = character_step(state, jnp.asarray([0.0, 0.0, -1.0]),
                                   False, 1.0 / 60.0, world, cp)
            u = dict(u)
            u["camera_position"] = state["position"] + cp["cam_offset"]
            color, depth = render_frame(scene, u, params)
            return state, color, depth

        from softwarerenderer_tpu.engine import default_frame_uniforms
        from softwarerenderer_tpu.utils.profiling import timed_frames
        u = camera_uniforms(default_frame_uniforms(width, height))
        state = initial_character_state([0.0, 3.0, 6.0])
        scene = jax.device_put(scene)
        out_box = [step(state, scene, u)]

        def one(i):
            out_box[0] = step(out_box[0][0], scene, u)
            return out_box[0]

        spf = timed_frames(one, frames, timeout_s=SYNC_TIMEOUT_S)
        return width * height / spf / 1e6, 1.0 / spf
    raise ValueError(f"unknown config {n}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--frames", type=int, default=None)
    ap.add_argument("--no-baseline", action="store_true",
                    help="skip the slow CPU-reference measurement")
    ap.add_argument("--config", type=int, default=None,
                    help="run one BASELINE config (1-5) instead of the "
                         "headline dust2 1080p metric")
    ap.add_argument("--use-pallas", action="store_true", default=None,
                    help="allow the Triton tile kernel (the default; the "
                         "route is tile_fold.fold_route's)")
    ap.add_argument("--no-pallas", dest="use_pallas", action="store_false",
                    help="force the XLA fused path")
    ap.add_argument("--game-loop", action="store_true",
                    help="benchmark the PLAYABLE dust2 loop (host wall "
                         "clock incl. input/physics/HUD/present) instead "
                         "of the jitted device frame")
    ap.add_argument("--bots", type=int, default=0,
                    help="--game-loop: spawn N bot agents")
    ap.add_argument("--network", action="store_true",
                    help="--game-loop: run the real UDP stack "
                         "(localhost host election) instead of offline")
    ap.add_argument("--raytrace", type=int, nargs="?", const=24,
                    default=0, metavar="CAP",
                    help="--game-loop: render through the ray tracer "
                         "(dust2 --raytrace; CAP = per-bundle cluster "
                         "budget)")
    ap.add_argument("--no-present", action="store_true",
                    help="--game-loop: leave frames on device (sync every "
                         "8th) — isolates the host loop from the "
                         "per-frame transfer")
    ap.add_argument("--mesh-fb", type=int, default=None,
                    help="time render_frame_sharded over an fb=N device "
                         "mesh (needs N devices)")
    ap.add_argument("--width", type=int, default=None)
    ap.add_argument("--height", type=int, default=None)
    args = ap.parse_args()

    import jax
    if jax.devices()[0].platform != "gpu":
        raise SystemExit(f"bench.py measures the GPU; JAX found "
                         f"{jax.devices()[0].platform!r} only")
    from softwarerenderer_tpu.utils import compile_cache
    compile_cache.enable_compile_cache()

    if args.game_loop:
        w = args.width or 1920
        h = args.height or 1080
        mpix, fps = bench_game_loop(w, h, args.frames or 120,
                                    bots=args.bots, network=args.network,
                                    present=not args.no_present,
                                    raytrace=args.raytrace)
        print(json.dumps({
            "metric": f"game_loop_fps_{h}p_dust2"
                      + ("_raytrace" if args.raytrace else "")
                      + ("_nopresent" if args.no_present else ""),
            "value": round(fps, 2), "unit": "fps",
            "vs_baseline": None,
            "extra": {"mpixels_per_s": round(mpix, 2),
                      "bots": args.bots,
                      "network": bool(args.network),
                      "raytrace": args.raytrace,
                      "present": not args.no_present,
                      "resolution": f"{w}x{h}",
                      "device": _device_name()},
        }))
        return

    if args.mesh_fb is not None:
        w = args.width or 1920
        h = args.height or 1080
        mpix, fps = bench_sharded(w, h, args.frames or 20, args.mesh_fb)
        print(json.dumps({
            "metric": f"mpixels_per_s_{h}p_dust2_fb{args.mesh_fb}",
            "value": round(mpix, 2), "unit": "Mpixels/s",
            "vs_baseline": None,
            "extra": {"fps": round(fps, 2), "n_fb": args.mesh_fb,
                      "resolution": f"{w}x{h}",
                      "device": _device_name()},
        }))
        return

    if args.config is not None:
        mpix, fps = bench_config(args.config, args.frames or 20)
        print(json.dumps({
            "metric": f"mpixels_per_s_config{args.config}",
            "value": round(mpix, 2), "unit": "Mpixels/s",
            "vs_baseline": None,
            "extra": {"fps": round(fps, 2), "device": _device_name()},
        }))
        return

    if args.small:
        width, height, frames = 320, 240, 10
        ref_w, ref_h = 160, 120
    else:
        # Same-resolution denominator: the CPU golden runs the SAME
        # 1920×1080 frame the device number is measured on.
        width, height, frames = 1920, 1080, 30
        ref_w, ref_h = 1920, 1080

    mpix, fps = bench_device(width, height, args.frames or frames,
                          use_pallas=args.use_pallas)
    if args.no_baseline:
        cpu_mpix = None
        vs = None
    else:
        cpu_mpix = bench_cpu_reference(ref_w, ref_h)
        vs = mpix / cpu_mpix
    # The PLAYABLE numbers ride the same artifact: the end-to-end game
    # loop at 640×400 (with the pipelined present), ray-traced, and at
    # the headline resolution with the frame left on device.  A failing
    # row fails the run.
    game_rows = {}
    if not args.small:
        for key, (gw, gh, pres, rt) in {
            "game_loop_fps_640x400": (640, 400, True, 0),
            "game_loop_fps_640x400_raytrace": (640, 400, True, 24),
            f"game_loop_fps_{height}p_nopresent": (width, height, False,
                                                   0),
        }.items():
            _, gfps = bench_game_loop(gw, gh, 120, present=pres,
                                      raytrace=rt)
            game_rows[key] = round(gfps, 2)
    print(json.dumps({
        "metric": f"mpixels_per_s_{height}p_dust2",
        "value": round(mpix, 2),
        "unit": "Mpixels/s",
        "vs_baseline": round(vs, 2) if vs is not None else None,
        "extra": {"fps": round(fps, 2),
                  "cpu_ref_mpixels_per_s": (round(cpu_mpix, 3)
                                            if cpu_mpix else None),
                  "resolution": f"{width}x{height}",
                  "device": _device_name(),
                  **game_rows},
    }))


def _device_name():
    """The device the numbers were taken on, as JAX reports it."""
    import jax
    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


if __name__ == "__main__":
    sys.exit(main())
