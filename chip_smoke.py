#!/usr/bin/env python
"""Run the renderer's main path on one NVIDIA GPU and check every result.

    python chip_smoke.py              # phases 1-7 on one GPU
    python chip_smoke.py --devices 4  # the four-GPU paths only

Phases, all in this one process:
  1. device    JAX must report a GPU; prints the card and its power limit.
  2. raster    the 1080p stand-in scene through the route the engine picks,
               against the NumPy reference (ref_cpu) at the same size; the
               tile kernel's winner maps against the XLA binned fold; what
               an unpinned (TF32) float32 resolve would have given.
  3. configs   BASELINE configs 1, 2 and 3 against ref_cpu.
  4. kbuffer   K=4 at 1080p on the translucent scene against the
               blend-exact sequential forward path.
  5. raytrace  640x400 with hard shadows; the bundle sweep's nearest-hit
               winners against the brute raycast.
  6. gameloop  Dust2Game at 1080p with 4 bots, 130 warm-up + 60 timed steps
               of the scripted input.
  7. timings   median ms per frame of every phase, and the tile kernel
               against the XLA path it replaces.

Any failed check raises, so the exit code is non-zero and the final line
is not printed.  The last line of stdout is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
"""

from __future__ import annotations

import argparse
import functools
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

# Contract of tests/test_device_raster.py: per-channel colour and depth
# within 5e-6, at most 0.5 % outlier pixels (near-coplanar ties where
# float reassociation legitimately flips the winner).
ATOL = 5e-6
OUTLIER_FRAC = 0.005
# Config 3's depth is held to 1e-4: its 60-unit ground plane meets the
# camera at a grazing angle, where interpolating depth across
# screen-sized triangles cancels enough bits that NumPy and XLA differ by
# up to 2.4e-5 (measured on a CPU render at 384x216).
DEPTH_ATOL = {3: 1e-4}
# K-buffer vs the sequential forward path: one blend ulp (PARITY.md
# "Exactness-preserving optimizations": <= 2^-23 weight on deeper layers).
BLEND_ULP = 2.0 ** -22
CARD = ""
# Frame sizes are divided by SCALE; 1 on the card (a CPU rehearsal of the
# phase functions sets it higher).
SCALE = 1


def px(n: int) -> int:
    return max(16, n // SCALE)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def timed(label: str, fn, n: int = 20, warm: int = 2) -> float:
    """Median ms of n calls of fn(i), each ending in block_until_ready,
    after `warm` untimed calls (compilation happens there)."""
    import jax
    t0 = time.perf_counter()
    for i in range(warm):
        jax.block_until_ready(fn(i))
    setup = time.perf_counter() - t0
    ts = []
    for i in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(warm + i))
        ts.append(time.perf_counter() - t0)
    ms = float(np.median(ts)) * 1e3
    log(f"  time {label}: median {ms:.3f} ms/frame over {n} frames "
        f"(warm-up incl. compile {setup:.1f} s) [{CARD}]")
    return ms


def compare(label, color, depth, ref_color, ref_depth, atol=ATOL,
            datol=ATOL, outlier_frac=OUTLIER_FRAC):
    """Pixel contract against a reference frame: colour within `atol`,
    depth within `datol`, at most `outlier_frac` pixels off; raises."""
    color, depth = np.asarray(color), np.asarray(depth)
    assert color.shape == ref_color.shape, (color.shape, ref_color.shape)
    assert np.isfinite(color).all(), f"{label}: non-finite colour"
    cbad = np.abs(color - ref_color).max(axis=-1) > atol
    big = np.finfo(np.float32).min
    cov, rcov = depth > big, ref_depth > big
    dbad = (cov != rcov) | (cov & rcov & (np.abs(depth - ref_depth) > datol))
    strict = (np.abs(color - ref_color).max(axis=-1) > ATOL).mean()
    log(f"  {label}: colour outliers {cbad.mean():.4%} at {atol:g}, depth "
        f"outliers {dbad.mean():.4%} at {datol:g} (limit {outlier_frac:.2%}"
        f"; colour outliers at {ATOL:g}: {strict:.4%}); max colour diff "
        f"{np.abs(color - ref_color).max():.3g}")
    assert cbad.mean() <= outlier_frac, f"{label}: colour contract failed"
    assert dbad.mean() <= outlier_frac, f"{label}: depth contract failed"


# ---------------------------------------------------------------------------
# references and helpers
# ---------------------------------------------------------------------------

def ref_render(insts, scene, uniforms, width, height,
               vertex_shader=None, fragment_shader=None, workers=None):
    """The NumPy reference rasterizer (ref_cpu) over the same instances,
    one mesh after another in scene order, with the engine's own shaders.
    Per-mesh atlas regions stand in for the engine's per-triangle
    channels.  The frame renders as row bands (the reference
    framebuffer's scissor) in `workers` CPU processes, which never touch
    the GPU."""
    import multiprocessing
    workers = workers or min(16, os.cpu_count() or 1)
    bands = np.linspace(0, height, workers + 1).astype(int)
    jobs = [(insts, scene, uniforms, width, height, vertex_shader,
             fragment_shader, (int(a), int(b)))
            for a, b in zip(bands[:-1], bands[1:]) if b > a]
    if len(jobs) == 1:
        parts = [_ref_band(*jobs[0])]
    else:
        ctx = multiprocessing.get_context("spawn")
        with ctx.Pool(len(jobs), initializer=_cpu_only) as pool:
            parts = pool.starmap(_ref_band, jobs)
    color = np.concatenate([c for c, _ in parts], axis=0)
    depth = np.concatenate([d for _, d in parts], axis=0)
    return color, depth


def _cpu_only():
    os.environ["JAX_PLATFORMS"] = "cpu"


def _ref_band(insts, scene, uniforms, width, height, vertex_shader,
              fragment_shader, rows):
    from softwarerenderer_tpu.engine import (camera_matrices,
                                             scene_fragment_shader,
                                             scene_vertex_shader)
    from softwarerenderer_tpu.ref_cpu import rasterizer as ref
    from softwarerenderer_tpu import shaders

    vs = vertex_shader or scene_vertex_shader
    fs = fragment_shader or scene_fragment_shader
    view, proj = camera_matrices(uniforms, width, height, xp=np)
    fb = ref.Framebuffer(width, height, rows=rows)
    fb.clear_color(uniforms["clear_color"])
    tex_id = np.asarray(scene["tri_texture_id"])
    mesh_id = np.asarray(scene["tri_mesh_id"])
    aoff = np.asarray(scene["atlas_offsets"])
    asiz = np.asarray(scene["atlas_sizes"])
    for i, inst in enumerate(insts):
        tid = int(tex_id[np.argmax(mesh_id == i)])
        region = {"tex_oy": aoff[tid, 0], "tex_ox": aoff[tid, 1],
                  "tex_h": asiz[tid, 0], "tex_w": asiz[tid, 1],
                  "tex_id": tid}
        mu = dict(uniforms)
        mu.update(model=np.asarray(inst.model_matrix, np.float32),
                  view=view, projection=proj,
                  atlas_data=np.asarray(scene["atlas_data"]),
                  atlas_offsets=aoff, atlas_sizes=asiz,
                  base_color=np.asarray(scene["base_color"]))
        mesh = inst.mesh
        vin = shaders.make_vertex_input(mesh["position"], mesh["uv"],
                                        mesh["normal"], mesh["color"])
        ref.render_mesh(fb, vin, mesh["indices"], mu, vs,
                        functools.partial(_with_region, fs, region),
                        near_clip=float(uniforms["near_clip"]))
    return fb.color[rows[0]:rows[1]], fb.depth[rows[0]:rows[1]]


def _with_region(fragment_shader, region, frag, uniforms, xp):
    shape = frag["uv"].shape[:-1]
    frag = dict(frag)
    frag["tri"] = {k: np.full(shape, v, np.int32) for k, v in region.items()}
    return fragment_shader(frag, uniforms, xp)


def frame_triangles(scene, uniforms, params):
    """The engine's geometry stage for the default shaders: clipped,
    set-up triangles as render_frame builds them."""
    import jax.numpy as jnp
    from softwarerenderer_tpu.engine import (camera_matrices,
                                             scene_fragment_shader,
                                             scene_vertex_shader)
    from softwarerenderer_tpu.ops import culling, geometry
    from softwarerenderer_tpu.utils import mathlib as ml

    w, h = params.width, params.height
    view, proj = camera_matrices(uniforms, w, h)
    visible = culling.spheres_in_frustum(
        scene["bounds_center"], scene["bounds_radius"],
        scene["mesh_matrices"], ml.transform(view, proj, xp=jnp), xp=jnp)
    u = dict(uniforms)
    u.update(model=culling.model_matrices_per_vertex(scene, xp=jnp),
             view=view, projection=proj)
    vin = {k: scene[k] for k in ("position", "uv", "normal", "color")}
    return geometry.build_triangles(
        scene_vertex_shader, vin, scene["indices"], u, width=w, height=h,
        cull_mode=params.cull_mode, near_clip=u["near_clip"],
        tri_mask=jnp.take(visible, scene["tri_mesh_id"]),
        keep_varyings=scene_fragment_shader.varyings)


def engine_frame(scene, params, ufn=None, **ekw):
    """(Engine, uniforms) for a scene; ufn(u, scene) edits the uniforms."""
    from softwarerenderer_tpu.engine import Engine
    eng = Engine(scene, params, **ekw)
    u = dict(eng.uniforms)
    if ufn is not None:
        ufn(u, scene)
    return eng, u


def fov_sweep(eng, u):
    """Frame i of a timing loop: the same view at a new traced FOV."""
    def fn(i):
        uu = dict(u)
        uu["fov_degrees"] = np.float32(float(u["fov_degrees"]) + 0.01 * i)
        return eng.render(uu)
    return fn


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_raster(times):
    import jax
    from softwarerenderer_tpu import RenderParams
    from softwarerenderer_tpu.engine import render_frame
    from softwarerenderer_tpu.models import workloads as wl
    from softwarerenderer_tpu.ops import binning, tile_fold

    log("phase 2: raster, 1080p stand-in scene")
    W, H = px(1920), px(1080)
    params = RenderParams(width=W, height=H)
    route = tile_fold.fold_route(params)
    log(f"  route the engine picks: {route}")
    assert route == ("kernel" if jax.default_backend() == "gpu"
                     else "xla"), route
    scene = wl.stand_in_scene()
    eng, _ = engine_frame(scene, params)
    u = wl.camera_uniforms(eng.uniforms, 0)
    color, depth = eng.render(u)
    t0 = time.perf_counter()
    ref_c, ref_d = ref_render(wl.stand_in_instances(), scene, u, W, H)
    log(f"  ref_cpu frame took {time.perf_counter() - t0:.1f} s")
    compare("kernel frame vs ref_cpu", color, depth, ref_c, ref_d)

    # The kernel's winner maps against the XLA binned fold (the fold that
    # render_binned_fused runs) on the same triangles.
    dev_scene = jax.device_put(scene)

    @jax.jit
    def folds(s, uu):
        tris = frame_triangles(s, uu, params)
        dk, ik = tile_fold.fold_visibility(
            tris, params, interpret=route != "kernel")
        dx, ix = binning.visibility_binned(
            tris, params, chunk=params.chunk, tile_h=params.tile_h,
            tile_w=params.tile_w, span_cap=params.span_cap,
            tile_group=params.tile_group)
        return dk, ik, dx, ix
    dk, ik, dx, ix = map(np.asarray, folds(dev_scene, u))
    n_i = int((ik != ix).sum())
    n_d = int((dk != dx).sum())
    log(f"  kernel vs XLA binned fold: {n_i} winner and {n_d} depth "
        f"mismatches of {ik.size} pixels")
    assert n_i == 0 and n_d == 0, "kernel fold differs from the XLA fold"

    fused = params.replace(use_pallas=False)
    fc, fd = jax.jit(functools.partial(render_frame, params=fused))(
        dev_scene, u)
    compare("XLA fused frame vs ref_cpu", fc, fd, ref_c, ref_d)
    # What the one-hot resolve gives when its float32 product is left to
    # the default precision (TF32 on this card) — why it is pinned.
    keep = binning.RESOLVE_PRECISION
    binning.RESOLVE_PRECISION = jax.lax.Precision.DEFAULT
    try:
        tc, td = jax.jit(functools.partial(render_frame, params=fused))(
            dev_scene, u)
        tc = np.asarray(tc)
    finally:
        binning.RESOLVE_PRECISION = keep
    bad = np.abs(tc - ref_c).max(axis=-1) > ATOL
    log(f"  with the default (TF32) resolve precision the fused frame "
        f"would miss the contract at {bad.mean():.4%} of pixels, max "
        f"colour diff {np.abs(tc - ref_c).max():.3g}")

    times["raster 1080p kernel"] = timed(
        "raster 1080p stand-in (kernel)",
        lambda i: eng.render(wl.camera_uniforms(eng.uniforms, i)))
    feng, _ = engine_frame(scene, fused)
    times["raster 1080p xla"] = timed(
        "raster 1080p stand-in (XLA fused)",
        lambda i: feng.render(wl.camera_uniforms(feng.uniforms, i)))


def phase_configs(times):
    import jax
    from softwarerenderer_tpu import RenderParams
    from softwarerenderer_tpu.models import scene as scene_mod
    from softwarerenderer_tpu.models import workloads as wl

    for n in (1, 2, 3, 5):
        insts, w, h, ufn, ekw = wl.config_workload(n)
        w, h = px(w), px(h)
        scene = scene_mod.build_scene_buffers(insts)
        params = RenderParams(width=w, height=h)
        eng, u = engine_frame(scene, params, ufn, **ekw)
        if n == 5:
            # 4K: kernel against the XLA fused path, timing only here;
            # its pixels are checked against the XLA path below.
            log("phase 7 (4K config 5): tile kernel vs XLA fused")
            feng, _ = engine_frame(scene, params.replace(use_pallas=False),
                                   ufn, **ekw)
            c, d = eng.render(u)
            fc, fd = feng.render(u)
            compare("config 5 kernel vs XLA fused", c, d, np.asarray(fc),
                    np.asarray(fd))
            times["config5 4K kernel"] = timed("config 5 4K (kernel)",
                                               fov_sweep(eng, u))
            times["config5 4K xla"] = timed("config 5 4K (XLA fused)",
                                            fov_sweep(feng, u))
            continue
        log(f"phase 3: BASELINE config {n} ({w}x{h})")
        c, d = eng.render(u)
        ref_c, ref_d = ref_render(insts, scene, u, w, h,
                                  ekw.get("vertex_shader"),
                                  ekw.get("fragment_shader"))
        compare(f"config {n} vs ref_cpu", c, d, ref_c, ref_d,
                datol=DEPTH_ATOL.get(n, ATOL))
        times[f"config{n}"] = timed(f"config {n}", fov_sweep(eng, u))
    jax.clear_caches()


def phase_kbuffer(times):
    import jax
    from softwarerenderer_tpu import RenderParams
    from softwarerenderer_tpu.models import workloads as wl

    log("phase 4: K-buffer K=4, 1080p translucent scene")
    scene = wl.translucent_scene(0.5)
    params = RenderParams(width=px(1920), height=px(1080), kbuffer=4,
                          cull_mode=0,
                          kbuffer_stats=True)
    eng, _ = engine_frame(scene, params)
    u = wl.camera_uniforms(eng.uniforms, 0)
    c, d, stats = eng.render(u)
    feng, _ = engine_frame(scene, params.replace(
        deferred=False, kbuffer=0, kbuffer_stats=False))
    fc, fd = feng.render(u)
    log(f"  saturated pixels (K-th layer occupied): "
        f"{int(stats['kbuffer_saturated_px'])}")
    compare("K=4 peel vs forward", c, d, np.asarray(fc), np.asarray(fd),
            atol=BLEND_ULP)
    timing = params.replace(kbuffer_stats=False)
    keng, _ = engine_frame(scene, timing)
    times["kbuffer K=4 kernel"] = timed(
        "K=4 translucent 1080p (kernel peel)",
        lambda i: keng.render(wl.camera_uniforms(keng.uniforms, i)))
    xeng, _ = engine_frame(scene, timing.replace(use_pallas=False))
    times["kbuffer K=4 xla"] = timed(
        "K=4 translucent 1080p (XLA K-slot fold)",
        lambda i: xeng.render(wl.camera_uniforms(xeng.uniforms, i)))
    jax.clear_caches()


def phase_raytrace(times):
    import importlib
    import jax
    import jax.numpy as jnp
    from softwarerenderer_tpu import RenderParams
    from softwarerenderer_tpu.engine import default_frame_uniforms
    from softwarerenderer_tpu.models import workloads as wl
    from softwarerenderer_tpu.ops import raytrace, rt_accel, sky
    rc = importlib.import_module("softwarerenderer_tpu.sim.raycast")

    log("phase 5: ray-traced frame, 640x400, hard shadows")
    W, H, tile, cap = px(640), px(400), 16, 24
    scene = jax.device_put(wl.stand_in_scene())
    u = wl.camera_uniforms(default_frame_uniforms(W, H), 0)

    @jax.jit
    def winners(s, uu):
        world = raytrace.build_rt_world(s, uu)
        dirs = sky.pixel_ray_directions(uu, W, H, xp=jnp)
        d_t = dirs.reshape(H // tile, tile, W // tile, tile, 3) \
            .transpose(0, 2, 1, 3, 4).reshape(-1, tile * tile, 3)
        eye = jnp.asarray(uu["camera_position"], jnp.float32)
        o_t = jnp.broadcast_to(eye, d_t.shape)
        accel = rt_accel.build_rt_accel(world, group=64)
        swept = rt_accel.raycast_bundles_nearest(
            o_t, d_t, world, accel, pair_cap=cap * d_t.shape[0],
            chunk_pairs=256, face_mask=rc.FACE_MASK_NONE,
            origin_shared=True)
        brute = jax.lax.map(lambda od: rc.raycast_batch(
            od[0], od[1], world, face_mask=rc.FACE_MASK_NONE),
            (o_t, d_t))
        return swept["hit"], swept["tri"], brute["hit"], brute["tri"]
    sh, st, bh, bt = map(np.asarray, winners(scene, u))
    n_bad = int(((sh != bh) | (bh & (st != bt))).sum())
    log(f"  bundle sweep vs brute raycast: {n_bad} winner mismatches of "
        f"{bh.size} rays ({int(bh.sum())} hits)")
    assert n_bad == 0, "ray-traced winners differ from the brute raycast"

    params = RenderParams(width=W, height=H)
    frame = jax.jit(lambda s, uu: raytrace.render_frame_raytraced(
        s, uu, params, shadows=True, cluster_cap=cap))
    c, d = frame(scene, u)
    c = np.asarray(c)
    assert c.shape == (H, W, 4) and np.isfinite(c).all()
    times["raytrace 640x400"] = timed(
        "ray-traced 640x400 hard shadows",
        lambda i: frame(scene, wl.camera_uniforms(u, i)))
    jax.clear_caches()


def scripted_input(i):
    """The benchmark's deterministic play script: strafe-run with a slow
    look sweep, a jump every 120 frames and a shot every 90."""
    keys = {"w", "d"} if (i // 45) % 2 == 0 else {"w", "a"}
    if i % 120 == 15:
        keys = keys | {"space"}
    return {"quit": False, "keys": keys,
            "mouse_delta": (1.5 if (i // 90) % 2 == 0 else -1.5, 0.2),
            "mouse_down": i % 90 == 5, "chars": "", "gamepad": None}


def phase_gameloop(times):
    import jax
    from softwarerenderer_tpu.apps.dust2 import Dust2Game

    log("phase 6: game loop, 1920x1080, 4 bots, offline, headless")
    game = Dust2Game(width=px(1920), height=px(1080), render_scale=1.0,
                     headless=True, offline=True, bots=4, seed=0)
    try:
        has_map = os.path.exists(os.path.join(game.assets_dir, "dust2",
                                              "scene.gltf"))
        log(f"  map: {'Dust2 asset' if has_map else 'procedural arena'} "
            f"({game.n_map} meshes, "
            f"{int(game.scene['indices'].shape[0])} triangles in the "
            f"packed scene)")
        shots = [0]
        shoot = game.shoot

        def counted_shoot():
            shots[0] += 1
            return shoot()
        game.shoot = counted_shoot
        game.mouse_locked = True
        warm, n = 130, 60
        t0 = time.perf_counter()
        for i in range(warm):
            game.step(1 / 60, inputs=scripted_input(i))
        jax.block_until_ready(game.char)
        log(f"  warm-up {warm} steps took {time.perf_counter() - t0:.1f} s")
        ts = []
        for i in range(n):
            t0 = time.perf_counter()
            game.step(1 / 60, inputs=scripted_input(warm + i))
            jax.block_until_ready(game.char)
            ts.append(time.perf_counter() - t0)
        ms = float(np.median(ts)) * 1e3
        log(f"  time game loop 1080p 4 bots: median {ms:.3f} ms/frame "
            f"over {n} steps [{CARD}]")
        times["game loop 1080p"] = ms
        pose = np.asarray(game.char["position"])
        frame = game.window.last_frame
        log(f"  pose {pose.tolist()}, shots fired {shots[0]}, decals "
            f"placed {game._decal_used}, frame "
            f"{None if frame is None else frame.shape}")
        assert np.isfinite(pose).all(), "non-finite pose"
        assert frame is not None \
            and frame.shape == (px(1080), px(1920), 3) \
            and frame.dtype == np.uint8, "bad RGB8 frame"
        assert shots[0] >= 1, "no shot went through"
    finally:
        game.close()
    jax.clear_caches()


def phase_four(times):
    """Four-GPU paths: the fb=4 sharded 4K frame against the unsharded one
    on one card, and the 4-view split screen against solo renders."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P
    from softwarerenderer_tpu import RenderParams
    from softwarerenderer_tpu.engine import (default_frame_uniforms,
                                             render_frame)
    from softwarerenderer_tpu.models import scene as scene_mod
    from softwarerenderer_tpu.models import workloads as wl
    from softwarerenderer_tpu.parallel import (make_mesh, make_view_mesh,
                                               render_frame_sharded,
                                               render_frame_views,
                                               shard_scene_triangles,
                                               stack_views)

    assert len(jax.devices()) >= 4, "--devices 4 needs four GPUs"
    log("four-GPU: sharded fb=4 frame, 3840x2160 config 5")
    insts, w, h, ufn, _ = wl.config_workload(5)
    w, h = px(w), px(h)
    scene = scene_mod.build_scene_buffers(insts)
    params = RenderParams(width=w, height=h)
    u = default_frame_uniforms(w, h)
    ufn(u, scene)
    one = jax.devices()[0]
    solo = jax.jit(functools.partial(render_frame, params=params))
    s1 = jax.device_put(scene, one)      # committed: runs on card 0
    rc, rd = map(np.asarray, solo(s1, u))
    mesh = make_mesh(4, 1)
    # Scene buffers live on the cards before timing, as one card's do.
    sscene = jax.device_put(shard_scene_triangles(scene, 1),
                            NamedSharding(mesh, P()))
    with mesh:
        sharded = jax.jit(lambda s, uu: render_frame_sharded(
            s, uu, params, mesh))
        c, d = map(np.asarray, sharded(sscene, u))
        n_c = int((c != rc).any(axis=-1).sum())
        n_d = int((d != rd).sum())
        log(f"  sharded vs one card: {n_c} colour and {n_d} depth "
            f"pixels differ (bit-identity required)")
        assert n_c == 0 and n_d == 0, "sharded frame is not bit-identical"
        times["sharded 4K fb=4"] = timed(
            "sharded 4K fb=4 (4 cards)",
            lambda i: sharded(sscene, dict(u, fov_degrees=np.float32(
                90.0 + 0.01 * i))))
    times["unsharded 4K"] = timed(
        "unsharded 4K (1 card)",
        lambda i: solo(s1, dict(u, fov_degrees=np.float32(
            90.0 + 0.01 * i))))

    log("four-GPU: split screen, 4 views of the 1080p stand-in")
    scene = wl.stand_in_scene()
    params = RenderParams(width=px(1920), height=px(1080))
    base = wl.camera_uniforms(default_frame_uniforms(px(1920), px(1080)),
                              0)
    views = [{"camera_position": np.float32(
        [3.0 * math.sin(k), 2.5, 6.0 * math.cos(k)])} for k in range(4)]
    vmesh = make_view_mesh(4)
    vscene = jax.device_put(scene, NamedSharding(vmesh, P()))
    with vmesh:
        vfn = jax.jit(lambda s, uu, v: render_frame_views(
            s, uu, params, v, vmesh))
        vs = stack_views(views)
        vc, vd = map(np.asarray, vfn(vscene, base, vs))
        vsolo = jax.jit(functools.partial(render_frame, params=params))
        s1 = jax.device_put(scene, one)
        for k, ov in enumerate(views):
            sc, sd = map(np.asarray, vsolo(s1, dict(base, **ov)))
            n = int((vc[k] != sc).any(axis=-1).sum()
                    + (vd[k] != sd).sum())
            log(f"  view {k} vs its solo render: {n} pixels differ")
            assert n == 0, f"view {k} differs from its solo render"
        times["split screen 4 views"] = timed(
            "split screen 4x1080p (4 cards)",
            lambda i: vfn(vscene, dict(base, fov_degrees=np.float32(
                90.0 + 0.01 * i)), vs))


def main(argv=None) -> int:
    global CARD
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--devices", type=int, choices=(1, 4), default=1,
                    help="4: run only the four-GPU paths")
    args = ap.parse_args(argv)

    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX platform {devs[0].platform!r}); "
              f"nothing is measured", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from softwarerenderer_tpu.utils.compile_cache import enable_compile_cache
    cache = enable_compile_cache()
    CARD = card_line()
    log("phase 1: device")
    log(f"  {devs[0].platform} {devs[0].device_kind} x{len(devs)}; "
        f"compile cache {cache}")
    log(f"  nvidia-smi: {CARD}")
    times = {}
    t_start = time.perf_counter()
    if args.devices == 4:
        phase_four(times)
    else:
        phase_raster(times)
        phase_configs(times)
        phase_kbuffer(times)
        phase_raytrace(times)
        phase_gameloop(times)
        log(f"phase 7: timings (median ms/frame) [{CARD}]")
        for k, v in times.items():
            log(f"  {k:24s} {v:10.3f} ms")
        log("  tile kernel vs the XLA path it replaces:")
        for cell, a, b in (("1080p stand-in", "raster 1080p kernel",
                            "raster 1080p xla"),
                           ("4K config 5", "config5 4K kernel",
                            "config5 4K xla"),
                           ("K=4 translucent", "kbuffer K=4 kernel",
                            "kbuffer K=4 xla")):
            log(f"  {cell:16s} kernel {times[a]:9.3f} ms  XLA "
                f"{times[b]:9.3f} ms  ({times[b] / times[a]:.1f}x)")
    log(f"all phases passed in {time.perf_counter() - t_start:.0f} s "
        f"[{CARD}]")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
