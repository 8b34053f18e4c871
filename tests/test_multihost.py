"""Multi-host bootstrap: 2 real processes over loopback DCN render a
sharded frame (exercises parallel/multihost.py beyond its docstring,
ROADMAP queue 2).

Each process runs 4 virtual CPU devices; jax.distributed.initialize joins
them into one 8-device runtime and the standard sharded frame renders over
the global (fb, tri) mesh.  Process 0 checks exact parity against a
single-process render.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORKER = r"""
import os, sys
sys.path.insert(0, os.environ["SRT_REPO"])
import numpy as np
import jax
from softwarerenderer_tpu import RenderParams
from softwarerenderer_tpu.engine import default_frame_uniforms
from softwarerenderer_tpu.models import primitives, scene as scene_mod
from softwarerenderer_tpu.ops import texture as tex_ops
from softwarerenderer_tpu.parallel import (render_frame_sharded,
                                           shard_scene_triangles)
from softwarerenderer_tpu.parallel.multihost import (initialize_from_env,
                                                     make_global_mesh)
from softwarerenderer_tpu.utils import mathlib as ml

assert initialize_from_env(), "SRT_COORD must be set"
assert jax.process_count() == 2, jax.process_count()
assert len(jax.devices()) == 8, len(jax.devices())

checker = np.asarray(tex_ops.checkerboard(16, 4)["data"])
insts = [scene_mod.MeshInstance(primitives.plane(20.0),
                                ml.translation([0.0, -1.0, 0.0]),
                                texture=checker),
         scene_mod.MeshInstance(primitives.cube(0.8),
                                ml.translation([0.5, 0.0, -3.0]),
                                texture=checker)]
scene = scene_mod.build_scene_buffers(insts)
W, H = 128, 96
params = RenderParams(width=W, height=H, tile_h=8, tile_w=64,
                      tile_group=4, chunk=16)
u = default_frame_uniforms(W, H)
u["camera_position"] = np.float32([0.0, 0.5, 3.0])

mesh = make_global_mesh(n_fb=4, n_tri=2)
sscene = shard_scene_triangles(scene, 2)
with mesh:
    c, d = jax.jit(lambda s, u: render_frame_sharded(
        s, u, params, mesh))(sscene, u)
# Cross-host fetch of the fully-replicated... the outputs are row-sharded
# across all 8 devices; gather the global arrays on every process.
from jax.experimental import multihost_utils
c_all = multihost_utils.process_allgather(c, tiled=True)
print("GLOBAL_SHAPE", c_all.shape, flush=True)

if jax.process_index() == 0:
    np.save(os.environ["SRT_OUT"], np.asarray(c_all))
print("WORKER_DONE", jax.process_index(), flush=True)
"""


@pytest.mark.slow
def test_two_process_dcn_render(tmp_path):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    out = str(tmp_path / "mh_frame.npy")
    worker_py = tmp_path / "worker.py"
    worker_py.write_text(WORKER)

    env_base = dict(os.environ)
    env_base.update(JAX_PLATFORMS="cpu",
                    XLA_FLAGS="--xla_force_host_platform_device_count=4",
                    SRT_COORD=f"127.0.0.1:{port}", SRT_NUM_PROCS="2",
                    SRT_REPO=REPO, SRT_OUT=out)

    # One retry: the 2-process jax.distributed bootstrap occasionally
    # times out when the full suite loads this 1-CPU host.
    for attempt in range(2):
        procs = []
        for pid in range(2):
            env = dict(env_base, SRT_PROC_ID=str(pid))
            procs.append(subprocess.Popen(
                [sys.executable, str(worker_py)], env=env,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
        outs = []
        for p in procs:
            try:
                o, _ = p.communicate(timeout=300)
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                o = "(timeout)"
            outs.append(o)
        ok = all(p.returncode == 0 and f"WORKER_DONE {pid}" in o
                 for pid, (p, o) in enumerate(zip(procs, outs)))
        if ok:
            break
        if attempt == 1:
            for pid, (p, o) in enumerate(zip(procs, outs)):
                assert p.returncode == 0 \
                    and f"WORKER_DONE {pid}" in o, \
                    f"proc {pid} failed:\n{o[-3000:]}"

    # parity vs a single-process render of the same scene
    import jax
    from softwarerenderer_tpu import RenderParams
    from softwarerenderer_tpu.engine import (default_frame_uniforms,
                                             render_frame)
    from softwarerenderer_tpu.models import primitives, scene as scene_mod
    from softwarerenderer_tpu.ops import texture as tex_ops
    from softwarerenderer_tpu.utils import mathlib as ml

    checker = np.asarray(tex_ops.checkerboard(16, 4)["data"])
    insts = [scene_mod.MeshInstance(primitives.plane(20.0),
                                    ml.translation([0.0, -1.0, 0.0]),
                                    texture=checker),
             scene_mod.MeshInstance(primitives.cube(0.8),
                                    ml.translation([0.5, 0.0, -3.0]),
                                    texture=checker)]
    scene = scene_mod.build_scene_buffers(insts)
    params = RenderParams(width=128, height=96, tile_h=8, tile_w=64,
                          tile_group=4, chunk=16)
    u = default_frame_uniforms(128, 96)
    u["camera_position"] = np.float32([0.0, 0.5, 3.0])
    ref = np.asarray(jax.jit(
        lambda s, u: render_frame(s, u, params=params))(scene, u)[0])
    got = np.load(out)
    assert got.shape == ref.shape
    assert (np.abs(got - ref).max(axis=-1) <= 1e-6).all()
