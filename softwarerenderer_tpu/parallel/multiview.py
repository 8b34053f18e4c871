"""View-parallel rendering: one chip per camera, one jitted program.

Split-screen / CCTV / stereo rendering is embarrassingly parallel over
the VIEW axis — the scene is shared, only the camera uniforms differ —
so the composition is a `shard_map` over a ("view",) mesh where each
device runs the COMPLETE single-device frame (the same render_frame the
engine uses, with the route tile_fold.fold_route picks) on its own
camera.  No collectives at all: scene and
base uniforms replicate, the stacked view overrides split, and the
(V, H, W, 4) output comes back view-sharded.

This is the scale-out form of engine.render_frame_multiview (which
tiles N views into one framebuffer on ONE device): a split-screen game
server or a CCTV wall renders every view in parallel for the latency
of one.  Composes with the single-device tiler: gather the stack and
concatenate, or present each view on its own host.

The reference has one camera, full stop (Renderer.cs:404-419).
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from softwarerenderer_tpu.config import RenderParams
from softwarerenderer_tpu.parallel._compat import shard_map_unchecked


def make_view_mesh(n_views: int, devices=None) -> Mesh:
    """A ("view",) mesh over the first n_views devices."""
    if devices is None:
        devices = jax.devices()
    if len(devices) < n_views:
        raise ValueError(f"need {n_views} devices, have {len(devices)}")
    return Mesh(np.asarray(devices[:n_views]), axis_names=("view",))


def stack_views(views) -> Dict:
    """Stack per-view uniform-override dicts into arrays with a leading
    view axis (the `views_stacked` input of render_frame_views).  Every
    view must override the same keys."""
    if not views:
        raise ValueError("views must be non-empty")
    keys = set(views[0])
    for ov in views[1:]:
        if set(ov) != keys:
            raise ValueError("every view must override the same keys "
                             f"(got {sorted(keys)} vs {sorted(set(ov))})")
    return {k: jnp.stack([jnp.asarray(ov[k]) for ov in views])
            for k in sorted(keys)}


def render_frame_views(scene: Dict, uniforms: Dict, params: RenderParams,
                       views_stacked: Dict, mesh: Mesh,
                       vertex_shader: Optional[Callable] = None,
                       fragment_shader: Optional[Callable] = None,
                       chunk: int = 128):
    """Render one full frame PER DEVICE along the mesh's "view" axis.

    `views_stacked` maps uniform keys to arrays with leading axis
    V == mesh.shape["view"] (build with stack_views).  Each device runs
    the complete single-chip render_frame — same program, same pixels
    as rendering its view alone — on `uniforms` overridden by its view
    slice.  Returns (color (V, H, W, 4), depth (V, H, W)), sharded on
    the view axis.
    """
    from softwarerenderer_tpu.engine import renderer as eng

    V = mesh.shape["view"]
    for k, a in views_stacked.items():
        if a.shape[0] != V:
            raise ValueError(f"views_stacked[{k!r}] leading axis "
                             f"{a.shape[0]} != mesh view size {V}")
    vertex_shader = vertex_shader or eng.scene_vertex_shader
    fragment_shader = fragment_shader or eng.scene_fragment_shader

    def one_view(scene_rep, uni_rep, view_slice):
        ov = jax.tree_util.tree_map(lambda a: a[0], view_slice)
        u = dict(uni_rep)
        u.update(ov)
        c, d = eng.render_frame(scene_rep, u, params,
                                vertex_shader=vertex_shader,
                                fragment_shader=fragment_shader,
                                chunk=chunk)
        return c[None], d[None]

    fn = shard_map_unchecked(
        one_view, mesh=mesh,
        in_specs=(P(), P(), P("view")),
        out_specs=(P("view"), P("view")))
    return fn(scene, uniforms, views_stacked)
