"""softwarerenderer_tpu — a JAX rendering + game-simulation framework.

A brand-new JAX/XLA/Pallas re-design of the capabilities of the reference C#
project OCSYT/SoftwareRenderer (see SURVEY.md): a programmable software
rasterizer, asset pipeline, raycast physics + Quake-style character
controller, UDP RPC multiplayer, audio, and debug UI — with the per-frame
inner loop expressed as one fused XLA program over device-resident scene
buffers, scaled across chips with `jax.sharding`.

Layering (bottom-up):
  utils/    — matrix/quaternion math in the reference's row-vector convention
  config    — pipeline enums (DepthTest/BlendMode/CullMode) + render params
  ref_cpu/  — NumPy scalar-faithful golden reference of the exact pipeline
  ops/      — device kernels: vertex transform, clip, raster, texture, raycast
  models/   — scene pytrees (meshes, materials, lights, textures) + loaders
  sim/      — batched raycast physics + character controller (pure functions)
  engine/   — frame graph: fused sim+render jit programs, framebuffers
  parallel/ — multi-chip sharding (shard_map over framebuffer shards)
  io_host/  — host services: window/present, audio, UDP RPC networking, UI
  apps/     — the Dust2 FPS demo reproducing the reference game
"""

__version__ = "0.1.0"

from softwarerenderer_tpu.config import (  # noqa: F401
    BlendMode,
    CullMode,
    DepthTest,
    DebugMode,
    RenderParams,
)
