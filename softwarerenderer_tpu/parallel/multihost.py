"""Multi-host (DCN) scale-out entry points.

Within a host, framebuffer/triangle sharding runs over the local devices
(parallel/sharding.py, parallel/ring.py).  Across hosts, JAX's standard
multi-controller runtime carries the same programs over DCN: every host
runs the identical jitted frame, the global mesh spans all processes, and
XLA partitions collectives into intra-host and cross-host phases
automatically.  This module is the thin bootstrap; it cannot be
exercised in a single-host image, but the mesh construction and sharding
layout below are what a multi-host launch uses unchanged.

Launch (one command per host):
  SRT_COORD=host0:9999 SRT_NUM_PROCS=4 SRT_PROC_ID=<i> python app.py
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np


def initialize_from_env() -> bool:
    """jax.distributed bootstrap from SRT_* (or JAX_*) env vars.
    Returns True when running multi-process, False for single-host."""
    import jax
    coord = os.environ.get("SRT_COORD")
    if not coord:
        return False
    jax.distributed.initialize(
        coordinator_address=coord,
        num_processes=int(os.environ["SRT_NUM_PROCS"]),
        process_id=int(os.environ["SRT_PROC_ID"]),
    )
    return True


def make_global_mesh(n_fb: Optional[int] = None, n_tri: int = 1):
    """An (fb, tri) mesh over ALL processes' devices; fb rows land so that
    each host owns contiguous bands (framebuffer halves stay host-local and
    only the triangle-axis winner all-reduce crosses DCN)."""
    import jax
    from jax.sharding import Mesh
    devices = jax.devices()          # global, ordered by process
    if n_fb is None:
        n_fb = len(devices) // n_tri
    arr = np.asarray(devices[: n_fb * n_tri]).reshape(n_fb, n_tri)
    return Mesh(arr, axis_names=("fb", "tri"))
