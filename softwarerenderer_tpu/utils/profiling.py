"""Tracing / profiling / metrics — first-class, unlike the reference.

The reference's only instrumentation is a display-only ImGui FPS pane
(Renderer.cs:662-668; SURVEY.md §5 "no tracer/profiler").  Here:

  * FrameStats — rolling frame-time window with fps / p50 / p99 and the
    throughput counters BASELINE.md names first-class: Mpixels/s shaded
    and Mtriangles/s through raster
  * stage_timer — wall-clock span recorder (host-side stages: input, net,
    sim dispatch, render dispatch, present)
  * trace() — context manager around jax.profiler for device-side traces
    viewable in TensorBoard/Perfetto
  * counters() — a plain dict snapshot for HUD display or structured logs
"""

from __future__ import annotations

import collections
import contextlib
import time
from typing import Dict, Optional


class FrameStats:
    """Rolling window of frame times + workload counters."""

    def __init__(self, window: int = 120):
        self._times = collections.deque(maxlen=window)
        self._stages: Dict[str, collections.deque] = {}
        self.pixels_per_frame = 0
        self.triangles_per_frame = 0
        self._last = None

    def frame(self, pixels: Optional[int] = None,
              triangles: Optional[int] = None) -> None:
        """Call once per presented frame."""
        now = time.perf_counter()
        if self._last is not None:
            self._times.append(now - self._last)
        self._last = now
        if pixels is not None:
            self.pixels_per_frame = pixels
        if triangles is not None:
            self.triangles_per_frame = triangles

    @contextlib.contextmanager
    def stage(self, name: str):
        """Per-stage host span: with stats.stage("render"): ..."""
        dq = self._stages.setdefault(name, collections.deque(maxlen=120))
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dq.append(time.perf_counter() - t0)

    def _pct(self, sorted_times, q):
        if not sorted_times:
            return 0.0
        i = min(len(sorted_times) - 1, int(q * (len(sorted_times) - 1)))
        return sorted_times[i]

    def counters(self) -> Dict[str, float]:
        ts = sorted(self._times)
        mean = sum(ts) / len(ts) if ts else 0.0
        fps = 1.0 / mean if mean > 0 else 0.0
        out = {
            "fps": fps,
            "frame_ms_mean": mean * 1000.0,
            "frame_ms_p50": self._pct(ts, 0.50) * 1000.0,
            "frame_ms_p99": self._pct(ts, 0.99) * 1000.0,
            "mpixels_per_s": self.pixels_per_frame * fps / 1e6,
            "mtris_per_s": self.triangles_per_frame * fps / 1e6,
        }
        for name, dq in self._stages.items():
            if dq:
                out[f"stage_{name}_ms"] = 1000.0 * sum(dq) / len(dq)
        return out

    def debug_lines(self):
        c = self.counters()
        lines = [f"{c['fps']:6.1f} fps   {c['frame_ms_mean']:6.2f} ms "
                 f"(p99 {c['frame_ms_p99']:.2f})",
                 f"{c['mpixels_per_s']:8.2f} Mpix/s  "
                 f"{c['mtris_per_s']:8.2f} Mtris/s"]
        for k, v in sorted(c.items()):
            if k.startswith("stage_"):
                lines.append(f"{k[6:]:>10s}: {v:6.2f} ms")
        return lines


@contextlib.contextmanager
def trace(log_dir: str = "/tmp/srt_trace"):
    """Device-side profiler trace (jax.profiler) around a code span."""
    import jax
    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()


def annotate(name: str):
    """Named span inside a trace (shows up in the profiler timeline)."""
    import jax
    return jax.profiler.TraceAnnotation(name)


class DeviceSyncTimeout(RuntimeError):
    """A device sync did not complete within its watchdog window —
    the device is wedged.  Raised by hard_sync/timed_frames instead of
    hanging the calling session forever."""


def hard_sync(out, timeout_s: Optional[float] = None) -> float:
    """Force completion of ALL device work `out` depends on; return a probe.

    A DATA-DEPENDENT scalar readback cannot return early: the device
    reduces the last output to one scalar and the host blocks on that
    transfer, which (by in-order program execution) awaits every
    previously enqueued frame.

    timeout_s: watchdog window.  The blocking readback runs on a worker
    thread; if it hasn't completed in time, a thread dump goes to stderr
    and DeviceSyncTimeout is raised so hardware-facing loops fail loudly
    with a diagnosis instead of hanging a session (the stuck worker
    thread is daemonic — process exit is not blocked).  None = block
    indefinitely (interactive callers that prefer Ctrl-C).

    Use as the one sync point of a pipelined timing loop:

        t0 = perf_counter()
        for i in range(n): out = step(i)
        hard_sync(out, timeout_s=120)
        dt = perf_counter() - t0
    """
    import jax
    import jax.numpy as jnp
    import numpy as np
    leaves = [x for x in jax.tree_util.tree_leaves(out)
              if hasattr(x, "dtype")]
    probe = sum(jnp.sum(x.astype(jnp.float32)) for x in leaves)
    if timeout_s is None:
        return float(np.asarray(probe))

    import threading
    box: Dict[str, object] = {}

    def _read():
        try:
            box["value"] = float(np.asarray(probe))
        except BaseException as e:          # surfaced below
            box["error"] = e

    th = threading.Thread(target=_read, daemon=True,
                          name="hard_sync_readback")
    th.start()
    th.join(timeout_s)
    if th.is_alive():
        import faulthandler
        import sys
        sys.stderr.write(
            f"\n[hard_sync] device readback still blocked after "
            f"{timeout_s:.0f}s — dumping all threads:\n")
        faulthandler.dump_traceback(file=sys.stderr)
        raise DeviceSyncTimeout(
            f"device sync did not complete within {timeout_s:.0f}s; the "
            f"device is likely wedged (a previously killed run can leave "
            f"it stuck).  Diagnosis: small "
            f"programs may still work while large ones hang; re-acquire "
            f"or reset the device before re-running benchmarks.")
    if "error" in box:
        raise box["error"]  # type: ignore[misc]
    return box["value"]  # type: ignore[return-value]


def timed_frames(step_fn, n_frames: int, *, warmup: int = 2,
                 timeout_s: Optional[float] = None):
    """Pipelined-N-frames timing with one hard_sync.  step_fn(i) must
    vary its inputs with i (defeat program/result caching) and return
    device arrays.

    timeout_s bounds EACH of the two syncs (warmup and timed) via
    hard_sync's watchdog; on expiry DeviceSyncTimeout propagates with a
    thread dump already on stderr.

    Returns seconds per frame."""
    out = None
    for i in range(warmup):
        out = step_fn(i)
    hard_sync(out, timeout_s=timeout_s)
    t0 = time.perf_counter()
    for i in range(n_frames):
        out = step_fn(warmup + i)
    hard_sync(out, timeout_s=timeout_s)
    return (time.perf_counter() - t0) / n_frames


def arm_watchdog(name: str, timeout_s: float, exit_code: int = 42):
    """Arm a hard process watchdog; returns a zero-arg cancel function.

    If not cancelled within timeout_s: dump all thread stacks to stderr
    and os._exit(exit_code).  A hung device call blocks in native code
    and cannot be interrupted by raising in the main thread — for a
    script the honest failure is a loud diagnostic and a non-zero exit
    within seconds, not a silently hung session.
    Library code should prefer hard_sync(timeout_s=...), which raises
    instead of exiting."""
    import faulthandler
    import os
    import sys
    import threading

    done = threading.Event()

    def _fire():
        if done.wait(timeout_s):
            return
        sys.stderr.write(
            f"\n[watchdog] stage '{name}' exceeded {timeout_s:.0f}s — "
            f"device likely wedged; dumping threads and exiting "
            f"{exit_code}:\n")
        faulthandler.dump_traceback(file=sys.stderr)
        sys.stderr.flush()
        os._exit(exit_code)

    threading.Thread(target=_fire, daemon=True,
                     name=f"watchdog:{name}").start()
    return done.set


@contextlib.contextmanager
def watchdog(name: str, timeout_s: float, exit_code: int = 42):
    """Context-manager form of arm_watchdog (see its docstring)."""
    cancel = arm_watchdog(name, timeout_s, exit_code)
    try:
        yield
    finally:
        cancel()
