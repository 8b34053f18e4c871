"""Batched AI agents: N characters stepped in ONE jitted program.

Beyond the reference (which has no AI — every ConnectedPlayer is a
human, /root/reference/Renderer.cs:62-70), but built entirely from its
pieces: each agent is the reference's kinematic capsule controller
(CharacterController.cs, re-designed as the pure `character_step`) plus
a tiny waypoint-seeking brain, and the whole crowd advances with one
`jax.vmap`ped call — steering, the 9-ray ground probes, and every
capsule slide shell for ALL agents fuse into a single device program
(SURVEY.md §2.2 P5 taken to N characters).  This is the batched
answer to "add bots": the cost of one more bot is one more row in a
batch, not another thread.

Brain (deliberately simple, masked arithmetic only):
  * head toward `waypoints[waypoint_idx]` on the XZ plane — either a
    PRNG-chosen patrol target, or (with a `next_hop` routing table from
    `build_waypoint_graph`) the next hop on the shortest waypoint-graph
    path toward a PRNG-chosen `goal`
  * within `arrive_radius` → advance (next hop, or the next random
    waypoint without a graph)
  * grounded and barely moving for `stuck_time` seconds while far from
    the goal → jump (the Quake-style controller steps up low obstacles
    by itself; the jump unsticks taller lips)
  * crowd separation: pairwise XZ repulsion inside `separation_radius`
    keeps agents from stacking (one (N, N) tensor op)
  * combat (when `targets` are passed): nearest line-of-sight enemy
    within `sight_range` is pursued to `standoff` range and strafed;
    `fire`/`aim` outputs ride in the state for the host to turn into
    hitscan shots (dust2 reuses the SAME batched shoot path as human
    players), with per-agent PRNG aim spread and cooldown jitter
PRNG state (`key`) lives in the agent state, so trajectories are
deterministic and checkpoint/replay-safe like the particle system.

dust2 hosts expose this as `--bots N`: bots join the session as
ordinary players (buffered ConnectedPlayer + per-frame Update RPCs on
the reference's wire protocol), so remote reference-shaped clients
render and shoot them like humans.
"""

from __future__ import annotations

from typing import Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from softwarerenderer_tpu.sim.character import (
    DEFAULT_SLIDE_H_RAYS,
    DEFAULT_SLIDE_V_STEPS,
    character_step,
    initial_character_state,
)
from softwarerenderer_tpu.sim.raycast import raycast_batch

F32 = jnp.float32


def default_brain_params() -> Dict:
    """Steering tunables (traced, like the character params)."""
    return {
        "arrive_radius": np.float32(1.2),    # waypoint reached within this
        "stuck_speed": np.float32(0.35),     # XZ speed below this = stuck
        "stuck_time": np.float32(0.5),       # seconds below it before a jump
        "move_scale": np.float32(1.0),       # 0..1 throttle on move_input
        # Give up on an unreached waypoint after this many seconds (a
        # scattered goal can be unreachable — behind a wall, off the
        # walkable area); patience keeps the crowd from deadlocking.
        "patience": np.float32(6.0),
        # -- crowd separation ------------------------------------------
        "separation_radius": np.float32(1.2),  # repel inside this (XZ)
        "separation_gain": np.float32(1.0),    # steering weight
        # -- combat ----------------------------------------------------
        "sight_range": np.float32(30.0),       # acquire LOS targets within
        "fire_range": np.float32(25.0),        # shoot within
        "standoff": np.float32(6.0),           # keep this distance, strafe
        "fire_cooldown": np.float32(0.9),      # seconds between shots
        "aim_spread": np.float32(0.035),       # radians of PRNG aim noise
        "eye_height": np.float32(0.15),        # eye/chest offset above feet
    }


def initial_agents_state(positions, key=None, waypoint_idx=None) -> Dict:
    """Batched agent state for positions (N, 3).

    `waypoint_idx` (N,) selects each agent's first goal (default 0);
    `key` seeds the steering PRNG (split into one key PER AGENT, so a
    batch of N agents steps bit-identically to N separate batches of 1
    — tested in tests/test_agents.py)."""
    positions = jnp.asarray(positions, F32)
    n = positions.shape[0]
    char = jax.vmap(initial_character_state)(positions)
    if key is None:
        key = jax.random.PRNGKey(0)
    if waypoint_idx is None:
        waypoint_idx = jnp.zeros((n,), jnp.int32)
    waypoint = jnp.asarray(waypoint_idx, jnp.int32)
    return {
        "char": char,
        "waypoint": waypoint,
        # Route destination (== waypoint until a next_hop graph routes
        # through intermediate hops).
        "goal": waypoint,
        "wp_age": jnp.zeros((n,), F32),
        "slow_time": jnp.zeros((n,), F32),
        "key": jax.random.split(key, n),                   # (N, 2)
        # facing quaternion [x,y,z,w] per agent, yaw-only (players render
        # bots through the same quat slot as human Updates)
        "rotation": jnp.tile(jnp.asarray([0, 0, 0, 1], F32), (n, 1)),
        # -- combat I/O (outputs of the last step; ignored as inputs) --
        "cooldown": jnp.zeros((n,), F32),
        "strafe": 1.0 - 2.0 * (jnp.arange(n, dtype=F32) % 2),  # ±1
        "fire": jnp.zeros((n,), bool),
        "aim": jnp.tile(jnp.asarray([0, 0, -1], F32), (n, 1)),
    }


def agents_step(state: Dict, dt, waypoints, world: Dict,
                char_params: Dict, brain: Dict, tri_mask=None,
                next_hop=None, targets=None, target_alive=None,
                target_ids=None, self_ids=None,
                slide_v_steps: int = DEFAULT_SLIDE_V_STEPS,
                slide_h_rays: int = DEFAULT_SLIDE_H_RAYS) -> Dict:
    """Advance every agent one tick; returns the new state.

    waypoints: (W, 3) patrol targets shared by all agents (W ≥ 1).
    next_hop: optional (W, W) int32 routing table from
      `build_waypoint_graph` — next_hop[i, g] is the waypoint to walk to
      from i when heading for g; without it agents beeline to random
      waypoints.
    targets: optional (M, 3) enemy positions (feet), with
      target_alive (M,) bool, target_ids (M,) int32 and self_ids (N,)
      int32 (an agent never targets its own id).  Enables combat: the
      new state's "fire" (N,) / "aim" (N, 3) report who shoots where
      this tick (PRNG spread already applied); the host owns the actual
      hitscan so bot shots share the human shot pipeline.
    All other args match `character_step`."""
    waypoints = jnp.asarray(waypoints, F32)
    dt = jnp.asarray(dt, F32)
    pos = state["char"]["position"]                     # (N, 3)
    n = pos.shape[0]
    n_wp = waypoints.shape[0]

    # --- patrol steering --------------------------------------------------
    target = jnp.take(waypoints, state["waypoint"], axis=0)   # (N, 3)
    delta = (target - pos).at[:, 1].set(0.0)
    dist = jnp.linalg.norm(delta, axis=1)                     # (N,)
    arrived = dist < brain["arrive_radius"]

    # Per-agent PRNG: state["key"] is (N, 2); split each agent's key so
    # agent i's stream is independent of the batch it rides in.
    split6 = jax.vmap(lambda k: jax.random.split(k, 6))(state["key"])
    key, k_adv, k_jump = split6[:, 0], split6[:, 1], split6[:, 2]
    k_aim, k_strafe, k_cd = split6[:, 3], split6[:, 4], split6[:, 5]

    # --- combat sensing ---------------------------------------------------
    in_combat = jnp.zeros((n,), bool)
    if targets is not None:
        tpos = jnp.asarray(targets, F32)                      # (M, 3)
        m = tpos.shape[0]
        alive = (jnp.ones((m,), bool) if target_alive is None
                 else jnp.asarray(target_alive, bool))
        if target_ids is not None and self_ids is not None:
            not_self = (jnp.asarray(target_ids, jnp.int32)[None, :]
                        != jnp.asarray(self_ids, jnp.int32)[:, None])
        else:
            not_self = jnp.ones((n, m), bool)
        eye = pos + jnp.asarray([0, 1, 0], F32) * brain["eye_height"]
        chest = tpos + jnp.asarray([0, 1, 0], F32) * brain["eye_height"]
        tdelta = chest[None, :, :] - eye[:, None, :]          # (N, M, 3)
        tdist = jnp.linalg.norm(tdelta, axis=2)               # (N, M)
        cand = alive[None, :] & not_self & (tdist < brain["sight_range"])
        # Line of sight: one batched wave of N·M rays vs the (map-only)
        # collision world; a hit closer than the target blocks it.
        los = raycast_batch(
            eye[:, None, :].repeat(m, 1).reshape(-1, 3),
            tdelta.reshape(-1, 3), world, tri_mask=tri_mask)
        blocked = (los["hit"]
                   & (los["distance"] < jnp.maximum(
                       tdist.reshape(-1) - 0.3, 0.0))).reshape(n, m)
        visible = cand & ~blocked
        big = jnp.finfo(jnp.float32).max
        tsel = jnp.argmin(jnp.where(visible, tdist, big), axis=1)  # (N,)
        in_combat = visible.any(axis=1)
        sel_delta = jnp.take_along_axis(
            tdelta, tsel[:, None, None].repeat(3, 2), axis=1)[:, 0]  # (N,3)
        sel_dist = jnp.take_along_axis(tdist, tsel[:, None], axis=1)[:, 0]

        # Pursue to standoff range, then strafe around the target (the
        # strafe sign flips with small PRNG probability so orbits vary).
        to_enemy = sel_delta.at[:, 1].set(0.0)
        to_enemy = to_enemy / jnp.maximum(
            jnp.linalg.norm(to_enemy, axis=1, keepdims=True), 1e-6)
        side = jnp.stack([-to_enemy[:, 2], jnp.zeros(n, F32),
                          to_enemy[:, 0]], axis=1)
        flip = jax.vmap(lambda k: jax.random.uniform(k, ()))(k_strafe) \
            < dt * 0.4
        strafe = jnp.where(flip, -state["strafe"], state["strafe"])
        close = sel_dist < brain["standoff"]
        combat_move = jnp.where(close[:, None],
                                side * strafe[:, None] - 0.3 * to_enemy,
                                to_enemy)
        # Fire control: in range, off cooldown → fire with PRNG-spread aim.
        cooldown = jnp.maximum(state["cooldown"] - dt, 0.0)
        fire = in_combat & (sel_dist < brain["fire_range"]) & (cooldown <= 0)
        noise = jax.vmap(
            lambda k: jax.random.normal(k, (3,)))(k_aim)       # (N, 3)
        aim = sel_delta / jnp.maximum(
            jnp.linalg.norm(sel_delta, axis=1, keepdims=True), 1e-6)
        aim = aim + noise * brain["aim_spread"] * jnp.maximum(
            sel_dist[:, None] / brain["fire_range"], 0.2)
        aim = aim / jnp.maximum(
            jnp.linalg.norm(aim, axis=1, keepdims=True), 1e-6)
        cooldown = jnp.where(fire, brain["fire_cooldown"]
                             * (0.75 + 0.5 * jax.vmap(
                                 lambda k: jax.random.uniform(k, ()))(
                                     k_cd)), cooldown)
    else:
        strafe = state["strafe"]
        cooldown = jnp.maximum(state["cooldown"] - dt, 0.0)
        fire = jnp.zeros((n,), bool)
        aim = state["aim"]
        combat_move = jnp.zeros((n, 3), F32)
        sel_delta = jnp.zeros((n, 3), F32)

    # --- waypoint advance / routing (suspended while fighting) ------------
    age = state["wp_age"] + dt * (1.0 - in_combat.astype(F32))
    switch = (arrived | (age > brain["patience"])) & ~in_combat
    if n_wp > 1:
        advance = jax.vmap(
            lambda k: jax.random.randint(k, (), 1, n_wp))(k_adv)  # 1..W-1
        rand_wp = (state["waypoint"] + advance) % n_wp
    else:
        rand_wp = state["waypoint"]
    if next_hop is not None:
        hop = jnp.asarray(next_hop, jnp.int32)                # (W, W)
        at_goal = state["waypoint"] == state["goal"]
        # Reached the goal (or gave up): pick a fresh random goal; else
        # keep routing toward the current one.
        goal = jnp.where(switch & (at_goal | (age > brain["patience"])),
                         rand_wp, state["goal"])
        waypoint = jnp.where(switch, hop[state["waypoint"], goal],
                             state["waypoint"])
    else:
        waypoint = jnp.where(switch, rand_wp, state["waypoint"])
        goal = waypoint
    wp_age = jnp.where(switch, 0.0, age)

    safe = jnp.maximum(dist, 1e-6)[:, None]
    move_dir = delta / safe                                   # (N, 3) unit XZ
    patrol_move = jnp.where(arrived[:, None], 0.0,
                            move_dir * brain["move_scale"])
    move_input = jnp.where(in_combat[:, None], combat_move, patrol_move)

    # --- crowd separation: pairwise XZ repulsion (one (N, N) op) ----------
    if n > 1:
        pd = pos[:, None, :] - pos[None, :, :]                # (N, N, 3)
        pd = pd.at[:, :, 1].set(0.0)
        pdist = jnp.linalg.norm(pd, axis=2)
        w = jnp.clip(1.0 - pdist / brain["separation_radius"], 0.0, 1.0)
        w = w * (1.0 - jnp.eye(n, dtype=F32))
        rep = (pd / jnp.maximum(pdist, 1e-6)[:, :, None]
               * w[:, :, None]).sum(axis=1)
        move_input = move_input + rep * brain["separation_gain"]
        norm = jnp.linalg.norm(move_input, axis=1, keepdims=True)
        move_input = jnp.where(norm > 1.0,
                               move_input / jnp.maximum(norm, 1e-6),
                               move_input)

    # Unstick: blocked below stuck_speed of ACTUAL movement for
    # stuck_time seconds → jump.  slow_time accumulated LAST frame from
    # real displacement (the controller keeps its commanded velocity
    # when a slide blocks all movement, so velocity is a lie here);
    # dither so a whole wall-hugging crowd doesn't pogo in sync.
    stuck = ~arrived & (state["slow_time"] >= brain["stuck_time"])
    jump = stuck & (jax.vmap(
        lambda k: jax.random.uniform(k, ()))(k_jump) < 0.5)

    # Facing: rotate [0,0,-1] by yaw to the move direction (or at the
    # combat target — dust2 builds human Update quats the same way).
    face = jnp.where(in_combat[:, None], sel_delta, move_dir)
    yaw = jnp.arctan2(-face[:, 0], -face[:, 2])
    half = 0.5 * yaw
    quat = jnp.stack([jnp.zeros(n, F32), jnp.sin(half),
                      jnp.zeros(n, F32), jnp.cos(half)], axis=1)
    rotation = jnp.where((arrived & ~in_combat)[:, None],
                         state["rotation"], quat)

    # --- physics: every agent's controller step in one vmap ---------------
    char = jax.vmap(
        lambda s, m_, j: character_step(
            s, m_, j, dt, world, char_params, tri_mask=tri_mask,
            slide_v_steps=slide_v_steps, slide_h_rays=slide_h_rays)
    )(state["char"], move_input, jump)

    # Accumulate the stuck streak from the step's real XZ displacement.
    disp = char["position"] - pos
    speed_xz = jnp.linalg.norm(disp[:, (0, 2)], axis=1) / jnp.maximum(
        dt, 1e-6)
    slow_now = (char["grounded"] & ~arrived
                & (speed_xz < brain["stuck_speed"]))
    slow_time = jnp.where(slow_now & ~jump, state["slow_time"] + dt, 0.0)

    return {"char": char, "waypoint": waypoint, "goal": goal,
            "wp_age": wp_age, "slow_time": slow_time, "key": key,
            "rotation": rotation, "cooldown": cooldown, "strafe": strafe,
            "fire": fire, "aim": aim}


def respawn_agent(state: Dict, index, position) -> Dict:
    """Teleport one agent (bot respawn after a kill): zero its velocity
    and place it at `position`.  Host-side index may be traced or int."""
    position = jnp.asarray(position, F32)
    char = dict(state["char"])
    char["position"] = state["char"]["position"].at[index].set(position)
    char["velocity"] = state["char"]["velocity"].at[index].set(0.0)
    return {**state, "char": char,
            "wp_age": state["wp_age"].at[index].set(0.0),
            "slow_time": state["slow_time"].at[index].set(0.0)}


def scatter_waypoints_on_floor(world: Dict, centers, n_points: int,
                               seed: int = 0, height: float = 30.0,
                               radius: float = 12.0,
                               tri_mask=None) -> np.ndarray:
    """Build a walkable waypoint set by dropping rays onto the map floor.

    Samples `n_points` XZ offsets around each center, raycasts straight
    down (one batched Möller–Trumbore wave, sim/raycast.py), and keeps
    the hit points; centers themselves are always included.  Host-side
    setup helper (runs once), returns (W, 3) float32 on host."""
    centers = np.atleast_2d(np.asarray(centers, np.float32))
    rng = np.random.default_rng(seed)
    offs = rng.uniform(-radius, radius, size=(len(centers), n_points, 2))
    starts = np.repeat(centers[:, None, :], n_points, axis=1).copy()
    starts[..., 0] += offs[..., 0]
    starts[..., 2] += offs[..., 1]
    starts[..., 1] += height
    origins = starts.reshape(-1, 3)
    dirs = np.tile(np.asarray([[0.0, -1.0, 0.0]], np.float32),
                   (len(origins), 1))
    res = jax.device_get(
        raycast_batch(jnp.asarray(origins), jnp.asarray(dirs), world,
                      tri_mask=tri_mask))
    floor = res["point"][np.asarray(res["hit"], bool)]
    return np.concatenate([centers, np.asarray(floor, np.float32)], axis=0)


def build_waypoint_graph(world: Dict, waypoints, tri_mask=None,
                         eye_height: float = 0.4,
                         max_edge: float = 18.0,
                         max_climb: float = 1.5) -> np.ndarray:
    """All-pairs shortest-path routing table over a waypoint set.

    Edges: waypoint pairs within `max_edge` whose eye-height sightline
    is unobstructed (ONE batched W² raycast wave vs the map soup) and
    whose height difference is ≤ `max_climb` (the controller can step /
    jump that much; a clear sightline down a cliff is not a walkable
    edge up it — kept symmetric for simplicity).

    Returns next_hop (W, W) int32: next_hop[i, g] = the neighbor to walk
    to from waypoint i en route to g (Floyd–Warshall on host — W is
    tens, so the O(W³) host loop is microseconds; the per-frame lookup
    `next_hop[waypoint, goal]` is the only part the device sees).
    Unreachable pairs fall back to the beeline: next_hop[i, g] = g.
    """
    wps = np.asarray(waypoints, np.float32)
    w = len(wps)
    eye = wps + np.asarray([0, eye_height, 0], np.float32)
    delta = eye[None, :, :] - eye[:, None, :]                 # (W, W, 3)
    dist = np.linalg.norm(delta, axis=2)
    origins = np.repeat(eye, w, axis=0)                       # (W², 3)
    dirs = delta.reshape(-1, 3)
    dirs[np.linalg.norm(dirs, axis=1) < 1e-6] = [0, 1, 0]     # self rows
    res = jax.device_get(raycast_batch(
        jnp.asarray(origins), jnp.asarray(dirs), world, tri_mask=tri_mask))
    blocked = (np.asarray(res["hit"], bool)
               & (np.asarray(res["distance"])
                  < dist.reshape(-1) - 1e-3)).reshape(w, w)
    edge = ((dist <= max_edge)
            & (np.abs(wps[None, :, 1] - wps[:, None, 1]) <= max_climb)
            & ~blocked & ~np.eye(w, dtype=bool))
    edge = edge | edge.T                                      # symmetric

    # Floyd–Warshall with path reconstruction.
    inf = np.float64(np.inf)
    d = np.where(edge, dist, inf)
    np.fill_diagonal(d, 0.0)
    nxt = np.where(edge, np.arange(w)[None, :], -1).astype(np.int32)
    np.fill_diagonal(nxt, np.arange(w))
    for k in range(w):
        alt = d[:, k, None] + d[None, k, :]
        better = alt < d
        d = np.where(better, alt, d)
        nxt = np.where(better, nxt[:, k, None], nxt)
    nxt = np.where(nxt < 0, np.arange(w)[None, :], nxt)       # beeline
    return nxt.astype(np.int32)
