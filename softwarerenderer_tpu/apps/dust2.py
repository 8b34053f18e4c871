"""The Dust2 multiplayer FPS demo — the reference game on the JAX engine.

Reproduces /root/reference/Renderer.cs end to end: Quake-style movement on
the Dust2 map, hitscan shooting with health/respawn, UDP multiplayer with
host election and chat, view-model gun with sway/recoil, nametags, HUD,
live-tunable fog/light, noclip + mouse-capture toggles.

Architecture differences (SURVEY.md §7):
  * ALL meshes (map + gun + MAX_PLAYERS player-model slots) live in ONE
    packed device scene; per-frame motion only rewrites the (M, 4, 4)
    mesh-matrix array + a mesh-visibility mask (Renderer.cs:444-540)
  * the WHOLE frame is ONE fused jitted device program (r5): character
    physics + bot crowd + particle sim + gun matrix + render + RGB8
    convert run as a single dispatch `(sim, ctl, uniforms) → (sim',
    rgb8, aux)`; the only per-frame host crossings are the tiny ctl
    upload and one pipelined (rgb8, aux) readback joined two frames
    later — the reference instead re-enters the thread pool and the
    GL upload every frame (Renderer.cs:258-268, MainWindow.cs:247-251)
  * shooting is one batched raycast against the whole soup with
    per-group masks instead of per-player Parallel.ForEach
    (Renderer.cs:172-249); it dispatches only on a click (4 Hz cap)
  * network RPCs are polled on the main thread (race-free), with the
    reference's exact RPC vocabulary (Renderer.cs:862-965)

Game constants are the reference's (Renderer.cs:30-46): spawns, fog
(1..25, color 1/0.62/0.5), light euler (-45,-45,0), clear color
(0.9137, 0.7098, 0.6588), FOV 90, shot cooldown 0.25 s, damage 10.

Run headless: python -m softwarerenderer_tpu.apps.dust2 --headless
--frames 3 --out /tmp/frame.png

Beyond-reference flags: --bots N (AI crowd) --dedicated (relay server)
--reliable --migrate --net-batch S (networking) --burn-hud (device text
overlay in the framebuffer) --record clip.avi (first-party AVI capture)
--mirror (rear-view picture-in-picture) --kbuffer K (ordered
translucency) --raytrace [CAP] (per-pixel ray-traced frames with exact
hard shadows — interactive via the r4 Pallas bundle sweep)
--config srt.json (utils/appconfig; SRT_* env overrides).
Gamepads work out of the box (left stick move, right stick look,
south button jump, trigger fire).
"""

from __future__ import annotations

import argparse
import math
import os
import random
import time
from typing import List, Optional

import numpy as np

import jax
import jax.numpy as jnp

from softwarerenderer_tpu import RenderParams
from softwarerenderer_tpu.engine import Engine, camera_matrices
from softwarerenderer_tpu.io_host import audio, model_loader
from softwarerenderer_tpu.io_host.networking import Networking
from softwarerenderer_tpu.io_host.ui import Hud, project_nametag
from softwarerenderer_tpu.io_host.window import make_window
from softwarerenderer_tpu.models import primitives, scene as scene_mod
from softwarerenderer_tpu.ops import texture as tex_ops
from softwarerenderer_tpu.sim import (
    agents_step,
    build_collision_world,
    build_waypoint_graph,
    character_step,
    default_brain_params,
    default_character_params,
    initial_agents_state,
    initial_character_state,
    raycast_batch,
    respawn_agent,
    scatter_waypoints_on_floor,
)
from softwarerenderer_tpu.sim import particles as particles_mod
from softwarerenderer_tpu.utils import mathlib as ml

F32 = np.float32

DEFAULT_ASSETS = os.environ.get(
    "SRT_ASSETS", "/root/reference/OutputAssets/Assets")

SPAWN_1 = np.asarray([-16.4, 1.5, 6.5], F32)      # Renderer.cs:30
SPAWN_2 = np.asarray([-16.5, 0.6, -23.0], F32)    # Renderer.cs:31
MAP_SCALE = 0.5                                    # Renderer.cs:32
SHOT_COOLDOWN = 0.25                               # Renderer.cs:60
SHOT_DAMAGE = 10.0                                 # Renderer.cs:223
SHOT_RANGE = 100.0                                 # Renderer.cs:176
MOUSE_SENSITIVITY = 0.1                            # Camera.cs:10
BOT_ID_BASE = 10000          # bot player ids live far above host-assigned


def _ray_capsule_t(origin, direction, cap_a, cap_b, radius):
    """Distance along the ray (origin, unit direction) to a vertical
    capsule [cap_a, cap_b] of `radius`, or None on a miss.  Host-side
    analytic test for the one hitbox that has no mesh in the local
    scene: the local player (see _bot_fire)."""
    o = np.asarray(origin, np.float64)
    d = np.asarray(direction, np.float64)
    d = d / max(np.linalg.norm(d), 1e-12)
    a = np.asarray(cap_a, np.float64)
    b = np.asarray(cap_b, np.float64)
    ab = b - a
    # Coarse-to-fine: sample the ray's closest approach to the segment.
    # (A closed-form ray/capsule exists but the quadratic's edge cases —
    # caps, parallel axis — outweigh its value for an AI hit test; 32
    # samples over SHOT_RANGE are exact to ~3 m / 32 ≈ 0.1 m in t, and
    # we refine the winner with a golden-section pass.)
    def seg_dist(t):
        p = o + d * t
        s = np.clip(np.dot(p - a, ab) / max(np.dot(ab, ab), 1e-12), 0, 1)
        return np.linalg.norm(p - (a + ab * s))
    ts = np.linspace(0.0, SHOT_RANGE, 64)
    p = o[None, :] + d[None, :] * ts[:, None]
    s = np.clip((p - a) @ ab / max(float(ab @ ab), 1e-12), 0.0, 1.0)
    dd = np.linalg.norm(p - (a[None, :] + ab[None, :] * s[:, None]),
                        axis=1)
    k = int(np.argmin(dd))
    lo = ts[max(k - 1, 0)]
    hi = ts[min(k + 1, len(ts) - 1)]
    for _ in range(24):                     # ternary refine
        m1 = lo + (hi - lo) / 3
        m2 = hi - (hi - lo) / 3
        if seg_dist(m1) <= seg_dist(m2):
            hi = m2
        else:
            lo = m1
    t_best = 0.5 * (lo + hi)
    if seg_dist(t_best) > radius:
        return None
    # walk back to the ENTRY point (first t whose distance == radius)
    while t_best > 0 and seg_dist(max(t_best - 0.01, 0.0)) <= radius:
        t_best = max(t_best - 0.01, 0.0)
    return float(t_best)


class ConnectedPlayer:
    """Renderer.cs:63-70."""

    def __init__(self, pid: int, name: str):
        self.id = pid
        self.name = name
        self.position = np.zeros(3, F32)
        self.local_position = np.zeros(3, F32)
        self.rotation = ml.QUAT_IDENTITY.copy()
        self.health = 100.0
        self.kills = 0
        self.deaths = 0


def load_player_name(path: str = "./Playername.txt") -> str:
    """Renderer.LoadPlayerNameFromFile (:86-110)."""
    try:
        with open(path) as f:
            name = f.read().strip()
        return name or "Player"
    except OSError:
        return "Player"


def _fallback_map():
    """Procedural arena when the Dust2 assets are unavailable."""
    checker = np.asarray(tex_ops.checkerboard(
        64, 8, (0.8, 0.75, 0.6, 1.0), (0.55, 0.5, 0.4, 1.0))["data"])
    meshes = [dict(primitives.plane(80.0), material=scene_mod.Material(),
                   bounds_center=np.zeros(3, F32), bounds_radius=60.0)]
    rng = np.random.default_rng(7)
    for _ in range(12):
        cube = primitives.cube(3.0)
        offs = rng.uniform(-30, 30, 3).astype(F32)
        offs[1] = 1.5
        cube["position"] = cube["position"] + offs
        c, r = scene_mod.bounding_sphere(cube["position"])
        meshes.append(dict(cube, material=scene_mod.Material(),
                           bounds_center=c, bounds_radius=r))
    model = model_loader.Model(meshes=meshes)
    return model, checker


class Dust2Game:
    def __init__(self, server: str = "127.0.0.1", port: int = 7777,
                 width: int = 800, height: int = 600,
                 render_scale: float = 0.25, headless: bool = False,
                 assets_dir: str = DEFAULT_ASSETS,
                 player_name: Optional[str] = None,
                 max_players: int = 8, out: Optional[str] = None,
                 offline: bool = False, seed: Optional[int] = None,
                 reliable: bool = False, migrate: bool = False,
                 net_batch: float = 0.0, upnp: bool = False,
                 bots: int = 0, bot_skill: str = "normal",
                 burn_hud: bool = False, record: Optional[str] = None,
                 record_fps: float = 30.0, mirror: bool = False,
                 kbuffer: int = 1, raytrace: int = 0):
        self.window = make_window(width, height, render_scale,
                                  headless=headless or None, out_path=out)
        # Burn the HUD into the framebuffer ON DEVICE (ops/text.py post-FX
        # stage) so headless captures / recordings carry it; the host
        # overlay (io_host/ui.py) still draws for interactive windows.
        self.burn_hud = burn_hud
        # Gameplay capture to an uncompressed AVI (utils/video.py) — works
        # headless; combine with burn_hud for a complete recording.
        self._recorder = None
        if record:
            from softwarerenderer_tpu.utils.video import AviWriter
            self._recorder = AviWriter(record, fps=record_fps)
        # Rear-view mirror: a second camera rendered as a top-center
        # picture-in-picture inside the same jitted frame
        # (engine.render_frame_pip; beyond the reference's single view).
        self.mirror = mirror
        self._frame_fn = None
        if mirror:
            from softwarerenderer_tpu.engine import render_frame_pip
            self._frame_fn = render_frame_pip
        # Ray-traced render mode (the bundle-culled pair sweep,
        # ops/rt_accel.py).  The value is the per-bundle cluster budget; physics/gameplay are unchanged (the raycast
        # sim never rendered), but RT ignores vertex updates (decal/
        # particle quads ride the scene as static geometry per frame).
        if raytrace:
            if mirror:
                raise SystemExit("--raytrace and --mirror both own the "
                                 "frame program; pick one")
            import functools
            from softwarerenderer_tpu.ops.raytrace import (
                render_frame_raytraced,
            )
            self._frame_fn = functools.partial(
                render_frame_raytraced, cluster_cap=int(raytrace))
        # Ordered translucency: K-layer frames (ops/kbuffer,
        # ops/tile_fold) — overlapping alpha content (particles, decals)
        # then blends in submission order like the reference's sequential
        # shade-blend instead of winner-takes-all.
        self.kbuffer = max(1, int(kbuffer))
        self.hud = Hud()
        # Layout persistence (the reference restores its ImGui dock layout
        # from OutputAssets/Layouts/DefaultLayout.ini, Renderer.cs:304-308;
        # here: positions + visibility toggles round-trip a JSON file).
        self.layout_path = "hud_layout.json"
        self.hud.load_layout(self.layout_path)
        self.max_players = max_players
        self.player_name = player_name or load_player_name()
        self.assets_dir = assets_dir
        self.rng = random.Random(seed)
        # Opt-in reliable delivery for state-critical RPCs (join, hits,
        # chat) — requires every peer to run this framework (the seq/ack
        # extension is not in the reference's wire protocol).
        self.reliable = reliable

        self._load_scene()
        self._init_state()

        # Networking bootstrap (Renderer.cs:75-82).
        self.net = Networking()
        # Windowed RPC batching: the frame's Update plus any chat/shoot
        # RPCs coalesce into one datagram per peer per window (flushed on
        # the game loop's poll_rpcs call each frame).
        self.net.rpc_batch_window = max(0.0, net_batch)
        # UPnP (Networking.cs:32-69): if this peer becomes the host, map
        # the session port on the LAN gateway so WAN friends can join.
        self.net.upnp_enabled = upnp
        if migrate:
            # Elastic recovery (beyond the reference, which strands
            # clients when the host dies): heartbeat failure detection +
            # lowest-id host election; on landing in the new session,
            # re-announce this player and let remote state rebuild.
            # The callback runs on the migration thread — it only QUEUES
            # the signal; the main loop consumes it on the poll path
            # (players/chat are main-thread state, SURVEY §5 races).
            self.net.peer_timeout = 2.0
            self.net.enable_host_migration = True
            self._migrated_signal: Optional[bool] = None
            self.net.on_migrated.append(
                lambda is_host: setattr(self, "_migrated_signal", is_host))
        if not offline:
            self.net.log = lambda s: None
            if not self.net.connect(server, port):
                raise SystemExit(1)  # Renderer.cs:115-118
            self.net.send_rpc(
                "ConnectedPlayer",
                [str(self.net.client_id), self.player_name],
                buffer_rpc=True, reliable=self.reliable)
        self.players: List[ConnectedPlayer] = []
        self._init_bots(bots, bot_skill)

    def _on_migrated(self, is_host: bool) -> None:
        """Landed in the migrated session (runs on the MAIN thread via
        the queued signal): drop the old roster (ids were reassigned)
        and re-announce; peers reappear via their own re-announcements."""
        self.players = []
        self.hud.add_chat("* host migrated"
                          + (" (you are the new host)" if is_host else ""))
        self.net.send_rpc(
            "ConnectedPlayer",
            [str(self.net.client_id), self.player_name],
            buffer_rpc=True, reliable=self.reliable)

    # Static shape of the burned-in HUD text (ops/text.py): slots × chars.
    HUD_TEXT_SLOTS = 16
    HUD_TEXT_CHARS = 48

    def _burn_hud_entries(self, tags):
        """Mirror the host HUD's key elements (crosshair, health, fps,
        chat, spectator banner, nametags — Renderer.cs:310-656) into
        packed device-text uniforms for the burn-in overlay.  `tags` is
        the frame's nametag list (computed once per frame in _render)."""
        from softwarerenderer_tpu.ops import text as text_ops
        p = self.engine.params
        # Post-FX stages run inside the ssaa branch's inner call, so the
        # overlay composites at the supersampled resolution — lay out
        # against that buffer (glyphs then downsample with the frame).
        rw, rh = p.width * p.ssaa, p.height * p.ssaa
        f = self._hud_font
        cw, chh = int(f["cell_w"]), int(f["cell_h"])
        hs = self.hud.state
        entries = [("+", (rw // 2 - cw // 2, rh // 2 - chh // 2),
                    (1.0, 1.0, 1.0, 0.9))]
        entries.append((f"hp {max(0, int(hs.health))}",
                        (4, rh - chh - 4), (0.35, 1.0, 0.35)))
        fps = self.stats.counters()["fps"]
        fps_s = f"{fps:5.1f} fps"
        entries.append((fps_s, (rw - len(fps_s) * cw - 4, 4),
                        (1.0, 1.0, 0.4)))
        row = 4
        if hs.spectating:
            entries.append((f"spectating {hs.spectating}", (4, row),
                            (1.0, 0.75, 0.2)))
            row += chh + 2
        for msg in hs.chat_messages[-4:]:
            entries.append((msg, (4, row), (1.0, 1.0, 1.0, 0.85)))
            row += chh + 1
        # Nametags project at window resolution; rescale to render pixels.
        sx = rw / max(1, self.window.width)
        sy = rh / max(1, self.window.height)
        for tx, ty, name in tags:
            entries.append((name,
                            (int(tx * sx - len(name) * cw * 0.5),
                             int(ty * sy - chh)), (0.9, 0.9, 1.0)))
        return text_ops.pack_text(entries, max_strings=self.HUD_TEXT_SLOTS,
                                  max_chars=self.HUD_TEXT_CHARS)

    # -- AI bots (beyond the reference; sim/agents.py) ------------------------

    # Difficulty presets: brain tunables only — the controller physics
    # stay identical to a human player's (no speed cheats).
    BOT_SKILLS = {
        "easy":   {"aim_spread": 0.09, "fire_cooldown": 1.6,
                   "sight_range": 18.0, "fire_range": 15.0},
        "normal": {},                            # default_brain_params
        "hard":   {"aim_spread": 0.012, "fire_cooldown": 0.45,
                   "sight_range": 40.0, "fire_range": 32.0},
    }

    def _init_bots(self, n: int, skill: str = "normal") -> None:
        """Spawn n host-owned AI bots: one BATCHED agent crowd stepped by a
        single jitted call per frame (vmapped character controller +
        waypoint brain), announced to peers as ordinary players over the
        reference wire protocol (buffered ConnectedPlayer + Update)."""
        self._bot_ids: List[int] = []
        self._bots_state = None
        if n <= 0:
            return
        if self.net.is_connected and not self.net.is_host:
            self.hud.add_chat("* --bots ignored (this peer is not host)")
            return
        n = min(n, max(0, self.max_players - 1))
        if n <= 0:
            return
        self._bot_brain = default_brain_params()
        for k, v in self.BOT_SKILLS.get(skill, {}).items():
            self._bot_brain[k] = np.float32(v)
        # Patrol targets: the two spawns plus points dropped onto the map
        # floor around them (one batched downward raycast wave), routed
        # through a shortest-path waypoint graph (one batched W² LOS
        # wave + host Floyd–Warshall) so bots round corners instead of
        # hugging the wall toward a beeline goal.
        self._bot_waypoints = scatter_waypoints_on_floor(
            self.world, [SPAWN_1, SPAWN_2], n_points=16,
            seed=self.rng.randrange(1 << 30),
            tri_mask=self._map_tri_mask)
        self._bot_next_hop = build_waypoint_graph(
            self.world, self._bot_waypoints, tri_mask=self._map_tri_mask)
        starts, wp0 = [], []
        for i in range(n):
            base = SPAWN_1 if i % 2 == 0 else SPAWN_2
            starts.append(base + np.asarray(
                [self.rng.uniform(-1.5, 1.5), 0.0,
                 self.rng.uniform(-1.5, 1.5)], F32))
            wp0.append(self.rng.randrange(len(self._bot_waypoints)))
        self._bots_state = initial_agents_state(
            np.stack(starts),
            key=jax.random.PRNGKey(self.rng.randrange(1 << 30)),
            waypoint_idx=np.asarray(wp0, np.int32))
        # char params + target roster ride as traced args of the fused
        # step: the debug panel's live character tuning applies to bots
        # without recompiling, and per-frame enemy positions never
        # retrace.  (self._bot_brain is read at first trace — tests that
        # retune it must do so BEFORE the first step.)
        self._bot_ids_arr = np.asarray([BOT_ID_BASE + i for i in range(n)],
                                       np.int32)
        for i in range(n):
            bid = BOT_ID_BASE + i
            self._bot_ids.append(bid)
            bot = ConnectedPlayer(bid, f"BOT {i + 1}")
            bot.position = np.asarray(starts[i], F32)
            self.players.append(bot)
            if self.net.is_connected:
                self.net.send_rpc("ConnectedPlayer", [str(bid), bot.name],
                                  buffer_rpc=True, reliable=self.reliable)
        if not self.net.is_connected:
            # Offline practice range: a roster entry for the local player
            # so bot hits/kills land on a scoreboard row (networked games
            # get this via the ConnectedPlayer local echo).
            self.players.append(
                ConnectedPlayer(self.net.client_id, self.player_name))

    def _bot_ctl(self) -> dict:
        """The bot crowd's per-frame traced inputs for the fused step:
        the target roster as fixed-shape arrays (a varying roster must
        never retrace): slot 0 = the local player, then every rendered
        ConnectedPlayer (bots included — FFA deathmatch)."""
        m = self.max_players + 1
        tpos = np.zeros((m, 3), F32)
        talive = np.zeros((m,), bool)
        tids = np.full((m,), -1, np.int32)
        # The local player's pose as AI target: the pipelined host copy
        # (2 steps behind the sim — see _init_state) instead of a
        # blocking readback of the in-flight character step.
        tpos[0] = self.cam_position \
            - np.asarray(self.char_params["cam_offset"])
        talive[0] = self.spectate_idx < 0       # spectators are ghosts
        tids[0] = self.net.client_id
        for i, p in enumerate(self.players[:self.max_players]):
            if p.id == self.net.client_id:
                continue    # slot 0 already carries us, live position
            tpos[1 + i] = np.asarray(p.position)
            talive[1 + i] = True
            tids[1 + i] = p.id
        return {"bot_targets": tpos, "bot_alive": talive, "bot_tids": tids}

    def _apply_bot_aux(self, pos, rot, fire, aim) -> None:
        """Publish the joined crowd poses to the roster + wire (the bots'
        analog of _update_network's per-frame Update), then turn the
        step's fire/aim outputs into hitscan shots — same pipeline depth
        as before fusion: outputs apply two frames after their sim step."""
        by_id = {p.id: p for p in self.players}
        for i, bid in enumerate(self._bot_ids):
            p = by_id.get(bid)
            if p is None:
                continue
            p.position = pos[i]
            p.rotation = rot[i]
            if self.net.is_connected:
                self.net.send_rpc("Update", [
                    str(bid),
                    repr(float(pos[i, 0])), repr(float(pos[i, 1])),
                    repr(float(pos[i, 2])),
                    repr(float(rot[i, 0])), repr(float(rot[i, 1])),
                    repr(float(rot[i, 2])), repr(float(rot[i, 3]))])
        if fire.any():
            eye = pos[fire] + np.asarray(
                [0, float(self._bot_brain["eye_height"]), 0], F32)
            self._bot_fire(eye, aim[fire],
                           [b for b, f in zip(self._bot_ids, fire) if f])

    def _bot_fire(self, origins: np.ndarray, dirs: np.ndarray,
                  bot_ids: List[int]) -> None:
        """Resolve bot shots through the SAME batched hitscan as human
        shots (shoot() above): one raycast wave vs map + player models,
        plus an analytic capsule test for the LOCAL player (who has no
        model in their own scene — remote peers adjudicate hits on us
        via our mesh exactly like this host adjudicates theirs)."""
        active_slots = {}
        for i, p in enumerate(self.players):
            if p.id == self.net.client_id or i >= self.max_players:
                continue
            active_slots[i] = p
        shoot_mask = self._map_tri_mask.copy()
        tri_mesh = np.asarray(self.scene["tri_mesh_id"])
        for slot in active_slots:
            lo, hi = self.player_slices[slot]
            shoot_mask |= (tri_mesh >= lo) & (tri_mesh < hi)
        # (A bot never hits itself: ray origins sit inside its own model,
        # whose triangles are all backfaces from within — culled by the
        # hitscan's IgnoreBackfaces mode, Physics.cs:136-179 semantics.)
        world = self._world_fn(dict(self.scene,
                                    mesh_matrices=self._mesh_matrices))
        out = self._shoot_rays(origins.astype(F32), dirs.astype(F32),
                               world, shoot_mask)
        hits = np.asarray(out["hit"])
        dists = np.asarray(out["distance"])
        points = np.asarray(out["point"])
        normals = np.asarray(out["normal"])
        tris = np.asarray(out["tri"])

        # Local-player capsule (axis = char position ± height/2, radius
        # matched to the scaled player model the remote peers raycast).
        h = float(self.char_params["height"])
        my_pos = np.asarray(self._char_pos_host, F32)
        cap_a = my_pos - np.asarray([0, h * 0.5, 0], F32)
        cap_b = my_pos + np.asarray([0, h * 0.5, 0], F32)
        cap_r = h * 0.35

        for k, bid in enumerate(bot_ids):
            hit_dist = float(dists[k]) if hits[k] else float("inf")
            t_cap = (_ray_capsule_t(origins[k], dirs[k], cap_a, cap_b,
                                    cap_r)
                     if self.spectate_idx < 0 else None)
            if self.net.is_connected:
                self.net.send_rpc("Shoot", [          # muzzle report
                    repr(float(origins[k][0])), repr(float(origins[k][1])),
                    repr(float(origins[k][2]))])
            if t_cap is not None and t_cap < min(hit_dist, SHOT_RANGE):
                # bot shot us: same PlayerHit path a human shooter uses
                if self.net.is_connected:
                    self.net.send_rpc("PlayerHit", [
                        str(self.net.client_id), str(bid),
                        str(SHOT_DAMAGE)], reliable=self.reliable)
                else:
                    self._handle_player_hit(self.net.client_id,
                                            SHOT_DAMAGE, attacker_id=bid)
                continue
            if not hits[k] or hit_dist >= SHOT_RANGE:
                continue
            mesh_id = int(tri_mesh[int(tris[k])])
            hit_player = None
            for slot, p in active_slots.items():
                lo, hi = self.player_slices[slot]
                if lo <= mesh_id < hi:
                    hit_player = p
                    break
            if hit_player is not None:
                if self.net.is_connected:
                    self.net.send_rpc("PlayerHit", [
                        str(hit_player.id), str(bid),
                        str(SHOT_DAMAGE)], reliable=self.reliable)
                else:
                    self._handle_player_hit(hit_player.id, SHOT_DAMAGE,
                                            attacker_id=bid)
            elif mesh_id < self.n_map:
                if self.net.is_connected:
                    self.net.send_rpc("LevelHit", [
                        str(bid),
                        repr(float(points[k][0])), repr(float(points[k][1])),
                        repr(float(points[k][2])),
                        repr(float(normals[k][0])),
                        repr(float(normals[k][1])),
                        repr(float(normals[k][2]))])
                else:
                    self._place_decal(points[k], normals[k])

    # -- scene assembly -------------------------------------------------------

    def _load_scene(self):
        fallback_tex = np.asarray(tex_ops.checkerboard(
            64, 8, (0.8, 0.75, 0.6, 1.0), (0.55, 0.5, 0.4, 1.0))["data"])
        dust2_path = os.path.join(self.assets_dir, "dust2", "scene.gltf")
        gun_path = os.path.join(self.assets_dir, "Gun", "scene.gltf")
        player_path = os.path.join(self.assets_dir, "gordon_freeman",
                                   "scene.gltf")
        self.map_matrix = ml.scale(MAP_SCALE)
        if os.path.exists(dust2_path):
            # rigid_animation=False: the map's PACKED vertices feed the
            # collision world + hitscan (world-space consumers)
            map_model = model_loader.load_model(dust2_path,
                                                rigid_animation=False)
        else:
            map_model, fallback_tex = _fallback_map()
            self.map_matrix = np.eye(4, dtype=F32)

        insts = model_loader.model_instances(
            map_model, self.map_matrix, fallback_texture=fallback_tex)
        self.n_map = len(insts)

        # View-model gun (Renderer.cs:33, 476-477).
        self.gun_base = (ml.scale(0.02)
                         @ ml.matrix_from_yaw_pitch_roll(
                             -90 * math.pi / 180, 0.0, 0.0)).astype(F32)
        if os.path.exists(gun_path):
            gun_model = model_loader.load_model(gun_path)
        else:
            gun_model = model_loader.Model(meshes=[dict(
                primitives.cube(1.0), material=scene_mod.Material(),
                bounds_center=np.zeros(3, F32), bounds_radius=1.0)])
            self.gun_base = ml.scale(0.1).astype(F32)
        gun_insts = model_loader.model_instances(
            gun_model, np.eye(4, dtype=F32), fallback_texture=fallback_tex)
        self.gun_slice = (len(insts), len(insts) + len(gun_insts))
        insts += gun_insts

        # MAX_PLAYERS player-model slots.
        if os.path.exists(player_path):
            player_model = model_loader.load_model(player_path,
                                                   rigid_animation=False)
        else:
            player_model = model_loader.Model(meshes=[dict(
                primitives.cube(1.0), material=scene_mod.Material(),
                bounds_center=np.zeros(3, F32), bounds_radius=1.0)])
        self.player_slices = []
        for _ in range(self.max_players):
            pinsts = model_loader.model_instances(
                player_model, np.eye(4, dtype=F32),
                fallback_texture=fallback_tex)
            self.player_slices.append((len(insts), len(insts) + len(pinsts)))
            insts += pinsts

        # Bullet-hole decal slots (beyond reference: the LevelHit RPC
        # carries hit point+normal, Renderer.cs:227-244, but nothing
        # renders it).  Pre-packed hidden quads — placing a decal only
        # rewrites a mesh matrix + the visibility mask, no recompile.
        self.n_decals = 24
        decal_tex = np.zeros((16, 16, 4), F32)
        yy, xx = np.mgrid[0:16, 0:16]
        inside = (yy - 7.5) ** 2 + (xx - 7.5) ** 2 <= 7.5 ** 2
        decal_tex[..., :3] = 0.06
        decal_tex[..., 3] = np.where(inside, 0.85, 0.0)
        self.decal_slice = (len(insts), len(insts) + self.n_decals)
        for _ in range(self.n_decals):
            insts.append(scene_mod.MeshInstance(
                primitives.plane(0.1), np.eye(4, dtype=F32),
                texture=decal_tex))
        self._decal_next = 0
        self._decal_used = 0

        # Impact-spark particles (sim/particles.py, beyond the reference):
        # one shared billboard pool; each bullet impact queues a one-frame
        # emitter burst at the hit point along the surface normal.  The
        # sim + billboard write ride the same jitted frame; bursts are
        # traced uniforms, so sparks never recompile.
        self.n_particles = 256
        insts.append(scene_mod.MeshInstance(
            particles_mod.particles_mesh(self.n_particles, extent=1000.0),
            np.eye(4, dtype=F32),
            texture=particles_mod.soft_disc_texture(16),
            particles=self.n_particles))

        # Flip-book animation sources: one entry per ANIMATED mesh instance
        # (in scene order), pointing at the host Model whose PlayAnimation
        # clock drives its device-side frame index (ModelLoader.cs:331-348).
        srcs = ([map_model] * self.n_map
                + [gun_model] * (self.gun_slice[1] - self.gun_slice[0])
                + [player_model] * (len(insts) - self.gun_slice[1]))
        self._anim_sources = [src for inst, src in zip(insts, srcs)
                              if inst.animation_positions is not None]

        self.scene = scene_mod.build_scene_buffers(insts)
        self.n_meshes = self.scene["mesh_matrices"].shape[0]

        params = RenderParams(*self.window.render_size,
                              kbuffer=self.kbuffer)
        if self.burn_hud:
            from softwarerenderer_tpu.ops import text as text_ops
            from softwarerenderer_tpu.utils import font as font_mod
            self._hud_font = font_mod.build_font(cell_h=14)
            self._hud_fx = text_ops.text_overlay_fx(self._hud_font)
            # The fx rides in params, so every engine rebuild
            # (render-scale, ssaa/ssao toggles, wireframe) keeps it.
            params = params.replace(post_fx=params.post_fx
                                    + (self._hud_fx,))
        self.engine = Engine(self.scene, params, frame_fn=self._frame_fn)
        u = self.engine.uniforms
        if self.mirror:
            u["pip_view"] = {
                "camera_position": np.zeros(3, F32),
                "camera_rotation": ml.QUAT_IDENTITY.copy(),
                "mesh_visible": np.ones(self.n_meshes, bool),
            }
        if self.burn_hud:
            from softwarerenderer_tpu.ops import text as text_ops
            u["hud_text"] = text_ops.pack_text(
                [], max_strings=self.HUD_TEXT_SLOTS,
                max_chars=self.HUD_TEXT_CHARS)
        # The game's live-tuned defaults (Renderer.cs:39-46).
        u["fog_start"] = np.float32(1.0)
        u["fog_end"] = np.float32(25.0)
        u["fog_color"] = np.asarray([1.0, 0.62, 0.5, 1.0], F32)
        u["light_direction"] = np.asarray(
            ml.euler_degrees_to_direction([-45.0, -45.0, 0.0]), F32)
        u["light_color"] = np.ones(4, F32)
        u["clear_color"] = np.asarray([0.9137, 0.7098, 0.6588, 1.0], F32)
        u["fov_degrees"] = np.float32(90.0)
        u["near_clip"] = np.float32(0.1)
        u["far_clip"] = np.float32(1000.0)
        u["mesh_visible"] = np.ones(self.n_meshes, bool)

        # Collision world: the map only (Renderer.cs:438 passes Dust2Model).
        map_tris = np.asarray(self.scene["tri_mesh_id"]) < self.n_map
        self._map_tri_mask = map_tris
        map_scene = {k: self.scene[k] for k in self.scene}
        self._world_fn = jax.jit(build_collision_world)
        self.world = self._world_fn(self.scene)
        # The character step itself lives INSIDE the fused frame program
        # (_get_fused); only the click-gated hitscan stays a separate
        # dispatch (it runs at most once per SHOT_COOLDOWN).
        self._shoot_rays = jax.jit(
            lambda o, d, w, mask: raycast_batch(o, d, w, tri_mask=mask))

    def _init_state(self):
        self.char_params = default_character_params()
        spawn_first = self.rng.random() > 0.5   # Renderer.cs:426-436
        spawn = SPAWN_1 if spawn_first else SPAWN_2
        self.cam_rotation = (ml.QUAT_IDENTITY.copy() if spawn_first else
                             ml.quat_from_axis_angle(
                                 np.asarray([0, 1, 0], F32), math.pi))
        self.char = initial_character_state(spawn)
        self.cam_position = spawn + self.char_params["cam_offset"]
        self.weapon_sway = ml.QUAT_IDENTITY.copy()
        self.recoil = ml.QUAT_IDENTITY.copy()
        self.time = 0.0
        self.last_shot = -10.0
        self.mouse_locked = True
        self.window.set_mouse_capture(True)
        self.noclip = False
        self.spectate_idx = -1          # -1 = own view; else players[] index
        self._prev_keys = set()
        self._tune_idx = 0
        self._drag_row = None           # active pointer-dragged slider
        self.mouse_sensitivity = MOUSE_SENSITIVITY  # Camera.cs:10, tunable
        # Right-stick look rate: mouse-pixel-equivalents/s at full
        # deflection (gamepad support is beyond the reference).
        self.stick_look_speed = 600.0
        self.wireframe = False
        self._wire_engine = None
        # Overlapped device→host fetch: every np.asarray of a device
        # array pays one device round trip, so the fused step's SINGLE
        # (rgb8, aux) readback runs on fetcher threads and joins
        # `present_depth` frames later, overlapping the transfer with the
        # next frames' host work.  The presented frame / visible pose
        # trail the sim by that many 60 Hz steps; the sim state itself
        # stays exact (checkpoint replay unchanged).
        import concurrent.futures
        self._fetcher = concurrent.futures.ThreadPoolExecutor(
            max_workers=4, thread_name_prefix="srt_fetch")
        self._out_q: List = []          # futures of (rgb8|None, aux)
        self._frame_i = 0
        # Fetch-pipeline depth: the presented frame / host pose trail
        # the sim by this many steps.  Default 2 (one frame of extra
        # latency over the reference's blocking upload); whether a
        # deeper pipeline pays on a locally attached card is not
        # measured yet.
        self.present_depth = int(os.environ.get("SRT_PRESENT_DEPTH", 2))
        # Bench/test hook: fetch the rgb frame only every Nth step (the
        # aux vector always fetches) — models a locally-attached display
        # where the frame-sized transfer is ~1 ms (bench --no-present).
        self._present_nth = 1
        self._blank_frame = None
        # Host cache of the character's position (the fused step's aux
        # output, two frames stale) — every host consumer (pose RPC,
        # nametags, bot targeting, the capsule hit test) reads this
        # instead of paying a device round trip.
        self._char_pos_host = np.asarray(spawn, F32)
        # live-tuned light euler (Renderer.cs:42 LightEulerDegrees)
        self.light_euler = {"light_yaw": np.float32(-45.0),
                            "light_pitch": np.float32(-45.0)}
        from softwarerenderer_tpu.utils.profiling import FrameStats
        self.stats = FrameStats()
        self._mesh_matrices = np.asarray(
            self.scene["mesh_matrices"]).copy()
        # Impact sparks: quiet emitter (rate 0) until a burst is queued.
        self._particles = particles_mod.initial_particle_state(
            self.n_particles, seed=0)
        em = particles_mod.default_emitter_params()
        em.update(rate=np.float32(0.0),
                  base_velocity=np.zeros(3, F32),
                  spread=np.float32(2.2),
                  lifetime=np.asarray([0.25, 0.6], F32),
                  size=np.asarray([0.05, 0.01], F32),
                  color0=np.asarray([1.0, 0.85, 0.4, 1.0], F32),
                  color1=np.asarray([1.0, 0.3, 0.05, 0.0], F32))
        self._emitter = em
        self._bursts: List[tuple] = []

    # -- per-frame ------------------------------------------------------------

    def step(self, dt: float, inputs: Optional[dict] = None) -> None:
        """One frame: input → net → sim → render → present
        (Renderer.Update ordering, :258-268)."""
        self.time += dt
        inp = inputs if inputs is not None else self.window.poll()
        if inp["quit"]:
            self.window.should_close = True

        self._update_mouse_look(inp, dt)
        # weapon sway/recoil (Renderer.cs:261-262)
        self.weapon_sway = np.asarray(ml.quat_slerp(
            self.weapon_sway, self.cam_rotation, 15.0 * dt), F32)
        self.recoil = np.asarray(ml.quat_slerp(
            self.recoil, ml.QUAT_IDENTITY, 5.0 * dt), F32)

        # Join the fused step submitted two frames ago: updates the host
        # pose cache + bot roster and yields the frame to present below.
        joined_rgb = self._join_fused()
        self._update_network()
        self._update_character(dt, inp)   # host staging for the fused step
        self._update_toggles(inp)
        self._update_pointer(inp)
        # Scoreboard (hold Tab) — beyond-reference ergonomics (ROADMAP #6).
        self.hud.state.show_scoreboard = "tab" in inp["keys"] \
            and not self.hud.state.chat_active
        if self.hud.state.show_scoreboard:
            self.hud.state.scoreboard = [
                (q.name, q.kills, q.deaths, q.health)
                for q in sorted(self.players,
                                key=lambda q: (-q.kills, q.deaths))]
        # Edge-trigger the gamepad fire (the trigger reports held state
        # every poll; the mouse fires per click — keep both semi-auto).
        gp_held = bool(inp.get("gamepad") and inp["gamepad"]["fire"])
        gp_fire = gp_held and not getattr(self, "_gp_fire_held", False)
        self._gp_fire_held = gp_held
        if (inp["mouse_down"] or gp_fire) and self.mouse_locked \
                and self.spectate_idx < 0 \
                and self.time - self.last_shot >= SHOT_COOLDOWN:
            self.shoot()
            self.last_shot = self.time

        self._render(dt, joined_rgb)
        self.hud.tick(dt)

    def _update_mouse_look(self, inp, dt: float = 0.0):
        """HandleMouseMovement (Renderer.cs:140-161), plus right-stick
        look (beyond reference): full stick deflection turns at
        `stick_look_speed` mouse-pixel-equivalents per second, through
        the same sensitivity math as the mouse."""
        if not self.mouse_locked:
            return
        dx, dy = inp["mouse_delta"]
        gp = inp.get("gamepad")
        if gp is not None:
            dx += gp["look"][0] * self.stick_look_speed * dt
            dy += gp["look"][1] * self.stick_look_speed * dt
        if dx == 0 and dy == 0:
            return
        euler = np.asarray(ml.quat_to_euler_degrees(self.cam_rotation))
        yaw = euler[1] - dx * self.mouse_sensitivity
        pitch = float(np.clip(euler[0] - dy * self.mouse_sensitivity,
                              -89, 89))
        self.cam_rotation = np.asarray(ml.quat_from_yaw_pitch_roll(
            yaw * math.pi / 180, pitch * math.pi / 180,
            euler[2] * math.pi / 180), F32)

    def _update_network(self):
        """Pose RPC every frame (Renderer.cs:270-287) + inbound handling."""
        if not self.net.is_connected:
            return
        euler = np.asarray(ml.quat_to_euler_degrees(self.cam_rotation))
        rot = ml.quat_from_yaw_pitch_roll(euler[1] * math.pi / 180, 0.0, 0.0)
        # The pipelined host pose (two frames behind the sim) — a direct
        # read of the device state would wait for a device round trip.
        pos = self._char_pos_host
        self.net.send_rpc("Update", [
            str(self.net.client_id),
            repr(float(pos[0])), repr(float(pos[1])), repr(float(pos[2])),
            repr(float(rot[0])), repr(float(rot[1])),
            repr(float(rot[2])), repr(float(rot[3]))])
        sig = getattr(self, "_migrated_signal", None)
        if sig is not None:
            self._migrated_signal = None
            self._on_migrated(sig)       # main thread: safe to touch state
        for method, params, sender in self.net.poll_rpcs():
            self._handle_rpc(method, params)

    def _handle_rpc(self, method: str, params: List[str]):
        """The game's RPC switch (Renderer.cs:866-965)."""
        try:
            if method == "ConnectedPlayer" and len(params) >= 2:
                pid = int(params[0])
                if not any(p.id == pid for p in self.players):
                    self.players.append(ConnectedPlayer(pid, params[1]))
                self.hud.add_chat(f"{params[1]} has joined the game!")
            elif method == "Update" and len(params) >= 8:
                pid = int(params[0])
                p = next((x for x in self.players if x.id == pid), None)
                if p is not None:
                    p.position = np.asarray(
                        [float(params[1]), float(params[2]),
                         float(params[3])], F32)
                    p.rotation = np.asarray(
                        [float(params[4]), float(params[5]),
                         float(params[6]), float(params[7])], F32)
            elif method in ("DisconnectedPlayer", "ClientDisconnected") \
                    and len(params) >= 1:
                pid = int(params[0])
                p = next((x for x in self.players if x.id == pid), None)
                if p is not None:
                    self.players.remove(p)
            elif method == "ChatMessage" and len(params) >= 2:
                self.hud.add_chat(f"{params[0]}: {params[1]}")
            elif method == "PlayerHit" and len(params) >= 3:
                self._handle_player_hit(int(params[0]), float(params[2]),
                                        attacker_id=int(params[1]))
            elif method == "LevelHit" and len(params) >= 7:
                self._place_decal(
                    np.asarray([float(params[1]), float(params[2]),
                                float(params[3])], F32),
                    np.asarray([float(params[4]), float(params[5]),
                                float(params[6])], F32))
            elif method == "Shoot" and len(params) >= 3:
                shot_pos = np.asarray([float(params[0]), float(params[1]),
                                       float(params[2])], F32)
                dist = float(np.linalg.norm(self.cam_position - shot_pos))
                wav = os.path.join(self.assets_dir, "pistol.wav")
                # stereo pan by the shot's bearing (beyond the
                # reference's mono distance attenuation)
                right = np.asarray(ml.quat_rotate(
                    np.asarray([1, 0, 0], F32), self.cam_rotation), F32)
                audio.play_sound(
                    wav, audio.shot_volume(dist),
                    pan=audio.direction_pan(self.cam_position, right,
                                            shot_pos))
        except (ValueError, IndexError):
            pass

    def _handle_player_hit(self, pid: int, damage: float,
                           attacker_id: int = -1):
        """PlayerHit: damage, kill message, respawn, heal (Renderer.cs:
        911-950) + kill feed / scoreboard counters (beyond-reference)."""
        p = next((x for x in self.players if x.id == pid), None)
        if p is None:
            return
        p.health = max(0.0, p.health - damage)
        if pid == self.net.client_id:
            self.hud.state.health = p.health
        if p.health <= 0:
            self.hud.add_chat(f"{p.name} was killed!")
            attacker = next((x for x in self.players
                             if x.id == attacker_id), None)
            self.hud.add_kill(attacker.name if attacker else "?", p.name)
            if attacker is not None and attacker is not p:
                attacker.kills += 1
            p.deaths += 1
            if pid == self.net.client_id:
                spawn_first = self.rng.random() > 0.5
                spawn = SPAWN_1 if spawn_first else SPAWN_2
                self.char["position"] = jnp.asarray(spawn)
                self.cam_rotation = (
                    ml.QUAT_IDENTITY.copy() if spawn_first else
                    np.asarray(ml.quat_from_axis_angle(
                        np.asarray([0, 1, 0], F32), math.pi), F32))
            elif pid in self._bot_ids and self._bots_state is not None:
                # This peer owns the bot: respawn it (remote peers just
                # heal it and wait for the owner's next Update).
                spawn = SPAWN_1 if self.rng.random() > 0.5 else SPAWN_2
                self._bots_state = respawn_agent(
                    self._bots_state, self._bot_ids.index(pid), spawn)
                p.position = np.asarray(spawn, F32)
            p.health = 100.0
            if pid == self.net.client_id:
                self.hud.state.health = 100.0
            if not self.net.is_connected:
                return                      # offline: nobody to notify
            self.net.send_rpc("Update", [
                str(p.id),
                repr(float(p.position[0])), repr(float(p.position[1])),
                repr(float(p.position[2])),
                repr(float(p.rotation[0])), repr(float(p.rotation[1])),
                repr(float(p.rotation[2])), repr(float(p.rotation[3]))])

    def _update_character(self, dt: float, inp):
        """UpdateCharacterController (Renderer.cs:356-383) — host side:
        derives this frame's move/jump from input and camera basis; the
        character_step itself runs inside the fused frame program."""
        keys = inp["keys"]
        front = np.asarray(ml.quat_rotate(
            np.asarray([0, 0, -1], F32), self.cam_rotation))
        right = np.asarray(ml.normalize(np.cross(front, [0.0, 1.0, 0.0])))
        front[1] = 0
        n = np.linalg.norm(front)
        front = front / n if n > 0 else front
        right[1] = 0
        n = np.linalg.norm(right)
        right = right / n if n > 0 else right

        move = np.zeros(3, F32)
        gp = inp.get("gamepad")
        gp_jump = bool(gp and gp["jump"])
        if not self.hud.state.chat_active and self.spectate_idx < 0:
            if "w" in keys:
                move += front
            if "s" in keys:
                move -= front
            if "a" in keys:
                move -= right
            if "d" in keys:
                move += right
            if gp is not None:
                # left stick: analog strafing/advance (beyond reference)
                move += right * F32(gp["move"][0]) \
                    + front * F32(gp["move"][1])
            if "space" in keys or gp_jump:
                move[1] += 1
            if "shift" in keys:
                move[1] -= 1
        jump = ("space" in keys or gp_jump) \
            and not self.hud.state.chat_active and self.spectate_idx < 0

        self.char["noclip"] = jnp.asarray(self.noclip)
        self._move = move.astype(F32)
        self._jump = np.bool_(jump)

    # Live-tunable parameters — the FULL debug-panel surface of the
    # reference (Renderer.cs:690-817): clipping, camera rotation/position/
    # offset/sensitivity, FOV, every character-controller parameter incl.
    # gravity, render scale, fog start/end/color, light rotation/color and
    # the clear color.  All TRACED uniforms/params, so adjusting them never
    # recompiles (render scale is the one exception: it changes the
    # framebuffer shape, exactly as UpdateRenderScale reallocates,
    # MainWindow.cs:268-274).
    #
    # kind grammar: "u"=scalar uniform, "u:key:i"=uniform vector component,
    # "c"=character scalar, "c:key:i"=character vector component,
    # "l"=light euler, "rot:i"=camera euler (pitch/yaw/roll),
    # "pos:i"=player position component, "s:attr"=app attribute,
    # "w"=render scale.   name -> (kind, step, lo, hi)
    TUNABLES = [
        ("near_clip", "u", 0.01, 0.001, 1.0),            # Renderer.cs:690
        ("far_clip", "u", 10.0, 0.001, 5000.0),
        ("cam_pitch", "rot:0", 1.0, -89.0, 89.0),        # :700-707
        ("cam_yaw", "rot:1", 1.0, -360.0, 360.0),
        ("cam_roll", "rot:2", 1.0, -180.0, 180.0),
        ("mouse_sensitivity", "s:mouse_sensitivity", 0.01, 0.01, 1.0),
        ("fov_degrees", "u", 1.0, 1.0, 179.0),
        ("pos_x", "pos:0", 0.5, -500.0, 500.0),          # :712
        ("pos_y", "pos:1", 0.5, -500.0, 500.0),
        ("pos_z", "pos:2", 0.5, -500.0, 500.0),
        ("cam_offset_x", "c:cam_offset:0", 0.05, -2.0, 2.0),
        ("cam_offset_y", "c:cam_offset:1", 0.05, -2.0, 2.0),
        ("cam_offset_z", "c:cam_offset:2", 0.05, -2.0, 2.0),
        ("move_speed", "c", 0.25, 0.5, 20.0),            # :724-744
        ("max_air_speed", "c", 0.25, 0.5, 30.0),
        ("jump_force", "c", 0.25, 0.5, 20.0),
        ("radius", "c", 0.01, 0.05, 1.0),
        ("height", "c", 0.05, 0.2, 3.0),
        ("ground_acceleration", "c", 0.25, 0.1, 20.0),
        ("air_acceleration", "c", 0.05, 0.0, 20.0),
        ("ground_friction", "c", 0.25, 0.0, 20.0),
        ("air_control", "c", 0.05, 0.0, 2.0),
        ("step_size", "c", 0.05, 0.05, 3.0),
        ("gravity_x", "c:gravity:0", 0.5, -20.0, 20.0),
        ("gravity_y", "c:gravity:1", 0.5, -20.0, 20.0),
        ("gravity_z", "c:gravity:2", 0.5, -20.0, 20.0),
        ("render_scale", "w", 0.05, 0.1, 1.0),           # :795
        ("fog_start", "u", 0.5, 0.0, 100.0),             # :800-802
        ("fog_end", "u", 0.5, 1.0, 500.0),
        ("fog_r", "u:fog_color:0", 0.05, 0.0, 1.0),
        ("fog_g", "u:fog_color:1", 0.05, 0.0, 1.0),
        ("fog_b", "u:fog_color:2", 0.05, 0.0, 1.0),
        ("fog_a", "u:fog_color:3", 0.05, 0.0, 1.0),
        ("light_yaw", "l", 5.0, -180.0, 180.0),          # :803-804
        ("light_pitch", "l", 5.0, -89.0, 89.0),
        ("light_r", "u:light_color:0", 0.05, 0.0, 4.0),
        ("light_g", "u:light_color:1", 0.05, 0.0, 4.0),
        ("light_b", "u:light_color:2", 0.05, 0.0, 4.0),
        ("light_a", "u:light_color:3", 0.05, 0.0, 4.0),
        ("clear_r", "u:clear_color:0", 0.05, 0.0, 1.0),
        ("clear_g", "u:clear_color:1", 0.05, 0.0, 1.0),
        ("clear_b", "u:clear_color:2", 0.05, 0.0, 1.0),
        ("clear_a", "u:clear_color:3", 0.05, 0.0, 1.0),
    ]

    def _update_toggles(self, inp):
        """Esc mouse-capture + V noclip edge toggles (Renderer.cs:385-402),
        F3-style debug panel + [-/=] live tuning."""
        keys = inp["keys"]
        if "escape" in keys and "escape" not in self._prev_keys:
            self.mouse_locked = not self.mouse_locked
            self.window.set_mouse_capture(self.mouse_locked)
        if "v" in keys and "v" not in self._prev_keys \
                and not self.hud.state.chat_active:
            self.noclip = not self.noclip
        if "b" in keys and "b" not in self._prev_keys \
                and not self.hud.state.chat_active:
            # Spectator mode: B cycles through the other connected players,
            # then back to the own first-person view (beyond-reference).
            others = self._spectate_targets()
            if others:
                self.spectate_idx += 1
                if self.spectate_idx >= len(others):
                    self.spectate_idx = -1
            else:
                self.spectate_idx = -1
        # debug panel + tuning via typed characters (works on any backend)
        for ch in inp["chars"]:
            if self.hud.state.chat_active:
                break
            if ch == "`":
                self.hud.state.show_debug = not self.hud.state.show_debug
            elif ch == "p":
                # wireframe debug mode (Rasterizer.RenderDebugMode toggle,
                # Renderer.cs:799-804); compiles a second frame program on
                # first use
                self.wireframe = not self.wireframe
            elif ch == "o":
                # SSAA 2× toggle (beyond reference; RenderParams.ssaa) —
                # static param, so this compiles a new frame program once.
                p = self.engine.params
                self._swap_params(p.replace(ssaa=2 if p.ssaa == 1 else 1))
            elif ch == "k":
                # SSAO toggle (beyond reference)
                p = self.engine.params
                self._swap_params(p.replace(ssao=not p.ssao))
            elif ch == "j":
                # bloom toggle (beyond reference)
                p = self.engine.params
                self._swap_params(p.replace(bloom=not p.bloom))
            elif ch == "u":
                # FXAA toggle (beyond reference; ops/fxaa.py) — cheap
                # post AA vs the 'o' SSAA mode's exact 4x render
                p = self.engine.params
                self._swap_params(p.replace(fxaa=not p.fxaa))
            elif ch == "m":
                # mip-mapped sampling toggle (beyond reference)
                p = self.engine.params
                self._swap_params(p.replace(
                    use_mipmaps=not bool(p.use_mipmaps)))
            elif ch == "n" and "tangent" in self.scene:
                # normal-mapped shading toggle (beyond reference): the
                # gun carries a real normal map; unmapped meshes shade
                # flat via the neutral atlas texel (ops/normalmap.py).
                # No-op when no loaded asset has a normal map (fallback
                # scenes carry no tangent buffers).
                self.normal_mapped = not getattr(self, "normal_mapped",
                                                 False)
                from softwarerenderer_tpu.ops import normalmap as _nm
                old = self.engine
                vs = (_nm.normal_mapped_vertex_shader
                      if self.normal_mapped else None)
                fs = (_nm.normal_mapped_fragment_shader
                      if self.normal_mapped else None)
                kw = {"frame_fn": self._frame_fn}
                if vs is not None:
                    kw.update(vertex_shader=vs, fragment_shader=fs)
                self.engine = Engine(old.scene, old.params, **kw)
                self.engine.scene = old.scene
                self.engine.uniforms = old.uniforms
                self._wire_engine = None
            elif ch == "[":
                self._tune_idx = (self._tune_idx - 1) % len(self.TUNABLES)
            elif ch == "]":
                self._tune_idx = (self._tune_idx + 1) % len(self.TUNABLES)
            elif ch in "-=":
                name, kind, step, lo, hi = self.TUNABLES[self._tune_idx]
                delta = step if ch == "=" else -step
                self._tunable_adjust(name, kind, delta, lo, hi)
        # chat input (T to open, Renderer.cs:587-656 simplified)
        hs = self.hud.state
        if hs.chat_active:
            hs.chat_input += inp["chars"]
            if "return" in keys and "return" not in self._prev_keys:
                text = hs.chat_input.strip()
                if text and self.net.is_connected:
                    me = next((p for p in self.players
                               if p.id == self.net.client_id), None)
                    self.net.send_rpc("ChatMessage",
                                      [me.name if me else self.player_name,
                                       text], reliable=self.reliable)
                hs.chat_input = ""
                hs.chat_active = False
        elif "t" in keys and "t" not in self._prev_keys:
            hs.chat_active = True
            hs.chat_input = ""
        self._prev_keys = set(keys)

    # -- shooting -------------------------------------------------------------

    def _swap_params(self, params):
        """Rebuild the frame program with new static RenderParams; scene
        and traced uniforms carry over (same machinery as render-scale)."""
        old = self.engine
        self.engine = Engine(old.scene, params, frame_fn=self._frame_fn)
        self.engine.scene = old.scene
        self.engine.uniforms = old.uniforms
        self._wire_engine = None

    def _rebuild_engine_for_scale(self):
        """Render-scale change = new framebuffer shapes = a new compiled
        frame program (UpdateRenderScale, MainWindow.cs:268-274); scene and
        uniforms carry over."""
        new_size = self.window.render_size
        if new_size == (self.engine.params.width,
                        self.engine.params.height):
            return
        old = self.engine
        self.engine = Engine(old.scene,
                             old.params.replace(width=new_size[0],
                                                height=new_size[1]),
                             frame_fn=self._frame_fn)
        self.engine.scene = old.scene
        self.engine.uniforms = old.uniforms
        self._wire_engine = None

    def _tunable_value(self, name: str, kind: str) -> float:
        parts = kind.split(":")
        if parts[0] == "u":
            return float(self.engine.uniforms[name] if len(parts) == 1
                         else self.engine.uniforms[parts[1]][int(parts[2])])
        if parts[0] == "c":
            return float(self.char_params[name] if len(parts) == 1
                         else self.char_params[parts[1]][int(parts[2])])
        if parts[0] == "l":
            return float(self.light_euler[name])
        if parts[0] == "rot":
            return float(np.asarray(
                ml.quat_to_euler_degrees(self.cam_rotation))[int(parts[1])])
        if parts[0] == "pos":
            # pipelined host copy: the debug panel redraws every frame
            return float(self._char_pos_host[int(parts[1])])
        if parts[0] == "s":
            return float(getattr(self, parts[1]))
        return float(self.window.render_scale)

    def _tunable_adjust(self, name: str, kind: str, delta: float,
                        lo: float, hi: float) -> None:
        """Apply one keyed debug-panel step (Renderer.cs:690-817)."""
        self._tunable_set(name, kind,
                          self._tunable_value(name, kind) + delta, lo, hi)

    def _tunable_set(self, name: str, kind: str, value: float,
                     lo: float, hi: float) -> None:
        """Write one tunable's absolute value (keyed steps AND pointer
        slider drags route here); every target is a traced value, so no
        path recompiles except the framebuffer-reshaping render scale."""
        v = min(hi, max(lo, float(value)))
        parts = kind.split(":")
        if parts[0] == "w":
            self.window.render_scale = v
            self._rebuild_engine_for_scale()
            return
        if parts[0] == "s":
            setattr(self, parts[1], np.float32(v))
            return
        if parts[0] == "rot":
            euler = np.asarray(ml.quat_to_euler_degrees(self.cam_rotation))
            euler[int(parts[1])] = v
            self.cam_rotation = np.asarray(ml.quat_from_yaw_pitch_roll(
                euler[1] * math.pi / 180, euler[0] * math.pi / 180,
                euler[2] * math.pi / 180), F32)
            return
        if parts[0] == "pos":
            i = int(parts[1])
            pos = np.asarray(self.char["position"]).copy()
            pos[i] = v
            self.char["position"] = jnp.asarray(pos, jnp.float32)
            # keep the panel's pipelined readback coherent immediately
            self._char_pos_host = pos.astype(F32)
            return
        if parts[0] == "l":
            self.light_euler[name] = np.float32(v)
            self.engine.uniforms["light_direction"] = np.asarray(
                ml.euler_degrees_to_direction(
                    [self.light_euler["light_pitch"],
                     self.light_euler["light_yaw"], 0.0]), F32)
            return
        tgt = self.engine.uniforms if parts[0] == "u" else self.char_params
        if len(parts) == 1:
            tgt[name] = np.float32(v)
        else:
            key, i = parts[1], int(parts[2])
            vec = np.asarray(tgt[key], F32).copy()
            vec[i] = v
            tgt[key] = vec

    def _update_pointer(self, inp) -> None:
        """Pointer interaction with the HUD while the cursor is released
        (Esc): drag the tunables panel's sliders, click the chat row to
        focus it — the reference's mouse-driven ImGui surface
        (Renderer.cs:658-820 sliders, :587-656 chat InputText).  Pure
        geometry lives in io_host.ui (panel_hit_row / slider_value /
        chat_input_rect) so headless tests drive the same math."""
        from softwarerenderer_tpu.io_host import ui as ui_mod
        pos = inp.get("mouse_pos")
        if self.mouse_locked or pos is None:
            self._drag_row = None
            return
        held = bool(inp.get("mouse_held"))
        clicked = bool(inp.get("mouse_down"))
        hs = self.hud.state
        w, h = self.window.width, self.window.height
        panel = ui_mod._anchor(self.hud.layout.panel_pos, w, h)
        if clicked:
            if hs.show_debug:
                row = ui_mod.panel_hit_row(panel, len(self.TUNABLES), pos)
                if row is not None:
                    self._drag_row = row
                    self._tune_idx = row
            if ui_mod.point_in_rect(pos, ui_mod.chat_input_rect(
                    self.hud.layout.chat_pos, len(hs.chat_messages),
                    hs.max_chat_lines, w, h)):
                hs.chat_active = True
        if held and self._drag_row is not None and hs.show_debug:
            name, kind, _step, lo, hi = self.TUNABLES[self._drag_row]
            self._tunable_set(name, kind, ui_mod.slider_value(
                panel, self._drag_row, pos[0], lo, hi), lo, hi)
        if not held:
            self._drag_row = None

    def _player_matrix(self, p: ConnectedPlayer) -> np.ndarray:
        """CreatePlayerMatrix (Renderer.cs:251-256)."""
        h = float(self.char_params["height"])
        flip = ml.quat_from_axis_angle(np.asarray([0, 1, 0], F32), math.pi)
        rot = ml.quat_mul(p.rotation, flip)
        return (ml.scale(h / 2)
                @ ml.matrix_from_quaternion(rot)
                @ ml.translation(p.local_position
                                 - np.asarray([0, h / 2, 0], F32))
                ).astype(F32)

    def shoot(self):
        """Hitscan (Renderer.cs:172-249): one batched raycast against the
        packed soup; winners classified map-vs-player by mesh id."""
        origin = self.cam_position.astype(F32)
        direction = np.asarray(ml.quat_rotate(
            np.asarray([0, 0, -1], F32), self.cam_rotation), F32)

        active_slots = {}
        for i, p in enumerate(self.players):
            if p.id == self.net.client_id or i >= self.max_players:
                continue
            active_slots[i] = p
        shoot_mask = self._map_tri_mask.copy()
        tri_mesh = np.asarray(self.scene["tri_mesh_id"])
        for slot in active_slots:
            lo, hi = self.player_slices[slot]
            shoot_mask |= (tri_mesh >= lo) & (tri_mesh < hi)

        world = self._world_fn(dict(self.scene,
                                    mesh_matrices=self._mesh_matrices))
        out = self._shoot_rays(origin[None], direction[None], world,
                               shoot_mask)
        hit = bool(out["hit"][0])
        dist = float(out["distance"][0])
        point = np.asarray(out["point"][0])
        normal = np.asarray(out["normal"][0])
        mesh_id = int(tri_mesh[int(out["tri"][0])]) if hit else -1

        if self.net.is_connected:
            self.net.send_rpc("Shoot", [repr(float(origin[0])),
                                        repr(float(origin[1])),
                                        repr(float(origin[2]))])
        if hit and dist < SHOT_RANGE:
            hit_player = None
            for slot, p in active_slots.items():
                lo, hi = self.player_slices[slot]
                if lo <= mesh_id < hi:
                    hit_player = p
                    break
            if self.net.is_connected:
                if hit_player is not None:
                    self.net.send_rpc("PlayerHit", [
                        str(hit_player.id), str(self.net.client_id),
                        str(SHOT_DAMAGE)], reliable=self.reliable)
                elif mesh_id < self.n_map:
                    self.net.send_rpc("LevelHit", [
                        str(self.net.client_id),
                        repr(float(point[0])), repr(float(point[1])),
                        repr(float(point[2])),
                        repr(float(normal[0])), repr(float(normal[1])),
                        repr(float(normal[2]))])
                    # (send_rpc's local echo places our own decal)
            elif hit_player is not None:
                # Offline: no RPC loop to echo the hit — apply directly
                # (makes --offline --bots a playable practice range).
                self._handle_player_hit(hit_player.id, SHOT_DAMAGE,
                                        attacker_id=self.net.client_id)
            elif mesh_id is not None and mesh_id < self.n_map:
                # Offline: no RPC loop to echo the hit — place directly.
                self._place_decal(point, normal)
        # recoil kick (Renderer.cs:248) — 45 is in RADIANS in the reference.
        self.recoil = np.asarray(ml.quat_mul(
            self.recoil, ml.quat_from_yaw_pitch_roll(0.0, 45.0, 0.0)), F32)

    def _place_decal(self, point: np.ndarray, normal: np.ndarray) -> None:
        """Place a bullet-hole quad at a LevelHit: orient the plane's +y
        onto the surface normal, offset slightly along it (ring buffer of
        pre-packed slots — oldest holes recycle)."""
        n = np.asarray(normal, F32)
        ln = float(np.linalg.norm(n))
        if ln < 1e-6:
            return
        n = n / ln
        a = np.asarray([0, 1, 0], F32) if abs(n[1]) < 0.9 \
            else np.asarray([1, 0, 0], F32)
        t = np.cross(a, n)
        t = t / np.linalg.norm(t)
        b = np.cross(n, t)
        m = np.eye(4, dtype=F32)
        m[0, :3], m[1, :3], m[2, :3] = t, n, b
        m[3, :3] = np.asarray(point, F32) + n * F32(0.01)
        slot = self.decal_slice[0] + self._decal_next
        self._mesh_matrices[slot] = m
        self._decal_next = (self._decal_next + 1) % self.n_decals
        self._decal_used = min(self._decal_used + 1, self.n_decals)
        # spark burst at the impact (local shots AND remote LevelHits —
        # every path that places a decal sprays)
        self._bursts.append((np.asarray(point, F32) + n * F32(0.02),
                             n * F32(2.0)))

    # -- render ---------------------------------------------------------------

    def _spectate_targets(self) -> List["ConnectedPlayer"]:
        """Other connected players, in scoreboard order (stable cycling)."""
        return [p for p in self.players if p.id != self.net.client_id]

    def _get_fused(self, eng):
        """The ONE-dispatch-per-frame program (SURVEY.md §3.2: 'all of
        §P1-P8 collapse into one jitted device program per frame'):
        character physics (CharacterController.cs:50-140), the bot
        crowd, the particle sim, the view-model gun matrix
        (Renderer.cs:476-477), the whole render and the RGB8 present
        convert trace into ONE jitted call
        (scene, sim, ctl, uniforms) → (sim', rgb8, aux).  aux packs
        every host-needed output (character position, bot poses / fire
        decisions) into one flat f32 vector so the host pays a single
        pipelined readback per frame.  Cached per Engine object, so
        wireframe/params swaps rebuild it naturally."""
        fn = getattr(eng, "_dust2_fused", None)
        if fn is not None:
            return fn
        gs0, gs1 = self.gun_slice
        world = self.world
        tri_mask = self._map_tri_mask
        has_bots = self._bots_state is not None
        frame = eng._frame          # jitted; inlines under the outer jit
        from softwarerenderer_tpu.engine.renderer import to_rgb8

        def fused(scene, sim, ctl, uniforms):
            cp = ctl["char_params"]
            char = character_step(sim["char"], ctl["move"], ctl["jump"],
                                  ctl["dt"], world, cp, tri_mask=tri_mask)
            new_sim = {"char": char}
            aux = [char["position"]]
            # The camera follows the fresh on-device pose (zero view
            # lag — host consumers still read the pipelined copy);
            # spectating takes the host-provided target pose instead.
            cam_pos = jnp.where(
                ctl["cam_follow"],
                char["position"] + jnp.asarray(cp["cam_offset"],
                                               jnp.float32),
                jnp.asarray(ctl["cam_position"], jnp.float32))
            # Gun matrix (Renderer.cs:476-477): the rotation factor is
            # host math (sway/recoil quats); the translation rides the
            # fresh camera.  Row-vector convention: translation row 3.
            trans = jnp.eye(4, dtype=jnp.float32).at[3, :3].set(
                cam_pos + jnp.asarray(ctl["gun_off"], jnp.float32))
            gun_m = ml.matmul(
                jnp.asarray(ctl["gun_rot_m"], jnp.float32), trans, xp=jnp)
            mm = jnp.asarray(ctl["mesh_matrices"], jnp.float32)
            mm = mm.at[gs0:gs1].set(gun_m[None])
            if has_bots:
                bdt = jnp.maximum(ctl["dt"], jnp.float32(1e-4))
                bots = agents_step(
                    sim["bots"], bdt, self._bot_waypoints, world,
                    cp, self._bot_brain, tri_mask=tri_mask,
                    next_hop=self._bot_next_hop,
                    targets=ctl["bot_targets"],
                    target_alive=ctl["bot_alive"],
                    target_ids=ctl["bot_tids"],
                    self_ids=self._bot_ids_arr)
                new_sim["bots"] = bots
                aux += [bots["char"]["position"].ravel(),
                        bots["rotation"].ravel(),
                        bots["fire"].astype(jnp.float32),
                        bots["aim"].ravel()]
            parts = particles_mod.particle_step(sim["particles"],
                                                ctl["emitter"],
                                                ctl["sim_dt"])
            new_sim["particles"] = parts
            u = dict(uniforms)
            u.update(particles_mod.particle_uniforms(parts,
                                                     ctl["emitter"]))
            u["camera_position"] = cam_pos
            color = frame(dict(scene, mesh_matrices=mm), u)[0]
            rgb = to_rgb8(color)
            aux = jnp.concatenate(
                [jnp.asarray(a, jnp.float32).ravel() for a in aux])
            # Pack aux INTO the frame transfer: bitcast the f32 vector
            # to bytes and append it as extra u8 rows below the image,
            # so the host's per-frame readback is ONE transfer (each
            # separate np.asarray pays a full device round trip).
            w = rgb.shape[1]
            au8 = jax.lax.bitcast_convert_type(aux, jnp.uint8).ravel()
            rb = w * 3
            rows = (au8.shape[0] + rb - 1) // rb
            au8 = jnp.pad(au8, (0, rows * rb - au8.shape[0]))
            packed = jnp.concatenate([rgb, au8.reshape(rows, w, 3)], 0)
            # tail = the image's last row + the aux rows (~4 KB): frames
            # whose rgb fetch is skipped (_present_nth) sync on THIS —
            # still data-dependent on the rendered image, without the
            # frame-sized transfer.
            return new_sim, packed, packed[rgb.shape[0] - 1:]

        fn = jax.jit(fused)
        eng._dust2_fused = fn
        return fn

    def _join_fused(self):
        """Pop the (rgb8, aux) fetch submitted `present_depth` frames
        ago and apply its aux outputs (pose cache, bot roster + fire).
        Returns a (rgb8_or_None,) 1-tuple — rgb8 is None when that
        frame's image fetch was skipped (_present_nth) — or None while
        the pipeline is still filling (the bootstrap case; the two MUST
        stay distinguishable, else every skipped-rgb frame would block
        on an in-flight future)."""
        if len(self._out_q) < max(1, self.present_depth):
            return None
        rgb, aux = self._out_q.pop(0).result()
        self._apply_aux(aux)
        return (rgb,)

    def _apply_aux(self, aux: np.ndarray) -> None:
        self._char_pos_host = np.asarray(aux[:3], F32).copy()
        self.cam_position = self._char_pos_host \
            + np.asarray(self.char_params["cam_offset"])
        if self._bot_ids:
            n = len(self._bot_ids)
            k = 3
            pos = aux[k:k + 3 * n].reshape(n, 3)
            k += 3 * n
            rot = aux[k:k + 4 * n].reshape(n, 4)
            k += 4 * n
            fire = aux[k:k + n] > 0.5
            k += n
            aim = aux[k:k + 3 * n].reshape(n, 3)
            self._apply_bot_aux(pos, rot, fire, aim)

    def _render(self, dt: float, joined_rgb=None):
        """RenderScene (Renderer.cs:404-419): update matrices + one frame."""
        mm = self._mesh_matrices
        visible = np.ones(self.n_meshes, bool)
        # Unplaced decal slots stay hidden.
        visible[self.decal_slice[0] + self._decal_used:
                self.decal_slice[1]] = False

        # Spectator camera: watch through the target's eyes; hide the gun
        # and the target's own model.  Falls back to first person when the
        # target disconnects.
        spectated = None
        if self.spectate_idx >= 0:
            others = self._spectate_targets()
            if self.spectate_idx < len(others):
                spectated = others[self.spectate_idx]
            else:
                self.spectate_idx = -1
        self.hud.state.spectating = spectated.name if spectated else ""

        # Gun matrix (Renderer.cs:476-477).
        sway_recoil = ml.quat_mul(self.weapon_sway, self.recoil)
        gun_off = ml.quat_rotate(np.asarray(
            [0.05, -0.05, -0.15 + abs(float(self.recoil[0]) / 5)], F32),
            self.cam_rotation)
        gun_m = (self.gun_base @ ml.matrix_from_quaternion(sway_recoil)
                 @ ml.translation(self.cam_position + gun_off)).astype(F32)
        for i in range(*self.gun_slice):
            mm[i] = gun_m

        # Remote players: interpolation + slot matrices (Renderer.cs:503-540).
        factor = 1.0 - math.exp(-12.0 * dt)
        used = set()
        for i, p in enumerate(self.players):
            p.local_position = p.local_position \
                + (p.position - p.local_position) * F32(factor)
            if p.id == self.net.client_id or i >= self.max_players:
                continue
            pm = self._player_matrix(p)
            lo, hi = self.player_slices[i]
            for j in range(lo, hi):
                mm[j] = pm
            used.add(i)
        for slot in range(self.max_players):
            if slot not in used:
                lo, hi = self.player_slices[slot]
                visible[lo:hi] = False

        u = self.engine.uniforms
        cam_pos, cam_rot = self.cam_position, self.cam_rotation
        if spectated is not None:
            cam_pos = np.asarray(spectated.local_position, F32) \
                + np.asarray(self.char_params["cam_offset"], F32)
            cam_rot = np.asarray(spectated.rotation, F32)
            for i in range(*self.gun_slice):        # no view weapon
                visible[i] = False
            si = self.players.index(spectated)
            if si < self.max_players:               # not our own eyes' body
                lo, hi = self.player_slices[si]
                visible[lo:hi] = False
        u["camera_position"] = np.asarray(cam_pos, F32)
        u["camera_rotation"] = np.asarray(cam_rot, F32)
        u["mesh_visible"] = visible
        if self.mirror:
            # Rear view: same eye, head turned 180° (pitch kept), gun
            # view-model hidden — all traced overrides, no recompile.
            e = np.asarray(ml.quat_to_euler_degrees(cam_rot))
            rear = ml.quat_from_yaw_pitch_roll(
                (e[1] + 180.0) * math.pi / 180, e[0] * math.pi / 180,
                e[2] * math.pi / 180)
            vis2 = visible.copy()
            vis2[self.gun_slice[0]:self.gun_slice[1]] = False
            u["pip_view"] = {"camera_position": np.asarray(cam_pos, F32),
                             "camera_rotation": np.asarray(rear, F32),
                             "mesh_visible": vis2}

        # Impact sparks: pop one queued burst into this step's emitter
        # (origin/velocity/rate are traced — no recompile); the particle
        # step itself runs inside the fused program.
        em = dict(self._emitter)
        sim_dt = np.float32(max(dt, 1e-3))
        if self._bursts:
            origin, vel = self._bursts.pop(0)
            em["origin"] = origin
            em["base_velocity"] = vel
            em["rate"] = np.float32(24.0) / sim_dt
        if self._anim_sources:
            # Advance each distinct model's flip-book clock once, then feed
            # the per-animated-mesh frame indices as a traced uniform.
            for m in {id(m): m for m in self._anim_sources}.values():
                m.advance_animation(dt)
            u["anim_frame"] = np.asarray(
                [m._frame_index for m in self._anim_sources], np.int32)
        if self.wireframe:
            if self._wire_engine is None:
                from softwarerenderer_tpu.config import DebugMode
                self._wire_engine = Engine(
                    self.engine.scene,
                    self.engine.params.replace(
                        debug_mode=DebugMode.WIREFRAME),
                    frame_fn=self._frame_fn)
                # share the live scene dict so per-frame matrix updates
                # (gun, players) reach the wireframe program too
                self._wire_engine.scene = self.engine.scene
                self._wire_engine.uniforms = self.engine.uniforms
            eng = self._wire_engine
        else:
            eng = self.engine
        tags = self._nametags()
        if self.burn_hud:
            u["hud_text"] = self._burn_hud_entries(tags)
        # ONE fused dispatch for the whole frame (sim + render + RGB8),
        # then ONE pipelined (rgb8, aux) fetch joined two frames later —
        # device compute AND the device→host round trip fully overlap
        # the intervening host work (see _init_state; the reference
        # instead re-enters its thread pool per subsystem and blocks on
        # a CPU→GPU upload every frame, MainWindow.cs:247-251).
        sim = {"char": self.char, "particles": self._particles}
        if self._bots_state is not None:
            sim["bots"] = self._bots_state
        ctl = {
            "move": self._move, "jump": self._jump,
            "dt": np.float32(dt if dt > 0 else 1 / 60),
            "sim_dt": sim_dt, "emitter": em,
            "char_params": self.char_params,
            "cam_follow": np.bool_(spectated is None),
            "cam_position": np.asarray(cam_pos, F32),
            "gun_off": np.asarray(gun_off, F32),
            "gun_rot_m": (self.gun_base
                          @ ml.matrix_from_quaternion(sway_recoil)
                          ).astype(F32),
            "mesh_matrices": mm,
        }
        if self._bots_state is not None:
            ctl.update(self._bot_ctl())
        new_sim, packed_dev, tail_dev = self._get_fused(eng)(
            eng.scene, sim, ctl, u)
        self.char = new_sim["char"]
        self._particles = new_sim["particles"]
        if "bots" in new_sim:
            self._bots_state = new_sim["bots"]

        self._frame_i += 1
        fetch_rgb = (self._present_nth <= 1
                     or self._frame_i % self._present_nth == 0)
        rh = eng.params.height
        n_aux = 3 + 11 * len(self._bot_ids)

        def _fetch(packed=packed_dev if fetch_rgb else None,
                   tail=tail_dev):
            # ONE device→host transfer: image rows + the aux bytes the
            # fused step packed below them (see _get_fused).  Frames
            # whose rgb is skipped (_present_nth) fetch the ~4 KB tail
            # instead — still a sync on the rendered image's data.
            if packed is None:
                t = np.asarray(tail)
                return None, t[1:].ravel()[:4 * n_aux].view(np.float32)
            buf = np.asarray(packed)
            a = buf[rh:].ravel()[:4 * n_aux].view(np.float32)
            return buf[:rh], a

        try:
            # Start the device→host copy NOW (non-blocking): by the time
            # the fetcher thread's np.asarray runs, the transfer is in
            # flight or done.
            (packed_dev if fetch_rgb else tail_dev).copy_to_host_async()
        except Exception:
            pass                    # backend without async host copies
        self._out_q.append(self._fetcher.submit(_fetch))
        if joined_rgb is None:
            # Bootstrap: repeat the first frame while the pipeline fills
            # (present-only peek; aux is applied when the future pops).
            rgb = self._out_q[0].result()[0]
            bootstrap = True
        else:
            rgb = joined_rgb[0]
            bootstrap = False
        if rgb is None:          # rgb fetch skipped (_present_nth > 1)
            if self._blank_frame is None or \
                    self._blank_frame.shape[:2] != self.window.render_size[::-1]:
                rw, rh = self.window.render_size
                self._blank_frame = np.zeros((rh, rw, 3), np.uint8)
            rgb = self._blank_frame
        if self._recorder is not None and not bootstrap:
            # Bootstrap repeats are not recorded; close() flushes the
            # in-flight tail, so an N-step run records exactly frames
            # 0..N-1.
            self._recorder.add(rgb)
        self.hud.state.rendered_meshes = int(visible.sum())
        self.hud.state.nametags = tags
        rw, rh = self.window.render_size
        n_tris = self.scene["indices"].shape[0]
        self.stats.frame(pixels=rw * rh, triangles=n_tris)
        if self.hud.state.show_debug:
            lines = self.stats.debug_lines()
            p = self.engine.params
            lines.append(f"ssaa [o]: {p.ssaa}x   mips [m]: "
                         f"{bool(p.use_mipmaps)}   wire [p]: "
                         f"{self.wireframe}   nmap [n]: "
                         f"{getattr(self, 'normal_mapped', False)}   "
                         f"ssao [k]: {p.ssao}   bloom [j]: {p.bloom}   "
                         f"fxaa [u]: {p.fxaa}")
            self.hud.state.debug_lines = lines
            # Clickable slider rows (drawn + hit-tested via the shared
            # io_host.ui panel geometry).
            self.hud.state.tunables = [
                (name, self._tunable_value(name, kind), lo, hi)
                for name, kind, _step, lo, hi in self.TUNABLES]
            self.hud.state.tune_selected = self._tune_idx
        self.window.present(rgb, overlay=self.hud)

    def _nametags(self):
        """Renderer.RenderPlayerNametags (:544-585)."""
        view, proj = camera_matrices(
            {k: self.engine.uniforms[k] for k in
             ("camera_position", "camera_rotation", "fov_degrees",
              "near_clip", "far_clip")},
            self.window.width, self.window.height, xp=np)
        tags = []
        for p in self.players:
            if p.id == self.net.client_id:
                continue
            xy = project_nametag(p.local_position, view, proj,
                                 self.window.width, self.window.height)
            if xy is not None:
                tags.append((xy[0], xy[1], p.name))
        return tags

    # -- main loop ------------------------------------------------------------

    def run(self, frames: Optional[int] = None):
        last = time.perf_counter()
        n = 0
        try:
            while not self.window.should_close:
                now = time.perf_counter()
                dt = min(now - last, 0.1)
                last = now
                self.step(dt if dt > 0 else 1 / 60)
                n += 1
                if frames is not None and n >= frames:
                    break
        finally:
            self.close()

    def save_state(self, path: str) -> None:
        """Checkpoint the deterministic sim state (utils/checkpoint —
        beyond the reference, which persists nothing).  The sim is a pure
        jitted function of (state, inputs), so a restored checkpoint
        replays bit-identically under the same input script."""
        from softwarerenderer_tpu.utils import checkpoint
        checkpoint.save(path, {
            "char": jax.device_get(self.char),
            "cam_rotation": np.asarray(self.cam_rotation),
            "cam_position": np.asarray(self.cam_position),
            "weapon_sway": np.asarray(self.weapon_sway),
            "recoil": np.asarray(self.recoil),
            "time": np.float64(self.time),
            "last_shot": np.float64(self.last_shot),
            "noclip": np.asarray(self.noclip),
            "char_params": jax.device_get(self.char_params),
            "particles": jax.device_get(self._particles),
            # Bot crowd state (PRNG key included) — without it a restored
            # replay would diverge the moment an agent steps.
            "bots": (None if self._bots_state is None
                     else jax.device_get(self._bots_state)),
        })

    def load_state(self, path: str) -> None:
        from softwarerenderer_tpu.utils import checkpoint
        st = checkpoint.load(path)
        self.char = jax.device_put(st["char"])
        self.cam_rotation = np.asarray(st["cam_rotation"], F32)
        self.cam_position = np.asarray(st["cam_position"], F32)
        self.weapon_sway = np.asarray(st["weapon_sway"], F32)
        self.recoil = np.asarray(st["recoil"], F32)
        self.time = float(st["time"])
        self.last_shot = float(st["last_shot"])
        self.noclip = bool(st["noclip"])
        self.char_params = jax.device_put(st["char_params"])
        if "particles" in st:       # absent in pre-particle checkpoints
            self._particles = jax.device_put(st["particles"])
        if st.get("bots") is not None and self._bots_state is not None:
            # Only meaningful when this run spawned the same crowd
            # (--bots N); a mismatched shape should fail loudly.
            self._bots_state = jax.device_put(st["bots"])
        # Drop in-flight fused-step fetches — they belong to the
        # pre-restore timeline; the pipeline refills (bootstrap) from
        # the restored state.
        self._out_q = []
        self._char_pos_host = np.asarray(st["char"]["position"], F32)
        self.cam_position = np.asarray(st["cam_position"], F32)

    def close(self):
        if self._recorder is not None:
            for fut in self._out_q:
                # flush the in-flight pipelined frames (see step())
                try:
                    rgb = fut.result()[0]
                    if rgb is not None:
                        self._recorder.add(rgb)
                except ValueError:
                    pass                      # size changed mid-recording
            self._out_q = []
            self._recorder.close()
            self._recorder = None
        try:
            self.hud.save_layout(self.layout_path)
        except OSError:
            pass
        self._fetcher.shutdown(wait=False)
        if self.net.is_connected:
            self.net.send_rpc("DisconnectedPlayer",
                              [str(self.net.client_id)])
            self.net.close()
        audio.cleanup()
        self.window.close()


def serve(port: int = 7777, net_batch: float = 0.0, quiet: bool = False,
          stop_event=None, poll_hz: float = 100.0) -> None:
    """Dedicated relay server: host a session with no scene, renderer,
    physics, or player slot — a deployment mode the reference cannot
    express (its host is always a rendering player; Renderer.cs:72-84
    boots the window unconditionally).

    Runs the pure Networking host: binds the port (it elects itself —
    nobody answers the ping), assigns client ids, replays buffered
    join RPCs to late joiners, relays Update/chat/hit traffic, and
    serves reliable-delivery acks.  Game rules live client-side in this
    protocol (each peer applies its own PlayerHit / respawn), so a
    logic-less relay is a complete server.  The host never announces a
    ConnectedPlayer, so clients see only each other.

    Blocks until `stop_event` (a threading.Event) is set; with the
    default None it serves forever (Ctrl-C to stop).
    """
    net = Networking()
    net.rpc_batch_window = max(0.0, net_batch)
    # Without a player host, client→client relay IS the server's job —
    # the reference's faithful no-relay quirk (only host-originated RPCs
    # broadcast) would make a playerless host useless.
    net.relay_client_rpcs = True
    # late joiners must learn of earlier clients: buffer their joins
    net.buffer_relayed_methods = {"ConnectedPlayer"}
    # a playerless host must expire crashed clients itself (graceful
    # Disconnects arrive as RPCs; silence does not) — heartbeat
    # failure detection stops relaying to dead endpoints and prunes
    # their buffered joins
    net.peer_timeout = 10.0
    if quiet:
        net.log = lambda s: None
    # Direct bind, no election: the server must be answering pings the
    # moment it returns (connect()'s election window is unbound+silent,
    # and a client pinging into it would elect itself host).
    if not net.host(port):
        raise SystemExit(f"port {port} is unavailable "
                         f"(already hosting a session?)")
    if not quiet:
        print(f"dedicated server on :{port}")
    try:
        while stop_event is None or not stop_event.is_set():
            net.poll_rpcs()     # drain + flush batch windows / resends
            time.sleep(1.0 / poll_hz)
    except KeyboardInterrupt:
        pass
    finally:
        net.close()


def apply_config_tunables(game: "Dust2Game", cfg) -> None:
    """Apply an AppConfig's uniform/physics tunables to a constructed
    game — the JSON/env config path for every value the debug panel can
    tune live (the reference has no config files at all, SURVEY.md §5)."""
    u = game.engine.uniforms
    u["fov_degrees"] = np.float32(cfg.fov_degrees)
    u["near_clip"] = np.float32(cfg.near_clip)
    u["far_clip"] = np.float32(cfg.far_clip)
    u["fog_start"] = np.float32(cfg.fog_start)
    u["fog_end"] = np.float32(cfg.fog_end)
    u["fog_color"] = np.asarray(cfg.fog_color, F32)
    u["light_color"] = np.asarray(cfg.light_color, F32)
    u["clear_color"] = np.asarray(cfg.clear_color, F32)
    u["light_direction"] = np.asarray(
        ml.euler_degrees_to_direction(list(cfg.light_euler_degrees)), F32)
    game.light_euler = {"light_yaw": np.float32(cfg.light_euler_degrees[1]),
                        "light_pitch":
                            np.float32(cfg.light_euler_degrees[0])}
    game.mouse_sensitivity = float(cfg.sensitivity)
    cp = dict(game.char_params)
    cp.update(
        gravity=np.asarray([0.0, cfg.gravity_y, 0.0], F32),
        height=np.float32(cfg.char_height),
        radius=np.float32(cfg.char_radius),
        step_size=np.float32(cfg.step_size),
        move_speed=np.float32(cfg.move_speed),
        jump_force=np.float32(cfg.jump_force),
        ground_acceleration=np.float32(cfg.ground_acceleration),
        air_acceleration=np.float32(cfg.air_acceleration),
        max_air_speed=np.float32(cfg.max_air_speed),
        ground_friction=np.float32(cfg.ground_friction),
        air_control=np.float32(cfg.air_control))
    game.char_params = cp


def main(argv=None):
    from softwarerenderer_tpu.utils import appconfig

    # --config pre-parse: the config's values become argparse DEFAULTS,
    # so explicit CLI flags always win over JSON/env.
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--config", default=None)
    pre_args, _ = pre.parse_known_args(argv)
    cfg = appconfig.load(pre_args.config)

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("server", nargs="?", default=cfg.server)
    ap.add_argument("--port", type=int, default=cfg.port)
    ap.add_argument("--width", type=int, default=cfg.width)
    ap.add_argument("--height", type=int, default=cfg.height)
    ap.add_argument("--render-scale", type=float,
                    default=cfg.render_scale)
    ap.add_argument("--headless", action="store_true")
    ap.add_argument("--reliable", action="store_true",
                    help="acked/resent delivery for join/hit/chat RPCs "
                         "(all peers must run this framework)")
    ap.add_argument("--migrate", action="store_true",
                    help="host migration: if the host vanishes, the "
                         "lowest-id client takes over the session "
                         "(all peers must run this framework)")
    ap.add_argument("--net-batch", type=float, default=0.0,
                    metavar="SECONDS",
                    help="coalesce outgoing RPCs within this window into "
                         "one datagram per peer (0 = off; all peers must "
                         "run this framework)")
    ap.add_argument("--bots", type=int, default=0,
                    help="host-owned AI bots (batched agent crowd; "
                         "ignored when joining as a client)")
    ap.add_argument("--bot-skill", choices=sorted(Dust2Game.BOT_SKILLS),
                    default="normal",
                    help="bot difficulty preset (brain tunables only — "
                         "bot physics match human players)")
    ap.add_argument("--upnp", action="store_true",
                    help="map the session UDP port on the LAN gateway "
                         "when hosting (UPnP IGD)")
    ap.add_argument("--offline", action="store_true",
                    help="skip networking entirely")
    ap.add_argument("--dedicated", action="store_true",
                    help="run a dedicated relay server on --port (no "
                         "scene, no rendering, no player slot)")
    ap.add_argument("--config", default=None, metavar="PATH.json",
                    help="JSON config (utils/appconfig; ./srt.json is "
                         "auto-loaded, SRT_* env vars override; explicit "
                         "CLI flags win over both)")
    ap.add_argument("--mirror", action="store_true",
                    help="rear-view mirror: a second camera rendered as "
                         "a top-center inset inside the same jitted "
                         "frame (engine.render_frame_pip)")
    ap.add_argument("--kbuffer", type=int, default=1, metavar="K",
                    help="K-layer ordered translucency (depth-peeled "
                         "kernel passes with the opaque short-circuit); "
                         "overlapping particles/decals blend in "
                         "submission order.  1 = single-winner (default)")
    ap.add_argument("--raytrace", type=int, nargs="?", const=24,
                    default=0, metavar="CAP",
                    help="render through the ray tracer (per-pixel "
                         "primary rays + geometrically exact hard "
                         "shadows; interactive via the bundle-culled "
                         "pair sweep).  CAP = per-bundle "
                         "cluster budget (default 24)")
    ap.add_argument("--burn-hud", action="store_true",
                    help="composite the HUD (crosshair/health/fps/chat/"
                         "nametags) into the framebuffer ON DEVICE "
                         "(ops/text.py) so headless captures carry it")
    ap.add_argument("--record", default=None, metavar="PATH.avi",
                    help="record presented frames to an uncompressed AVI "
                         "(utils/video.py; works headless)")
    ap.add_argument("--record-fps", type=float, default=30.0,
                    help="playback rate stamped into the recording")
    ap.add_argument("--frames", type=int, default=None)
    ap.add_argument("--out", default=None, help="headless PNG output path")
    ap.add_argument("--assets", default=cfg.assets_dir or DEFAULT_ASSETS)
    ap.add_argument("--name", default=cfg.player_name)
    args = ap.parse_args(argv)
    from softwarerenderer_tpu.utils import compile_cache
    compile_cache.enable_compile_cache()

    if args.dedicated:
        serve(port=args.port, net_batch=args.net_batch)
        return

    game = Dust2Game(server=args.server, port=args.port, width=args.width,
                     height=args.height, render_scale=args.render_scale,
                     headless=args.headless, assets_dir=args.assets,
                     player_name=args.name, out=args.out,
                     offline=args.offline, reliable=args.reliable,
                     migrate=args.migrate, net_batch=args.net_batch,
                     upnp=args.upnp, bots=args.bots,
                     bot_skill=args.bot_skill, burn_hud=args.burn_hud,
                     record=args.record, record_fps=args.record_fps,
                     mirror=args.mirror, kbuffer=args.kbuffer,
                     raytrace=args.raytrace)
    apply_config_tunables(game, cfg)
    game.run(frames=args.frames)


if __name__ == "__main__":
    main()
