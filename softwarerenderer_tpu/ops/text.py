"""Device-side text overlay: glyph strings composited into the framebuffer
INSIDE the jitted frame program.

The reference draws every piece of text (chat, nametags, health, debug
panel) host-side through ImGui onto the GL surface (Renderer.cs:544-820);
our window overlay (io_host/ui.py) is that path's analog.  This op is the
device alternative: strings are packed host-side into small
static-shape integer/float arrays (`pack_text`) that ride the uniforms
pytree — so CONTENT and POSITION are traced values (changing text never
recompiles) — and compositing happens on device as one strip-gather plus
one `dynamic_update_slice` per string slot.  Headless captures, video
recordings (utils/video.py), render-to-texture passes and multi-chip
shards therefore carry the HUD with zero host-side drawing.

Cost model (why strips, not per-glyph writes): a string's glyphs are
assembled into a single (cell_h, L·cell_w) coverage strip with reshapes —
no per-glyph loop — so the sequential `fori_loop` runs once per STRING
slot (S iterations of a tiny read-lerp-write), not once per character.
Hidden slots (alpha == 0) are masked with `where`, making them bit-exact
no-ops on the framebuffer.

Use standalone via `composite_text`, or as a user post-FX stage
(config.RenderParams.post_fx) via `text_overlay_fx`.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from softwarerenderer_tpu.utils.font import FIRST_CODEPOINT, N_GLYPHS

F32 = np.float32


def encode_glyphs(text: str, max_chars: int) -> np.ndarray:
    """ASCII string → (max_chars,) int32 atlas indices (space-padded).

    Printable ASCII maps to codepoint - 32; control characters map to
    space; anything ≥ DEL maps to the replacement box (index 95)."""
    ids = np.zeros((max_chars,), np.int32)
    for j, ch in enumerate(text[:max_chars]):
        cp = ord(ch)
        if cp < FIRST_CODEPOINT:
            ids[j] = 0
        elif cp >= FIRST_CODEPOINT + N_GLYPHS - 1:
            ids[j] = N_GLYPHS - 1
        else:
            ids[j] = cp - FIRST_CODEPOINT
    return ids


def pack_text(entries: Sequence, max_strings: int = 8,
              max_chars: int = 48) -> dict:
    """Pack up to `max_strings` text entries into the static-shape traced
    arrays `composite_text` consumes.

    entries: sequence of (text, (x, y)) or (text, (x, y), (r, g, b[, a]))
    tuples — (x, y) is the string's top-left in pixels, color defaults to
    opaque white.  Unused slots get alpha 0 (bit-exact no-ops).  Entries
    beyond max_strings and characters beyond max_chars are dropped
    (deterministically, from the tail).

    Returns {"glyphs": (S, L) i32, "pos": (S, 2) i32, "color": (S, 4) f32}.
    """
    S, L = int(max_strings), int(max_chars)
    glyphs = np.zeros((S, L), np.int32)
    pos = np.zeros((S, 2), np.int32)
    color = np.zeros((S, 4), F32)
    for i, e in enumerate(entries[:S]):
        text, xy = e[0], e[1]
        c = tuple(e[2]) if len(e) > 2 else (1.0, 1.0, 1.0, 1.0)
        if len(c) == 3:
            c = c + (1.0,)
        glyphs[i] = encode_glyphs(str(text), L)
        pos[i] = (int(xy[0]), int(xy[1]))
        color[i] = c
    return {"glyphs": glyphs, "pos": pos, "color": color}


def text_size(font: dict, text: str) -> Tuple[int, int]:
    """(width, height) in pixels of `text` on the monospace grid."""
    return len(text) * int(font["cell_w"]), int(font["cell_h"])


def composite_text(color, bitmaps, packed: dict, xp=None):
    """Blend packed text strips over a (H, W, 4) color buffer.  Jittable;
    `bitmaps` is the font atlas (96, gh, gw) — close over it as a
    constant, don't re-upload per frame.

    Per string slot: every covered channel lerps toward (r, g, b, 1) by
    coverage × alpha; uncovered / alpha-0 pixels are returned bit-exactly
    (masked with `where`, not blended by 0).

    A string's glyph strip is a STATIC (cell_h, max_chars·cell_w) patch
    (content is traced, shapes can't follow the live length), so the
    composite runs on a strip-padded copy of the buffer and crops back —
    strings may hang off any edge (partially visible, exact clipping) or
    sit fully off-screen, and a dynamic-slice clamp can never drag a
    right-aligned string back into view.  The pad+crop costs one ~1.4×
    frame copy; the sequential work is one read-lerp-write per STRING
    slot.
    """
    import jax
    import jax.numpy as jnp
    from jax import lax

    bitmaps = jnp.asarray(bitmaps, jnp.float32)
    glyphs = jnp.asarray(packed["glyphs"], jnp.int32)
    pos = jnp.asarray(packed["pos"], jnp.int32)
    scol = jnp.asarray(packed["color"], jnp.float32)
    S, L = glyphs.shape
    gh, gw = int(bitmaps.shape[1]), int(bitmaps.shape[2])
    H, W = int(color.shape[0]), int(color.shape[1])
    C = int(color.shape[2])
    sw, sh = L * gw, gh

    # (S, L, gh, gw) coverage → (S, gh, L·gw) strips.
    cov = jnp.take(bitmaps, glyphs.reshape(-1), axis=0)
    strips = cov.reshape(S, L, gh, gw).transpose(0, 2, 1, 3) \
                .reshape(S, gh, sw)

    padded = jnp.pad(color, ((sh, sh), (sw, sw), (0, 0)))
    # Positions in padded coords; anything our clamp moves stays entirely
    # inside the pad margin (cropped away), so off-screen slots vanish
    # instead of snapping back into view.
    x = jnp.clip(pos[:, 0] + sw, 0, W + sw)
    y = jnp.clip(pos[:, 1] + sh, 0, H + sh)
    # Lerp target: the string color with alpha channel driven to 1 (text
    # is opaque in the output's alpha plane).
    tgt = jnp.concatenate(
        [scol[:, :3], jnp.ones((S, 1), jnp.float32)], axis=1)[:, :C]

    def body(i, buf):
        st = lax.dynamic_index_in_dim(strips, i, keepdims=False)
        a = (st * scol[i, 3])[..., None]                     # (sh, sw, 1)
        patch = lax.dynamic_slice(buf, (y[i], x[i], 0), (sh, sw, C))
        blended = patch + (tgt[i] - patch) * a
        out = jnp.where(a > 0, blended, patch)
        return lax.dynamic_update_slice(buf, out, (y[i], x[i], 0))

    out = lax.fori_loop(0, S, body, padded)
    return out[sh:sh + H, sw:sw + W]


def text_overlay_fx(font: dict, uniforms_key: str = "hud_text"):
    """A user post-FX stage (RenderParams.post_fx) that composites the
    packed text in uniforms[uniforms_key] over the finished frame.

    The atlas bitmaps are closed over as a device constant; the packed
    text arrays ride the uniforms pytree, so updating the HUD each frame
    is a pure traced-value change.  When the key is absent from the
    uniforms (a trace-time, static condition) the stage is a no-op.
    """
    bitmaps = np.asarray(font["bitmaps"], F32)

    def fx(color, depth, uniforms):
        packed = uniforms.get(uniforms_key)
        if packed is None:
            return color, depth
        return composite_text(color, bitmaps, packed), depth

    return fx
