"""Texture sampling — nearest/repeat parity mode plus bilinear.

Reference semantics (Texture.cs:42-63): nearest-neighbor with repeat wrap,
    u = frac(u) (+1 if negative);  x = int(u*W) % W (+W if negative)
Bilinear is an additional non-parity mode (the reference advertises only
nearest; SURVEY.md §6 note 4).

Textures are dicts {"data": (H, W, 4) float32 in [0,1]} so they ride pytrees
into jit.  `sample_*` works under numpy and jax.numpy alike; gathers lower to
`jnp.take` on device.
"""

from __future__ import annotations

import numpy as np

F32 = np.float32


def quantize_u8_grid(data: np.ndarray) -> np.ndarray:
    """Snap float colors to the u8/255 grid (still float32).

    The reference stores textures as BYTE images (Texture.cs via ImageSharp;
    `Sample` returns bytes/255f), so the u8 grid IS the texture value space.
    Quantizing at load time keeps the CPU oracle and the device's packed
    RGBA8 atlas (see `pack_rgba8`) bit-identical.
    """
    q = np.clip(np.round(np.asarray(data, np.float32) * F32(255.0)),
                0.0, 255.0).astype(np.float32)
    return q / F32(255.0)


def pack_rgba8(data: np.ndarray) -> np.ndarray:
    """(H, W, 4) float32 in [0,1] → (H, W, 4) uint8 RGBA.

    The device atlas format: 4-byte texel ROWS instead of 16-byte f32 rows,
    so a texel fetch moves a quarter of the bytes."""
    return np.clip(np.round(np.asarray(data, np.float32) * 255.0),
                   0, 255).astype(np.uint8)


def unpack_rgba8(q, xp=np):
    """uint8 RGBA rows → (..., 4) float32; bytes/255 exactly like the
    reference's Sample (Texture.cs:59-62)."""
    return xp.asarray(q).astype(xp.float32) / F32(255.0)


def make_texture(data, xp=np):
    """Wrap an (H, W, 4) float32/uint8 array as a texture pytree.

    Colors snap to the u8/255 grid (the reference's byte-image value space,
    Texture.cs) so the CPU oracle and the device's packed-RGBA8 atlas agree
    exactly."""
    data = xp.asarray(data)
    if data.dtype == np.uint8 or str(data.dtype) == "uint8":
        data = data.astype(xp.float32) / F32(255.0)
    data = xp.asarray(data, dtype=xp.float32)
    if data.ndim == 2:
        data = data[..., None]
    if data.shape[-1] == 3:
        data = xp.concatenate(
            [data, xp.ones(data.shape[:-1] + (1,), dtype=xp.float32)], axis=-1)
    if xp is np:
        data = quantize_u8_grid(data)
    return {"data": data}


def _wrap_uv(uv, xp):
    """u - trunc(u), +1 if negative (Texture.cs:45-48)."""
    uv = xp.asarray(uv, dtype=xp.float32)
    frac = uv - xp.trunc(uv)
    return xp.where(frac < 0, frac + F32(1.0), frac)


def sample_nearest(texture, uv, xp=np):
    """Nearest-neighbor, repeat wrap; integer truncation exactly as the
    reference: x = int(u*W) % W, then +W if still negative."""
    data = texture["data"]
    h, w = data.shape[0], data.shape[1]
    st = _wrap_uv(uv, xp)
    x = xp.asarray(st[..., 0] * F32(w), dtype=xp.int32) % w
    y = xp.asarray(st[..., 1] * F32(h), dtype=xp.int32) % h
    x = xp.where(x < 0, x + w, x)
    y = xp.where(y < 0, y + h, y)
    flat = data.reshape(h * w, data.shape[-1])
    return xp.take(flat, y * w + x, axis=0)


def sample_atlas_nearest(atlas_data, offsets, sizes, tex_id, uv, xp=np):
    """Nearest/repeat sampling inside a packed-atlas sub-rectangle.

    Same integer semantics as `sample_nearest` (Texture.cs:42-63) applied
    within the texture's (h, w) region: one big gather from the atlas, so a
    whole frame's texturing is a single `take` on device.

    atlas_data: (AH, AW, 4) uint8 RGBA (pack_rgba8) or (AH, AW, 4) f32;
    offsets/sizes: (N, 2) int32 (y, x)/(h, w); tex_id: (...,) int32;
    uv: (..., 2).
    """
    data = xp.asarray(atlas_data)
    oy, ox, h, w = _atlas_region(offsets, sizes, tex_id, xp)
    return sample_atlas_region(data, oy, ox, h, w, uv, xp=xp)


def _atlas_fetch(data, idx, ah, aw, xp):
    """One row-gather per texel: u8 rows (packed atlas) or f32 rows."""
    rows = xp.take(data.reshape(ah * aw, data.shape[-1]), idx, axis=0)
    if str(data.dtype) == "uint8":
        return unpack_rgba8(rows, xp)
    return xp.asarray(rows, dtype=xp.float32)


def _atlas_region(offsets, sizes, tex_id, xp):
    """Per-element (oy, ox, h, w) from the atlas tables — an integer
    gather, exact for any offset.  Used only on the custom-shader path:
    the engine's own shaders pre-resolve regions per TRIANGLE and carry
    them as flat varyings (sample_atlas_region)."""
    offsets = xp.asarray(offsets, dtype=xp.int32)
    sizes = xp.asarray(sizes, dtype=xp.int32)
    off = xp.take(offsets, tex_id, axis=0)
    size = xp.take(sizes, tex_id, axis=0)
    return off[..., 0], off[..., 1], size[..., 0], size[..., 1]


def sample_atlas_region(atlas_data, oy, ox, h, w, uv, xp=np):
    """Nearest/repeat sampling with the texture's atlas region supplied
    per-element (pre-resolved per triangle and interpolated flat) — the
    fast path: the only per-pixel memory access is the texel row-gather.

    Same integer semantics as sample_atlas_nearest (Texture.cs:42-63)."""
    data = xp.asarray(atlas_data)
    ah, aw = data.shape[0], data.shape[1]
    oy = xp.asarray(oy, dtype=xp.int32)
    ox = xp.asarray(ox, dtype=xp.int32)
    h = xp.asarray(h, dtype=xp.int32)
    w = xp.asarray(w, dtype=xp.int32)
    st = _wrap_uv(uv, xp)
    x = xp.asarray(st[..., 0] * w.astype(xp.float32), dtype=xp.int32) % w
    y = xp.asarray(st[..., 1] * h.astype(xp.float32), dtype=xp.int32) % h
    x = xp.where(x < 0, x + w, x)
    y = xp.where(y < 0, y + h, y)
    return _atlas_fetch(data, (oy + y) * aw + (ox + x), ah, aw, xp)


def sample_atlas_region_bilinear(atlas_data, oy, ox, h, w, uv, xp=np):
    """Bilinear filtering with repeat wrap inside a per-element atlas
    region (oy, ox, h, w) — the region-resolved analog of
    sample_atlas_bilinear, used by the trilinear quality mode where two
    mip regions ride the per-triangle channels."""
    data = xp.asarray(atlas_data)
    ah, aw = data.shape[0], data.shape[1]
    oy = xp.asarray(oy, dtype=xp.int32)
    ox = xp.asarray(ox, dtype=xp.int32)
    h = xp.asarray(h, dtype=xp.int32)
    w = xp.asarray(w, dtype=xp.int32)
    st = _wrap_uv(uv, xp)
    fx = st[..., 0] * w.astype(xp.float32) - F32(0.5)
    fy = st[..., 1] * h.astype(xp.float32) - F32(0.5)
    x0 = xp.floor(fx)
    y0 = xp.floor(fy)
    tx = (fx - x0)[..., None]
    ty = (fy - y0)[..., None]
    x0i = xp.asarray(x0, dtype=xp.int32) % w
    y0i = xp.asarray(y0, dtype=xp.int32) % h
    x0i = xp.where(x0i < 0, x0i + w, x0i)
    y0i = xp.where(y0i < 0, y0i + h, y0i)
    x1i = (x0i + 1) % w
    y1i = (y0i + 1) % h

    def fetch(yi, xi):
        return _atlas_fetch(data, (oy + yi) * aw + (ox + xi), ah, aw, xp)

    c00 = fetch(y0i, x0i)
    c10 = fetch(y0i, x1i)
    c01 = fetch(y1i, x0i)
    c11 = fetch(y1i, x1i)
    top = c00 + (c10 - c00) * tx
    bot = c01 + (c11 - c01) * tx
    return top + (bot - top) * ty


def sample_atlas_bilinear(atlas_data, offsets, sizes, tex_id, uv, xp=np):
    """Bilinear filtering with repeat wrap inside an atlas sub-rectangle
    (texel centers at half-integers).  The non-parity quality mode — the
    reference only ships nearest (SURVEY.md §6 note 4)."""
    data = xp.asarray(atlas_data)
    ah, aw = data.shape[0], data.shape[1]
    oy, ox, h, w = _atlas_region(offsets, sizes, tex_id, xp)
    off = xp.stack([oy, ox], axis=-1)
    st = _wrap_uv(uv, xp)
    fx = st[..., 0] * w.astype(xp.float32) - F32(0.5)
    fy = st[..., 1] * h.astype(xp.float32) - F32(0.5)
    x0 = xp.floor(fx)
    y0 = xp.floor(fy)
    tx = (fx - x0)[..., None]
    ty = (fy - y0)[..., None]
    x0i = xp.asarray(x0, dtype=xp.int32) % w
    y0i = xp.asarray(y0, dtype=xp.int32) % h
    x0i = xp.where(x0i < 0, x0i + w, x0i)
    y0i = xp.where(y0i < 0, y0i + h, y0i)
    x1i = (x0i + 1) % w
    y1i = (y0i + 1) % h

    def fetch(yi, xi):
        return _atlas_fetch(data, (off[..., 0] + yi) * aw
                            + (off[..., 1] + xi), ah, aw, xp)

    c00 = fetch(y0i, x0i)
    c10 = fetch(y0i, x1i)
    c01 = fetch(y1i, x0i)
    c11 = fetch(y1i, x1i)
    top = c00 + (c10 - c00) * tx
    bot = c01 + (c11 - c01) * tx
    return top + (bot - top) * ty


def sample_bilinear(texture, uv, xp=np):
    """Bilinear filtering with repeat wrap (texel centers at half-integers)."""
    data = texture["data"]
    h, w = data.shape[0], data.shape[1]
    st = _wrap_uv(uv, xp)
    fx = st[..., 0] * F32(w) - F32(0.5)
    fy = st[..., 1] * F32(h) - F32(0.5)
    x0 = xp.floor(fx)
    y0 = xp.floor(fy)
    tx = (fx - x0)[..., None]
    ty = (fy - y0)[..., None]
    x0i = xp.asarray(x0, dtype=xp.int32) % w
    y0i = xp.asarray(y0, dtype=xp.int32) % h
    x0i = xp.where(x0i < 0, x0i + w, x0i)
    y0i = xp.where(y0i < 0, y0i + h, y0i)
    x1i = (x0i + 1) % w
    y1i = (y0i + 1) % h
    flat = data.reshape(h * w, data.shape[-1])
    c00 = xp.take(flat, y0i * w + x0i, axis=0)
    c10 = xp.take(flat, y0i * w + x1i, axis=0)
    c01 = xp.take(flat, y1i * w + x0i, axis=0)
    c11 = xp.take(flat, y1i * w + x1i, axis=0)
    top = c00 + (c10 - c00) * tx
    bot = c01 + (c11 - c01) * tx
    return top + (bot - top) * ty


def checkerboard(size=64, cells=8, color_a=(1.0, 1.0, 1.0, 1.0),
                 color_b=(0.2, 0.2, 0.2, 1.0)):
    """Procedural checkerboard texture (test/demo asset)."""
    yy, xx = np.mgrid[0:size, 0:size]
    cell = size // cells
    mask = ((xx // cell) + (yy // cell)) % 2 == 0
    data = np.where(mask[..., None],
                    np.asarray(color_a, dtype=F32),
                    np.asarray(color_b, dtype=F32))
    return make_texture(data.astype(F32))
