"""Host-side frame export: point-sprite PNG rendering and PLY meshes.

Counterpart of ``sphfluidsimulation_tpu/render/export.py``, copied verbatim
(numpy only): importing the JAX package's module would import jax.

The reference draws speed-colored instanced spheres with alpha blending and
no depth write (InstancedIndirectColor.shader:6-7, 42-44) via
DrawMeshInstancedIndirect (SphFluidSimulation.cs:107). On TPU there is no
swapchain, so frames are exported host-side: particles are projected with
the orbit camera and splatted as depth-sorted colored discs (painter's
algorithm ~ the reference's transparent, ZWrite-off pass). PNG encoding is
pure stdlib (zlib), no imaging dependency.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from .camera import OrbitCamera


def save_png(path: str, rgb: np.ndarray) -> None:
    """Write an RGB8 image [H, W, 3] as PNG (pure zlib encoder)."""
    h, w, _ = rgb.shape
    raw = np.concatenate(
        [np.zeros((h, 1), np.uint8), rgb.reshape(h, -1)], axis=1).tobytes()

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data)))

    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    png = (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", header)
           + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(png)


def render_frame_png(pos_unit: np.ndarray, colors: np.ndarray, *,
                     sim_scale: float = 5.0, particle_radius: float = 0.01,
                     camera: OrbitCamera | None = None, width: int = 800,
                     height: int = 600,
                     background=(16, 16, 24)) -> np.ndarray:
    """Render unit-cube positions to an RGB8 image.

    World transform matches UpdateMeshProperties.compute:40
    (pos·simScale − simScale/2); sprite radius is the projected particle
    radius; far-to-near painter's order approximates the reference's
    unsorted alpha blend.
    """
    cam = camera or OrbitCamera(distance=8.0, yaw=30.0, pitch=20.0)
    world = np.asarray(pos_unit, np.float32) * sim_scale - sim_scale / 2.0
    xy, z = cam.project(world, width, height)
    colors = np.asarray(colors, np.float32)
    rgb8 = (np.clip(colors[:, :3], 0, 1) * 255).astype(np.uint8)
    # SrcAlpha/OneMinusSrcAlpha compositing (shader:6): the reference's
    # colors carry constant alpha 1 (UpdateMeshProperties.compute:63), for
    # which the blend degenerates to the opaque painter overwrite below —
    # translucent alphas take the compositing path.
    alpha = (np.clip(colors[:, 3], 0.0, 1.0)
             if colors.shape[1] > 3 else np.ones(len(colors), np.float32))
    translucent = bool((alpha < 1.0).any())

    img = np.empty((height, width, 3), np.uint8)
    img[:] = np.asarray(background, np.uint8)

    visible = z > 0.05
    f = (height / 2.0) / np.tan(np.deg2rad(cam.fov_deg) / 2.0)
    r_px = particle_radius * sim_scale * f / np.maximum(z, 0.05)

    # native rasterizer (sphfluidsimulation_torch/native) when available —
    # the numpy path below is the behavioral reference and fallback
    if translucent:
        from ..native.build import splat_points_alpha_native
        if splat_points_alpha_native(xy, z, r_px, rgb8, alpha,
                                     img) is not None:
            return img
    else:
        from ..native.build import splat_points_native
        if splat_points_native(xy, z, r_px, rgb8, img) is not None:
            return img

    order = np.argsort(-z)  # far → near (the unsorted ZWrite-off blend
    order = order[visible[order]]       # ≈ painter's order)

    xs = np.round(xy[order, 0]).astype(np.int64)
    ys = np.round(xy[order, 1]).astype(np.int64)
    rs = np.clip(np.round(r_px[order]).astype(np.int64), 1, 16)
    cs = rgb8[order]
    al = alpha[order]

    if translucent:
        # exact sequential src-over in global depth order: one particle at
        # a time (python loop — the fallback when the native sequential
        # compositor is unavailable; at most a few px² of work per splat)
        for x0, y0, radius, c0, a0 in zip(xs, ys, rs, cs,
                                          al.astype(np.float32)):
            d = np.arange(-radius + 1, radius)
            dx, dy = np.meshgrid(d, d, indexing="ij")
            disc = (dx * dx + dy * dy) <= radius * radius
            px = (x0 + dx[disc]).ravel()
            py = (y0 + dy[disc]).ravel()
            ok = (px >= 0) & (px < width) & (py >= 0) & (py < height)
            px, py = px[ok], py[ok]
            base = img[py, px].astype(np.float32)
            img[py, px] = (a0 * c0.astype(np.float32)
                           + (1.0 - a0) * base).astype(np.uint8)
        return img

    # Splat as filled discs bucketed by radius (vectorized per radius).
    for radius in np.unique(rs):
        sel = rs == radius
        x0, y0, c0 = xs[sel], ys[sel], cs[sel]
        d = np.arange(-radius + 1, radius)
        dx, dy = np.meshgrid(d, d, indexing="ij")
        disc = (dx * dx + dy * dy) <= radius * radius
        dx, dy = dx[disc], dy[disc]
        px = (x0[:, None] + dx[None, :]).ravel()
        py = (y0[:, None] + dy[None, :]).ravel()
        pc = np.repeat(c0, len(dx), axis=0)
        ok = (px >= 0) & (px < width) & (py >= 0) & (py < height)
        img[py[ok], px[ok]] = pc[ok]
    return img


def assemble_animation(frame_paths: list[str], out_path: str, *,
                       fps: float = 12.0) -> str:
    """Assemble exported PNG frames into an animation.

    The reference's user-facing output is a continuously drawn fluid
    (SphFluidSimulation.cs:106-107, one DrawMeshInstancedIndirect per
    frame); headless TPU runs export stills, and this stitches them into
    the moving-fluid artifact. GIF via Pillow when available, else an APNG
    written with the same stdlib-zlib encoder as save_png.
    """
    if not frame_paths:
        raise ValueError("no frames to assemble")
    try:
        from PIL import Image
        frames = [Image.open(p).convert("P", palette=Image.ADAPTIVE)
                  for p in sorted(frame_paths)]
        frames[0].save(out_path, save_all=True, append_images=frames[1:],
                       duration=int(1000 / fps), loop=0)
        return out_path
    except ImportError:
        return _save_apng(sorted(frame_paths), out_path, fps=fps)


def _read_png_rgb(path: str) -> np.ndarray:
    """Minimal reader for PNGs written by save_png (8-bit RGB, one IDAT)."""
    with open(path, "rb") as f:
        data = f.read()
    pos, idat = 8, b""
    w = h = 0
    while pos < len(data):
        (ln,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + ln]
        if tag == b"IHDR":
            w, h = struct.unpack(">II", body[:8])
        elif tag == b"IDAT":
            idat += body
        pos += 12 + ln
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, -1)
    assert (raw[:, 0] == 0).all(), "only filter-0 PNGs supported"
    return raw[:, 1:].reshape(h, w, 3)


def _save_apng(frame_paths: list[str], out_path: str, *, fps: float) -> str:
    """Animated PNG via the stdlib encoder (no Pillow needed)."""
    imgs = [_read_png_rgb(p) for p in frame_paths]
    h, w, _ = imgs[0].shape

    def chunk(tag: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + tag + body
                + struct.pack(">I", zlib.crc32(tag + body)))

    def raw(img):
        return zlib.compress(np.concatenate(
            [np.zeros((h, 1), np.uint8), img.reshape(h, -1)], 1).tobytes(), 6)

    delay_num, delay_den = 1, max(1, int(round(fps)))
    out = [b"\x89PNG\r\n\x1a\n",
           chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)),
           chunk(b"acTL", struct.pack(">II", len(imgs), 0))]
    seq = 0
    for i, img in enumerate(imgs):
        out.append(chunk(b"fcTL", struct.pack(
            ">IIIIIHHBB", seq, w, h, 0, 0, delay_num, delay_den, 0, 0)))
        seq += 1
        if i == 0:
            out.append(chunk(b"IDAT", raw(img)))
        else:
            out.append(chunk(b"fdAT", struct.pack(">I", seq) + raw(img)))
            seq += 1
    out.append(chunk(b"IEND", b""))
    with open(out_path, "wb") as f:
        f.write(b"".join(out))
    return out_path


def save_ply(path: str, pos: np.ndarray, colors: np.ndarray | None = None,
             triangles: np.ndarray | None = None, *,
             binary: bool = False) -> None:
    """PLY export of points (with optional colors) or a mesh.

    ``binary=True`` uses the native C++ writer (point clouds only) and
    falls back to ASCII when the native library is unavailable.
    """
    pos = np.asarray(pos, np.float32)
    if binary and triangles is None:
        from ..native.build import write_ply_native
        c8 = None
        if colors is not None:
            c8 = (np.clip(np.asarray(colors, np.float32)[:, :3], 0, 1)
                  * 255).astype(np.uint8)
        if write_ply_native(path, pos, c8):
            return
    lines = ["ply", "format ascii 1.0", f"element vertex {len(pos)}",
             "property float x", "property float y", "property float z"]
    if colors is not None:
        lines += ["property uchar red", "property uchar green",
                  "property uchar blue"]
        c8 = (np.clip(np.asarray(colors, np.float32)[:, :3], 0, 1)
              * 255).astype(np.uint8)
    if triangles is not None:
        lines += [f"element face {len(triangles)}",
                  "property list uchar int vertex_indices"]
    lines.append("end_header")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
        for i, p in enumerate(pos):
            row = f"{p[0]} {p[1]} {p[2]}"
            if colors is not None:
                row += f" {c8[i, 0]} {c8[i, 1]} {c8[i, 2]}"
            f.write(row + "\n")
        if triangles is not None:
            for t in np.asarray(triangles, np.int64):
                f.write(f"3 {t[0]} {t[1]} {t[2]}\n")


def save_instanced_mesh_ply(path: str, pos_unit: np.ndarray,
                            colors: np.ndarray | None = None, *,
                            sim_scale: float = 5.0,
                            particle_radius: float = 0.01,
                            subdivisions: int = 1,
                            max_particles: int = 65536) -> str:
    """Mesh export instancing the octahedron sphere at every particle.

    This is the reference's actual draw: one octasphere instance per
    particle (OctahedronSphereCreator.cs:14 built at
    SphFluidSimulation.cs:162, instanced by SphFluidSimulation.cs:107) with
    the world TRS of UpdateMeshProperties.compute:34-48 — translation
    pos·simScale − simScale/2, uniform scale particle_radius·simScale —
    baked into vertex positions. Colors replicate per instance (the
    per-instance color buffer of InstancedIndirectColor.shader:30,42).

    ``max_particles`` guards against accidental multi-GB files; pass a
    larger value deliberately for full-scene meshes.
    """
    from .sphere import octahedron_sphere

    pos_unit = np.asarray(pos_unit, np.float32)
    if len(pos_unit) > max_particles:
        raise ValueError(
            f"{len(pos_unit)} particles would instance "
            f"{len(pos_unit)}×~24 vertices; raise max_particles to allow")
    mesh = octahedron_sphere(subdivisions, 1.0)
    v, t = mesh.vertices, np.asarray(mesh.triangles, np.int64)
    world = pos_unit * sim_scale - sim_scale / 2.0
    scale = particle_radius * sim_scale
    verts = (world[:, None, :] + scale * v[None, :, :]).reshape(-1, 3)
    tris = (t[None, :, :]
            + (np.arange(len(world), dtype=np.int64)[:, None, None]
               * len(v))).reshape(-1, 3)
    cols = None
    if colors is not None:
        cols = np.repeat(np.asarray(colors, np.float32)[:, :3], len(v),
                         axis=0)
    save_ply(path, verts, cols, tris)
    return path
