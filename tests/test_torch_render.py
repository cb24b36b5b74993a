"""The torch port's render layer against the JAX package's: the mesh
properties (``render/meshprops.py``, torch), the copied numpy exporters
(PNG, PLY, the WebGL viewer) byte for byte on the same input and the same
rasteriser, the CLI's ``export`` and ``run --export-dir/--animate/--viewer``
(tests/test_render_artifacts.py, tests/test_viewer.py, tests/test_cli.py),
and the native codec's loader under concurrent first use."""

import base64
import json
import os
import re
import shutil
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sphfluidsimulation_tpu.native.build as jnative
import sphfluidsimulation_torch.native.build as tnative
from sphfluidsimulation_tpu.config import TINY_CONFIG as JTINY
from sphfluidsimulation_tpu.config import SimConfig as JConfig
from sphfluidsimulation_tpu.render import export as jexport
from sphfluidsimulation_tpu.render import meshprops as jmesh
from sphfluidsimulation_tpu.render import viewer as jviewer
from sphfluidsimulation_tpu.state import make_state as jmake_state
from sphfluidsimulation_tpu.utils.checkpoint import save_checkpoint as jsave
from sphfluidsimulation_torch import cli
from sphfluidsimulation_torch.config import TINY_CONFIG
from sphfluidsimulation_torch.render import export, meshprops, viewer

# one intra-op thread: the suite runs in several worker processes on
# shared cores, where each worker's spinning OpenMP threads slowed the
# port's many small CPU ops about fivefold
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _inputs(n=500, seed=0):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-0.05, 1.05, (n, 3)).astype(np.float32)
    vel = rng.normal(0, 0.4, (n, 3)).astype(np.float32)
    nan_mask = rng.uniform(size=n) < 0.2
    return pos, vel, nan_mask


def test_mesh_properties_match_jax():
    # world_positions, speed_colors (with and without the NaN marker) and
    # the MeshProperties buffer: elementwise the same float32 operations,
    # within 1e-6 (norms may round differently)
    pos, vel, nan_mask = _inputs()
    rp = meshprops.RenderParams.from_config(TINY_CONFIG)
    jrp = jmesh.RenderParams.from_config(JTINY)
    tpos, tvel = torch.from_numpy(pos), torch.from_numpy(vel)
    np.testing.assert_allclose(
        meshprops.world_positions(tpos, rp).numpy(),
        np.asarray(jmesh.world_positions(jnp.asarray(pos), jrp)), atol=1e-6)
    for mask in (None, nan_mask):
        tmask = None if mask is None else torch.from_numpy(mask)
        jm = None if mask is None else jnp.asarray(mask)
        col = meshprops.speed_colors(tvel, rp, tmask).numpy()
        np.testing.assert_allclose(
            col, np.asarray(jmesh.speed_colors(jnp.asarray(vel), jrp, jm)),
            atol=1e-6)
        mat, col2 = meshprops.mesh_properties(tpos, tvel, rp, tmask)
        jmat, jcol = jmesh.mesh_properties(jnp.asarray(pos),
                                           jnp.asarray(vel), jrp, jm)
        np.testing.assert_allclose(mat.numpy(), np.asarray(jmat), atol=1e-6)
        np.testing.assert_allclose(col2.numpy(), np.asarray(jcol), atol=1e-6)
    # the marker: alpha 0.003 exactly on trapped rows, 1 elsewhere
    # (VelPos.compute:146, UpdateMeshProperties.compute:63)
    a = meshprops.speed_colors(tvel, rp, torch.from_numpy(nan_mask))[:, 3]
    assert bool((a[torch.from_numpy(nan_mask)]
                 == np.float32(meshprops.NAN_MARKER_ALPHA)).all())
    assert bool((a[~torch.from_numpy(nan_mask)] == 1.0).all())


def _on_rasteriser(monkeypatch, kind):
    """Both packages on one rasteriser: numpy (both native entry points
    answer None) or the port's native codec (the JAX exporter is pointed
    at the port's loaded library, so the two draw with the same code)."""
    for mod in (jnative, tnative):
        for name in ("splat_points_native", "splat_points_alpha_native",
                     "write_ply_native"):
            if kind == "numpy":
                fallback = False if name == "write_ply_native" else None
                monkeypatch.setattr(mod, name,
                                    lambda *a, _f=fallback, **k: _f)
            else:
                monkeypatch.setattr(mod, name, getattr(tnative, name))


@pytest.mark.parametrize("alpha", ["opaque", "translucent"])
@pytest.mark.parametrize("kind", ["numpy", "native"])
def test_exported_files_are_byte_equal_to_jax(tmp_path, monkeypatch, kind,
                                              alpha):
    _on_rasteriser(monkeypatch, kind)
    pos, vel, _ = _inputs(300, seed=2)
    col = np.random.default_rng(3).uniform(0, 1, (300, 4)).astype(
        np.float32)
    if alpha == "opaque":
        col[:, 3] = 1.0
    kw = dict(width=96, height=64, particle_radius=0.03)
    img = export.render_frame_png(pos, col, **kw)
    np.testing.assert_array_equal(img,
                                  jexport.render_frame_png(pos, col, **kw))
    files = []
    for mod, tag in ((export, "t"), (jexport, "j")):
        mod.save_png(str(tmp_path / f"{tag}.png"), img)
        mod.save_ply(str(tmp_path / f"{tag}.ply"), pos, col)
        mod.save_ply(str(tmp_path / f"{tag}_bin.ply"), pos, col,
                     binary=True)
        mod.save_instanced_mesh_ply(str(tmp_path / f"{tag}_mesh.ply"),
                                    pos[:20], col[:20])
        files.append([tmp_path / f"{tag}{x}" for x in
                      (".png", ".ply", "_bin.ply", "_mesh.ply")])
    for a, b in zip(*files):
        assert a.read_bytes() == b.read_bytes(), a.name


def test_viewer_html_is_byte_equal_to_jax(tmp_path):
    rng = np.random.default_rng(0)
    snaps = rng.uniform(0, 1, (4, 100, 3)).astype(np.float32)
    speeds = rng.uniform(0, 1, (4, 100)).astype(np.float32)
    for refresh in (None, 2.0):
        t, j = str(tmp_path / "t.html"), str(tmp_path / "j.html")
        viewer.export_html_viewer(t, snaps, speeds, refresh_s=refresh)
        jviewer.export_html_viewer(j, snaps, speeds, refresh_s=refresh)
        assert open(t).read() == open(j).read()
    html = open(t).read()
    pos_b64 = re.search(r'decode\("([A-Za-z0-9+/=]*)"\).buffer', html)
    q = np.frombuffer(base64.b64decode(pos_b64.group(1)), "<u2")
    np.testing.assert_allclose(q.reshape(4, 100, 3) / 65535.0, snaps,
                               atol=1.0 / 65535)
    with pytest.raises(ValueError):
        viewer.export_html_viewer(str(tmp_path / "x.html"),
                                  np.zeros((4, 3), np.float32))


def _meta(path):
    html = open(path).read()
    return json.loads(re.search(r"const META = (\{.*?\});", html).group(1)), \
        html


TINY = ["--device", "cpu", "--particles", "256", "--bucket-resolution", "7",
        "--gas-constant", "1.0", "--neighbor", "slotted"]


def test_cli_run_exports_frames_animation_and_viewer(tmp_path, capsys):
    # tests/test_cli.py:15-44 and tests/test_viewer.py:32-75 on the port
    frames, out = tmp_path / "frames", str(tmp_path / "run.html")
    ck = str(tmp_path / "ck.npz")
    rc = cli.main(["run", *TINY, "--frames", "3", "--checkpoint", ck,
                   "--export-dir", str(frames), "--export-every", "1",
                   "--animate", str(tmp_path / "anim.png"), "--viewer", out,
                   "--viewer-live", "1"])
    assert rc == 0
    assert sorted(os.listdir(frames)) == [f"frame_{i:05d}.png"
                                          for i in (1, 2, 3)]
    data = (tmp_path / "anim.png").read_bytes()
    assert data[:6] in (b"GIF87a", b"GIF89a") or data[:8] == \
        b"\x89PNG\r\n\x1a\n"
    meta, html = _meta(out)      # the final write: static, no refresh
    assert meta["frames"] == 3 and meta["n"] == 256
    assert meta["live"] is False and "http-equiv" not in html
    assert "http://" not in html and "https://" not in html
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last["frames"] == 3

    rc = cli.main(["run", *TINY, "--frames", "2", "--viewer", out,
                   "--viewer-every", "2"])
    assert rc == 0 and _meta(out)[0]["frames"] == 1


def test_cli_export_of_a_jax_checkpoint(tmp_path):
    # tests/test_render_artifacts.py:72-86 and tests/test_cli.py:33-38: a
    # checkpoint written by the JAX package, exported by the port's CLI
    cfg = JConfig(particle_number=1024, bucket_resolution=9)
    state = jmake_state(jnp.full((cfg.n_particles, 3), 0.5))
    ck = str(tmp_path / "ck.npz")
    jsave(ck, state, cfg, frame=1)
    png, ply, mesh = (str(tmp_path / x) for x in ("f.png", "f.ply",
                                                  "mesh.ply"))
    assert cli.main(["export", ck, "--png", png, "--ply", ply, "--ply-mesh",
                     mesh]) == 0
    for p in (png, ply, mesh):
        assert os.path.getsize(p) > 0
    assert open(png, "rb").read(8) == b"\x89PNG\r\n\x1a\n"
    with pytest.raises(ValueError, match="max_particles"):
        cli.main(["export", ck, "--ply-mesh", mesh, "--mesh-max-particles",
                  "10"])


_LOADER = """
import sys
sys.path.insert(0, {root!r})
from sphfluidsimulation_torch.native import build
lib = build.open_framecodec({so!r})
print("loaded" if lib is not None and hasattr(lib, "splat_points_alpha")
      else "none")
"""


def test_native_loader_builds_once_under_concurrent_first_use(tmp_path):
    """Six processes open the codec at once in a fresh directory: each gets
    a whole library (the build writes a temporary file and replaces the
    library path under an exclusive lock), or, without g++, each gets None
    and the exporters fall back to numpy."""
    so = str(tmp_path / "_framecodec.so")
    code = _LOADER.format(root=ROOT, so=so)
    procs = [subprocess.Popen([sys.executable, "-c", code],
                              stdout=subprocess.PIPE, text=True)
             for _ in range(6)]
    outs = [p.communicate(timeout=300)[0].strip() for p in procs]
    assert all(p.returncode == 0 for p in procs)
    have_gxx = shutil.which("g++") is not None
    assert outs == ["loaded" if have_gxx else "none"] * 6
    if have_gxx:
        assert [f for f in os.listdir(tmp_path) if "tmp" in f] == []
        img = np.zeros((16, 16, 3), np.uint8)
        drawn = tnative.splat_points_native(
            np.array([[8.0, 8.0]], np.float32), np.array([1.0], np.float32),
            np.array([2.0], np.float32), np.array([[9, 8, 7]], np.uint8),
            img)
        assert drawn == 1 and tuple(img[8, 8]) == (9, 8, 7)
