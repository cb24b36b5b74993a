"""The torch port's CLI, checkpoints, metrics log and state diagnostics
against the JAX package's."""

import json

import numpy as np
import pytest
import torch

from sphfluidsimulation_tpu.config import SimConfig as JConfig
from sphfluidsimulation_tpu.state import ParticleState as JState
from sphfluidsimulation_tpu.utils import checkpoint as jck
from sphfluidsimulation_tpu.utils import diagnostics as jdiag
from sphfluidsimulation_tpu.utils.metrics import MetricsLogger as JLogger
from sphfluidsimulation_torch import cli
from sphfluidsimulation_torch.config import SimConfig
from sphfluidsimulation_torch.sim.stepper import initial_state, make_rollout
from sphfluidsimulation_torch.utils import checkpoint, diagnostics
from sphfluidsimulation_torch.utils.metrics import MetricsLogger

# one intra-op thread: the suite runs in several worker processes on
# shared cores, where each worker's spinning OpenMP threads slowed the
# port's many small CPU ops about fivefold
torch.set_num_threads(1)

_CALM = dict(particle_number=1024, bucket_resolution=11, preset=0,
             gas_constant=20.0, rest_density=1.7, viscosity=0.05,
             stiffness_coefficient=1000.0, frame_dt=1 / 240)
_CALM_FLAGS = ["--particles", "1024", "--bucket-resolution", "11",
               "--preset", "0", "--gas-constant", "20", "--rest-density",
               "1.7", "--viscosity", "0.05", "--stiffness", "1000",
               "--frame-dt", str(1 / 240)]


def _state_after(frames=2):
    cfg = SimConfig(**_CALM, xsph=0.3)
    st, _ = make_rollout(cfg, frames, device="cpu")(
        initial_state(cfg, "cpu"))
    st = st._replace(nan_count=torch.arange(cfg.n_particles,
                                            dtype=torch.int32) % 3)
    return cfg, st


def test_checkpoint_jax_to_port_and_back(tmp_path):
    # exact, both ways: the npz layout and meta JSON are the JAX package's
    cfg, st = _state_after()
    jcfg = JConfig(**cfg.as_dict())
    jstate_ = JState(*(np.asarray(x) for x in st))
    jpath, tpath = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    jck.save_checkpoint(jpath, jstate_, jcfg, frame=7, extra={"k": 1})
    got, gcfg, meta = checkpoint.load_checkpoint(jpath)
    assert gcfg == cfg and meta["frame"] == 7 and meta["extra"] == {"k": 1}
    for a, b in zip(got, st):
        assert a.dtype == b.dtype and torch.equal(a, b)

    checkpoint.save_checkpoint(tpath, st, cfg, frame=9)
    back, bcfg, bmeta = jck.load_checkpoint(tpath)
    assert bcfg == jcfg and bmeta["frame"] == 9
    assert bmeta["format_version"] == 1
    for a, b in zip(back, jstate_):
        np.testing.assert_array_equal(np.asarray(a), b)
        assert np.asarray(a).dtype == b.dtype


def test_checkpoint_rejects_the_orbax_format(tmp_path):
    cfg, st = _state_after(0)
    with pytest.raises(ValueError, match="npz"):
        checkpoint.save_checkpoint(str(tmp_path / "ck"), st, cfg)
    with pytest.raises(ValueError, match="npz"):
        checkpoint.load_checkpoint(str(tmp_path / "ck"))


def _one_frame_metrics():
    cfg, _ = _state_after(0)
    _, m = make_rollout(cfg, 1, device="cpu")(initial_state(cfg, "cpu"))
    return type(m)(*(x[0] for x in m))


def test_metrics_logger_keys_match_jax(tmp_path):
    m1 = _one_frame_metrics()
    rec = MetricsLogger(str(tmp_path / "t.jsonl"), n_particles=1024).log(
        1, m1)
    jrec = JLogger(None, n_particles=1024).log(1, m1)
    assert list(rec) == list(jrec)
    line = json.loads((tmp_path / "t.jsonl").read_text().splitlines()[0])
    assert line == rec and line["exact_cert"] == 0


def test_validate_state_matches_jax():
    cfg, st = _state_after()
    want = jdiag.validate_state(JState(*(np.asarray(x) for x in st)),
                                n_particles=cfg.n_particles)
    assert diagnostics.validate_state(st, n_particles=cfg.n_particles) \
        == want
    bad = st._replace(pos=st.pos.clone())
    bad.pos[3, 1] = float("nan")
    with pytest.raises(diagnostics.StateError):
        diagnostics.validate_state(bad)
    with pytest.raises(diagnostics.StateError):
        diagnostics.validate_state(st, n_particles=5)


def _run(argv, capsys):
    rc = cli.main(argv)
    out = capsys.readouterr().out.strip().splitlines()
    return rc, out


def test_cli_run_corrected_extensions_checkpoint_and_resume(tmp_path,
                                                            capsys):
    metrics, ck = str(tmp_path / "m.jsonl"), str(tmp_path / "ck.npz")
    rc, out = _run(["run", "--device", "cpu", *_CALM_FLAGS, "--corrected",
                    "--xsph", "0.3", "--alpha-visc", "0.4", "--frames", "2",
                    "--metrics", metrics, "--checkpoint", ck, "--verbose"],
                   capsys)
    assert rc == 0
    final = json.loads(out[-1])
    assert final["frames"] == 2 and final["exact_cert"] == 0
    lines = [json.loads(x) for x in open(metrics)]
    jkeys = list(JLogger(None).log(0, _one_frame_metrics()))
    assert [x["frame"] for x in lines] == [1, 2]
    assert all(list(x) == jkeys for x in lines)
    _, ccfg, meta = checkpoint.load_checkpoint(ck)
    assert meta["frame"] == 2
    assert ccfg.xsph == 0.3 and ccfg.artificial_viscosity == 0.4

    rc, out = _run(["run", "--device", "cpu", "--resume", ck, "--corrected",
                    "--frames", "1"], capsys)
    assert rc == 0 and out[0].startswith("resumed frame 2")
    assert json.loads(out[-1])["frames"] == 3


def test_cli_run_brute_matches_sorted_on_calm(capsys):
    args = ["run", "--device", "cpu", *_CALM_FLAGS, "--frames", "1"]
    _, a = _run(args, capsys)
    _, b = _run(args + ["--neighbor", "brute"], capsys)
    a, b = json.loads(a[-1]), json.loads(b[-1])
    assert a["overflow"] == b["overflow"]
    assert a["mean_density"] == pytest.approx(b["mean_density"], rel=1e-5)


# export, --export-dir, --viewer and --animate run
# (tests/test_torch_render.py)


_SMALL = ["--particles", "512", "--bucket-resolution", "9"]


def test_cli_sweep_prints_jax_sweep_metrics_and_writes_a_png_a_scene(
        tmp_path, capsys):
    # JAX cli.py:264-301 on the slotted tier (the JAX CLI's default), two
    # scenes of 512 particles, one frame; JAX's BatchedScenes on the same
    # scenes gives the same metrics
    from sphfluidsimulation_tpu.parallel.batch import BatchedScenes as JB
    out_dir = tmp_path / "frames"
    rc, out = _run(["sweep", "--device", "cpu", *_SMALL, "--scenes", "2",
                    "--frames", "1", "--neighbor", "slotted",
                    "--vary-rest-density", "1.2", "1.6", "--export-dir",
                    str(out_dir)], capsys)
    assert rc == 0 and out[-1] == f"frames → {out_dir}"
    got = json.loads(out[-2])
    assert list(got) == ["scenes", "frames", "mean_density", "max_speed",
                         "overflow", "exact_cert"]
    assert got["scenes"] == 2 and got["frames"] == 1
    jb = JB(JConfig(particle_number=512, bucket_resolution=9),
            cli.sweep_overrides(1.2, 1.6, 2))
    jb.step()
    m = jb.last_metrics
    assert got["overflow"] == [int(x) for x in m.overflow]
    assert got["exact_cert"] == [int(x) for x in m.exact_cert] == [0, 0]
    np.testing.assert_allclose(got["mean_density"],
                               np.asarray(m.mean_density), atol=1e-4)
    assert sorted(p.name for p in out_dir.iterdir()) == ["scene_00.png",
                                                         "scene_01.png"]


def test_cli_sweep_sorted_default_runs_each_scene_as_alone(capsys):
    # the port's default tier; scene 1's metrics are those of its own run
    rc, out = _run(["sweep", "--device", "cpu", *_SMALL, "--scenes", "2",
                    "--frames", "2"], capsys)
    assert rc == 0
    got = json.loads(out[-1])
    cfg = SimConfig(particle_number=512, bucket_resolution=9,
                    **cli.sweep_overrides(1.0, 2.0, 2)[1])
    _, m = make_rollout(cfg, 2, device="cpu")(initial_state(cfg, "cpu"))
    assert got["mean_density"][1] == round(float(m.mean_density[-1]), 4)
    assert got["max_speed"][1] == float(m.max_speed[-1])
    assert got["overflow"][1] == int(m.overflow[-1])


def test_cli_run_shards_resumes_and_logs(tmp_path, capsys):
    # JAX cli.py:150-200: the sites slab step on 2 slabs, its metrics JSONL,
    # a checkpoint, and a resume through the same path
    metrics, ck = str(tmp_path / "m.jsonl"), str(tmp_path / "ck.npz")
    rc, out = _run(["run", "--device", "cpu", *_CALM_FLAGS, "--shards", "2",
                    "--row-slack", "4", "--frames", "2", "--metrics",
                    metrics, "--checkpoint", ck], capsys)
    assert rc == 0
    final = json.loads(out[-1])
    assert final["frames"] == 2 and final["shards"] == 2
    assert final["lost"] == 0 and final["halo"] == 2
    assert final["slab_z"] == 6 and final["rows_per_device"] == 2048
    lines = [json.loads(x) for x in open(metrics)]
    assert [x["frame"] for x in lines] == [1, 2]
    rc, out = _run(["run", "--device", "cpu", "--resume", ck, "--shards",
                    "2", "--row-slack", "4", "--frames", "1"], capsys)
    assert rc == 0 and out[0].startswith("resumed frame 2")
    assert json.loads(out[-1])["frames"] == 3


def test_cli_run_shards_matches_the_sites_step_on_calm(capsys):
    # one slab frame of the calm scene equals the single-device sites step
    # within the slab tolerances (tests/test_slab.py:164-167)
    args = ["run", "--device", "cpu", *_CALM_FLAGS, "--frames", "1",
            "--site-capacity", "24"]
    _, a = _run(args + ["--shards", "2", "--row-slack", "4"], capsys)
    _, b = _run(args + ["--neighbor", "sites"], capsys)
    a, b = json.loads(a[-1]), json.loads(b[-1])
    assert a["exact_cert"] == 0 == b["exact_cert"]
    assert a["overflow"] == b["overflow"]
    assert a["mean_density"] == pytest.approx(b["mean_density"], rel=1e-5)


@pytest.mark.parametrize("flag", [["--corrected"], ["--export-dir", "x"],
                                  ["--animate", "a.gif"], ["--viewer",
                                                           "v.html"]])
def test_cli_run_shards_refuses_what_the_slab_step_lacks(flag, capsys):
    # as the JAX CLI (cli.py:164-172): exit 2, naming the flag
    assert cli.main(["run", "--device", "cpu", "--shards", "2",
                     *flag]) == 2
    assert f"{flag[0]} not supported with --shards > 1" in \
        capsys.readouterr().err


def test_cli_bench_takes_the_jax_flags(monkeypatch, capsys):
    # --neighbor sites and --host-loop parse; without a card bench exits 2
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.main(["bench", "--neighbor", "sites", "--host-loop",
                     "--particles", "1024"]) == 2
    assert "no CUDA device" in capsys.readouterr().err


def test_cli_without_a_card_exits_2(monkeypatch, capsys):
    # --device cuda (the default) never falls back to the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.main(["run", *_CALM_FLAGS, "--frames", "1"]) == 2
    assert cli.main(["bench", "--particles", "1024"]) == 2
    assert cli.main(["sweep", *_CALM_FLAGS, "--frames", "1"]) == 2
    assert cli.main(["run", *_CALM_FLAGS, "--shards", "2"]) == 2
    assert "no CUDA device" in capsys.readouterr().err
