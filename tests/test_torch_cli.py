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
@pytest.mark.parametrize("argv", [
    ["sweep", "--scenes", "8"],
    ["run", "--device", "cpu", "--shards", "2"],
])
def test_cli_unported_cases_exit_2_naming_their_roadmap_item(argv, capsys):
    assert cli.main(argv) == 2
    assert "ROADMAP.md queue A item" in capsys.readouterr().err


def test_cli_without_a_card_exits_2(monkeypatch, capsys):
    # --device cuda (the default) never falls back to the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.main(["run", *_CALM_FLAGS, "--frames", "1"]) == 2
    assert cli.main(["bench", "--particles", "1024"]) == 2
    assert "no CUDA device" in capsys.readouterr().err
