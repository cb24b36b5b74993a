"""The scene axis of the batched step (``parallel/batch.py``) on the CPU.

JAX's config-5 step is ``jax.vmap`` of the frame step: on the pallas tier
Pallas's batching rule prepends the scene to each kernel's grid. The port's
counterpart builds one frame over all scenes (``frame.build_frame_scenes``)
and runs K1 and K2 once over all of them (``sph_kernels.density_scenes``,
``fused_substep_scenes``); on the CPU the wrappers take the plain versions.
These tests hold, on small batches (2-4 scenes of 512 particles, R = 9):

- the batched frame build integer for integer to ``build_frame`` of each
  scene, on spawns that alias, with a capacity drop and with NaN rows;
- the scene-axis plain versions and the stacked scalar block and pj bit
  for bit to the solo ones of each scene;
- JAX's ``jax.vmap(density_pass)`` and ``jax.vmap(fused_substep)`` (Pallas
  in interpret mode with tile groups of two 64-row tiles and no unroll, as
  tests/test_torch_variants.py runs them) on 2 scenes with different rest
  densities, against the scene-axis plain versions, within the tolerances
  of the solo kernels' tests (tests/test_torch_kernels.py: density 1e-5
  relative, the same candidates summed in another order; substep 1e-6
  absolute in position and velocity, ρ and the NaN count equal);
- ``BatchedScenes`` on the scene axis, bit for bit each scene stepped
  alone, with and without the extensions, through 1 K1 + 5 K2 calls a
  frame; every other mode, route and variant of the sorted tier on the
  scene axis too (the corrected mode through 6 K1 + 5 K3 calls a frame,
  the unfused route 1 K1 + 5 K3, the compact route 1 + 5 K5, the variants
  in their own instances), each with no solo pass and bit for bit each
  scene alone; the tiers without kernels, which step scene by scene; the
  recorded frame body run eagerly against the host loop.

The scene axis of K3 and K5 against JAX's vmapped kernels is in
tests/test_torch_scene_routes.py; the card's side (the kernels, the graph)
in tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sphfluidsimulation_tpu.config import SimConfig as JConfig
from sphfluidsimulation_tpu.ops import pallas_sph
from sphfluidsimulation_tpu.ops.pallas_sph import PallasTuning
from sphfluidsimulation_tpu.params import PhysParams as JPhys
from sphfluidsimulation_tpu.params import stack_params as jstack_params
from sphfluidsimulation_torch.config import SimConfig
from sphfluidsimulation_torch.ops import compact, sph_kernels as sk
from sphfluidsimulation_torch.ops.frame import (build_frame,
                                                build_frame_scenes,
                                                scene_frame)
from sphfluidsimulation_torch.ops.sph_kernels import SortedTuning
from sphfluidsimulation_torch.params import PhysParams, stack_params
from sphfluidsimulation_torch.parallel import BatchedScenes
from sphfluidsimulation_torch.parallel.batch import (SceneCarry,
                                                     make_batched_step,
                                                     scene_frame_body)
from sphfluidsimulation_torch.sim import graph, stepper
from sphfluidsimulation_torch.sim.stepper import (initial_state,
                                                  make_frame_step)
from sphfluidsimulation_torch.state import StepMetrics, stack_states

# one intra-op thread, as in the port's other test modules
torch.set_num_threads(1)

# the golden spawn (out-of-cube jitter: aliased raw cells) at a small size
_GOLDEN = dict(particle_number=512, bucket_resolution=9)
# tests/test_pallas.py:18-21 at the same size
_CALM = dict(particle_number=512, bucket_resolution=9, preset=0,
             gas_constant=20.0, rest_density=1.7, viscosity=0.05,
             stiffness_coefficient=1000.0, frame_dt=1 / 240)
EXT = dict(xsph=0.3, artificial_viscosity=0.4)
CAP = 32
# the JAX kernels' tile geometry (tests/test_torch_variants.py)
JFAST = dict(tiles_per_group=2, unroll=1)
# 3 scenes: rest density and seed vary, as in the CLI's sweep
OVERRIDES = [{"rest_density": 1.0 + 0.4 * i, "seed": i} for i in range(3)]


def _same_bits(a, b):
    """Equal tensors, NaNs and signed zeros bit for bit."""
    assert a.shape == b.shape and a.dtype == b.dtype
    if a.is_floating_point():
        a, b = a.view(torch.int32), b.view(torch.int32)
    assert torch.equal(a, b)


def _batch(base=_GOLDEN, overrides=OVERRIDES, **ext):
    """(configs, stacked spawn states, stacked params) of a batch."""
    cfgs = [SimConfig(**base, **ext).replace(**ov) for ov in overrides]
    return (cfgs, stack_states([initial_state(c, "cpu") for c in cfgs]),
            stack_params([PhysParams.from_config(c) for c in cfgs]))


def _with_nan_rows(states):
    pos = states.pos.clone()
    pos[0, 5] = float("nan")
    pos[-1, 7, 1] = float("nan")
    return states._replace(pos=pos)


# ------------------------------------------------------------ frame build --

@pytest.mark.parametrize("cap", [4, CAP, None])
def test_build_frame_scenes_is_build_frame_of_each_scene(cap):
    _, states, _ = _batch()
    states = _with_nan_rows(states)
    vel = torch.from_numpy(np.random.default_rng(0).normal(
        size=tuple(states.pos.shape)).astype(np.float32))
    r = _GOLDEN["bucket_resolution"]
    frame, (pos_s, vel_s) = build_frame_scenes(states.pos, r, cap,
                                               extras=(states.pos, vel))
    assert frame.start.shape == (3, r ** 3 + 1)
    aliased = dropped = 0
    for s in range(3):
        want, (p1, v1) = build_frame(states.pos[s], r, cap,
                                     extras=(states.pos[s], vel[s]))
        for got, w in zip(scene_frame(frame, s), want):
            _same_bits(got, w)
        _same_bits(pos_s[s], p1)
        _same_bits(vel_s[s], v1)
        in_range = (want.raw >= 0) & (want.raw < r ** 3)
        aliased += int((~in_range).sum())
        dropped += int((in_range & ~want.occ).sum())
    # the spawn aliases, and capacity 4 drops rows the range keeps
    assert aliased > 0
    assert (dropped > 0) == (cap == 4)


def test_build_frame_scenes_keys_ties_by_gid():
    # the carried particle ids of a sorted rollout, below n_ids: each
    # scene's ranks keyed to its own ids, as build_frame keys them
    _, states, _ = _batch()
    r = _GOLDEN["bucket_resolution"]
    rng = np.random.default_rng(1)
    n = states.pos.shape[1]
    gid = torch.from_numpy(np.stack([rng.permutation(n) + 7
                                     for _ in range(3)]).astype(np.int32))
    frame, _ = build_frame_scenes(states.pos, r, 4, gid=gid, n_ids=600)
    for s in range(3):
        want, _ = build_frame(states.pos[s], r, 4, gid=gid[s], n_ids=600)
        for got, w in zip(scene_frame(frame, s), want):
            _same_bits(got, w)


def test_build_frame_scenes_checks_the_sort_key_bound():
    _, states, _ = _batch()
    gid = torch.zeros(states.pos.shape[:2], dtype=torch.int32)
    with pytest.raises(ValueError, match="int64"):
        build_frame_scenes(states.pos, 9, CAP, gid=gid, n_ids=2 ** 55)


# ------------------------------------------------- blocks, layout, unsort --

def test_scene_blocks_are_each_scenes_solo_blocks():
    _, states, params = _batch()
    rho = torch.rand(states.pos.shape[:2]) * 3.0
    rho[1, :9] = 0.0                        # below the ρ > ε guard
    blocks = sk.scal_blocks(params, *EXT.values())
    pj = sk.pj_cols_scenes(rho, params)
    rows = sk.pack_rows_scenes(states.pos, states.vel, rho)
    assert blocks.shape == (3, sk.N_SCAL) and blocks.is_contiguous()
    for s in range(3):
        ph = sk.scene_params(params, s)
        _same_bits(blocks[s], sk.scal_block(ph, *EXT.values()))
        _same_bits(pj[s], sk.pj_cols(rho[s], ph))
        _same_bits(rows[s], sk.pack_rows(states.pos[s], states.vel[s],
                                         rho[s]))
        for got, w in zip(sk.unpack_rows_scenes(rows),
                          sk.unpack_rows(rows[s])):
            _same_bits(got[s], w)


def test_unsort_scenes_is_each_scenes_unsort():
    _, states, _ = _batch()
    frame, (pos_s,) = build_frame_scenes(states.pos, 9, CAP,
                                         extras=(states.pos,))
    got = stepper._unsort_scenes(frame.order, pos_s)
    _same_bits(got, states.pos)
    for s in range(3):
        _same_bits(got[s], stepper._unsort(frame.order[s], pos_s[s]))


# ------------------------------------------- plain versions, scene by scene --

def _sorted_inputs(**ext):
    cfgs, states, params = _batch(**ext)
    r = _GOLDEN["bucket_resolution"]
    frame, (pos_s, vel_s) = build_frame_scenes(states.pos, r, CAP,
                                               extras=(states.pos,
                                                       states.vel))
    return cfgs, frame, pos_s, vel_s, params, r


@pytest.mark.parametrize("ext", [False, True])
def test_scene_plain_versions_are_each_scene_alone(ext):
    kw = EXT if ext else {}
    _, frame, pos_s, vel_s, params, r = _sorted_inputs(**kw)
    rho = sk.density_scenes(frame, pos_s, params, r, CAP)
    rows = sk.pack_rows_scenes(pos_s, vel_s, rho)
    out = sk.fused_substep_scenes(frame, rows, params, r, CAP,
                                  *kw.values())
    for s in range(3):
        fs, ph = scene_frame(frame, s), sk.scene_params(params, s)
        _same_bits(rho[s], sk.density_pass(fs, pos_s[s], ph, r, CAP))
        _same_bits(out[s], sk.fused_substep(fs, rows[s], ph, r, CAP,
                                            *kw.values()))
    # the plain versions themselves, as the card's checks call them
    _same_bits(sk.density_scenes_plain(frame, pos_s, params, r, CAP), rho)
    _same_bits(sk.fused_substep_scenes_plain(frame, rows, params, r, CAP,
                                             *kw.values()), out)


# ---------------------------------------------------- against JAX's vmap --

def _jax_batch(ext):
    """Two calm scenes with different rest densities and random
    velocities: (JAX frames' sorted pos, vel, ρ per scene, the port's
    frame, pos_s, vel_s, JAX and port params, JAX tuning, r, n)."""
    overrides = [{"rest_density": 1.5}, {"rest_density": 1.9}]
    kw = EXT if ext else {}
    jcs = [JConfig(**_CALM, **kw).replace(**ov) for ov in overrides]
    jp = jstack_params([JPhys.from_config(c) for c in jcs])
    cfgs, states, tp = _batch(_CALM, overrides, **kw)
    vel = np.random.default_rng(2).normal(
        0, 0.2, tuple(states.pos.shape)).astype(np.float32)
    pos = states.pos.numpy()
    r, n = _CALM["bucket_resolution"], cfgs[0].n_particles
    frame, (pos_s, vel_s) = build_frame_scenes(
        states.pos, r, CAP, extras=(states.pos, torch.from_numpy(vel)))
    return pos, vel, jp, tp, frame, pos_s, vel_s, r, n


def test_density_scenes_matches_jax_vmapped_density_pass():
    pos, _, jp, tp, frame, pos_s, _, r, n = _jax_batch(False)
    jt = PallasTuning(**JFAST)

    def density(p, phys):
        jf, (ps,) = pallas_sph.build_frame(p, r, CAP, extras=(p,), tune=jt)
        return pallas_sph.density_pass(jf, ps, phys, r, n, jt)[0]

    want = np.asarray(jax.vmap(density)(jnp.asarray(pos), jp))
    got = sk.density_scenes(frame, pos_s, tp, r, CAP).numpy()
    # same candidate set, sums in another order: rtol 1e-5
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)


@pytest.mark.parametrize("ext", [False, True])
def test_fused_substep_scenes_matches_jax_vmapped_fused_substep(ext):
    pos, vel, jp, tp, frame, pos_s, vel_s, r, n = _jax_batch(ext)
    xs, al = (EXT["xsph"], EXT["artificial_viscosity"]) if ext else (0, 0)
    jt = PallasTuning(**JFAST)
    rho = sk.density_scenes(frame, pos_s, tp, r, CAP)

    def substep(p, v, rho_s, phys):
        jf, (ps, vs) = pallas_sph.build_frame(p, r, CAP, extras=(p, v),
                                              tune=jt)
        rows = pallas_sph.pack_rows(ps, vs, rho_s, None, n, jt)
        out, cert = pallas_sph.fused_substep(jf, rows, phys, r, n,
                                             xsph=xs, alpha_visc=al,
                                             tune=jt)
        return out.reshape(-1, sk.N_FIELDS)[:n], cert

    want, cert = jax.vmap(substep)(jnp.asarray(pos), jnp.asarray(vel),
                                   jnp.asarray(rho.numpy()), jp)
    assert np.asarray(cert).tolist() == [0, 0]
    want = np.asarray(want)
    got = sk.fused_substep_scenes(frame, sk.pack_rows_scenes(pos_s, vel_s,
                                                             rho),
                                  tp, r, CAP, xs, al).numpy()
    np.testing.assert_allclose(got[..., 0:6], want[..., 0:6], rtol=0,
                               atol=1e-6)
    np.testing.assert_array_equal(got[..., 6:8], want[..., 6:8])


# -------------------------------------------------------- BatchedScenes --

# the sorted tier's passes the stepper calls: over the scene axis, and solo
SCENE_PASSES = {sk: ("density_scenes", "fused_substep_scenes",
                     "forces_scenes"),
                compact: ("density_compact_scenes", "compact_substep_scenes",
                          "forces_compact_scenes")}
SOLO_PASSES = {sk: ("density_pass", "fused_substep", "forces_pass"),
               compact: ("density_compact", "compact_substep",
                         "forces_compact")}


def _count_calls(monkeypatch):
    """Counts the calls of the sorted passes, scene axis and solo."""
    calls = {}
    for passes in (SCENE_PASSES, SOLO_PASSES):
        for module, names in passes.items():
            for name in names:
                real = getattr(module, name)

                def counted(*a, _real=real, _name=name, **k):
                    calls[_name] = calls.get(_name, 0) + 1
                    return _real(*a, **k)

                monkeypatch.setattr(module, name, counted)
    return calls


def _alone(cfgs, frames, **kw):
    """Each scene stepped alone: (final states, last metrics), stacked."""
    outs = []
    for c in cfgs:
        step = make_frame_step(c, device="cpu", **kw)
        st = initial_state(c, "cpu")
        for _ in range(frames):
            st, m = step(st)
        outs.append((st, m))
    return (stack_states([o[0] for o in outs]),
            stack_states([o[1] for o in outs]))


@pytest.mark.parametrize("ext", [False, True])
def test_batched_scenes_take_the_scene_axis(monkeypatch, ext):
    kw = EXT if ext else {}
    cfgs, _, _ = _batch(**kw)
    calls = _count_calls(monkeypatch)
    bs = BatchedScenes(SimConfig(**_GOLDEN, **kw), OVERRIDES, devices="cpu")
    assert bs.host_loop is True
    bs.step(2)
    # 1 K1 + 5 K2 a frame over all scenes, no solo pass
    assert calls == {"density_scenes": 2, "fused_substep_scenes": 10}
    monkeypatch.undo()
    want, m = _alone(cfgs, 2)
    for a, b in zip((*bs.states, *bs.last_metrics), (*want, *m)):
        _same_bits(a, b)


ROUTES = {
    "sorted": ("sorted", True, SortedTuning(), True),
    "pallas": ("pallas", True, SortedTuning(), True),
    "corrected": ("sorted", False, SortedTuning(), True),
    "compact": ("sorted", True, SortedTuning(compact=True), True),
    "unfused": ("sorted", True, SortedTuning(fused=False), True),
    "kahan": ("sorted", True, SortedTuning(kahan=True), True),
    "bf16": ("sorted", True, SortedTuning(bf16=True), True),
    "facc0": ("sorted", True, SortedTuning(fuse_acc=False), True),
    "slotted": ("slotted", True, SortedTuning(), False),
    "gather": ("gather", True, SortedTuning(), False),
    "brute": ("brute", True, SortedTuning(), False),
    "sites": ("sites", True, SortedTuning(), False),
}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_scene_axis_routes(route):
    # every mode, route and variant of the sorted tier takes the scene
    # axis; the tiers without kernels step scene by scene
    neighbor, faithful, tune, axis = ROUTES[route]
    assert stepper.scene_axis(neighbor) is axis
    step = make_batched_step(SimConfig(**_GOLDEN), neighbor=neighbor,
                             faithful=faithful, tune=tune)
    assert (step.__qualname__.startswith("make_scenes_step")) is axis


# the sorted tier's other modes, routes and variants (the name dates from
# when they stepped scene by scene): (options, extension coefficients,
# scene-axis calls a frame); each scene bit-equal to its scene alone, and
# no solo pass (the default route: test_batched_scenes_take_the_scene_axis)
COMPACT = SortedTuning(compact=True)
SCENE_BY_SCENE = {
    "corrected": (dict(faithful=False), EXT,
                  dict(density_scenes=6, forces_scenes=5)),
    "compact": (dict(tune=COMPACT), EXT,
                dict(density_compact_scenes=1, compact_substep_scenes=5)),
    "kahan": (dict(tune=SortedTuning(kahan=True)), EXT,
              dict(density_scenes=1, fused_substep_scenes=5)),
    "unfused": (dict(tune=SortedTuning(fused=False)), {},
                dict(density_scenes=1, forces_scenes=5)),
    "bf16": (dict(tune=SortedTuning(bf16=True)), EXT,
             dict(density_scenes=1, fused_substep_scenes=5)),
    "facc0": (dict(tune=SortedTuning(fuse_acc=False)), {},
              dict(density_scenes=1, fused_substep_scenes=5)),
    "compact-corrected": (dict(faithful=False, tune=COMPACT), {},
                          dict(density_compact_scenes=6,
                               forces_compact_scenes=5)),
    "compact-corrected-ext": (dict(faithful=False, tune=COMPACT), EXT,
                              dict(density_compact_scenes=6,
                                   forces_scenes=5)),
    "compact-unfused": (dict(tune=SortedTuning(compact=True, fused=False)),
                        {}, dict(density_compact_scenes=1,
                                 forces_compact_scenes=5)),
}


@pytest.mark.parametrize("route", sorted(SCENE_BY_SCENE))
def test_other_routes_step_scene_by_scene(monkeypatch, route):
    kw, ext, per_frame = SCENE_BY_SCENE[route]
    cfgs, _, _ = _batch(**ext)
    calls = _count_calls(monkeypatch)
    bs = BatchedScenes(SimConfig(**_GOLDEN, **ext), OVERRIDES,
                       devices="cpu", **kw)
    bs.step(2)
    assert calls == {k: 2 * v for k, v in per_frame.items()}
    monkeypatch.undo()
    want, m = _alone(cfgs, 2, **kw)
    for a, b in zip((*bs.states, *bs.last_metrics), (*want, *m)):
        _same_bits(a, b)


# the batched steps BatchedScenes records on the card, each on the scene
# axis: the default route, the corrected mode, the compact route (faithful
# and corrected), the unfused route and a variant
BODIES = {"scene-axis": ({}, {}), "scene-axis-ext": ({}, EXT),
          "corrected": (dict(faithful=False), EXT),
          "compact": (dict(tune=COMPACT), {}),
          "compact-corrected": (dict(faithful=False, tune=COMPACT), {}),
          "unfused": (dict(tune=SortedTuning(fused=False)), EXT),
          "bf16": (dict(tune=SortedTuning(bf16=True)), EXT)}


@pytest.mark.parametrize("case", sorted(BODIES))
def test_batched_frame_body_is_bit_equal_to_the_host_loop(case):
    kw, ext = BODIES[case]
    base = SimConfig(**_GOLDEN, **ext)
    bs = BatchedScenes(base, OVERRIDES, devices="cpu", host_loop=True, **kw)
    _, params = bs.blocks[0]
    carry = SceneCarry(bs.states, StepMetrics(*(
        torch.full((3,), -1, dtype=t) for t in graph.METRIC_DTYPES))).clone()
    advance = scene_frame_body(make_batched_step(base, **kw), params)
    for _ in range(2):
        advance(carry)
    bs.step(2)
    for a, b in zip((*carry.states, *carry.metrics),
                    (*bs.states, *bs.last_metrics)):
        _same_bits(a, b)


def test_host_loop_choice_on_the_cpu():
    base = SimConfig(**_GOLDEN)
    assert BatchedScenes(base, OVERRIDES[:2], devices="cpu").host_loop
    assert BatchedScenes(base, OVERRIDES[:2], devices="cpu",
                         host_loop=True).host_loop
    with pytest.raises(RuntimeError, match="card"):
        BatchedScenes(base, OVERRIDES[:2], devices="cpu", host_loop=False)
    with pytest.raises(NotImplementedError, match="A16"):
        BatchedScenes(base, OVERRIDES[:2], neighbor="slotted",
                      devices="cpu", host_loop=False)
