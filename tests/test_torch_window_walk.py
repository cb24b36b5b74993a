"""The window walk of K1, K2 and K3 (``csrc/window_walk.cuh``) on the CPU.

- ``sph_kernels.pj_cols``, the j-side columns the kernels read, must equal
  ``pallas_sph._pj_cols`` bit for bit.
- A line-for-line Python mirror of the kernels' range walk must visit, for
  every row, exactly that row's member set from ``sph_kernels._candidates``
  in walk order, j == i skipped (K2, K3) or kept (K1): the kernels sum the
  same terms in the same order as the plain versions; on a slab's banded
  frame too, where dead rows walk nothing.
- The kernels' division-free pair terms, evaluated in float32 over the
  plain candidates, must pass the per-particle rule of
  ``sph_kernels.forces_accuracy``.
- The stepper builds ``pj`` once a frame in faithful mode, once a substep
  in corrected mode, on either route.

The kernels themselves are held to the plain versions on the card
(tests/test_torch_cuda.py).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from sphfluidsimulation_tpu.config import SimConfig as JConfig
from sphfluidsimulation_tpu.ops import pallas_sph
from sphfluidsimulation_tpu.params import PhysParams as JPhys
from sphfluidsimulation_torch.config import EPSILON, SimConfig
from sphfluidsimulation_torch.ops import sph_kernels as sk
from sphfluidsimulation_torch.ops import sph_math
from sphfluidsimulation_torch.ops.frame import build_frame
from sphfluidsimulation_torch.params import PhysParams
from sphfluidsimulation_torch.sim.stepper import (initial_state,
                                                  make_rollout)

# one intra-op thread, as in the port's other test modules
torch.set_num_threads(1)

# tests/test_pallas.py:18-21
_CALM = dict(particle_number=1024, bucket_resolution=11, preset=0,
             gas_constant=20.0, rest_density=1.7, viscosity=0.05,
             stiffness_coefficient=1000.0, frame_dt=1 / 240)
_GOLDENISH = dict(particle_number=1024, bucket_resolution=11)
CONFIGS = {"calm": _CALM, "goldenish": _GOLDENISH}
CAP = 32
XSPH, ALPHA = 0.3, 0.5          # BASELINE config 3


def _bits(a):
    return np.asarray(a, dtype=np.float32).view(np.uint32)


def _check_pj(rho_np, cfg_kw):
    jp = JPhys.from_config(JConfig(**cfg_kw))
    tp = PhysParams.from_config(SimConfig(**cfg_kw))
    press, inv = pallas_sph._pj_cols(jnp.asarray(rho_np), jp)
    got = sk.pj_cols(torch.from_numpy(rho_np), tp).numpy()
    np.testing.assert_array_equal(_bits(got[:, 0]), _bits(press))
    np.testing.assert_array_equal(_bits(got[:, 1]), _bits(inv))


def _state(name, frames):
    """(cfg, state) of a test scene after ``frames`` faithful frames."""
    cfg = SimConfig(**CONFIGS[name])
    st = initial_state(cfg, "cpu")
    if frames:
        st, _ = make_rollout(cfg, frames, device="cpu")(st)
    return cfg, st


@pytest.mark.parametrize("frames", [0, 3])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_pj_cols_matches_jax_bit_for_bit(name, frames):
    cfg, st = _state(name, frames)
    r = cfg.bucket_resolution
    tf, (ps,) = build_frame(st.pos, r, CAP, extras=(st.pos,))
    rho = sk.density_plain(tf, ps, PhysParams.from_config(cfg), r, CAP)
    assert bool((rho > 1e-6).any())
    _check_pj(rho.numpy(), CONFIGS[name])


def test_pj_cols_matches_jax_on_special_densities():
    eps = np.float32(1e-6)
    rho = np.array([0.0, eps, np.nextafter(eps, np.float32(1)), -1.0, np.inf,
                    -np.inf, np.nan, 1e-30, 1.7, 1e30], dtype=np.float32)
    for kw in CONFIGS.values():
        _check_pj(rho, kw)
    inv = sk.pj_cols(torch.from_numpy(rho),
                     PhysParams.from_config(SimConfig(**_CALM)))[:, 1]
    # the guard: rho <= eps (and NaN) give 0, never a reciprocal
    assert inv[[0, 1, 3, 5, 6]].tolist() == [0.0] * 5
    assert inv[2] > 0 and inv[4] == 0.0


# ------------------------------------------------------------ range walk --

def _raw_near(raw, cx, cy, cz, r):
    z = raw // (r * r)
    y = (raw - z * r * r) // r
    x = raw - z * r * r - y * r
    return abs(x - cx) <= 1 and abs(y - cy) <= 1 and abs(z - cz) <= 1


def _range_walk(start, raw, occ, c, i, r, cap, skip_self=True, step=2,
                band=None):
    """range_walk of csrc/window_walk.cuh, line for line, ``step`` slots a
    step: the slots row i sums, in order (``skip_self``: K2's and K3's walk,
    two slots a step; K1's keeps j == i, one slot a step), over the frame's
    ``band`` of z-planes (None: the whole grid, (0, r)); a dead row (past
    ``start[-1]``, walk_row's and K1's dead_row) walks nothing."""
    zbase, z_span = (0, r) if band is None else band
    if i >= start[z_span * r * r]:
        return []
    cx, cy, cz = c
    x0, x1 = max(cx - 1, 0), min(cx + 1, r - 1)
    y0, y1 = max(cy - 1, 0), min(cy + 1, r - 1)
    z0 = max(cz - 1, 0, zbase)
    z1 = min(cz + 1, r - 1, zbase + z_span - 1)
    out = []
    for z in range(z0, z1 + 1):
        for y in range(y0, y1 + 1):
            line = (z * r + y) * r                   # global: the raw gate
            sl = ((z - zbase) * r + y) * r           # local: start[]

            def member(j):
                if not occ[j] or (skip_self and j == i):
                    return False
                return (0 <= raw[j] - line - x0 <= x1 - x0
                        or _raw_near(raw[j], cx, cy, cz, r))

            end = start[sl + x0]
            x = x0
            while x <= x1:
                q = end
                end = start[sl + x + 1]
                e = min(end, q + cap) if cap >= 0 else end
                while e == end and x < x1:
                    x += 1
                    end = start[sl + x + 1]
                    e = min(end, e + cap) if cap >= 0 else end
                while q < e:
                    q2 = min(q + step - 1, e - 1)
                    out += [j for j in ((q, q2) if q2 > q else (q,))
                            if member(j)]
                    q += step
                x += 1
    return out


def _walk_scene(name, cap=CAP):
    """(frame, sorted positions, R) of a range-walk scene, its frame built
    with capacity ``cap``."""
    if name == "random":
        rng = np.random.default_rng(4)
        pos = torch.from_numpy(rng.random((3000, 3), dtype=np.float32))
        r = 13
    else:
        base, frames = name.split("@")
        cfg, st = _state(base, int(frames))
        pos, r = st.pos, cfg.bucket_resolution
    tf, (ps,) = build_frame(pos, r, cap, extras=(pos,))
    if name == "calm@0":
        # rows moved 1.5 cells up in z: they leave their frame-start cell
        ps = ps.clone()
        ps[100:150, 2] = (ps[100:150, 2] + 1.5 / (r - 1)).clamp(max=1.0)
    return tf, ps, r


# the canonical spawn (out-of-cube spawns alias to raw cells far from their
# anchor), the same three frames on, the calm scene with drifted rows, a
# random scene; with the capacity cut and without
@pytest.mark.parametrize("cap", [CAP, None])
@pytest.mark.parametrize("name", ["goldenish@0", "goldenish@3", "calm@0",
                                  "random"])
def test_range_walk_visits_each_rows_members_in_walk_order(name, cap):
    tf, ps, r = _walk_scene(name)
    c = sk.fresh_cell(ps, r)
    j, member = sk._candidates(tf, c, r, sk._window_width(tf, cap))
    start, raw = tf.start.tolist(), tf.raw.tolist()
    occ, cells = tf.occ.tolist(), c.tolist()
    pairs = 0
    for i in range(ps.shape[0]):
        want = [int(v) for v in j[i][member[i]] if int(v) != i]
        got = _range_walk(start, raw, occ, cells[i], i, r,
                          -1 if cap is None else cap)
        assert got == want, i
        pairs += len(got)
    assert pairs > 0


# K1's walk: the self pair kept; the frame built with the walk's capacity
@pytest.mark.parametrize("cap", [4, CAP, None])
@pytest.mark.parametrize("name", ["goldenish@0", "goldenish@3", "calm@0",
                                  "random"])
def test_range_walk_with_self_visits_each_rows_density_members(name, cap):
    tf, ps, r = _walk_scene(name, cap)
    c = sk.fresh_cell(ps, r)
    j, member = sk._candidates(tf, c, r, sk._window_width(tf, cap))
    start, raw = tf.start.tolist(), tf.raw.tolist()
    occ, cells = tf.occ.tolist(), c.tolist()
    pairs = own = 0
    for i in range(ps.shape[0]):
        want = [int(v) for v in j[i][member[i]]]
        got = _range_walk(start, raw, occ, cells[i], i, r,
                          -1 if cap is None else cap, skip_self=False,
                          step=1)
        assert got == want, i
        pairs += len(got)
        own += got.count(i)
    # the self pair is visited, and is not all the walk visits
    assert 0 < own < pairs


# K1's and K2's banded walk: a slab's frame over its band of z-planes, with
# dead rows past the live ones (ops/frame.py), rows moved 1.5 cells in z so
# that some windows leave the band; each live row visits exactly its banded
# members (sph_kernels._candidates with the band), a dead row nothing
@pytest.mark.parametrize("cap", [4, CAP, None])
@pytest.mark.parametrize("band", [(-2, 7), (3, 5), (7, 7)])
def test_banded_range_walk_visits_each_rows_band_members(band, cap):
    cfg, st = _state("goldenish", 3)
    r = cfg.bucket_resolution
    rng = np.random.default_rng(8)
    valid = torch.from_numpy(rng.random(st.pos.shape[0]) < 0.8)
    az = sph_math.cell_index(st.pos[:, 2], r).clamp(0, r - 1)
    valid &= (az >= band[0]) & (az < band[0] + band[1])
    tf, (ps,) = build_frame(st.pos, r, cap, extras=(st.pos,),
                            gid=torch.arange(st.pos.shape[0],
                                             dtype=torch.int32),
                            band=band, valid=valid)
    ps = ps.clone()
    ps[::7, 2] = (ps[::7, 2] + 1.5 / (r - 1)).clamp(max=1.0)
    c = sk.fresh_cell(ps, r)
    n_live = int(tf.start[-1])
    assert 0 < n_live < ps.shape[0]
    j, member = sk._candidates(tf, c[:n_live], r, sk._window_width(tf, cap),
                               band)
    start, raw = tf.start.tolist(), tf.raw.tolist()
    occ, cells = tf.occ.tolist(), c.tolist()
    capw = -1 if cap is None else cap
    pairs = 0
    for i in range(ps.shape[0]):
        for skip_self, step in ((True, 2), (False, 1)):
            got = _range_walk(start, raw, occ, cells[i], i, r, capw,
                              skip_self, step, band)
            want = ([int(v) for v in j[i][member[i]]
                     if not skip_self or int(v) != i]
                    if i < n_live else [])
            assert got == want, (i, skip_self)
            pairs += len(got)
    assert pairs > 0


# ------------------------------------------------------------ pair terms --

def _pj_sums(frame, rows, phys, r, capacity, ext, magnitude=False):
    """add_pair_pj of csrc/window_walk.cuh over the plain candidates, in
    float32: press_j and the guarded 1/ρⱼ from pj_cols, 1/|r| from a
    reciprocal square root, one reciprocal of ρᵢ + ρⱼ and one of
    r² + 0.01h² for the extensions; f[N, 12] like forces_plain."""
    assert not magnitude
    n = rows.shape[0]
    ids = torch.arange(n)
    j, member = sk._candidates(frame, sk.fresh_cell(rows[:, 0:3], r), r,
                               sk._window_width(frame, capacity))
    pj = sk.pj_cols(rows[:, 6], phys)
    sc = sk.scal_block(phys)
    h, h2, c9, cg, k, rho0 = sc[0], sc[1], sc[2], sc[3], sc[5], sc[6]
    cs = sc[14]
    use = member & (j != ids[:, None])
    rho_i, rho_j = rows[:, 6, None], rows[j, 6]
    pv = use & (rho_j > EPSILON)
    d = rows[:, None, 0:3] - rows[j, 0:3]
    r2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]
    abs_r = torch.sqrt(r2)
    diff = h - abs_r
    ok = (diff > EPSILON) & (abs_r > EPSILON)
    g = torch.where(ok, cg * (diff * diff * diff)
                    * torch.rsqrt(r2.clamp(min=1e-30)), 0.0)
    dv = rows[j, 3:6] - rows[:, None, 3:6]
    gwv = torch.where(abs_r < h, cg * diff, 0.0)
    press_i = k * (rho_i - rho0)
    pc = (press_i + pj[j, 0]) * 0.5 * pj[j, 1]
    vc = gwv * pj[j, 1]
    terms = [torch.where(pv[..., None], pc[..., None] * (g[..., None] * d),
                         0.0),
             torch.where(pv[..., None], vc[..., None] * dv, 0.0)]
    if ext:
        d2 = h2 - r2
        w6 = torch.where(d2 > 0, c9 * d2 * d2 * d2, 0.0)
        denom = rho_i + rho_j
        two_over = 2.0 * (1.0 / denom)
        xc = torch.where(denom > EPSILON, two_over * w6, 0.0)
        terms.append(torch.where(use[..., None], xc[..., None] * dv, 0.0))
        vr = -(dv[..., 0] * d[..., 0]) - dv[..., 1] * d[..., 1] \
            - dv[..., 2] * d[..., 2]
        mu = h * vr * (1.0 / (r2 + 0.01 * h2))
        pi_ok = (vr < 0) & (0.5 * denom > EPSILON)
        ac = torch.where(pi_ok, -cs * mu * two_over, 0.0) * g
        terms.append(torch.where(use[..., None], ac[..., None] * d, 0.0))
    else:
        terms.append(rows.new_zeros((n, j.shape[1], 6)))
    return sk._tree_sum(torch.cat(terms, -1))


@pytest.mark.parametrize("ext", [False, True])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_division_free_pair_terms_pass_the_forces_rule(name, ext):
    cfg, st = _state(name, 2)
    r = cfg.bucket_resolution
    tp = PhysParams.from_config(cfg)
    tf, (ps, vs) = build_frame(st.pos, r, CAP, extras=(st.pos, st.vel))
    rows = sk.pack_rows(ps, vs, sk.density_plain(tf, ps, tp, r, CAP))
    xs, al = (XSPH, ALPHA) if ext else (0.0, 0.0)
    sums = _pj_sums(tf, rows, tp, r, CAP, ext)
    # the sums of the two-accumulator pair (K3's facc0 instance)
    f, dv = sk.fold_forces(sums, rows[:, 6], tp, xs, al, fuse_acc=False)
    acc = sk.forces_accuracy(tf, rows, f, dv, tp, r, CAP, xs, al)
    assert acc.ok, acc
    # the planted control: the pressure sums dropped fail the rule
    sums0 = sums.clone()
    sums0[:, 0:3] = 0.0
    f0, dv0 = sk.fold_forces(sums0, rows[:, 6], tp, xs, al, fuse_acc=False)
    assert not sk.forces_accuracy(tf, rows, f0, dv0, tp, r, CAP, xs, al).ok


# --------------------------------------------------------------- stepper --

@pytest.mark.parametrize("mode", ["faithful", "corrected", "compact",
                                  "compact corrected"])
def test_stepper_builds_pj_once_a_frame_or_substep(monkeypatch, mode):
    cfg = SimConfig(**_CALM)
    calls = []
    real = sk.pj_cols
    monkeypatch.setattr(sk, "pj_cols",
                        lambda rho, phys: calls.append(1) or real(rho, phys))
    tune = sk.SortedTuning(compact=mode.startswith("compact"))
    frames = 2
    make_rollout(cfg, frames, faithful=not mode.endswith("corrected"),
                 tune=tune, device="cpu")(initial_state(cfg, "cpu"))
    want = {"faithful": frames, "corrected": frames * cfg.substeps,
            "compact": frames,
            "compact corrected": frames * cfg.substeps}[mode]
    assert len(calls) == want
