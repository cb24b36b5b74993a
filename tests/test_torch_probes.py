"""The probes (``sphfluidsimulation_torch/probes``) on the CPU, against the
JAX probe scripts.

Each script is loaded from its path with importlib, and its grid made
smaller on the loaded module: ``GROUPS = 2`` for loopstruct and scalar
(32 tiles), ``N_PART = 2048`` for mxu. The same numpy inputs, from the
scripts' own generators, go to the script's ``build_call`` (Pallas in
interpret mode, as the scripts run on a CPU) and to the port's plain
version. Tolerances:

- loopstruct A, C, D, E and mxu D, A, M, D128, A128, M128 and G: scale-rel
  (max |port - JAX| / max |JAX|, the scripts' measure) within 1e-5. The
  Gram r² of G and M cancels at near-coincident pairs (the mxu script's
  docstring), and XLA's CPU code fuses the norms' multiply-adds in its own
  way, so the plain Gram dot is taken in JAX's order (a chain of fused
  multiply-adds) and the rows where G and M still differ are named below
  (GRAM_ROWS): there JAX's output is held to the plain version by the
  Gram-conditioning rule the kernels are held to (``mxu.mxu_hold``);
- the mxu rule at 1×TF32 (``mxu.mxu_rule``) holds a plain version whose
  float32 coefficients sit at their rounding bound, and fails the card's
  planted controls, computed through the plain version;
- loopstruct B: scale-rel within 1e-6 (JAX sums the 128 lanes as a tree at
  the end, the port in its own order);
- scalar S0-S3: within 1 ulp.

``intops`` and ``intcell_fix`` call ``pallas_call`` without ``interpret``,
which JAX refuses on a CPU: their plain stages are held exactly to the
scripts' numpy truth, copied here. ``v7prims``: the plain version must
equal the script's np.roll expectations and its ``kernel`` run through a
``pallas_call`` with the specs ``main()`` builds and ``interpret=True``
(``main()`` itself arms ``signal.alarm(420)``, which would kill the test
worker minutes later). An interpret call of the loopstruct or mxu kernel
takes 10-15 s here, so tier-1 runs loopstruct A (on the script's inputs and
with the gate open) and B, mxu D and A, and scalar S0 and S3; the other
variants are marked slow.

The CUDA kernels are held to these plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py phase 11).
"""

import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from sphfluidsimulation_torch import probes
from sphfluidsimulation_torch.bench import scaled_config
from sphfluidsimulation_torch.config import SimConfig
from sphfluidsimulation_torch.ops import sph_kernels as sk
from sphfluidsimulation_torch.probes import (common, compact, intops, live,
                                             loopstruct, mxu, scalar,
                                             v7prims)
from sphfluidsimulation_torch.probes.__main__ import main as probes_main
from sphfluidsimulation_torch.sim.stepper import initial_state, make_rollout

# one intra-op thread, as in the port's other test modules
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
GROUPS = 2
N_PART = 2048
FULL_TOL = 1e-5
MIN_TOL = 1e-6
# (tile, row) where the plain Gram form and JAX's differ by more than
# scale-rel 1e-5, at N_PART = 2048: rows with a member pair whose Gram r²
# cancels (G and M share them; M128 has its own)
GRAM_ROWS = {
    64: {(1, 2), (2, 19), (5, 16), (6, 46), (6, 61), (9, 6), (10, 32),
         (13, 51), (16, 36), (16, 37), (17, 10), (18, 10), (19, 14),
         (19, 46), (20, 8), (20, 11), (21, 12), (22, 44), (23, 6),
         (24, 41), (27, 11), (27, 20), (28, 26), (29, 16)},
    128: {(0, 68), (0, 88), (0, 96), (1, 59), (1, 80), (1, 120), (2, 18),
          (4, 45), (4, 63), (4, 82), (5, 71), (5, 96), (7, 22), (7, 46),
          (9, 85), (9, 110), (10, 10), (10, 29), (13, 6), (14, 73),
          (14, 102), (14, 105), (15, 17), (15, 20), (15, 71)},
}


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"_{name}", ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def ls_script():
    mod = _load("probe_loopstruct_tpu")
    mod.GROUPS = GROUPS            # 32 tiles instead of 4,096
    return mod


@pytest.fixture(scope="module")
def mx_script():
    mod = _load("probe_mxu_tpu")
    mod.N_PART = N_PART            # 2,048 rows instead of 262,144
    return mod


@pytest.fixture(scope="module")
def sc_script():
    mod = _load("probe_scalar_tpu")
    mod.GROUPS = GROUPS
    return mod


def _slow_but(keep, values):
    return [pytest.param(v, marks=() if v in keep else pytest.mark.slow)
            for v in values]


# -------------------------------------------------------------- live --

def test_live_plain_is_x_plus_c():
    x = torch.ones(live.SHAPE)
    c = torch.tensor([live.clock_constant()])
    out = live.live(x, c)
    assert float(out.double().sum()) == (1.0 + float(c)) * x.numel()
    assert torch.equal(out, live.live_plain(x, c))


def test_probe_device_answers_false_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    ok, why = live.probe_device(120.0)
    assert not ok and why.startswith("rc=3"), why


def test_probe_cli_raises_without_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="--device cpu"):
        probes_main(["live"])
    assert probes_main(["live", "--device", "cpu"]) == 0


# ------------------------------------------------------------ intops --

def _intops_truths():
    """The scripts' inputs and numpy truths, as they compute them
    (scripts/probe_intops_tpu.py, scripts/probe_intcell_fix_tpu.py)."""
    out = {}
    rng = np.random.RandomState(0)
    enc_i = rng.randint(-(1 << 28), 1 << 28, (8, 128)).astype(np.int32)
    out["bitcast_shift_mask_8x128"] = (
        enc_i.view(np.float32), None,
        ((enc_i >> 10) & 1023).astype(np.float32))
    xs = (rng.uniform(-3, 3, (8, 128)) * 10).astype(np.float32)
    out["trunc_convert_8x128"] = (xs, None,
                                  xs.astype(np.int32).astype(np.float32))
    rc = rng.randint(-2, 259, (64, 3)).astype(np.float32)
    out["rowkey_shifts_64x1"] = (rc, None, np.broadcast_to(
        (rc[:, 0:1].astype(np.int32) + (rc[:, 1:2].astype(np.int32) << 10)
         + (rc[:, 2:3].astype(np.int32) << 20)).astype(np.float32),
        (64, 128)).copy())
    bias = 1 + (1 << 10) + (1 << 20)
    r = 19
    cell = rng.randint(0, r, (128, 3)).astype(np.int32)
    enc = (cell[:, 0] + (cell[:, 1] << 10) + (cell[:, 2] << 20))
    enc[rng.rand(128) < 0.2] = -1
    rcell = rng.randint(-2, r + 2, (64, 3)).astype(np.int32)
    rkey = (bias - (rcell[:, 0] + (rcell[:, 1] << 10)
                    + (rcell[:, 2] << 20))).astype(np.int32)
    tv = (enc[None, :].astype(np.int64)
          + rkey[:, None].astype(np.int64)).astype(np.int32)
    t4 = ((enc[None, :] >= 0) & ((tv & 1023) <= 2)
          & (((tv >> 10) & 1023) <= 2)
          & (((tv >> 20) & 1023) <= 2)).astype(np.float32)
    out["membership_bcast_64x128"] = (enc.astype(np.int32).view(np.float32),
                                      rkey.view(np.float32), t4)

    rng = np.random.RandomState(0)
    rc = rng.randint(-2, 259, (64, 3)).astype(np.float32)
    icol = rc.astype(np.int32)
    ta = np.broadcast_to(icol[:, 0:1].astype(np.float32), (64, 128)).copy()
    tb = np.broadcast_to((icol[:, 1:2] << 10).astype(np.float32),
                         (64, 128)).copy()
    tkey = (icol[:, 0:1].astype(np.int64)
            + (icol[:, 1:2].astype(np.int64) << 10)
            + (icol[:, 2:3].astype(np.int64) << 20)).astype(np.int32)
    td = np.broadcast_to(tkey.astype(np.float32), (64, 128)).copy()
    out["a_convert_64x1"] = (rc, None, ta)
    out["b_shift_64x1"] = (rc, None, tb)
    out["c_mul_64x1"] = (rc, None, tb)
    out["d_bcast_then_shift"] = (rc, None, td)
    out["e_rowkey_mul_64x1"] = (rc, None, td)
    cell = rng.randint(0, r, (128, 3)).astype(np.int32)
    enc = (cell[:, 0] + (cell[:, 1] << 10) + (cell[:, 2] << 20))
    enc[rng.rand(128) < 0.2] = -1
    rcell = rng.randint(-2, r + 2, (64, 3)).astype(np.float32)
    ri = rcell.astype(np.int32)
    rkey = (bias - (ri[:, 0:1] + (ri[:, 1:2] << 10)
                    + (ri[:, 2:3] << 20))).astype(np.int32)
    tv = (enc[None, :].astype(np.int64)
          + rkey.astype(np.int64)).astype(np.int32)
    tf = ((enc[None, :] >= 0) & ((tv & 1023) <= 2)
          & (((tv >> 10) & 1023) <= 2)
          & (((tv >> 20) & 1023) <= 2)).astype(np.float32)
    out["f_membership_mulkey"] = (enc.astype(np.int32).view(np.float32),
                                  rcell, tf)
    return out


@pytest.mark.parametrize("stage", intops.stages(), ids=lambda s: s.label)
def test_intops_plain_stage_equals_the_scripts_truth(stage):
    a, b, truth = _intops_truths()[stage.label]
    np.testing.assert_array_equal(stage.a, a)
    if b is not None:
        np.testing.assert_array_equal(stage.b, b)
    np.testing.assert_array_equal(stage.truth, truth)
    got = intops.stage_run(stage, torch.from_numpy(a),
                           None if b is None else torch.from_numpy(b))
    np.testing.assert_array_equal(got.numpy(), truth)


def test_intops_planted_shift_of_nine_breaks_the_row_key():
    st = [s for s in intops.stages() if s.stage == 3][0]
    got = intops.stage_plain(3, torch.from_numpy(st.a), None, shift=9)
    assert not np.array_equal(got.numpy(), st.truth)
    assert intops.digit_test_matches_per_axis()


# -------------------------------------------------------- loopstruct --

def _ls_inputs(ls_script):
    arrs = ls_script.synth_inputs(np.random.RandomState(0))
    mine = loopstruct.synth_inputs(np.random.RandomState(0), GROUPS)
    for a, b in zip(arrs, mine):
        np.testing.assert_array_equal(np.asarray(a), b)
    return arrs, loopstruct.to_device(mine, CPU)


@pytest.mark.parametrize("variant", _slow_but("AB", "ABCDE"))
def test_loopstruct_plain_matches_jax(ls_script, variant):
    arrs, inp = _ls_inputs(ls_script)
    want = torch.from_numpy(np.asarray(ls_script.build_call(variant)(*arrs)))
    got = loopstruct.synth_plain(variant, inp)
    tol = MIN_TOL if variant == "B" else FULL_TOL
    assert common.scale_rel(want[..., :6], got[..., :6]) <= tol
    assert torch.equal(got[..., 6:], want[..., 6:])


@pytest.mark.parametrize("variant", _slow_but("A", "ACDE"))
def test_loopstruct_plain_matches_jax_with_the_gate_open(ls_script,
                                                         variant):
    _, inp = _ls_inputs(ls_script)
    opened = loopstruct.gate_open(inp)
    want = torch.from_numpy(np.asarray(ls_script.build_call(variant)(
        *(jnp.asarray(x.numpy()) for x in opened))))
    got = loopstruct.synth_plain(variant, opened)
    assert float(want[..., :6].abs().max()) > 0
    assert common.scale_rel(want[..., :6], got[..., :6]) <= FULL_TOL
    assert loopstruct.synth_rule(variant, want, got, opened)
    if variant == "A":
        # chip_smoke.py's planted control: a line dropped must fail
        dropped = loopstruct.synth_plain("A", loopstruct.drop_line(opened))
        assert not loopstruct.synth_rule("A", want, dropped, opened)


def test_loopstruct_b_rule_holds_a_running_sum_and_fails_a_dropped_line():
    inp = loopstruct.to_device(
        loopstruct.synth_inputs(np.random.RandomState(0), 1), CPU)
    want = loopstruct.synth_plain("B", inp)
    # a thread's running sum over the tile's chunks and lanes, in order
    run = torch.zeros(want.shape[:2], dtype=torch.float32)
    for t in range(inp.rows.shape[0]):
        for e in inp.flat[t, :int(inp.fcnt[t])].tolist():
            for x in inp.win[e, 0].tolist():
                run[t] = run[t] + torch.tensor(x, dtype=torch.float32)
    got = torch.zeros_like(want)
    got[..., 0] = run
    assert loopstruct.synth_rule("B", want, got, inp)
    dropped = loopstruct.synth_plain("B", loopstruct.drop_line(inp))
    assert not loopstruct.synth_rule("B", want, dropped, inp)


def _frame_scene(cap):
    cfg = SimConfig(particle_number=1024, bucket_resolution=11,
                    voxel_capacity=cap)
    st = initial_state(cfg, CPU)
    st, _ = make_rollout(cfg, 3, device=CPU)(st)
    return loopstruct.frame_inputs(cfg, st)


def _member(fin, j, i, lx0, span, c):
    if not bool(fin.frame.occ[j]) or j == i:
        return False
    rj = int(fin.frame.raw[j])
    if 0 <= rj - lx0 <= span:
        return True
    r = fin.r
    z, rem = divmod(rj, r * r)
    y, x = divmod(rem, r)
    return abs(x - c[0]) <= 1 and abs(y - c[1]) <= 1 and abs(z - c[2]) <= 1


@pytest.mark.parametrize("cap", [4, 32, None])
def test_range_list_and_step_walks_visit_each_rows_members_in_walk_order(
        cap):
    """D_f's walk of the pre-pass's ranges (2 slots a step) and E_f's (4 a
    step), mirrored line for line, visit each row's members in walk order:
    the order of sph_kernels._candidates, j == i skipped."""
    fin = _frame_scene(cap)
    ranges, count = loopstruct.ranges_plain(fin)
    c = sk.fresh_cell(fin.rows[:, 0:3], fin.r)
    j, member = sk._candidates(fin.frame, c, fin.r,
                               sk._window_width(fin.frame, cap))
    cells = c.tolist()
    for i in range(fin.rows.shape[0]):
        want = [int(v) for v in j[i][member[i]] if int(v) != i]
        for step in (2, 4):
            got = []
            for t in range(int(count[i])):
                q, e, lx0, span = ranges[t, i].tolist()
                assert q < e
                while q < e:
                    got += [s for s in range(q, min(q + step, e))
                            if _member(fin, s, i, lx0, span, cells[i])]
                    q += step
            assert got == want, (i, step)
    assert int(count.max()) <= loopstruct.MAX_RANGES
    if cap == 4:
        assert int(count.max()) > 9      # a line cut into several ranges


def test_walk_sum_plain_and_its_rule():
    fin = _frame_scene(32)
    total, members = loopstruct.walk_sum_plain(fin)
    c = sk.fresh_cell(fin.rows[:, 0:3], fin.r)
    j, member = sk._candidates(fin.frame, c, fin.r, 32)
    member &= j != torch.arange(j.shape[0])[:, None]
    want = torch.where(member, fin.rows[j, 0].double(), 0.0).sum(1)
    assert torch.equal(members, member.sum(1))
    assert loopstruct.walk_sum_rule(total, want.float(), members)
    assert not loopstruct.walk_sum_rule(total * 0.999, want.float(), members)


def test_loopstruct_probe_runs_on_the_cpu():
    # one group of tiles and a 1,024-particle frame, through probes.run (the
    # CLI runs the script's size)
    res = probes.run("loopstruct", CPU, groups=1, cfg=scaled_config(1024),
                     frames=1)
    assert res["ok"] and res["walk_share"] is None


# --------------------------------------------------------------- mxu --

def _mx_inputs(mx_script, rows_n):
    # the script's main() draws the 64-row set first and the 128-row set
    # from a fresh RandomState(0): both start from the seed
    arrs = mx_script.synth_inputs(np.random.RandomState(0), rows_n)
    inp = mxu.script_inputs(CPU, N_PART)[rows_n]
    for a, b in zip(arrs, inp):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    return arrs, inp


@pytest.mark.parametrize("variant", _slow_but("DA", mxu.VARIANTS))
def test_mxu_plain_matches_jax(mx_script, variant):
    rows_n = mxu.rows_of(variant)
    arrs, inp = _mx_inputs(mx_script, rows_n)
    want = torch.from_numpy(np.asarray(
        mx_script.build_call(variant, rows_n)(*arrs)))
    got = mxu.mxu_plain(variant, inp)
    scale = float(want[..., :6].abs().max())
    over = (got[..., :6] - want[..., :6]).abs().amax(-1) > FULL_TOL * scale
    named = GRAM_ROWS.get(rows_n, set()) if variant[0] in "GM" else set()
    assert {tuple(x) for x in over.nonzero().tolist()} == named
    if named:
        # where the Gram r² cancels, JAX's output is within the plain
        # version's Gram-conditioning rule (the kernels' rule)
        hold = mxu.mxu_hold(variant, 3, inp, want)
        assert hold.ok, hold
    assert torch.equal(got[..., 6:], want[..., 6:])


def test_mxu_rule_holds_the_plain_version_and_fails_a_dropped_chunk():
    inp = mxu.script_inputs(CPU, 1024)[64]
    for prec in (1, 3):
        assert mxu.mxu_hold("A", prec, inp, mxu.mxu(
            "A", prec, inp).float()).ok
        dropped = mxu.mxu_plain("A", inp._replace(fcnt=inp.fcnt - 1),
                                prec == 1)
        assert not mxu.mxu_hold("A", prec, inp, dropped).ok


def _coefficients_off_by_their_bound(orig):
    # a kernel's float32 coefficients: each the plain version's moved by
    # its first-order rounding bound, up and down in turn
    def coefficients(r2, rho_j, press_i, gate, dtype):
        pc, vc = orig(r2, rho_j, press_i, gate, dtype)
        if dtype != torch.float32:
            return pc, vc
        e_pc, e_vc = mxu._coefficient_errors(
            r2.double(), rho_j.double(), press_i.double(), pc.double(),
            vc.double())
        sign = 1.0 - 2.0 * (torch.arange(pc.numel()).reshape(pc.shape) % 2)
        return ((pc.double() + sign * e_pc).float(),
                (vc.double() - sign * e_vc).float())
    return coefficients


def _planted(variant, inp, fault):
    """What the kernel's planted control computes, through the plain
    version (1×TF32)."""
    if fault == "first chunk dropped":
        flat = inp.flat.clone()
        flat[:, 0] = -1
        return mxu.mxu_plain(variant, inp._replace(flat=flat), True)
    assert fault == "velocity accumulate negated"
    if mxu.mode_of(variant) in "AM":
        # pc and vc read no velocity and TF32 rounding is odd, so negated
        # candidate velocities negate the product VC Vⱼ alone
        win = inp.win.clone()
        win[:, 4:7] = -win[:, 4:7]
        return mxu.mxu_plain(variant, inp._replace(win=win), True)
    out = mxu.mxu_plain(variant, inp, True)
    out[..., 3:6] = -out[..., 3:6]
    return out


@pytest.mark.parametrize("variant", ["G", "A", "M", "A128", "M128"])
def test_mxu_1x_tf32_rule_holds_rounding_and_fails_the_controls(
        variant, monkeypatch):
    # the rule of each 1×TF32 instance the card holds to planted controls
    inp = mxu.script_inputs(CPU, 1024)[mxu.rows_of(variant)]
    rule = mxu.mxu_rule(variant, 1, inp)
    with monkeypatch.context() as m:
        m.setattr(mxu, "_coefficients",
                  _coefficients_off_by_their_bound(mxu._coefficients))
        kernel = mxu.mxu_plain(variant, inp, True)
    assert mxu.mxu_hold(variant, 1, inp, kernel, rule).ok
    if variant == "A128":
        # here such coefficients round apart from the plain version's: Φ,
        # the TF32 rounding spread, is what holds them
        _, sc = mxu.mxu_plain(variant, inp, True, torch.float64, True)
        err = (kernel[..., :6].double() - rule.p64).abs()
        assert (err > rule.tol - sc.phi).any()
    assert set(mxu.CONTROLS[(variant, 1)]) == {
        "first chunk dropped", "velocity accumulate negated"} | (
        {"ones column zeroed"} if variant == "A" else set())
    for fault in ("first chunk dropped", "velocity accumulate negated"):
        hold = mxu.mxu_hold(variant, 1, inp, _planted(variant, inp, fault),
                            rule)
        assert hold.n_over > 0, fault


def test_tf32_spread_bounds_two_roundings():
    g = torch.Generator().manual_seed(0)
    c = torch.rand(4096, generator=g, dtype=torch.float64) * 10 ** (
        torch.randint(-8, 9, (4096,), generator=g).double())
    w = c * 2.0 ** -torch.randint(5, 30, (4096,), generator=g).double()
    spread = mxu.tf32_spread(c, w)
    for _ in range(4):
        y1, y2 = ((c + (2 * torch.rand(4096, generator=g,
                                       dtype=torch.float64) - 1) * w)
                  .float() for _ in range(2))
        apart = (mxu.tf32_round(y1).double()
                 - mxu.tf32_round(y2).double()).abs()
        assert (apart <= spread).all()
    # 1 + 3·2⁻¹³ lies 2⁻¹³ below the midpoint 1 + 2⁻¹¹ of 1 and 1 + 2⁻¹⁰:
    # a window that misses it leaves both roundings alike, one that holds
    # it lets them part by a TF32 step
    c = torch.tensor([1.0 + 3 * 2 ** -13], dtype=torch.float64)
    assert mxu.tf32_spread(c, torch.full_like(c, 2 ** -14)).item() == 0.0
    assert mxu.tf32_spread(c, torch.full_like(c, 2 ** -12)).item() \
        == 2 ** -10


def test_tf32_round_is_cvt_rna():
    # TF32 keeps 10 mantissa bits: an ulp at 1 is 2⁻¹⁰, the tie 2⁻¹¹
    x = torch.tensor([1.0 + 2 ** -11, 1.0 + 2 ** -12, 1.0 + 3 * 2 ** -12,
                      -1.0 - 2 ** -11, -1.0 - 2 ** -12, float("inf"),
                      float("nan")], dtype=torch.float32)
    got = mxu.tf32_round(x)
    assert got[:5].tolist() == [1.0 + 2 ** -10, 1.0, 1.0 + 2 ** -10,
                                -1.0 - 2 ** -10, -1.0]   # ties away from 0
    assert got[5] == float("inf") and torch.isnan(got[6])
    assert not (got[:5].view(torch.int32) & 0x1FFF).any()


# ----------------------------------------------------------- v7prims --

def test_v7prims_plain_equals_the_script_kernel_and_np_roll():
    mod = _load("probe_v7_prims")
    fn = pl.pallas_call(
        mod.kernel,
        in_specs=[pl.BlockSpec(memory_space=pltpu.SMEM),
                  pl.BlockSpec(memory_space=pltpu.VMEM),
                  pl.BlockSpec(memory_space=pl.ANY)],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((16, 128), jnp.float32),
        scratch_shapes=[pltpu.SMEM((mod.S_SLICE,), jnp.int32),
                        pltpu.SemaphoreType.DMA],
        interpret=True)
    x = v7prims.x_input()
    off = np.array([v7prims.OFF], np.int32)
    for name, table in v7prims.tables().items():
        want = np.asarray(jax.jit(fn)(jnp.asarray(off), jnp.asarray(x),
                                      jnp.asarray(table)))
        got = v7prims.prims(torch.from_numpy(off), torch.from_numpy(x),
                            torch.from_numpy(table)).numpy()
        np.testing.assert_array_equal(got, want)
        if name == "B":
            np.testing.assert_array_equal(got, v7prims.expected_b(x))


# ------------------------------------------------------------ scalar --

@pytest.mark.parametrize("variant", _slow_but((0, 3), scalar.VARIANTS))
def test_scalar_plain_matches_jax_within_an_ulp(sc_script, variant):
    # the script's main() draws the slice, the spans and x in this order
    rng = np.random.RandomState(0)
    slc = np.sort(rng.randint(0, 1 << 14, sc_script.S_SLICE)).astype(
        np.int32)
    spans = rng.randint(0, sc_script.S_SLICE - 100,
                        (GROUPS * sc_script.TPG, 2)).astype(np.int32)
    spans[:, 1] = spans[:, 0] + 3
    x = rng.rand(GROUPS * sc_script.TPG, 8, sc_script.LANES).astype(
        np.float32)
    for a, b in zip((slc, spans, x), scalar.synth_inputs(GROUPS)):
        np.testing.assert_array_equal(a, b)
    want = torch.from_numpy(np.asarray(sc_script.build(variant)(
        jnp.asarray(slc), jnp.asarray(spans), jnp.asarray(x))))
    got = scalar.scalar(variant, torch.from_numpy(slc),
                        torch.from_numpy(spans), torch.from_numpy(x))
    assert scalar.ulps(want, got) <= 1


# ----------------------------------------------------------- compact --

def test_compact_probe_runs_on_the_cpu_at_1024_particles():
    res = compact.run(CPU, n_check=1024, bench_particles=1024, frames=2)
    assert res["ok"] and res["explained"]
    assert res["check"]["cert_window"] == 0
    # the spawn's certified rows are where the routes may part; at
    # N_AGREE particles there are none and the routes agree
    assert res["check"]["rows_differing"] <= res["check"]["cert_compact"]
    assert res["agree"]["cert_compact"] == 0
    assert res["agree"]["rows_differing"] == 0
    assert res["check"]["dpos"] == res["check"]["dpos"]
    assert set(res["bench"]) == {"compact_262k", "compact_1m",
                                 "v6bf16_262k"}
    assert all(b["value"] is None for b in res["bench"].values())


def test_small_probes_run_on_the_cpu():
    for name in ("intops", "v7prims"):
        assert probes_main([name, "--device", "cpu"]) == 0
    assert probes.run("scalar", CPU, groups=1)["ok"]
