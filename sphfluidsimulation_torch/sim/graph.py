"""The sorted tier's rollout as one recorded device program, replayed.

Counterpart of the JAX package's scanned rollouts: ``_make_pallas_rollout``
(``sphfluidsimulation_tpu/sim/stepper.py:405-516``, a ``lax.scan`` over
frames around a scan over substeps) and the scan of ``make_dt_rollout``
(:550-563), each compiled into one device dispatch a rollout. The port's
counterpart of a compiled scan is a CUDA graph:

- :class:`FrameBody` advances a fixed set of tensors, the :class:`Carry`,
  by one frame, or by k frames with ``snapshot_every = k``. It calls the
  host loop's own frame: ``stepper._carried_frame`` (the frame build keyed
  by the carried particle ids, then ``_sorted_frame``) in faithful mode,
  ``_corrected_step`` in corrected mode, on every route and variant of
  ``SortedTuning``. So a replay launches the kernels the host loop
  launches (K1, K2, K3, K5), on the same inputs, and its result is the
  host loop's bit for bit.
- :class:`RecordedStep` warms a step up once on a copy of its carry,
  records it once (``torch.cuda.CUDAGraph``, in the graph's own memory
  pool) and replays it; :class:`GraphRollout` replays the body
  ``n_frames // k`` times a call.
- :func:`step_body` is one frame of a step ``(state, phys) → (state,
  metrics)`` over a :class:`StepCarry`, written back into it. It is what
  the other recorded entry points replay, one replay a frame, each the
  counterpart of a jitted JAX step: ``parallel.BatchedScenes`` (the jitted
  ``vmap`` of the frame step), ``models.Scene`` (``jit=True``) and the
  slab step on a ``LocalRing`` (``parallel.slab_pallas``, the jitted
  ``shard_map``: every shard's migration, exchanges and banded kernels).

Nothing in the body depends on a Python number that changes from frame to
frame: the frame index is a device counter. Frame f's metrics go to lane f
of ``[n_frames]`` tensors and snapshot s to slot s of an
``[n_frames // k, N, 3]`` tensor through ``index_copy_``, and a dt
schedule's frame dt is ``dts[counter]``. The body makes no synchronising
call (``tests/test_torch_cuda.py::test_rollout_never_waits_for_the_card``).
On the CPU the same body runs eagerly, which is how the CPU tests hold it
to the host loop; the graph needs the card.

Launch counters (``sph_kernels.launch_counts``) count in the kernel
wrappers, which a replay does not call. The capture keeps what its
wrappers counted and each replay adds it, so the counts after a graph
rollout equal the host loop's; the warm-up and the capture add nothing.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import SimConfig
from ..ops import sph_kernels
from ..ops.sph_kernels import SortedTuning
from ..params import PhysParams
from ..state import ParticleState, StepMetrics
from . import stepper

# dtypes of the StepMetrics lanes, in field order
METRIC_DTYPES = (torch.float32,) * 3 + (torch.int32,) * 3


def choose_host_loop(neighbor: str, device: torch.device,
                     host_loop: bool | None) -> bool:
    """Whether a rollout of ``neighbor``'s tier on ``device`` loops over
    frames on the host. None chooses: the graph for the sorted tier on the
    card, the host loop for every other tier and on the CPU. False asks for
    the graph and raises where none can run: on the exact tiers, the
    brute oracle and the sites tier (ROADMAP.md A16), and on the CPU."""
    if host_loop is None:
        return neighbor != "sorted" or device.type != "cuda"
    if not host_loop:
        if neighbor != "sorted":
            raise NotImplementedError(
                f"neighbor={neighbor!r} rolls out only as a host loop "
                "(ROADMAP.md A16): pass host_loop=True or None")
        if device.type != "cuda":
            raise RuntimeError(
                "host_loop=False replays a CUDA graph, which needs the "
                "card; on the CPU pass host_loop=True or None")
    return bool(host_loop)


class Carry(NamedTuple):
    """The tensors a :class:`FrameBody` reads and writes in place.

    pos, vel, nan_count: the state, in sorted order between faithful
        frames (the order of ``pid``), in the caller's order in corrected
        mode
    pid:     i32[N] the particle id of each row (the identity in corrected
             mode)
    counter: i64[1] the index of the next frame
    metrics: ``StepMetrics`` of ``[n_frames]`` lanes
    snaps:   f32[n_frames // k, N, 3] the snapshots, or None
    dts:     f32[n_frames] each frame's substep dt, or None
    """

    pos: torch.Tensor
    vel: torch.Tensor
    nan_count: torch.Tensor
    pid: torch.Tensor
    counter: torch.Tensor
    metrics: StepMetrics
    snaps: torch.Tensor | None
    dts: torch.Tensor | None

    def clone(self) -> "Carry":
        return Carry(*(x.clone() for x in self[:5]),
                     StepMetrics(*(x.clone() for x in self.metrics)),
                     *(None if x is None else x.clone() for x in self[6:]))


class FrameBody:
    """One step of the sorted tier's rollout over a :class:`Carry`: ``k``
    frames (``snapshot_every`` or 1) with their metrics and, with
    snapshots, the positions after the last of them in the caller's order.
    ``dt=True`` reads each frame's dt from ``carry.dts``
    (``make_dt_rollout``); else the config's ``frame_dt`` runs every
    frame. ``replays`` is the
    number of steps a rollout of ``n_frames`` takes."""

    def __init__(self, cfg: SimConfig, n_frames: int, *, faithful: bool,
                 snapshot_every: int, tune: SortedTuning,
                 device: torch.device, dt: bool = False):
        self.cfg, self.n_frames, self.tune = cfg, n_frames, tune
        self.faithful, self.device = faithful, device
        self.snapshot_every = snapshot_every
        self.k = snapshot_every or 1
        self.replays = n_frames // self.k
        self.phys = PhysParams.from_config(cfg, device)
        self.div = (torch.tensor(cfg.substep_divisor, dtype=torch.float32,
                                 device=device) if dt else None)
        self._corrected = (None if faithful
                           else stepper._corrected_step(cfg, tune))

    def new_carry(self) -> Carry:
        n, nf, dev = self.cfg.n_particles, self.n_frames, self.device
        f32 = dict(dtype=torch.float32, device=dev)
        return Carry(
            pos=torch.zeros(n, 3, **f32), vel=torch.zeros(n, 3, **f32),
            nan_count=torch.zeros(n, dtype=torch.int32, device=dev),
            pid=torch.zeros(n, dtype=torch.int32, device=dev),
            counter=torch.zeros(1, dtype=torch.int64, device=dev),
            metrics=metric_lanes((nf,), dev),
            snaps=(torch.zeros(self.replays, n, 3, **f32)
                   if self.snapshot_every else None),
            dts=torch.zeros(nf, **f32) if self.div is not None else None)

    def load(self, c: Carry, state: ParticleState, dt_schedule=None) -> None:
        """The caller's state (and dt schedule) into the carry, frame 0."""
        for dst, src in zip(c[:3], state):
            if src.shape != dst.shape:
                raise ValueError(f"state tensor of shape {tuple(src.shape)}"
                                 f"; the rollout holds {tuple(dst.shape)}")
            dst.copy_(src)
        torch.arange(c.pid.shape[0], dtype=torch.int32, device=self.device,
                     out=c.pid)
        c.counter.zero_()
        if c.dts is not None:
            # the host loop's arithmetic: frame f's dt is dts[f]
            c.dts.copy_(torch.as_tensor(
                dt_schedule, dtype=torch.float32,
                device=self.device).reshape(self.n_frames) / self.div)

    def _caller_order(self, pid: torch.Tensor, x: torch.Tensor
                      ) -> torch.Tensor:
        return stepper._unsort(pid, x) if self.faithful else x.clone()

    def advance(self, c: Carry) -> None:
        """``k`` frames from the carry, written back into it."""
        state, pid = ParticleState(*c[:3]), c.pid
        for j in range(self.k):
            f = c.counter + j
            phys = (self.phys if c.dts is None else self.phys._replace(
                dt=c.dts.index_select(0, f).reshape(())))
            if self.faithful:
                state, pid, m = stepper._carried_frame(state, pid, phys,
                                                       self.cfg, self.tune)
            else:
                state, m = self._corrected(state, phys)
            for lane, x in zip(c.metrics, m):
                lane.index_copy_(0, f, x.reshape(1))
        if c.snaps is not None:
            slot = torch.div(c.counter, self.k, rounding_mode="floor")
            c.snaps.index_copy_(0, slot,
                                self._caller_order(pid, state.pos)[None])
        c.counter.add_(self.k)
        for dst, src in zip(c[:4], (*state, pid)):
            dst.copy_(src)

    def result(self, c: Carry):
        """(final state, metrics[, snapshots]) as fresh tensors, the state
        in the caller's order; the metrics are None for 0 frames, as the
        host loop's."""
        final = ParticleState(*(self._caller_order(c.pid, x)
                                for x in c[:3]))
        m = (StepMetrics(*(x.clone() for x in c.metrics))
             if self.n_frames else None)
        if not self.snapshot_every:
            return final, m
        return final, m, c.snaps.clone()


class StepCarry(NamedTuple):
    """What :func:`step_body` reads and writes in place: the state (a
    ``ParticleState``, a batch's stacked one or a ``SlabState``), the
    physics the step reads and the metrics of its last frame (0-d lanes,
    or one lane a scene)."""

    state: tuple
    phys: PhysParams
    metrics: StepMetrics

    def clone(self) -> "StepCarry":
        return StepCarry(*(type(x)(*(t.clone() for t in x)) for x in self))


def step_body(step):
    """``advance(carry)``: one frame of ``step(state, phys) → (state,
    metrics)`` on a :class:`StepCarry`, written back into it; what
    :class:`RecordedStep` records, and on the CPU runs eagerly."""

    def advance(c: StepCarry) -> None:
        state, m = step(c.state, c.phys)
        for dst, src in zip((*c.state, *c.metrics), (*state, *m)):
            dst.copy_(src)

    return advance


def metric_lanes(shape: tuple, device: torch.device) -> StepMetrics:
    """Zeroed ``StepMetrics`` lanes of ``shape`` for a carry."""
    return StepMetrics(*(torch.zeros(shape, dtype=t, device=device)
                         for t in METRIC_DTYPES))


class RecordedStep:
    """``advance(carry)`` recorded once as a CUDA graph on ``device`` and
    replayed: the graph reads and writes the carry's tensors in place. The
    first :meth:`replay` warms ``advance`` up on ``carry.clone()`` (it
    builds the kernels and primes the caching allocator) and records it on
    a side stream; a capture that fails raises, counts nothing, restores
    the caller's stream, and nothing runs in its place. Each replay adds
    the launch counts the capture's wrappers counted."""

    def __init__(self, advance, carry, device: torch.device):
        self._advance, self._carry, self.device = advance, carry, device
        self.graph: torch.cuda.CUDAGraph | None = None
        self.launches: dict[str, int] = {}

    def replay(self) -> None:
        if self.graph is None:
            self._capture()
        self.graph.replay()
        counts = sph_kernels.launch_counts
        for name, k in self.launches.items():
            counts[name] = counts.get(name, 0) + k

    def _capture(self) -> None:
        counts = sph_kernels.launch_counts
        saved = dict(counts)
        main = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(main)
        try:
            # the outer stream context restores the caller's stream even
            # when a failed capture skips the inner one's exit
            with torch.cuda.stream(side):
                self._advance(self._carry.clone())
                before = dict(counts)
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph, stream=side):
                    self._advance(self._carry)
            self.launches = {name: k - before.get(name, 0)
                             for name, k in counts.items()
                             if k != before.get(name, 0)}
        finally:
            counts.clear()
            counts.update(saved)
        main.wait_stream(side)
        self.graph = graph


class GraphRollout:
    """``make_rollout`` / ``make_dt_rollout`` of the sorted tier on the
    card: ``rollout(state[, dt_schedule])`` copies the state into the
    carry, replays the recorded body (:class:`RecordedStep`) ``n_frames //
    k`` times and returns fresh tensors. The first call records the body."""

    host_loop = False

    def __init__(self, body: FrameBody):
        self.body = body
        self._carry = body.new_carry()
        self._step = RecordedStep(body.advance, self._carry, body.device)

    def __call__(self, state: ParticleState, dt_schedule=None):
        body = self.body
        body.load(self._carry, state, dt_schedule)
        for _ in range(body.replays):
            self._step.replay()
        return body.result(self._carry)
