"""Simulation configuration.

Counterpart of ``sphfluidsimulation_tpu/config.py``, copied verbatim (pure
Python): importing the JAX package's module would import jax.

Mirrors the reference's inspector-field contract (the 15 public fields of
``SphFluidSimulation`` — reference ``Assets/Scripts/SphFluidSimulation.cs:34-53``)
plus the derivation rules the host code applies:

* ``particle_number`` is rounded up to the next power of two
  (``SphFluidSimulation.cs:84``) and the state "texture" resolution is
  ``int(sqrt(N))`` (``:85``); the active particle count is ``res**2``.
* smoothing length ``h = 1 / (bucket_resolution - 1)`` (``:159``),
* particle mass ``m = dam_fill_rate / particle_number`` (``:176``),
* five integration substeps of ``dt_frame / 25`` per frame (``:101-102``).

The default values below are the canonical scene config
(``Assets/Scenes/SampleScene.unity:362-376``), which is the reference's only
shipped workload.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

# Gravity is hardcoded in the reference's integration kernel
# (VelPos.compute:7): static const float3 a_gravity = (0, -9.8, 0).
GRAVITY_Y = -9.8

# Slot capacity of a single grid voxel (Bucket.compute:2,
# SphFluidSimulation.cs:9). Particles past this are silently dropped by the
# reference; we reproduce that (deterministically) by default.
REFERENCE_VOXEL_CAPACITY = 32

# Division-by-zero guard used throughout the force kernel (VelPos.compute:5).
EPSILON = 1e-6


def next_power_of_two(n: int) -> int:
    """Mathf.NextPowerOfTwo semantics (SphFluidSimulation.cs:84)."""
    if n <= 0:
        return 0
    return 1 << (n - 1).bit_length()


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Frozen scene configuration.

    Field names are snake_case versions of the reference inspector fields;
    defaults are the canonical SampleScene values
    (Assets/Scenes/SampleScene.unity:362-376).
    """

    # -- Initialization (SphFluidSimulation.cs:34-38) --
    preset: int = 1                 # kernel index: 0→Preset1, 1→Preset2, 2→Preset3
    particle_number: int = 262144   # rounded up to next pow2 on resolve
    bucket_resolution: int = 47     # uniform grid cells per axis (R)
    dam_fill_rate: float = 0.8

    # -- Physics parameters (SphFluidSimulation.cs:40-45) --
    viscosity: float = 0.01
    rest_density: float = 1.5
    gas_constant: float = 150.0
    stiffness_coefficient: float = 5000.0
    damping_coefficient: float = 10.0

    # -- Rendering (SphFluidSimulation.cs:47-53; SampleScene.unity:369-376) --
    occlusion_range: float = 150.0
    particle_radius: float = 0.01
    render_particles: bool = True
    low_speed: float = 0.0
    high_speed: float = 0.5
    sim_scale: float = 5.0          # Simulation object uniform scale (scene :461)

    # -- Time stepping --
    # The reference steps in Update() with dt = Time.deltaTime / 25, five
    # times per frame (SphFluidSimulation.cs:101-102) — i.e. frame-rate
    # dependent. We fix the frame dt (default 60 FPS) for determinism.
    frame_dt: float = 1.0 / 60.0
    substeps: int = 5
    substep_divisor: float = 25.0

    # -- Framework knobs (no reference equivalent) --
    # XSPH advection smoothing epsilon and Monaghan artificial-viscosity
    # alpha (BASELINE config 3); 0.0 disables (reference-faithful path).
    xsph: float = 0.0
    artificial_viscosity: float = 0.0
    # Voxel slot capacity (the reference silently drops particles beyond 32
    # per voxel, Bucket.compute:2,30-35). None disables the drop entirely —
    # supported by the 'brute' and 'pallas' backends, whose candidate
    # structures are not capacity-shaped; 'slotted'/'gather' allocate static
    # per-voxel slot arrays and raise a ValueError for None (pick a cap).
    voxel_capacity: int | None = REFERENCE_VOXEL_CAPACITY
    # Site-grid backend (neighbor="sites"): max distinct (position, ρ)
    # sites per voxel in the dense evaluation/candidate grids. Coincident
    # particles (the clamp parks fast particles on exactly equal wall/corner
    # points, VelPos.compute:154) share one site, so this is NOT the voxel
    # occupancy bound; overflow is counted in StepMetrics.exact_cert. The
    # default matches the reference's 32-candidates-per-voxel bound
    # (Bucket.compute:2); throughput configs dial it down (cost scales with
    # site_capacity² per window cell) and watch the certificate.
    site_capacity: int = 32
    # Evaluation-grid (i-side) site capacity; None = same as site_capacity.
    # The j-side is bounded by the reference's 32-candidate bucket cap, but
    # FRESH voxels can transiently hold more distinct evaluation tuples
    # than any stale voxel held candidates — raise this to keep the i-side
    # certificate at zero on long rollouts without paying the j-side cost
    # (window flops scale with site_capacity_i × site_capacity).
    site_capacity_i: int | None = None
    # Site-grid z-banding: process the domain as this many sequential
    # z-bands per pass, each a dense [K, (span+6)·R²] slab-local grid —
    # the dense R³ grids at R≥~60 (1M scale) overflow worker memory as
    # one piece (BENCH_NOTES round 3). 1 = single full grid; 0 = auto
    # (bands chosen so a band's grid stays under ~128k cells). The banded
    # walk visits the same candidate set with identical site ranks, so
    # results are bit-identical to the full grid on TPU and ULP-close on
    # CPU (tests/test_sites.py).
    site_bands: int = 0
    # Noise seed offset (the reference noise is a pure function of position
    # and particle index; seed shifts the noise-domain offset).
    seed: int = 0

    # ---- Derived quantities (reference derivation rules) ----

    @property
    def particle_number_pow2(self) -> int:
        """particleNumber after NextPowerOfTwo (SphFluidSimulation.cs:84)."""
        return next_power_of_two(self.particle_number)

    @property
    def texture_resolution(self) -> int:
        """(int)sqrt(N) — the state-texture edge (SphFluidSimulation.cs:85)."""
        return int(math.sqrt(self.particle_number_pow2))

    @property
    def n_particles(self) -> int:
        """Active particle count.

        The reference dispatches res×res threads, so for non-square powers of
        two (e.g. 2048 → res 45) only res² particles are ever initialized or
        integrated; we make that explicit.
        """
        return self.texture_resolution ** 2

    @property
    def effective_radius(self) -> float:
        """Smoothing length h = 1/(R−1) (SphFluidSimulation.cs:159)."""
        return 1.0 / (self.bucket_resolution - 1)

    @property
    def particle_mass(self) -> float:
        """m = damFillRate / particleNumber (SphFluidSimulation.cs:176).

        Note: divides the pow2-rounded count, not the active count.
        """
        return self.dam_fill_rate / self.particle_number_pow2

    @property
    def substep_dt(self) -> float:
        """dt = frame_dt / 25 per substep (SphFluidSimulation.cs:102)."""
        return self.frame_dt / self.substep_divisor

    @property
    def n_cells(self) -> int:
        return self.bucket_resolution ** 3

    # The reference inspector's [Range] bounds (SphFluidSimulation.cs:35-53),
    # enforced field-for-field by validate(). Two deliberate deviations:
    # bucket_resolution's LOWER bound is 2, not the inspector's 1 (R=1 makes
    # h = 1/(R-1) infinite — the inspector slider allows it but the scene is
    # degenerate), and particle_number's lower bound is relaxed below the
    # inspector's 1024 for tiny test scenes (the reference's pow2+sqrt
    # derivation already makes sub-1024 counts square-truncated; nothing in
    # the physics needs the UI floor).
    INSPECTOR_RANGES = (
        ("preset", 0, 2),                          # :35
        ("particle_number", 1, 4194304),           # :36 (UI floor 1024 relaxed)
        ("bucket_resolution", 2, 256),             # :37 (UI floor 1 tightened)
        ("dam_fill_rate", 0.01, 1.0),              # :38
        ("viscosity", 0.0, 0.1),                   # :41
        ("rest_density", 0.0, 5.0),                # :42
        ("gas_constant", 1.0, 5000.0),             # :43
        ("stiffness_coefficient", 1000.0, 10000.0),  # :44
        ("damping_coefficient", 1.0, 50.0),        # :45
        ("particle_radius", 0.001, 1.0),           # :49
        ("low_speed", 0.0, 1000.0),                # :52
        ("high_speed", 0.0, 1000.0),               # :53
    )

    def validate(self) -> "SimConfig":
        for field, lo, hi in self.INSPECTOR_RANGES:
            v = getattr(self, field)
            if not (lo <= v <= hi):
                raise ValueError(
                    f"{field} {v} outside the reference inspector range "
                    f"[{lo}, {hi}] (SphFluidSimulation.cs:35-53)")
        if self.n_particles < 1:
            raise ValueError("particle_number too small")
        if self.substeps < 1:
            raise ValueError("substeps must be >= 1")
        if not (self.frame_dt > 0.0 and self.substep_divisor > 0.0):
            raise ValueError("frame_dt and substep_divisor must be positive")
        return self

    def replace(self, **kw: Any) -> "SimConfig":
        return dataclasses.replace(self, **kw)

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "SimConfig":
        return cls(**d)


# The canonical scene ("golden") configuration — SampleScene.unity:362-376.
GOLDEN_CONFIG = SimConfig()

# A small CPU-friendly config used by tests and the stage-1 oracle.
TINY_CONFIG = SimConfig(particle_number=4096, bucket_resolution=17)
