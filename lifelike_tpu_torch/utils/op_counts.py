"""The work of each kernel in scalar operations and dependency levels: the one
table every operation bound and chain floor of the port reads.

The counts are those of the reference's Pallas kernels, traced from their
jaxprs by tools/kernel_op_counts.py: each arithmetic primitive is one
operation per lane, a primitive on a (K, 1, 1) box value K operations, a
length-K dot 2K - 1; a depth is the longest chain of dependent primitives,
each one level whatever its shape (the box axis counts once; for K5 and K6
a dot is one level too). They are data here because the card's machine has
no JAX. The tests hold the table to a live trace: K1 (at substeps 1 and 2,
and at the headline settings through its linearity in the substeps) and K6
in tests/test_torch_measure_tools.py, every entry in
tests/test_torch_op_counts_slow.py (marked slow).

Each entry names the configuration it was traced at. A rollout of H
strictly sequential control steps takes at least depth x H x CHAIN_CYCLES
cycles per candidate: its chain floor.
"""
from typing import NamedTuple

CHAIN_CYCLES = 4  # latency of a dependent FP32 / FP64 operation on the H100, cycles


class LaneStep(NamedTuple):
    """One control step of one candidate (K3: one plan) of K1-K4:
    ops.scalar_phys.control_step traced at (1, 1) tiles with `boxes` box rows
    (0: the plane), plus the stage cost of ops/traversal_pallas.py (K2 the
    joystick traversal cost without the gait term, K4 the chase cost; K1
    and K3 none counted)."""

    kernel: str
    substeps: int
    mass_freeze: int
    boxes: int
    physics_ops: int
    stage_ops: int
    physics_depth: int
    stage_depth: int

    @property
    def ops(self) -> int:
        return self.physics_ops + self.stage_ops


class SweepCount(NamedTuple):
    """One PGS sweep (one iteration) of one element of K5:
    lifelike_tpu.physics.impulse._pgs on the flat (60-row) or box-scene
    (129-row) system."""

    rows: int
    ops: int
    depth: int

    @property
    def ops_per_row(self) -> float:
        return self.ops / self.rows

    @property
    def depth_per_row(self) -> float:
        return self.depth / self.rows


class RiccatiStep(NamedTuple):
    """One backward step of one scenario of K6:
    lifelike_tpu.solver.riccati_pallas._backward_step (with its Gauss-Jordan
    inverse) at state size n and control size m; bytes_f32 are the six input
    blocks read once and the two gains written once, in float32."""

    n: int
    m: int
    ops: int
    bytes_f32: int
    depth: int


LANE_STEPS = (
    # the headline solve (bench.py bench_pmc) and the closed loops' default plant
    LaneStep("K1", 10, 10, 0, 52286, 0, 1228, 0),
    LaneStep("K1", 10, 1, 0, 95720, 0, 1390, 0),
    # reduced configurations the tier-1 test traces live (seconds, not 16 s)
    LaneStep("K1", 1, 1, 0, 9572, 0, 139, 0),
    LaneStep("K1", 2, 2, 0, 14318, 0, 260, 0),
    # the EPMC solve: 8 boxes of the pruned course
    LaneStep("K2", 10, 10, 8, 155546, 312, 1410, 20),
    LaneStep("K2", 10, 1, 8, 198980, 312, 1410, 20),
    # the chase solves on the 4-wall arena: headline, then the chase plant
    LaneStep("K3", 10, 10, 4, 105146, 0, 1410, 0),
    LaneStep("K4", 10, 10, 4, 105146, 235, 1410, 20),
    LaneStep("K3", 20, 1, 4, 297160, 0, 2820, 0),
    LaneStep("K4", 20, 1, 4, 297160, 235, 2820, 20),
)

PGS_SWEEPS = {60: SweepCount(60, 4728, 540), 129: SweepCount(129, 10248, 1161)}

RICCATI_STEP = RiccatiStep(n=37, m=12, ops=383995, bytes_f32=15324, depth=75)


def lane_step(kernel: str, substeps: int, mass_freeze: int) -> LaneStep:
    """The LaneStep of `kernel` at (substeps, mass_freeze); KeyError naming
    the traced configurations when there is none."""
    for e in LANE_STEPS:
        if (e.kernel, e.substeps, e.mass_freeze) == (kernel, substeps, mass_freeze):
            return e
    have = [(e.kernel, e.substeps, e.mass_freeze) for e in LANE_STEPS]
    raise KeyError(f"no {kernel} count at substeps {substeps}, mass_freeze {mass_freeze}; "
                   f"traced: {have}")


def k1_ops(substeps: int, mass_freeze: int) -> int:
    """K1's operations per control step at any setting. control_step unrolls
    its substeps and refactors the mass matrix every `mass_freeze` of them,
    so the count is ceil(substeps / mass_freeze) x F + substeps x S, with F
    (one freeze_mass) and S (one substep) from the traced (1, 1) and (2, 2)
    entries; it equals every traced K1 entry."""
    one, two = lane_step("K1", 1, 1).ops, lane_step("K1", 2, 2).ops
    sub = two - one
    freeze = one - sub
    return -(-substeps // max(mass_freeze, 1)) * freeze + substeps * sub


def chain_floor_ms(depth: int, units: int, sm_clock_mhz: float) -> float:
    """The chain floor (ms) of `units` dependent steps of `depth` levels each
    at CHAIN_CYCLES cycles per level and the given SM clock."""
    return depth * units * CHAIN_CYCLES / (sm_clock_mhz * 1e3)
