"""Every entry of the op-count table (lifelike_tpu_torch/utils/op_counts.py)
against a live trace of the JAX reference by tools/kernel_op_counts.py: K1-K4
physics and stage counts and depths at each traced configuration, K5's PGS
sweep at 60 and 129 rows, K6's Riccati step. About nine minutes on one CPU
core, so marked slow; tests/test_torch_measure_tools.py holds K1 and K6 in
tier-1.
"""
import pytest

from lifelike_tpu_torch.utils import op_counts
from tests.test_torch_measure_tools import _kernel_op_counts

STAGES = {"K2": "traversal_stage_ops", "K4": "chase_stage_ops"}


@pytest.mark.slow
def test_op_count_table_matches_the_reference_trace():
    koc = _kernel_op_counts()
    for e in op_counts.LANE_STEPS:
        got = (koc.physics_ops(e.substeps, e.mass_freeze, e.boxes),
               koc.physics_ops(e.substeps, e.mass_freeze, e.boxes, measure=koc._depth))
        if e.kernel in STAGES:
            stage = getattr(koc, STAGES[e.kernel])
            got += (stage(e.boxes), stage(e.boxes, measure=koc._depth))
        else:
            got += (0, 0)
        assert got == (e.physics_ops, e.physics_depth, e.stage_ops, e.stage_depth), (e, got)
    for with_boxes in (False, True):
        rows, ops, depth = koc.pgs_ops(with_boxes)
        assert op_counts.PGS_SWEEPS[rows] == (rows, ops, depth), (rows, ops, depth)
    assert koc.riccati_ops() == op_counts.RICCATI_STEP[2:]
