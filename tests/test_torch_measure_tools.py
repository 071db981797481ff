"""The measurement tools' twins (lifelike_tpu_torch/tools/{sol_report,
probe_sweep, epmc_sweep, scaling_bench}.py) on the CPU at small sizes, and
the op-count table (lifelike_tpu_torch/utils/op_counts.py) held to the JAX
reference's jaxpr, traced live by tools/kernel_op_counts.py's method.

Item 1: sol_report, probe_sweep and epmc_sweep with --device cpu print the
reference tools' rows (names and keys) with finite positive times; K1's
count at substeps 1 and 2 (and so, by its linearity in the substeps, at the
headline settings) and K6's entry equal the live trace. Item 2:
scaling_bench at sizes 1 and 2 on CPU gloo ranks: the reference's row
names, and the size-2 plan within 2e-4 of the size-1 plan at the same
population (chip_smoke.py phase 15's gate). The whole table is held to the
trace in tests/test_torch_op_counts_slow.py.
"""
import importlib.util
import json
import math
import os
import re

import numpy as np

from tests import torch_port_util  # noqa: F401  (one intra-op thread per worker)
from lifelike_tpu_torch.tools import epmc_sweep, probe_sweep, scaling_bench, sol_report
from lifelike_tpu_torch.utils import op_counts

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _kernel_op_counts():
    """tools/kernel_op_counts.py, loaded by path (it imports JAX)."""
    spec = importlib.util.spec_from_file_location(
        "kernel_op_counts", os.path.join(REPO, "tools", "kernel_op_counts.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _positive(row, keys):
    for k in keys:
        assert isinstance(row[k], (int, float)) and math.isfinite(row[k]) and row[k] > 0, (k, row)


def _json_lines(lines):
    return [json.loads(ln) for ln in lines if ln.startswith("{")]


def _check_op_counts():
    koc = _kernel_op_counts()
    traced = {(s, mf): koc.physics_ops(s, mf, 0) for s, mf in ((1, 1), (2, 2))}
    for (s, mf), n in traced.items():
        assert op_counts.lane_step("K1", s, mf).physics_ops == n, (s, mf, n)
    # control_step unrolls its substeps: the headline entries follow from the
    # traced ones, and the table's linear model reads them back
    for e in op_counts.LANE_STEPS:
        if e.kernel == "K1":
            assert op_counts.k1_ops(e.substeps, e.mass_freeze) == e.ops, e
    ops, nbytes, depth = koc.riccati_ops(op_counts.RICCATI_STEP.n, op_counts.RICCATI_STEP.m)
    assert (ops, nbytes, depth) == op_counts.RICCATI_STEP[2:], (ops, nbytes, depth)


def _check_sol_report(monkeypatch):
    monkeypatch.setenv("SOL_POP", "64")
    monkeypatch.setenv("SOL_HORIZON", "2")
    monkeypatch.setenv("SOL_SUBSTEPS", "2")
    lines = []
    out = sol_report.main(["--device", "cpu"], log=lines.append)
    text = "\n".join(lines)
    # the reference's lines: the solve, the cost-analysis roofline, the
    # substep rate and the arithmetic model
    for name in ("solve pop=64 H=2 sub=2", "speed of light", "M physics substeps/s",
                 "scalar ops/lane/control-step", "GFLOP per solve", "TFLOP/s over"):
        assert name in text, (name, text)
    assert _json_lines(lines) == [out]
    _positive(out, ("ms_per_solve", "msubsteps_per_s", "tflops", "fp32_peak_share", "bytes",
                    "ops_per_lane_step"))
    assert math.isfinite(out["flops_counted"]) and out["flops_counted"] >= 0
    assert out["ops_per_lane_step"] == op_counts.lane_step("K1", 2, 2).ops
    assert sol_report.expected_launches()["K1"] == 25  # 1 + (1 + 2) x (2 + 6)


def _check_probe_sweep():
    argv = ["--device=cpu", "--scenarios=2", "--population=16", "--horizon=2",
            "--substeps=2", "--reps=1"]
    lines = []
    rows = probe_sweep.main(argv, log=lines.append)
    # the reference's names at S scenarios of S x Bs candidate rows of L
    assert list(rows) == ["plan_fused S=2", "plan_fused S=1", "chase_fused 2x16 rows",
                          "full fused round"], list(rows)
    for name, r in rows.items():
        _positive(r, ("min_ms", "med_ms"))
        assert math.isfinite(r["out_mean"])
        assert f"  {name} out-mean " in "\n".join(lines)
        assert re.search(rf"^{re.escape(name)}: min \S+ ms  med \S+ ms", "\n".join(lines), re.M)
    assert probe_sweep.expected_launches(argv) == {"K1": 0, "K2": 0, "K3": 8, "K4": 6}


def _check_epmc_sweep():
    argv = ["--device=cpu", "--ks=8", "--pops=16", "--horizon=2", "--eval_pop=8",
            "--eval_horizon=3", "--substeps=2", "--reps=1", "--m_hi=3"]
    lines = []
    rows = epmc_sweep.main(argv, log=lines.append)
    assert _json_lines(lines) == rows
    assert [r["metric"] for r in rows] == ["epmc_solve_latency_pop16_H2_k8",
                                           "epmc_solve_latency_pop8_H3_k8"]
    for r in rows:
        assert {"metric", "contact_k", "value", "unit"} <= set(r) and r["unit"] == "ms"
        assert r["contact_k"] == 8
        _positive(r, ("value", "k2_ms"))


def test_measure_tools_cpu_and_op_counts(monkeypatch):
    """sol_report, probe_sweep and epmc_sweep on the CPU; the op-count
    table's K1 and K6 entries vs the live jaxpr count."""
    _check_op_counts()
    _check_sol_report(monkeypatch)
    _check_probe_sweep()
    _check_epmc_sweep()


def test_scaling_bench_cpu_ranks():
    """scaling_bench at sizes 1 and 2 (two CPU gloo ranks) and its process
    rows: the reference's row names and keys, finite positive values, and
    the size-2 plan within 2e-4 of the size-1 fixed-work plan."""
    lines = []
    rows = scaling_bench.main(["--device=cpu", "--sizes=1,2", "--reps=1", "--pop_per_dev=32",
                               "--horizon=3", "--substeps=2", "--scen_per_dev=1",
                               "--sweep_pop=8"], log=lines.append)
    assert [r["metric"] for r in rows] == [
        "weak_scaling_n1_pop32_H3", "weak_scaling_fixedwork_n1_pop64_H3",
        "sweep_weak_scaling_n1_s1_pop8", "weak_scaling_n2_pop64_H3",
        "sweep_weak_scaling_n2_s2_pop8", "multiproc_scaling_p1_pop32_H3",
        "multiproc_scaling_p2_pop32_H3"]
    printed = _json_lines(lines)
    assert [r["metric"] for r in printed] == [r["metric"] for r in rows]
    for r in printed:
        assert {"metric", "value", "unit", "vs_baseline"} <= set(r) and "plan" not in r
        _positive(r, ("value", "vs_baseline"))
        assert r["device"] == "cpu" and r["ranks_per_card"] is None
    plans = {r["metric"]: np.asarray(r["plan"]) for r in rows if "plan" in r}
    np.testing.assert_allclose(plans["weak_scaling_n2_pop64_H3"],
                               plans["weak_scaling_fixedwork_n1_pop64_H3"], rtol=2e-4, atol=2e-4)
