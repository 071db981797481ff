"""The port's twins of tools/pmc_curve.py and tools/sysid_contact.py vs the
reference tools, on the CPU.

pmc_curve: the twin's parse_log returns the reference's rows for the repo's
JAX learner log (runs/pmc_r5/train.log; the reference tool imports no JAX
and is loaded by path), and eval_policy reads finite episode rewards from
the port's bin/run_eval --device=cpu (the evaluation table: random init
and the run's last pool checkpoint); the section goes to stdout. The
port's own `update N:` lines are parsed in tests/test_torch_run_learner.py,
which runs a CPU PMC update.

sysid_contact: the objective (per-trace max |joint error| of the compliant
engine over the walk / run / stand golden traces, 50 control steps each),
at the default ContactParams and at one other point of the search box,
against the reference tool's own jitted objective (float64: x64 is on under
the tests) within 1e-8 relative; then one CEM iteration of the twin's
search, whose elitism keeps the best at or below the defaults. The other
point is a softer contact (kn 8e3, dn 30, v_slip 0.2, cap 60), where the
objective is well conditioned: at stiffer points such as (2e4, 80, 0.05,
120) a 1e-12 shift of log theta moves the port's own walk error by 170 %
(the chaos the reference tool's docstring describes), so no two
implementations can agree there. The check asserts that conditioning.
"""
import functools
import importlib.util
import io
import json
import math
import os
from contextlib import redirect_stdout

import numpy as np

from lifelike_tpu_torch.tools import pmc_curve, sysid_contact

from tests.torch_port_util import CPU

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUN_DIR = os.path.join(REPO, "runs", "pmc_r5")


def _load(name):
    spec = importlib.util.spec_from_file_location(f"reference_{name}",
                                                  os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@functools.lru_cache(maxsize=None)
def reference_pmc_curve():
    """The reference tools/pmc_curve.py (it imports no JAX)."""
    return _load("pmc_curve")


def _check_parse_log():
    path = os.path.join(RUN_DIR, "train.log")
    rows = pmc_curve.parse_log(path)
    assert len(rows) > 100
    assert rows == reference_pmc_curve().parse_log(path)
    assert [r[0] for r in rows] == sorted({r[0] for r in rows})  # one row per update
    out = io.StringIO()
    with redirect_stdout(out):
        pmc_curve.main(["--device=cpu", "--no_eval", f"--run_dir={RUN_DIR}", "--points=4"])
    text = out.getvalue()
    assert "## From-scratch PMC training" in text and text.count("\n| ") == 5, text


def _check_eval_policy():
    """The evaluation table through eval_policy: random init and the run's
    last pool checkpoint with finite reward sums, the imported reference
    model absent."""
    lines = pmc_curve.eval_lines(RUN_DIR, 1, 3, "cpu", log=lambda m: None)
    rows = [ln for ln in lines if ln.startswith("| ") and not ln.startswith("| policy")]
    assert len(rows) == 3 and rows[2] == "| imported primitive_level.model | absent | |", rows
    for row in rows[:2]:
        _, name, reward, length, _ = row.split("|")
        assert math.isfinite(float(reward.split("+-")[0])) and 1 <= float(length) <= 3, row


def _check_sysid_objective():
    ref = _load("sysid_contact")
    jeval = ref.make_eval(ref._load_all())
    evaluate = sysid_contact.make_eval(sysid_contact.load_traces(CPU))
    theta0 = sysid_contact.default_theta()
    np.testing.assert_array_equal(theta0, np.log(np.array([1.2e4, 50.0, 0.1, 80.0])))
    thetas = np.stack([theta0, np.log(np.array([8e3, 30.0, 0.2, 60.0]))])
    assert ((thetas > ref.LOG_LO) & (thetas < ref.LOG_HI)).all()
    want = np.asarray(jeval(thetas))
    got = evaluate(np.concatenate([thetas, thetas + 1e-12]))
    assert got.shape == (4, 3) and np.isfinite(got).all()
    np.testing.assert_allclose(got[2:], got[:2], rtol=1e-10, atol=0)  # well conditioned
    np.testing.assert_allclose(got[:2], want, rtol=1e-8, atol=0)
    np.testing.assert_array_equal(sysid_contact.LOG_LO, ref.LOG_LO)
    np.testing.assert_array_equal(sysid_contact.LOG_HI, ref.LOG_HI)
    assert sysid_contact.NAMES == ref.NAMES


def _check_sysid_search():
    lines = []
    out = sysid_contact.main(["--device=cpu", "--iters=1", "--pop=4", "--elites=2"],
                             log=lambda *a: lines.append(" ".join(map(str, a))))
    assert json.loads(lines[-1]) == out
    best, base = sum(out["errors"].values()), sum(out["default_errors"].values())
    assert math.isfinite(best) and best <= base


# Each test file of the port holds at most two test items: pytest-xdist's
# loadfile scheduler queues files by item count, so files this small run
# after the long reference files and do not lengthen the tier-1 run.


def test_pmc_curve_twin_matches_reference():
    _check_parse_log()
    _check_eval_policy()


def test_sysid_contact_twin_matches_reference():
    _check_sysid_objective()
    _check_sysid_search()
