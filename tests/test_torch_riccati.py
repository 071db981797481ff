"""The Riccati backward sweep of lifelike_tpu_torch (solver/riccati_cuda.py)
vs the JAX reference's oracle, on the CPU.

Inputs are made with numpy from a seed in the shape of the reference
test's `_rand_lqr` (tests/test_riccati_pallas.py): S 3 scenarios, H 5
steps, n 37, m 12. The plain sweep is held to JAX's riccati_sweep_ref at
1e-9 in float64 and, in float32, at the reference kernel test's 2e-5
(x max(|k|, 1) for the feedforward gains); it must solve an exact LQR
problem optimally; the wrapper on CPU tensors is the plain sweep. The
kernel (K6) is held to the plain sweep on a card only (float32 2e-5,
float64 1e-9; also at S 1, S 13, H 1 and on a stiff system), by the
`cuda`-marked test, which skips here.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lifelike_tpu.solver import riccati_pallas
from lifelike_tpu_torch.solver import riccati_cuda

from tests.torch_port_util import CPU, F64, assert_close, np_of

N, M = 37, 12


def rand_lqr(rng, S=3, H=5, n=N, m=M):
    """numpy float64 (A, Bm, cx, cu, Cxx, Cuu) shaped as the reference
    test's _rand_lqr: A near identity, SPD cost Hessians."""
    A = 0.1 * rng.standard_normal((S, H, n, n)) + np.eye(n)
    Bm = 0.1 * rng.standard_normal((S, H, n, m))
    cx = rng.standard_normal((S, H, n))
    cu = rng.standard_normal((S, H, m))
    W = 0.1 * rng.standard_normal((S, H, n, n))
    Cxx = W @ np.swapaxes(W, -1, -2) + 0.1 * np.eye(n)
    V = 0.1 * rng.standard_normal((S, H, m, m))
    Cuu = V @ np.swapaxes(V, -1, -2) + 0.1 * np.eye(m)
    return A, Bm, cx, cu, Cxx, Cuu


def stiff_lqr(rng, S, H):
    """rand_lqr with B's columns scaled from 1e-3 to 10**2.8 and Cuu = 3e-3 I:
    B'VB reaches ~1e6 beside the damping, as in the hybrid loop's
    linearizations through contact."""
    A, Bm, cx, cu, Cxx, Cuu = rand_lqr(rng, S=S, H=H)
    Cuu = np.broadcast_to(3e-3 * np.eye(M), Cuu.shape).copy()
    return A, Bm * np.logspace(-3.0, 2.8, M), cx, cu, Cxx, Cuu


def _tensors(prob, dtype, device=CPU):
    return [torch.as_tensor(x, dtype=dtype, device=device) for x in prob]


def assert_gains_close(got, want, tol):
    """The reference kernel test's gate: k at tol x max(|k|, 1), K at tol."""
    (k1, K1), (k2, K2) = got, want
    scale = float(np.max(np.abs(np_of(k2))))
    assert_close(k1, k2, rtol=0, atol=tol * max(scale, 1.0))
    assert_close(K1, K2, rtol=0, atol=tol)


def _check_plain_matches_reference(rng):
    prob = rand_lqr(rng)
    ref = jax.jit(riccati_pallas.riccati_sweep_ref, static_argnames="reg")
    for reg in (1e-3, 0.0):
        want = ref(*(jnp.asarray(x) for x in prob), reg=reg)
        got = riccati_cuda.riccati_sweep_plain(*_tensors(prob, F64), reg=reg)
        for g, w in zip(got, want):
            assert g.dtype == F64
            assert_close(g, w, rtol=1e-9, atol=1e-9)
        # float32 on both sides, at the reference kernel test's tolerance
        want32 = ref(*(jnp.asarray(x, jnp.float32) for x in prob), reg=reg)
        got32 = riccati_cuda.riccati_sweep_plain(*_tensors(prob, torch.float32), reg=reg)
        assert got32[0].dtype == torch.float32
        assert_gains_close(got32, want32, 2e-5)
        # the wrapper on CPU tensors is the plain sweep, and launches nothing
        before = riccati_cuda.riccati_sweep.launches
        again = riccati_cuda.riccati_sweep(*_tensors(prob, F64), reg=reg)
        for a, g in zip(again, got):
            assert torch.equal(a, g)
        assert riccati_cuda.riccati_sweep.launches == before
    # mixed dtypes promote, as jnp.result_type does in the reference
    mixed = _tensors(prob, F64)
    mixed[0] = mixed[0].float()
    assert riccati_cuda.riccati_sweep_plain(*mixed)[1].dtype == F64
    # neither CPU nor CUDA: refused
    with pytest.raises(ValueError, match="unsupported device"):
        riccati_cuda.riccati_sweep(*_tensors(prob, F64, device="meta"))


def _check_plain_solves_lqr(rng):
    """The reference test's exact-LQR check (test_riccati_pallas.py:45-75)
    on the plain sweep: linear dynamics, quadratic cost around the origin;
    the swept gains from x0 = 0 beat any perturbed control sequence."""
    A, Bm, cx, cu, Cxx, Cuu = _tensors(rand_lqr(rng, S=1, H=6), F64)
    cx = torch.zeros_like(cx)
    H = 6

    def cost_of(us):
        x = torch.zeros(N, dtype=F64)
        total = 0.0
        for t in range(H):
            u = us[t]
            total = total + 0.5 * x @ Cxx[0, t] @ x + 0.5 * u @ Cuu[0, t] @ u + cu[0, t] @ u
            x = A[0, t] @ x + Bm[0, t] @ u
        return float(total)

    ks, Ks = riccati_cuda.riccati_sweep_plain(A, Bm, cx, cu, Cxx, Cuu, reg=0.0)
    x = torch.zeros(N, dtype=F64)
    us = []
    for t in range(H):
        u = ks[0, t] + Ks[0, t] @ x
        us.append(u)
        x = A[0, t] @ x + Bm[0, t] @ u
    us = torch.stack(us)
    c_opt = cost_of(us)
    for seed in range(3):
        du = 0.1 * torch.as_tensor(np.random.default_rng(seed).standard_normal(us.shape))
        assert c_opt <= cost_of(us + du) + 1e-5


# Each test file of the port holds at most two test items (ROADMAP.md ground
# rules): the checks are plain helpers called in turn.


def test_riccati_plain_matches_reference():
    rng = np.random.default_rng(0)
    _check_plain_matches_reference(rng)
    _check_plain_solves_lqr(rng)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA Riccati kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_riccati_kernel_matches_plain(cuda_device):
    """K6 vs riccati_sweep_plain on the card, at chip_smoke.py's random
    systems (S 3 and S 8, H 50) and at S 1, S 13 and H 1: float32 at 2e-5
    (x max(|k|, 1) for k), float64 at 1e-9; float64 at 1e-9 (k of max(|k|,
    1)) on a stiff system (Cuu 3e-3 I beside B'VB ~1e6); one launch per
    call; wrong shapes and mixed dtypes are refused."""
    rng = np.random.default_rng(6)
    for S, H in ((3, 50), (8, 50), (1, 50), (13, 50), (3, 1)):
        prob = rand_lqr(rng, S=S, H=H)
        for dtype, tol in ((torch.float32, 2e-5), (torch.float64, 1e-9)):
            args = _tensors(prob, dtype, cuda_device)
            before = riccati_cuda.riccati_sweep.launches
            got = riccati_cuda.riccati_sweep(*args, reg=1e-3)
            torch.cuda.synchronize()
            assert riccati_cuda.riccati_sweep.launches == before + 1
            want = riccati_cuda.riccati_sweep_plain(*args, reg=1e-3)
            if dtype == torch.float64:
                for g, w in zip(got, want):
                    assert_close(g, w, rtol=0, atol=tol)
            else:
                assert_gains_close(got, want, tol)
    args = _tensors(stiff_lqr(rng, S=2, H=50), torch.float64, cuda_device)
    got = riccati_cuda.riccati_sweep(*args, reg=0.0)
    want = riccati_cuda.riccati_sweep_plain(*args, reg=0.0)
    assert float(want[0].abs().max()) > 100.0  # the stiff directions' gains
    assert_gains_close(got, want, 1e-9)
    args = _tensors(rand_lqr(rng, S=2, H=3), torch.float32, cuda_device)
    with pytest.raises(ValueError, match="Bm"):
        riccati_cuda.riccati_sweep(args[0], args[1][..., :11], *args[2:])
    with pytest.raises(ValueError, match="cx"):
        riccati_cuda.riccati_sweep(args[0], args[1], args[2].double(), *args[3:])
