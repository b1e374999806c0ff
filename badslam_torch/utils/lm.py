"""Generic Levenberg-Marquardt optimizer with optional Schur complement.

Counterpart of ``badslam_tpu/utils/lm.py`` (libvis's LMOptimizer,
lm_optimizer.h:47, the reusable solver libvis ships for tools and tests;
the SLAM core uses its own Gauss-Newton loops). Residuals are a function
of the state, Jacobians come from ``torch.func.jacfwd``, and the damped
normal equations are solved densely, or through the Schur complement when
the state splits into a small dense block and a large block-diagonal one.
Each step's convergence test is read back once, on the device of the
state.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import torch
from torch.func import jacfwd


class LMResult(NamedTuple):
    x: torch.Tensor     # final state
    cost: torch.Tensor  # final cost
    iterations: int     # iterations run


def optimize(
    residual_fn: Callable[[torch.Tensor], torch.Tensor],
    x0: torch.Tensor,
    max_iterations: int = 50,
    initial_lambda: float = 1e-4,
    lambda_up: float = 10.0,
    lambda_down: float = 0.5,
    tolerance: float = 1e-12,
) -> LMResult:
    """Dense LM: minimize ||residual_fn(x)||^2 over a flat state vector."""

    def cost_of(x):
        r = residual_fn(x)
        return torch.sum(r * r)

    x = x0
    lam = torch.tensor(initial_lambda, dtype=x0.dtype, device=x0.device)
    eye = torch.eye(x0.shape[0], dtype=x0.dtype, device=x0.device)
    cost = cost_of(x0)
    it = 0
    done = False
    while it < max_iterations and not done:
        r = residual_fn(x)
        J = jacfwd(residual_fn)(x)
        H = J.T @ J
        g = J.T @ r
        delta = torch.linalg.solve(H + lam * eye, -g)
        new_cost = cost_of(x + delta)
        improved = new_cost < cost
        x = torch.where(improved, x + delta, x)
        lam = torch.where(improved, lam * lambda_down, lam * lambda_up)
        new_cost = torch.where(improved, new_cost, cost)
        done = bool((torch.abs(cost - new_cost)
                     < tolerance * torch.clamp_min(cost, 1.0)) & improved)
        cost = new_cost
        it += 1
    return LMResult(x=x, cost=cost, iterations=it)


def optimize_schur(
    residual_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    a0: torch.Tensor,        # [Na] dense block (e.g. a pose)
    b0: torch.Tensor,        # [Nb, Bb] block-diagonal states (e.g. points)
    max_iterations: int = 50,
    initial_lambda: float = 1e-4,
    lambda_up: float = 10.0,
    lambda_down: float = 0.5,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """LM where each residual row couples the dense block `a` with exactly
    one block-diagonal state b[i] (bundle-adjustment structure):
    `residual_fn(a, b) -> [Nb, R]` with row i depending only on (a, b[i]).
    The damped normal equations are solved through the Schur complement
    over the b blocks. Returns (a, b, cost)."""
    nb, bb = b0.shape
    na = a0.shape[0]
    rows = torch.arange(nb, device=b0.device)
    eye_a = torch.eye(na, dtype=a0.dtype, device=a0.device)
    eye_b = torch.eye(bb, dtype=b0.dtype, device=b0.device)

    def cost_of(a, b):
        r = residual_fn(a, b)
        return torch.sum(r * r)

    a, b = a0, b0
    lam = torch.tensor(initial_lambda, dtype=a0.dtype, device=a0.device)
    cost = cost_of(a0, b0)
    for _ in range(max_iterations):
        r = residual_fn(a, b)                                       # [Nb, R]
        Ja = jacfwd(lambda a_: residual_fn(a_, b))(a)              # [Nb, R, Na]
        # d r_i / d b_i: the diagonal blocks of the full Jacobian, the same
        # forward-mode products as one Jacobian per row.
        Jb = jacfwd(lambda b_: residual_fn(a, b_))(b)[rows, :, rows, :]  # [Nb, R, Bb]

        U = torch.einsum("nri,nrj->ij", Ja, Ja) + lam * eye_a
        W = torch.einsum("nri,nrj->nij", Ja, Jb)
        V = torch.einsum("nri,nrj->nij", Jb, Jb) + lam * eye_b[None]
        ga = torch.einsum("nri,nr->i", Ja, r)
        gb = torch.einsum("nri,nr->ni", Jb, r)
        V_inv = torch.linalg.inv(V)
        WVi = torch.einsum("nij,njk->nik", W, V_inv)
        S = U - torch.einsum("nik,njk->ij", WVi, W)
        rhs = -ga + torch.einsum("nik,nk->i", WVi, gb)
        da = torch.linalg.solve(S, rhs)
        # Back-substitute each block: db_n = -V_n^-1 (gb_n + W_n^T da).
        wt_da = torch.einsum("nji,j->ni", W, da)
        db = -torch.einsum("nij,nj->ni", V_inv, gb + wt_da)
        new_cost = cost_of(a + da, b + db)
        improved = new_cost < cost
        a = torch.where(improved, a + da, a)
        b = torch.where(improved, b + db, b)
        lam = torch.where(improved, lam * lambda_down, lam * lambda_up)
        cost = torch.where(improved, new_cost, cost)
    return a, b, cost
