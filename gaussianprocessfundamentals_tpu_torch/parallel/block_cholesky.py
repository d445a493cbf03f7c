"""Distributed block-cyclic Cholesky and block triangular solves over the
ranks of a mesh axis.

Counterpart of ``gaussianprocessfundamentals_tpu/parallel/block_cholesky.py``:
the cyclic layout (``:40-64``), the factorisation (``_block_cholesky_local``
``:69`` and its Linv-returning form ``distributed_cholesky_factor``
``:324``), the block substitutions with and without the diagonal blocks'
inverses (``:131``, ``:165``, ``:349``, ``:378``), ``distributed_cholesky``
(``:288``), ``distributed_chol_solve`` (``:489``),
``distributed_chol_solve_inv`` (``:410``), ``distributed_posterior``
(``:464``) and ``distributed_nll`` (``:518``).

K is stored as block-rows of height B, distributed cyclically over the
``tp`` axis: block-row g lives on rank g mod P, as local block j = g // P,
so every panel step keeps every rank busy. A rank holds its block-rows as
one [nb/P, B, n] tensor (``L_loc``; gathered in rank order it is the JAX
package's ``L_cyclic``). The factorisation is one Python loop over the
nb = n/B panel steps, right-looking and in place. In step k:

* the owner of block-row k broadcasts the diagonal block;
* every rank factors it with ``torch.linalg.cholesky`` (B³/3, redundant)
  and inverts the factor;
* every rank turns its block-rows below k into the panel,
  L_ik = A_ik·L_kk⁻ᵀ, in one [live·B, B] × [B, B] product;
* the ranks all-gather the panel (the only O(n·B) message);
* every rank applies the trailing update A_ij −= L_ik·L_jkᵀ to its own
  rows, one [live·B, B] × [B, n − (k+1)B] product.

The JAX package chose between a ``fori_loop`` and a statically unrolled
body, a TPU compile-size trade; here there is one loop, and ``unroll`` is
accepted and does nothing. The GEMMs and the small factorisations are
``torch.matmul`` and ``torch.linalg``, as they were XLA's there. The
functions that take ``(kernel, x)`` build only this rank's block-rows
(:func:`cyclic_gram`, through K5/K6 on a card), so no rank holds the whole
K; those that take ``K`` take their rows of it: a copy of them from a
[n, n] K, or this rank's [nb/P, B, n] block-rows as they come from
:func:`cyclic_gram`, which are factored in place (the caller hands them
over, and they hold L afterwards), so a rank holds one copy of its share
of K, not two.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from gaussianprocessfundamentals_tpu_torch.linalg.cholesky import (
    LOG_2PI,
    cholesky_or_nan,
)
from gaussianprocessfundamentals_tpu_torch.ops.cuda_dense_gram import (
    dense_gram_for,
)
from gaussianprocessfundamentals_tpu_torch.parallel.meshes import (
    Mesh,
    all_gather_rows,
    broadcast_from,
)


def cyclic_permutation(nb: int, num_devices: int) -> np.ndarray:
    """perm[d·nb_local + j] = j·P + d: shard d receives the cyclic
    block-rows {g : g ≡ d (mod P)} in local order j = g // P."""
    if nb % num_devices:
        raise ValueError(f"{nb} block-rows do not split over {num_devices}")
    nb_local = nb // num_devices
    return np.asarray([j * num_devices + d for d in range(num_devices)
                       for j in range(nb_local)])


def to_cyclic_blocks(K: torch.Tensor, block: int, num_devices: int
                     ) -> torch.Tensor:
    """[n, n] → [nb, B, n] with block-rows permuted for cyclic sharding."""
    n = K.shape[0]
    nb = n // block
    return K.reshape(nb, block, n)[cyclic_permutation(nb, num_devices)]


def from_cyclic_blocks(A: torch.Tensor, num_devices: int) -> torch.Tensor:
    nb, block, n = A.shape
    return A[np.argsort(cyclic_permutation(nb, num_devices))].reshape(n, n)


def _layout(n: int, block: int, mesh: Mesh, axis: str) -> tuple:
    """(P, this rank's coordinate d, nb, nb_local), checking that n splits
    into whole blocks and the blocks over the ranks."""
    P = mesh.size(axis)
    if n % block or (n // block) % P:
        raise ValueError(f"n={n} must be a multiple of block·P = "
                         f"{block}·{P}")
    return P, mesh.index(axis), n // block, n // block // P


def local_blocks(n: int, block: int, mesh: Mesh, axis: str = "tp"
                 ) -> list:
    """The global block-rows g = j·P + d this rank holds, in local order."""
    P, d, _, nb_local = _layout(n, block, mesh, axis)
    return [j * P + d for j in range(nb_local)]


def _add_global_diag(A: torch.Tensor, value, gs: list) -> torch.Tensor:
    """A [nb_local, B, n] (block-rows gs) plus ``value`` on the global
    diagonal, in place: row b of block-row g gets it at column g·B + b."""
    nb_local, B, n = A.shape
    r = torch.arange(nb_local * B, device=A.device)
    g = torch.as_tensor(gs, device=A.device)
    cols = g[r // B] * B + r % B
    value = torch.as_tensor(value, dtype=A.dtype, device=A.device)
    flat = A.view(nb_local * B, n)
    flat[r, cols] += value
    return A


def cyclic_gram(kernel, x: torch.Tensor, block: int, mesh: Mesh,
                axis: str = "tp", diag_add=0.0) -> torch.Tensor:
    """This rank's block-rows [nb/P, B, n] of K(x, x) + diag_add·I, built
    from the replicated x with no communication: one
    ``dense_gram_for`` of its nb/P·B rows against x (K5 or K6 for SE and
    Matérn leaves on CUDA float32, else ``kernel.gram``), ``diag_add``
    (σ² + jitter) added at each block-row's own columns [g·B, (g+1)·B)."""
    n, dim = x.shape
    P, d, nb, nb_local = _layout(n, block, mesh, axis)
    x_loc = x.reshape(nb, block, dim)[d::P].reshape(nb_local * block, dim)
    A = dense_gram_for(kernel, x_loc, x).reshape(nb_local, block, n)
    add = torch.is_tensor(diag_add) or diag_add != 0.0
    return _add_global_diag(A, diag_add, local_blocks(n, block, mesh, axis)) \
        if add else A


def _local_rows(K: torch.Tensor, block: int, mesh: Mesh, axis: str
                ) -> torch.Tensor:
    """This rank's block-rows of K to factor in place: a copy of its rows
    of a [n, n] K, or K itself when it is already the [nb/P, B, n]
    block-rows."""
    if K.ndim == 3:
        return K
    n = K.shape[0]
    P, d, nb, _ = _layout(n, block, mesh, axis)
    return K.reshape(nb, block, n)[d::P].clone()


def _first_below(k: int, d: int, P: int) -> int:
    """The first local block-row j whose global row j·P + d is below k."""
    return (k - d) // P + 1


def _factor_inplace(A: torch.Tensor, mesh: Mesh, axis: str):
    """Right-looking block Cholesky of the cyclic block-rows A
    [nb_local, B, n], in place (A becomes L's block-rows, zeros above the
    diagonal). Returns (Linv [nb, B, B] replicated, logdet)."""
    nb_local, B, n = A.shape
    P, d, nb, _ = _layout(n, B, mesh, axis)
    A2 = A.view(nb_local * B, n)
    eye = torch.eye(B, dtype=A.dtype, device=A.device)
    Linv = A.new_empty((nb, B, B))
    logdet = torch.zeros((), dtype=A.dtype, device=A.device)
    for k in range(nb):
        owner, li = k % P, k // P
        c0, c1 = k * B, (k + 1) * B
        diag = (A[li, :, c0:c1].contiguous() if d == owner
                else A.new_empty((B, B)))
        L_kk = cholesky_or_nan(broadcast_from(diag, owner, mesh, axis))
        Li = torch.linalg.solve_triangular(L_kk, eye, upper=False)
        Linv[k] = Li
        logdet = logdet + 2.0 * torch.sum(torch.log(torch.diagonal(L_kk)))
        if d == owner:
            A[li, :, c0:c1] = L_kk
            A[li, :, c1:] = 0.0
        jf = _first_below(k, d, P)
        live = nb_local - jf
        if live > 0:
            col = A2[jf * B:, c0:c1]
            L_col = col @ Li.T  # L_ik = A_ik·L_kk⁻ᵀ
            col.copy_(L_col)
        if k + 1 == nb:
            break
        # all-gather the panel below k: local rows j ≥ k // P on every rank
        # (one shape for all), zeros where the row is not below k
        j0 = k // P
        part = A.new_zeros((nb_local - j0, B, B))
        if live > 0:
            part[jf - j0:] = L_col.view(live, B, B)
        W = all_gather_rows(part[None], mesh, axis)  # [P, nb_local − j0, B, B]
        W = W.transpose(0, 1).reshape(-1, B, B)  # global rows j0·P, j0·P+1, …
        W_trail = W[k + 1 - j0 * P:].reshape(-1, B)  # rows > k: [n − c1, B]
        if live > 0:
            A2[jf * B:, c1:].addmm_(L_col, W_trail.T, alpha=-1.0)
    return Linv, logdet


def distributed_cholesky_factor(K: torch.Tensor, mesh: Mesh,
                                axis: str = "tp", block: int = 256):
    """(L_loc [nb/P, B, n], Linv [nb, B, B] replicated, logdet): the
    factor's cyclic block-rows on this rank, the diagonal blocks'
    inverses for matmul-only substitutions, and log|K|. Block-rows given
    as K become L_loc (factored in place)."""
    A = _local_rows(K, block, mesh, axis)
    Linv, logdet = _factor_inplace(A, mesh, axis)
    return A, Linv, logdet


def distributed_cholesky(K: torch.Tensor, mesh: Mesh, axis: str = "tp",
                         block: int = 256, unroll: bool = False):
    """(L_loc, logdet): the block-cyclic Cholesky of K. Gather ``L_loc``
    with :func:`gather_cyclic` and reassemble a dense L with
    :func:`from_cyclic_blocks` to inspect it. ``unroll`` (the JAX
    package's compile-size switch) does nothing here."""
    del unroll
    L, _, logdet = distributed_cholesky_factor(K, mesh, axis, block)
    return L, logdet


def gather_cyclic(L_loc: torch.Tensor, mesh: Mesh, axis: str = "tp"
                  ) -> torch.Tensor:
    """Every rank's block-rows in rank order: the JAX package's
    ``L_cyclic`` [nb, B, n]."""
    return all_gather_rows(L_loc, mesh, axis)


def _diag_blocks(L_loc: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """The factor's diagonal blocks L_kk [nb, B, B], replicated (one
    all-gather)."""
    nb_local, B, n = L_loc.shape
    P = mesh.size(axis)
    gs = local_blocks(n, B, mesh, axis)
    mine = torch.stack([L_loc[j, :, g * B:(g + 1) * B]
                        for j, g in enumerate(gs)])
    W = all_gather_rows(mine[None], mesh, axis)  # [P, nb_local, B, B]
    return W.transpose(0, 1).reshape(nb_local * P, B, B)


def _forward(L_loc, Y, mesh, axis, solve_kk):
    """Z with L·Z = Y (Y [n, t] replicated) by block forward substitution;
    ``solve_kk(k, R)`` returns L_kk⁻¹R. One broadcast of a [B, t] partial
    sum per step."""
    nb_local, B, n = L_loc.shape
    P, d, nb, _ = _layout(n, B, mesh, axis)
    t = Y.shape[1]
    s_loc = Y.new_zeros((nb_local, B, t))
    Z = torch.empty_like(Y)
    for k in range(nb):
        owner, li = k % P, k // P
        s = s_loc[li].clone() if d == owner else Y.new_empty((B, t))
        s_k = broadcast_from(s, owner, mesh, axis)
        z_k = solve_kk(k, Y[k * B:(k + 1) * B] - s_k)
        Z[k * B:(k + 1) * B] = z_k
        jf = _first_below(k, d, P)
        if jf < nb_local and k + 1 < nb:
            s_loc[jf:] += torch.einsum(
                "jbc,ct->jbt", L_loc[jf:, :, k * B:(k + 1) * B], z_k)
    return Z


def _backward(L_loc, Z, mesh, axis, solve_kk_t):
    """X with Lᵀ·X = Z (Z [n, t] replicated) by block backward
    substitution; ``solve_kk_t(k, R)`` returns L_kk⁻ᵀR. One all-reduce of a
    [B, t] partial sum per step."""
    nb_local, B, n = L_loc.shape
    P, d, nb, _ = _layout(n, B, mesh, axis)
    t = Z.shape[1]
    x_loc = Z.new_zeros((nb_local, B, t))
    X = torch.empty_like(Z)
    for k in reversed(range(nb)):
        jf = _first_below(k, d, P)
        t_k = torch.einsum("jbc,jbt->ct", L_loc[jf:, :, k * B:(k + 1) * B],
                           x_loc[jf:]).contiguous()
        dist.all_reduce(t_k, group=mesh.group(axis))
        x_k = solve_kk_t(k, Z[k * B:(k + 1) * B] - t_k)
        X[k * B:(k + 1) * B] = x_k
        if d == k % P:
            x_loc[k // P] = x_k
    return X


def _solvers(L_loc, Linv, mesh, axis):
    """(solve_kk, solve_kk_t) from the inverses, or by triangular solves
    against the gathered diagonal blocks."""
    if Linv is not None:
        return (lambda k, R: Linv[k] @ R), (lambda k, R: Linv[k].T @ R)
    Ld = _diag_blocks(L_loc, mesh, axis)

    def solve(k, R):
        return torch.linalg.solve_triangular(Ld[k], R, upper=False)

    def solve_t(k, R):
        return torch.linalg.solve_triangular(Ld[k].T, R, upper=True)

    return solve, solve_t


def _chol_solve(L_loc, Linv, y, mesh, axis):
    vec = y.ndim == 1
    Y = y[:, None] if vec else y
    solve, solve_t = _solvers(L_loc, Linv, mesh, axis)
    X = _backward(L_loc, _forward(L_loc, Y, mesh, axis, solve), mesh, axis,
                  solve_t)
    return X[:, 0] if vec else X


def distributed_chol_solve(L_loc: torch.Tensor, y: torch.Tensor, mesh: Mesh,
                           axis: str = "tp", block: int = 256
                           ) -> torch.Tensor:
    """α = L⁻ᵀL⁻¹y from the cyclic factor (two block substitutions with
    triangular solves); ``y`` [n] or [n, t], replicated."""
    del block  # the factor's own block height
    return _chol_solve(L_loc, None, y, mesh, axis)


def distributed_chol_solve_inv(L_loc: torch.Tensor, Linv: torch.Tensor,
                               y: torch.Tensor, mesh: Mesh, axis: str = "tp",
                               block: int = 256) -> torch.Tensor:
    """α = L⁻ᵀL⁻¹y by the matmul-only substitutions of the diagonal blocks'
    inverses (:func:`distributed_cholesky_factor`); ``y`` [n] or [n, t]."""
    del block
    return _chol_solve(L_loc, Linv, y, mesh, axis)


def forward_solve_inv(L_loc: torch.Tensor, Linv: torch.Tensor,
                      Y: torch.Tensor, mesh: Mesh, axis: str = "tp"
                      ) -> torch.Tensor:
    """L⁻¹Y (forward substitution only, Y [n, t]): the posterior's
    variances come from v = L⁻¹K_s."""
    solve, _ = _solvers(L_loc, Linv, mesh, axis)
    return _forward(L_loc, Y, mesh, axis, solve)


def distributed_posterior(kernel, x: torch.Tensor, y: torch.Tensor,
                          x_test: torch.Tensor, noise, jitter, mesh: Mesh,
                          axis: str = "tp", block: int = 256):
    """The exact posterior moments through the distributed factorisation:
    μ* = K_sᵀα with α = Kₙ⁻¹y, and var* = k_ss − ‖L⁻¹K_s‖² per column,
    clamped at 0. Each rank builds only its block-rows of
    K + (σ² + jitter)·I (:func:`cyclic_gram`), factored in place in x's
    dtype; K_s [n, t] is built on every rank."""
    with torch.no_grad():
        sigma2 = torch.as_tensor(noise, dtype=x.dtype, device=x.device) + jitter
        A = cyclic_gram(kernel, x, block, mesh, axis, sigma2)
        Linv, _ = _factor_inplace(A, mesh, axis)
        K_s = dense_gram_for(kernel, x, x_test)  # [n, t]
        alpha = distributed_chol_solve_inv(A, Linv, y, mesh, axis)
        mu = K_s.T @ alpha
        V = forward_solve_inv(A, Linv, K_s, mesh, axis)
        var = kernel.diag(x_test) - torch.sum(V * V, dim=0)
    return mu, torch.clamp_min(var, 0.0)


def distributed_nll(K: torch.Tensor, y: torch.Tensor, noise, jitter,
                    mesh: Mesh, axis: str = "tp", block: int = 256,
                    unroll: bool = False) -> torch.Tensor:
    """The exact NLL through the distributed factorisation,
    ½‖L⁻¹y‖² + Σ log diag L + (n/2)·log 2π of K + (σ² + jitter)·I: only the
    forward substitution is needed for the data fit. K is [n, n] (rows
    copied) or this rank's block-rows (:func:`cyclic_gram`), which get the
    noise and are factored in place; the result is in K's dtype.
    ``unroll`` does nothing."""
    del unroll
    A = _local_rows(K, block, mesh, axis)
    n = A.shape[-1]
    _add_global_diag(A, torch.as_tensor(noise, dtype=A.dtype,
                                        device=A.device) + jitter,
                     local_blocks(n, block, mesh, axis))
    Linv, logdet = _factor_inplace(A, mesh, axis)
    z = forward_solve_inv(A, Linv, y.to(A.dtype)[:, None], mesh, axis)
    return 0.5 * torch.sum(z * z) + 0.5 * logdet + 0.5 * n * LOG_2PI
