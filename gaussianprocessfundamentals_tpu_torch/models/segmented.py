"""Segmented GPs: independent blocks fitted and served one by one, or
fitted together as one batched Cholesky.

Counterpart of ``gaussianprocessfundamentals_tpu/models/segmented.py``:
``pad_segments`` (``:31``), ``masked_nll`` (``:52``), ``segmented_nll``
(``:82``), ``fit_segments_vmapped`` (``:100``), ``BlockwiseGP`` (``:175``)
and ``PartitionedGP`` (``:237``). S segments of n/S rows cost S·O((n/S)³):
the reference's "scalability by independence". Each segment of a
``BlockwiseGP`` or ``PartitionedGP`` is a dense exact
:class:`..models.exact.GaussianProcess` on the same device, so on a card
the SE and Matérn Gram kernels (K5, K6) build every segment's Gram in
``predict`` and in ``log_marginal_likelihood``; its fit runs under
autograd on ``kernel.gram``.

The JAX package vmaps a whole Adam run over the segment axis. The port
vmaps the Gram (``torch.func.vmap`` over the stacked parameters and
inputs: one batched evaluation, each Gram differentiable from its own
slice), the S NLLs are one batched Cholesky (``cholesky_ex`` and
``cholesky_solve`` batch), and one ``torch.optim.Adam`` steps the stacked
parameters (:func:`adam_stacked`, which ``fit.fit_batch_independent``
shares). Adam acts elementwise, so each segment follows its own Adam run.
"""
from __future__ import annotations

import copy
from typing import List, Sequence, Tuple

import torch

from gaussianprocessfundamentals_tpu_torch.config import DEFAULT_CONFIG, GPConfig
from gaussianprocessfundamentals_tpu_torch.fit.transforms import (
    constrain,
    unconstrain,
)
from gaussianprocessfundamentals_tpu_torch.kernels.partition import (
    BoxPartitioning,
    PartitioningModel,
)
from gaussianprocessfundamentals_tpu_torch.linalg import cholesky as chol
from gaussianprocessfundamentals_tpu_torch.models.exact import GaussianProcess
from gaussianprocessfundamentals_tpu_torch.utils.tree import (
    tree_leaves,
    tree_map,
)


def pad_segments(xs: Sequence[torch.Tensor], ys: Sequence[torch.Tensor]
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Pad variable-length segments to a common length L: returns x
    [S, L, d], y [S, L] and mask [S, L]. Padded rows repeat the segment's
    first point with mask 0 and target 0; :func:`masked_nll` makes them
    exactly inert."""
    L = max(int(x.shape[0]) for x in xs)
    xb, yb, mb = [], [], []
    for x, y in zip(xs, ys):
        n = int(x.shape[0])
        pad = L - n
        xb.append(torch.cat([x, x[:1].expand(pad, -1)]) if pad else x)
        yb.append(torch.cat([y, y.new_zeros(pad)]) if pad else y)
        mb.append(torch.cat([x.new_ones(n), x.new_zeros(pad)]))
    return torch.stack(xb), torch.stack(yb), torch.stack(mb)


def masked_nll(K, y, mask, noise, jitter) -> torch.Tensor:
    """The NLL over the rows where ``mask`` is 1 (K [..., L, L], y and mask
    [..., L]): padded rows become decoupled diagonal rows with target 0,
    each adding log(c + σ² + jitter) to the logdet and ½·log 2π to the
    constant, both subtracted exactly.

    Two float32 points keep it equal to the unpadded NLL: the padded
    diagonal c is the mean of the real rows' diagonal, so the dtype-aware
    jitter floor (:func:`..linalg.cholesky.effective_jitter`) resolves to
    the value the unpadded factorisation would use; and the correction uses
    that effective jitter, not the raw ``jitter``."""
    m2 = mask[..., :, None] * mask[..., None, :]
    n_real = torch.clamp_min(mask.sum(dim=-1), 1.0)
    diag_K = torch.diagonal(K, dim1=-2, dim2=-1)
    c = (diag_K * mask).sum(dim=-1) / n_real
    eye = torch.eye(K.shape[-1], dtype=K.dtype, device=K.device)
    K_pad = K * m2 + (1.0 - mask[..., :, None]) * c[..., None, None] * eye
    raw = chol.nll(K_pad, y * mask, noise, jitter)
    n_pad = K.shape[-1] - mask.sum(dim=-1)
    sigma2 = (torch.as_tensor(noise, dtype=K.dtype, device=K.device)
              + chol.effective_jitter(K_pad, jitter))
    return raw - 0.5 * n_pad * (chol.LOG_2PI + torch.log(c + sigma2))


def _stacked(module, params, fn, *args) -> torch.Tensor:
    """``fn(*a)`` for every slice s of ``args`` (each [S, ...]), with slice
    s of the stacked ``params`` tree (every leaf [S, ...]) installed in
    ``module``, stacked on a leading S: one batched evaluation
    (``torch.func.vmap``), each slice differentiable from its own
    parameters. The module's installed parameters come back afterwards
    (the last slice's, when none were installed)."""
    before = module.get_params() if module.has_params() else None

    def one(p, *a):
        module.set_params(p)
        return fn(*a)

    try:
        return torch.func.vmap(one)(params, *args)
    finally:
        module.set_params(before if before is not None
                          else tree_map(lambda p: p[-1], params))


def stacked_gram(kernel, params, x: torch.Tensor) -> torch.Tensor:
    """[S, L, L] Grams of x [S, L, d], segment s at slice s of the stacked
    params tree."""
    return _stacked(kernel, params, lambda xs: kernel.gram(xs, xs), x)


def segmented_nll(kernel_segments: Sequence, params_segments, x, y, mask,
                  noise, jitter: float) -> torch.Tensor:
    """Σ of the per-segment masked NLLs as one batched Cholesky: every
    segment has ``kernel_segments[0]``'s type, with its own slice of the
    stacked ``params_segments`` (x [S, L, d], y and mask [S, L]; noise a
    scalar or [S])."""
    K = stacked_gram(kernel_segments[0], params_segments, x)
    return masked_nll(K, y, mask, noise, jitter).sum()


def fit_segments_vmapped(
    kernel,
    segments: Sequence[Tuple[torch.Tensor, torch.Tensor]],
    config: GPConfig = DEFAULT_CONFIG,
    steps: int = 300,
    lr: float = 0.05,
    optimize_noise: bool = True,
    init_noise: float = 1e-3,
    generator=None,
):
    """Fit every segment (one kernel type, independent hyperparameters) by
    Adam over the padded masked blocks as one batched program. Each
    segment starts from the kernel's defaults for its own range (or a
    random point inside the bounds drawn from ``generator``). Returns
    (kernel params stacked on a leading axis S, noises [S], the NLLs [S] of
    the last step, before its update)."""
    xs = [s[0] for s in segments]
    ys = [s[1] for s in segments]
    xb, yb, mb = pad_segments(xs, ys)
    S = xb.shape[0]
    pos = kernel.positivity()
    inits = []
    for i in range(S):
        xr = torch.stack([xs[i].min(dim=0).values, xs[i].max(dim=0).values],
                         dim=-1).cpu().numpy()
        kp = kernel.init_params(xr, xs[i].shape[0], generator, xb.dtype)
        inits.append({
            "kernel": unconstrain(pos, tree_map(lambda t: t.to(xb.device), kp)),
            "log_noise": torch.log(torch.as_tensor(init_noise, dtype=xb.dtype,
                                                   device=xb.device)),
        })
    fixed_noise = torch.full((S,), init_noise, dtype=xb.dtype, device=xb.device)
    u, final = adam_stacked(kernel, xb, yb, mb, inits, steps, lr,
                            optimize_noise, fixed_noise, config.jitter)
    with torch.no_grad():
        kp = constrain(pos, u["kernel"])
        noises = torch.exp(u["log_noise"]) if optimize_noise else fixed_noise
    return kp, noises, final


def adam_stacked(kernel, xb, yb, mb, inits, steps: int, lr: float,
                 optimize_noise: bool, fixed_noise, jitter: float,
                 mean=None):
    """Adam over S independent problems as one batched program: ``inits``
    holds one unconstrained tree per problem (``{"kernel", "log_noise"}``,
    and ``"mean"`` with a ``mean``), stacked here on a leading axis S; each
    step builds the S Grams (:func:`stacked_gram`), the S masked NLLs as
    one batched Cholesky (:func:`masked_nll`; x [S, L, d], y and mask
    [S, L]) and one Adam update of the stacked leaves. Adam acts
    elementwise, so each problem follows its own Adam run. Returns (the
    final stacked tree, detached; the S NLLs of the last step, before its
    update). ``fixed_noise`` [S] is the noise when it is not optimised."""
    pos = kernel.positivity()
    mpos = mean.positivity() if mean is not None else None
    u = tree_map(lambda *ls: torch.stack(ls).requires_grad_(True), *inits)
    opt = torch.optim.Adam(tree_leaves(u), lr=lr)
    final = None
    for _ in range(steps):
        opt.zero_grad()
        noise = torch.exp(u["log_noise"]) if optimize_noise else fixed_noise
        K = stacked_gram(kernel, constrain(pos, u["kernel"]), xb)
        resid = yb
        if mean is not None:
            resid = yb - _stacked(mean, constrain(mpos, u["mean"]),
                                  mean.mean, xb)
        nlls = masked_nll(K, resid, mb, noise, jitter)
        nlls.sum().backward()
        opt.step()
        final = nlls.detach()
    return tree_map(torch.Tensor.detach, u), final


def _own_modules(modules) -> list:
    """Each segment's own module: a module object passed for more than one
    segment is copied for every segment after its first (the port's
    modules hold their parameters, so segments cannot share one)."""
    seen, out = set(), []
    for m in modules:
        out.append(copy.deepcopy(m) if id(m) in seen else m)
        seen.add(id(m))
    return out


class BlockwiseGP:
    """A change-point segmented GP: one dense exact GP per segment of x[:, 0],
    the segments split at the sorted ``locations`` into half-open intervals
    [lo, hi). Each segment's GP gets its own copy of ``mean`` and runs on
    ``device`` (the GPU unless the caller asks for another)."""

    def __init__(self, kernels: Sequence, locations, mean=None,
                 config: GPConfig = DEFAULT_CONFIG, device="cuda"):
        locations = torch.as_tensor(locations, dtype=torch.float64
                                    ).reshape(-1).tolist()
        if locations != sorted(locations):
            raise ValueError(f"locations must be sorted, got {locations}")
        if len(kernels) != len(locations) + 1:
            raise ValueError(f"{len(locations)} locations need "
                             f"{len(locations) + 1} kernels, got {len(kernels)}")
        self.locations = locations
        self._init(kernels, BoxPartitioning(edges=tuple(locations), dim=0),
                   mean, config, device)

    def _init(self, kernels, model: PartitioningModel, mean, config, device):
        self.model = model
        self.mean = mean
        self.config = config
        self.device = torch.device(device)
        self.kernels = _own_modules(kernels)
        self.gps: List[GaussianProcess] = [
            GaussianProcess(k, None if mean is None else copy.deepcopy(mean),
                            config=config, device=self.device)
            for k in self.kernels]

    def _segment(self, x, y):
        x = torch.as_tensor(x, device=self.device)
        y = torch.as_tensor(y, device=self.device, dtype=x.dtype)
        ids = self.model.assign(x)
        return [(x[ids == p], y[ids == p]) for p in range(len(self.gps))]

    def fit(self, x, y, **kw) -> list:
        """Fit each segment's GP to its own rows (``kw`` as
        :meth:`GaussianProcess.fit`); returns the FitResults."""
        return [gp.fit(xs, ys, **kw)
                for gp, (xs, ys) in zip(self.gps, self._segment(x, y))]

    def predict(self, x_test):
        """(μ, mean-function μ, posterior μ, variance) at x_test [t, d], each
        [t] in input order, from the GP of each point's segment."""
        x_test = torch.as_tensor(x_test, device=self.device)
        ids = self.model.assign(x_test)
        out = [x_test.new_zeros(x_test.shape[0]) for _ in range(4)]
        for p, gp in enumerate(self.gps):
            sel = torch.nonzero(ids == p)[:, 0]
            if sel.numel() == 0:
                continue
            post = gp.posterior(x_test[sel])
            for o, v in zip(out, (post.mean, post.mean_fn_mu,
                                  post.posterior_mu, post.var)):
                o[sel] = v
        return tuple(out)

    def log_marginal_likelihood(self) -> float:
        """Σ of the segments' dense log marginal likelihoods."""
        return float(sum(float(gp.log_marginal_likelihood())
                         for gp in self.gps))


class PartitionedGP(BlockwiseGP):
    """A partitioned GP: as :class:`BlockwiseGP`, the segments from a
    partitioning model (:mod:`..kernels.partition`), one kernel per
    partition."""

    def __init__(self, kernels: Sequence, model: PartitioningModel,
                 mean=None, config: GPConfig = DEFAULT_CONFIG,
                 device="cuda"):
        if len(kernels) != model.num_partitions():
            raise ValueError(f"{model.num_partitions()} partitions need as "
                             f"many kernels, got {len(kernels)}")
        self._init(kernels, model, mean, config, device)

