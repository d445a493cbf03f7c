"""Exact GP posterior: the functional router and the ``GaussianProcess`` facade.

Counterpart of ``gaussianprocessfundamentals_tpu/models/exact.py``:
``Posterior`` (``:33``), the ``posterior`` router (``:44``) with the same
dense→iterative threshold, ``_posterior_dense`` (``:128``) and the
``GaussianProcess`` facade (``:192``) with ``fit`` (``:218``, the routed
:func:`..fit.fit.fit` or ``method="iterative"``), the projected-process
posterior after an approximation fit (``:273-292``),
``log_marginal_likelihood`` (``:314``) and prior and posterior sampling
(``:151-188``, ``:300-312``).

Every Gram the dense route builds goes through
:func:`..ops.cuda_dense_gram.dense_gram_for`: on a card the SE and Matérn
leaves take the Gram kernels K5 and K6, K + (σ² + jitter)·I in one pass.
Sampling takes an explicit ``torch.Generator``; its normal draws are an
argument of the inner functions (:func:`prior_draws`,
:func:`posterior_draws`), so the tests hand both packages the same numbers.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from gaussianprocessfundamentals_tpu_torch.config import DEFAULT_CONFIG, GPConfig
from gaussianprocessfundamentals_tpu_torch.fit.fit import (
    FitResult,
    iterative_fit_result,
)
from gaussianprocessfundamentals_tpu_torch.fit.fit import fit as _fit
from gaussianprocessfundamentals_tpu_torch.linalg import cholesky as chol
from gaussianprocessfundamentals_tpu_torch.linalg.nystroem import (
    nystroem_posterior,
)
from gaussianprocessfundamentals_tpu_torch.means.functions import (
    MeanFunction,
    ZeroMean,
)
from gaussianprocessfundamentals_tpu_torch.models.iterative import (
    fit_iterative,
    iterative_posterior_chunked,
)
from gaussianprocessfundamentals_tpu_torch.ops.cuda_dense_gram import (
    dense_gram_for,
    noised_gram,
)

# posterior() switches from the dense Cholesky to the matrix-free chunked
# mBCG route at this many training rows: a dense f32 K is 1.6 GB at 20k and
# 40 GB at 100k
_AUTO_ITERATIVE_POST_N = 20_000


class Posterior(NamedTuple):
    """Posterior moments at the test inputs, including the mean function."""

    mean: torch.Tensor  # [..., m]
    var: torch.Tensor  # [..., m] marginal variances
    sd: torch.Tensor  # [..., m]
    mean_fn_mu: torch.Tensor  # mean-function contribution
    posterior_mu: torch.Tensor  # GP residual posterior
    # iterative route only: CG iterations and largest true relative
    # residual per solve (see iterative_posterior_chunked's ``stats``)
    solve_stats: Optional[dict] = None


@torch.no_grad()
def posterior(
    kernel,
    x_train: torch.Tensor,
    y_train: torch.Tensor,
    x_test: torch.Tensor,
    noise,
    jitter: float = DEFAULT_CONFIG.jitter,
    mean: Optional[MeanFunction] = None,
    full_cov: bool = False,
    method: str = "auto",
):
    """Posterior moments: detrend y by the mean function, μ* = K_sᵀα and the
    marginal variances, then add the mean back at the test inputs.

    ``method``: "auto" (dense below ``_AUTO_ITERATIVE_POST_N`` training rows,
    matrix-free chunked mBCG from there on), "dense" (the Cholesky route at
    any n; the caller owns its O(n²) memory) or "iterative" (the matrix-free
    route at any n). ``full_cov=True`` takes the dense route and returns
    ``(Posterior, cov)``.
    """
    if method not in ("auto", "dense", "iterative"):
        raise ValueError(
            f"posterior(method={method!r}): one of 'auto', 'dense', 'iterative'"
        )
    mean = mean if mean is not None else ZeroMean(dim=x_train.shape[-1])
    n = x_train.shape[-2]
    want_iterative = method == "iterative" or (
        method == "auto" and n >= _AUTO_ITERATIVE_POST_N
    )
    if method == "iterative" and (full_cov or x_train.ndim != 2):
        raise ValueError(
            "posterior(method='iterative') supports marginal variances on "
            "unbatched inputs only (full_cov=False, x_train [n, d])"
        )
    if want_iterative and not full_cov and x_train.ndim == 2:
        resid = y_train - mean.mean(x_train)
        stats = {}
        post_mu, var = iterative_posterior_chunked(
            kernel, x_train, resid, x_test,
            torch.as_tensor(noise, dtype=x_train.dtype,
                            device=x_train.device) + jitter,
            stats=stats,
        )
        mean_mu = mean.mean(x_test)
        return Posterior(mean_mu + post_mu, var, torch.sqrt(var), mean_mu,
                         post_mu, stats)
    return _posterior_dense(kernel, x_train, y_train, x_test, noise, jitter,
                            mean, full_cov)


def _posterior_dense(kernel, x_train, y_train, x_test, noise, jitter, mean,
                     full_cov):
    resid = y_train - mean.mean(x_train)
    state = chol.factor_noised(noised_gram(kernel, x_train, noise, jitter),
                               resid)
    K_s = dense_gram_for(kernel, x_train, x_test)
    post_mu = chol.posterior_mean(state, K_s)
    mean_mu = mean.mean(x_test)
    if full_cov:
        cov = chol.posterior_cov(state, K_s,
                                 dense_gram_for(kernel, x_test, x_test))
        var = torch.diagonal(cov, dim1=-2, dim2=-1)
        sd = torch.sqrt(torch.clamp_min(var, 0.0))
        return Posterior(mean_mu + post_mu, var, sd, mean_mu, post_mu), cov
    var = torch.clamp_min(
        chol.posterior_var(state, K_s, kernel.diag(x_test)), 0.0
    )
    return Posterior(mean_mu + post_mu, var, torch.sqrt(var), mean_mu, post_mu)


def _cholesky_escalating(A: torch.Tensor, jitter: float, retries: int,
                         carried: float = 0.0) -> torch.Tensor:
    """The lower Cholesky factor of A + j·I for the first j in jitter·10ᵏ,
    k = 0..retries, whose factorisation succeeds, as ``fit`` escalates the
    NLL's jitter; ``carried`` is what A's diagonal already holds. In
    float64 the first try succeeds for a positive-definite A; a float32
    posterior covariance K_ss − vᵀv carries O(eps·k_ss) rounding that the
    first jitters do not cover."""
    j = jitter
    for _ in range(retries + 1):
        shifted = A if j == carried else chol.add_diag(A, j - carried)
        L, info = torch.linalg.cholesky_ex(shifted)
        if not bool((info != 0).any()):
            return L
        j *= 10.0
    raise torch.linalg.LinAlgError(
        f"no Cholesky factor up to jitter {j / 10.0:.1e}: the covariance is "
        "not positive definite at this precision")


def prior_draws(kernel, x: torch.Tensor, z: torch.Tensor,
                jitter: float = DEFAULT_CONFIG.jitter,
                retries: int = DEFAULT_CONFIG.max_jitter_retries):
    """f = L·z with L = chol(K(x, x) + jitter·I): z [s, n] standard-normal
    draws → [s, n]."""
    K = dense_gram_for(kernel, x, x, jitter)
    L = _cholesky_escalating(K, jitter, retries, carried=jitter)
    return torch.einsum("nm,sm->sn", L, z)


def _normal(shape, generator, like: torch.Tensor) -> torch.Tensor:
    dev = generator.device if generator is not None else like.device
    return torch.randn(shape, generator=generator, dtype=like.dtype,
                       device=dev).to(like.device)


@torch.no_grad()
def sample_prior(kernel, x: torch.Tensor, generator=None,
                 num_samples: int = 1, jitter: float = DEFAULT_CONFIG.jitter):
    """f ~ N(0, K(x, x)): ``num_samples`` draws [s, n], the normals from
    ``generator`` (or the global stream of x's device)."""
    return prior_draws(kernel, x, _normal((num_samples, x.shape[-2]),
                                          generator, x), jitter)


def posterior_draws(kernel, x_train, y_train, x_test, noise, z,
                    jitter: float = DEFAULT_CONFIG.jitter, mean=None,
                    retries: int = DEFAULT_CONFIG.max_jitter_retries):
    """f* = μ* + L·z with L = chol(Σ* + jitter·I) of the dense posterior at
    x_test: z [s, t] standard-normal draws → [s, t]."""
    post, cov = posterior(kernel, x_train, y_train, x_test, noise, jitter,
                          mean, full_cov=True)
    L = _cholesky_escalating(cov, jitter, retries)
    return post.mean + torch.einsum("nm,sm->sn", L, z)


@torch.no_grad()
def sample_posterior(kernel, x_train, y_train, x_test, noise, generator=None,
                     num_samples: int = 1,
                     jitter: float = DEFAULT_CONFIG.jitter, mean=None):
    """f* ~ N(μ*, Σ*) at x_test: ``num_samples`` draws [s, t], the normals
    from ``generator`` (or the global stream of x's device)."""
    z = _normal((num_samples, x_test.shape[-2]), generator, x_test)
    return posterior_draws(kernel, x_train, y_train, x_test, noise, z,
                           jitter, mean)


def _check_matmul_precision(config: GPConfig) -> None:
    """The CUDA path needs full-float32 matmuls: TF32 keeps about three
    decimal digits, too few for CG and Cholesky."""
    if (torch.get_float32_matmul_precision() != config.matmul_precision
            or torch.backends.cuda.matmul.allow_tf32):
        raise RuntimeError(
            "float32 matmuls may use TF32: call torch.set_float32_matmul_"
            f"precision({config.matmul_precision!r}) and set "
            "torch.backends.cuda.matmul.allow_tf32 = False before fitting "
            "or serving posteriors on a GPU"
        )


class GaussianProcess:
    """Stateful facade: kernel + mean + noise + training data on one
    ``device`` (the GPU unless the caller asks for another), with ``fit``,
    ``posterior``, ``predict`` and ``log_marginal_likelihood``.

    The kernel and mean modules hold their hyperparameters (``fit`` installs
    them; or set them with ``set_params`` or
    :func:`..utils.checkpoint.params_from_numpy`); unset ones get the
    kernel's defaults for the training range, and an unset ``noise``
    defaults to the jitter.

    After a fit with an approximation objective, ``approximation`` names
    it and ``inducing`` holds the fitted inducing inputs; ``posterior``
    (marginal variances) then serves the O(nm²) projected-process
    predictive through them.
    """

    def __init__(self, kernel, mean: Optional[MeanFunction] = None,
                 config: GPConfig = DEFAULT_CONFIG, noise=None,
                 device="cuda"):
        self.device = torch.device(device)
        self.kernel = kernel.to(self.device)
        self.mean = (mean if mean is not None else ZeroMean()).to(self.device)
        self.config = config
        self.noise = noise
        self.x_train = None
        self.y_train = None
        self.inducing = None
        self.approximation = None

    def set_data(self, x_train, y_train) -> "GaussianProcess":
        self.x_train = torch.as_tensor(x_train, device=self.device)
        self.y_train = torch.as_tensor(y_train, device=self.device,
                                       dtype=self.x_train.dtype)
        return self

    def fit(self, x_train=None, y_train=None, **kwargs) -> FitResult:
        """Fit the hyperparameters to the training data (given here or by
        ``set_data``) and install them. ``method="iterative"`` runs
        :func:`..models.iterative.fit_iterative` with ``kwargs`` (its
        ``generator`` draws the probes); any other call is
        :func:`..fit.fit.fit` with ``kwargs``, ``method="auto"`` routing
        between the dense and the iterative NLL, and ``approximation=…``
        setting :attr:`approximation` and :attr:`inducing`."""
        if x_train is not None:
            self.set_data(x_train, y_train)
        if self.x_train is None:
            raise ValueError("no training data: call fit(x, y) or set_data")
        if self.device.type == "cuda":
            _check_matmul_precision(self.config)
        x, y = self.x_train, self.y_train
        if kwargs.get("method") == "iterative":
            kwargs.pop("method")
            kwargs.pop("return_diagnostics", None)
            generator = kwargs.pop("generator", None)
            mean = None if type(self.mean) is ZeroMean else self.mean
            res = iterative_fit_result(
                fit_iterative(self.kernel, x, y, generator, mean=mean,
                              return_diagnostics=True, **kwargs),
                mean is not None)
        else:
            res = _fit(self.kernel, x, y, mean=self.mean, config=self.config,
                       **kwargs)
        self.approximation = kwargs.get("approximation")
        self.inducing = res.inducing
        self.noise = res.noise
        return res

    @torch.no_grad()
    def log_marginal_likelihood(self) -> torch.Tensor:
        """The dense log marginal likelihood of the training data at the
        installed hyperparameters (an [n, n] Gram: small n)."""
        self._ensure_params()
        resid = self.y_train - self.mean.mean(self.x_train)
        Kn = noised_gram(self.kernel, self.x_train, self.noise,
                         self.config.jitter)
        return chol.mll_noised(Kn, resid)

    def _ensure_params(self):
        if self.x_train is None:
            raise ValueError(
                "no training data attached: call set_data(x, y) before "
                "predict/posterior"
            )
        dt = self.x_train.dtype
        for module in (self.kernel, self.mean):
            if not module.has_params():
                xr = torch.stack([self.x_train.min(dim=0).values,
                                  self.x_train.max(dim=0).values], dim=-1)
                module.set_params(module.init_params(
                    xr.cpu().numpy(), self.x_train.shape[0], dtype=dt
                ))
            module.to(device=self.device, dtype=dt)
        if self.noise is None:
            self.noise = self.config.jitter

    def posterior(self, x_test, full_cov: bool = False, method: str = "auto"):
        """Posterior moments at x_test (:func:`posterior`); after an
        approximation fit the projected-process predictive through the
        fitted inducing inputs (:func:`..linalg.nystroem.nystroem_posterior`
        on the mean's residual, the mean added back), unless ``full_cov``
        asks for the exact dense covariance."""
        self._ensure_params()
        if self.device.type == "cuda":
            _check_matmul_precision(self.config)
        if self.approximation is not None and not full_cov:
            with torch.no_grad():
                resid = self.y_train - self.mean.mean(self.x_train)
                xt = self._as_x(x_test)
                mu, var = nystroem_posterior(
                    self.kernel, self.x_train, resid, self.inducing, xt,
                    self.noise, self.config.jitter)
                mean_mu = self.mean.mean(xt)
            return Posterior(mean_mu + mu, var, torch.sqrt(var), mean_mu, mu)
        return posterior(
            self.kernel, self.x_train, self.y_train, self._as_x(x_test),
            self.noise, self.config.jitter, self.mean, full_cov=full_cov,
            method=method,
        )

    def predict(self, x_test):
        """(full μ, mean-function μ, posterior μ), the reference's triple."""
        post = self.posterior(x_test)
        return post.mean, post.mean_fn_mu, post.posterior_mu

    def _as_x(self, x):
        return torch.as_tensor(x, device=self.device, dtype=self.x_train.dtype)

    def sample_prior(self, x, generator=None, num_samples: int = 1):
        """Draws [s, n] of the prior at x (the kernel only, no mean)."""
        self._ensure_params()
        if self.device.type == "cuda":
            _check_matmul_precision(self.config)
        return sample_prior(self.kernel, self._as_x(x), generator,
                            num_samples, self.config.jitter)

    def sample_posterior(self, x_test, generator=None, num_samples: int = 1):
        """Draws [s, t] of the dense posterior at x_test, mean included."""
        self._ensure_params()
        if self.device.type == "cuda":
            _check_matmul_precision(self.config)
        return sample_posterior(
            self.kernel, self.x_train, self.y_train, self._as_x(x_test),
            self.noise, generator, num_samples, self.config.jitter, self.mean)
