"""Normal-Inverse-Wishart prior for Gaussian emissions (port of
``pysvihmm_tpu/distributions/niw.py``).

Parameters batch over leading axes (canonically the K hidden states):
mean (..., D), kappa (...), nu (...), psi (..., D, D).

The expected log-likelihood is a linear function of per-observation
features, ``ell_features(y) @ ell_feature_matrix(q)``, with the features
[1, y, triu(y y^T)]: F = 1 + D + D(D+1)/2 columns (45 at D=8). The same
feature array is the observation side of the emission sufficient
statistics, which the fused E-step kernels accumulate as gamma^T @ feats.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..utils.device import resolve_device
from .dirichlet import lgamma_diff, standard_gamma


class NIW(NamedTuple):
    """NIW parameters, leading axes broadcast (canonically (K,))."""

    mean: torch.Tensor  # (..., D)
    kappa: torch.Tensor  # (...,)
    nu: torch.Tensor  # (...,)
    psi: torch.Tensor  # (..., D, D)


class GaussianStats(NamedTuple):
    """Weighted Gaussian sufficient statistics sum_t w_t (1, y, y y^T)."""

    n: torch.Tensor  # (...,)
    sum_y: torch.Tensor  # (..., D)
    sum_yyT: torch.Tensor  # (..., D, D)


class EllParams(NamedTuple):
    """E_q[log N(y | mu, Sigma)] = const - 0.5 y^T P y + y . h with
    P = nu Psi^{-1}, h = P m,
    const = 0.5 (E[log|Lambda|] - D log 2pi - D / kappa) - 0.5 m^T P m."""

    P: torch.Tensor  # (..., D, D)
    h: torch.Tensor  # (..., D)
    const: torch.Tensor  # (...,)


def make_prior(
    K: int,
    D: int,
    *,
    mean: torch.Tensor | None = None,
    kappa: float = 1.0,
    nu: float | None = None,
    psi_scale: float = 1.0,
    dtype: torch.dtype = torch.float32,
    device: torch.device | str | None = None,
) -> NIW:
    """Weakly-informative NIW prior replicated over K states, on ``device``
    (the card when None)."""
    device = resolve_device(device)
    if mean is None:
        mean = torch.zeros((D,), dtype=dtype, device=device)
    mean = torch.as_tensor(mean, dtype=dtype, device=device).expand(K, D).clone()
    if nu is None:
        nu = D + 2.0
    eye = torch.eye(D, dtype=dtype, device=device)
    return NIW(
        mean=mean,
        kappa=torch.full((K,), kappa, dtype=dtype, device=device),
        nu=torch.full((K,), nu, dtype=dtype, device=device),
        psi=(eye * psi_scale).expand(K, D, D).clone(),
    )


def _mvdigamma_half(nu: torch.Tensor, D: int) -> torch.Tensor:
    """sum_{i=1..D} digamma((nu + 1 - i) / 2), batched over nu's axes."""
    i = torch.arange(1, D + 1, dtype=nu.dtype, device=nu.device)
    return torch.special.digamma((nu[..., None] + 1.0 - i) / 2.0).sum(dim=-1)


def _mv_gammaln(a: torch.Tensor, D: int) -> torch.Tensor:
    """log multivariate gamma: log Gamma_D(a)."""
    i = torch.arange(1, D + 1, dtype=a.dtype, device=a.device)
    return D * (D - 1) / 4.0 * math.log(math.pi) + torch.lgamma(
        a[..., None] + (1.0 - i) / 2.0
    ).sum(dim=-1)


def _cholesky(psi: torch.Tensor) -> torch.Tensor:
    """Cholesky factor of psi without a host synchronisation
    (``torch.linalg.cholesky`` reads its error code back to the host). As in
    JAX, a factor that does not exist comes out NaN instead of raising."""
    chol, info = torch.linalg.cholesky_ex(psi)
    return torch.where((info == 0)[..., None, None], chol, torch.nan)


def _logdet_from_chol(chol: torch.Tensor) -> torch.Tensor:
    return 2.0 * torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)).sum(dim=-1)


def ell_params(q: NIW) -> EllParams:
    D = q.mean.shape[-1]
    chol = _cholesky(q.psi)
    eye = torch.eye(D, dtype=q.psi.dtype, device=q.psi.device).expand(q.psi.shape)
    psi_inv = torch.cholesky_solve(eye, chol)
    P = q.nu[..., None, None] * psi_inv
    h = torch.einsum("...de,...e->...d", P, q.mean)
    elogdet = _mvdigamma_half(q.nu, D) + D * math.log(2.0) - _logdet_from_chol(chol)
    const = 0.5 * (
        elogdet - D * math.log(2.0 * math.pi) - D / q.kappa
    ) - 0.5 * torch.einsum("...d,...d->...", q.mean, h)
    return EllParams(P=P, h=h, const=const)


def _pair_features(y: torch.Tensor) -> torch.Tensor:
    """(..., D) -> (..., D*D) products y_d y_e at column d*D + e."""
    return (y[..., :, None] * y[..., None, :]).flatten(-2)


def _triu_features(y: torch.Tensor) -> torch.Tensor:
    """(..., D) -> (..., D(D+1)/2) products y_i y_j for i <= j, row-major."""
    D = y.shape[-1]
    return torch.cat([y[..., d : d + 1] * y[..., d:] for d in range(D)], dim=-1)


def expected_log_likelihood(q: NIW, y: torch.Tensor) -> torch.Tensor:
    """E_q[log N(y_t | mu_k, Sigma_k)] for y (..., D) and q leading (K,) -> (..., K).

    The quadratic term is one (..., D^2) @ (D^2, K) product over the pair
    features, so no (..., K, D) intermediate is built."""
    p = ell_params(q)
    D = y.shape[-1]
    quad = _pair_features(y) @ p.P.reshape(p.P.shape[0], D * D).T
    lin = y @ p.h.T
    return p.const - 0.5 * quad + lin


def ell_features(y: torch.Tensor) -> torch.Tensor:
    """(..., D) -> (..., 1 + D + D(D+1)/2) features [1, y, triu(y y^T)].

    ``expected_log_likelihood(q, y) == ell_features(y) @ ell_feature_matrix(q)``.
    The quadratic block keeps the upper triangle (with diagonal) in row-major
    (i, j >= i) order; the off-diagonal 2x lives in the weights, so the stat
    columns are the raw sums that :meth:`GaussianNIW.unpack_flat_stats`
    mirrors back to the symmetric matrix."""
    ones = torch.ones(y.shape[:-1] + (1,), dtype=y.dtype, device=y.device)
    return torch.cat([ones, y, _triu_features(y)], dim=-1)


def ell_feature_matrix(q: NIW) -> torch.Tensor:
    """(1 + D + D(D+1)/2, K) weights W with E_q[log N(y | mu_k, Sigma_k)] =
    ell_features(y) @ W (the off-diagonal P entries carry the symmetric 2x)."""
    p = ell_params(q)
    D = q.mean.shape[-1]
    iu, ju = torch.triu_indices(D, D, device=q.mean.device)
    scale = torch.where(iu == ju, 1.0, 2.0).to(p.P.dtype)
    pair_w = -0.5 * p.P[:, iu, ju] * scale  # (K, D(D+1)/2)
    return torch.cat([p.const[None, :], p.h.T, pair_w.T], dim=0)


def suff_stats(gamma: torch.Tensor, y: torch.Tensor) -> GaussianStats:
    """Expected sufficient stats: gamma (..., T, K), y (..., T, D) -> leading (..., K)."""
    n = gamma.sum(dim=-2)
    sum_y = torch.einsum("...tk,...td->...kd", gamma, y)
    D = y.shape[-1]
    sum_yyT = torch.einsum("...tk,...tf->...kf", gamma, _pair_features(y)).reshape(
        *n.shape, D, D
    )
    return GaussianStats(n=n, sum_y=sum_y, sum_yyT=sum_yyT)


def _outer(a: torch.Tensor) -> torch.Tensor:
    return a[..., :, None] * a[..., None, :]


def posterior(prior: NIW, stats: GaussianStats) -> NIW:
    """Exact conjugate mean-field update."""
    kappa_n = prior.kappa + stats.n
    nu_n = prior.nu + stats.n
    mean_n = (prior.kappa[..., None] * prior.mean + stats.sum_y) / kappa_n[..., None]
    psi_n = (
        prior.psi
        + stats.sum_yyT
        + prior.kappa[..., None, None] * _outer(prior.mean)
        - kappa_n[..., None, None] * _outer(mean_n)
    )
    return NIW(mean=mean_n, kappa=kappa_n, nu=nu_n, psi=psi_n)


class NIWNat(NamedTuple):
    eta1: torch.Tensor  # kappa * m              (..., D)
    eta2: torch.Tensor  # kappa                  (...,)
    eta3: torch.Tensor  # psi + kappa m m^T      (..., D, D)
    eta4: torch.Tensor  # nu                     (...,)


def to_natural(q: NIW) -> NIWNat:
    return NIWNat(
        eta1=q.kappa[..., None] * q.mean,
        eta2=q.kappa,
        eta3=q.psi + q.kappa[..., None, None] * _outer(q.mean),
        eta4=q.nu,
    )


def from_natural(n: NIWNat) -> NIW:
    mean = n.eta1 / n.eta2[..., None]
    return NIW(
        mean=mean,
        kappa=n.eta2,
        nu=n.eta4,
        psi=n.eta3 - n.eta2[..., None, None] * _outer(mean),
    )


def nat_grad_step(
    q: NIW,
    prior: NIW,
    stats: GaussianStats,
    scale: torch.Tensor | float,
    rho: torch.Tensor | float,
) -> NIW:
    """SVI natural-gradient step (pybasicbayes ``meanfield_sgdstep``).

    eta <- (1-rho) eta + rho (eta_prior + scale * t(stats)), where the
    sufficient-statistic map is t = (sum_y, n, sum_yyT, n). With rho=1,
    scale=1 and full-data stats this equals :func:`posterior`.
    """
    qn, pn = to_natural(q), to_natural(prior)
    blended = NIWNat(
        eta1=(1.0 - rho) * qn.eta1 + rho * (pn.eta1 + scale * stats.sum_y),
        eta2=(1.0 - rho) * qn.eta2 + rho * (pn.eta2 + scale * stats.n),
        eta3=(1.0 - rho) * qn.eta3 + rho * (pn.eta3 + scale * stats.sum_yyT),
        eta4=(1.0 - rho) * qn.eta4 + rho * (pn.eta4 + scale * stats.n),
    )
    return from_natural(blended)


def kl(q: NIW, p: NIW) -> torch.Tensor:
    """KL(NIW_q || NIW_p) per leading element: the expected Gaussian KL on
    the mean plus the Wishart KL on the precision."""
    D = q.mean.shape[-1]
    chol_q = _cholesky(q.psi)
    logdet_q = _logdet_from_chol(chol_q)
    logdet_p = _logdet_from_chol(_cholesky(p.psi))
    elogdet = _mvdigamma_half(q.nu, D) + D * math.log(2.0) - logdet_q
    psi_p = p.psi.expand(q.psi.shape)
    tr_term = torch.diagonal(
        torch.cholesky_solve(psi_p, chol_q), dim1=-2, dim2=-1
    ).sum(dim=-1)

    kl_wishart = (
        0.5 * (q.nu - p.nu) * elogdet
        - 0.5 * q.nu * D
        + 0.5 * q.nu * tr_term
        - 0.5 * (q.nu - p.nu) * D * math.log(2.0)
        + 0.5 * q.nu * logdet_q
        - 0.5 * p.nu * logdet_p
        + _mv_gammaln(p.nu / 2.0, D)
        - _mv_gammaln(q.nu / 2.0, D)
    )

    dm = q.mean - p.mean
    sol = torch.cholesky_solve(dm[..., None], chol_q)[..., 0]
    quad = q.nu * (dm * sol).sum(dim=-1)
    ratio = p.kappa / q.kappa
    kl_normal = 0.5 * (p.kappa * quad + D * (ratio - 1.0 - torch.log(ratio)))
    return kl_wishart + kl_normal


def mean_params(q: NIW) -> tuple[torch.Tensor, torch.Tensor]:
    """Posterior-mean point estimate (E[mu], E[Sigma]) for plug-in scoring."""
    D = q.mean.shape[-1]
    denom = torch.clamp_min(q.nu - D - 1.0, 1e-2)
    return q.mean, q.psi / denom[..., None, None]


def _inverse(chol: torch.Tensor) -> torch.Tensor:
    """The inverse of the matrices whose Cholesky factors are ``chol``."""
    eye = torch.eye(chol.shape[-1], dtype=chol.dtype, device=chol.device).expand(chol.shape)
    return torch.cholesky_solve(eye, chol)


def _mahalanobis(y: torch.Tensor, mean: torch.Tensor, prec: torch.Tensor) -> torch.Tensor:
    """(y - m_k)^T P_k (y - m_k) for y (..., D), mean (K, D), prec (K, D, D)
    -> (..., K), expanded into products with the pair features
    (y^T P y - 2 y^T P m + m^T P m), so no (..., K, D) intermediate is built."""
    K, D = mean.shape
    pm = torch.einsum("kde,ke->kd", prec, mean)
    return (_pair_features(y) @ prec.reshape(K, D * D).T - 2.0 * (y @ pm.T)
            + (mean * pm).sum(dim=-1))


def gaussian_log_likelihood(mu: torch.Tensor, sigma: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """log N(y_t | mu_k, Sigma_k): y (..., D), mu (K, D), sigma (K, D, D) -> (..., K)."""
    D = mu.shape[-1]
    chol = _cholesky(sigma)
    quad = _mahalanobis(y, mu, _inverse(chol))
    return -0.5 * (D * math.log(2.0 * math.pi) + _logdet_from_chol(chol) + quad)


def predictive_log_likelihood(q: NIW, y: torch.Tensor) -> torch.Tensor:
    """Exact NIW posterior predictive, a multivariate Student-t
    t_{nu'}(m, Psi (kappa + 1) / (kappa nu')) with nu' = nu - D + 1 (Murphy,
    "Conjugate Bayesian analysis of the Gaussian", eq. 232).
    y (..., D), q leading (K,) -> (..., K)."""
    D = q.mean.shape[-1]
    nu_p = q.nu - D + 1.0  # (K,)
    S = q.psi * ((q.kappa + 1.0) / (q.kappa * nu_p))[..., None, None]
    chol = _cholesky(S)
    quad = _mahalanobis(y, q.mean, _inverse(chol))
    return (
        lgamma_diff((nu_p + D) / 2.0, nu_p / 2.0)
        - 0.5 * D * torch.log(nu_p * math.pi)
        - 0.5 * _logdet_from_chol(chol)
        - 0.5 * (nu_p + D) * torch.log1p(quad / nu_p)
    )


def sample_draws(
    generator: torch.Generator, q: NIW
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The Bartlett draws :func:`sample_params` consumes, on the generator's
    device: chi2 (..., D) with chi2_i ~ chi2(nu - i), standard normals
    (..., D, D) for the strict lower triangle and (..., D) for the mean."""
    D = q.mean.shape[-1]
    i = torch.arange(D, dtype=q.nu.dtype, device=q.nu.device)
    chi2 = 2.0 * standard_gamma(generator, (q.nu[..., None] - i) / 2.0)
    normals = torch.randn(q.psi.shape, generator=generator, dtype=q.mean.dtype,
                          device=q.mean.device)
    eps = torch.randn(q.mean.shape, generator=generator, dtype=q.mean.dtype,
                      device=q.mean.device)
    return chi2, normals, eps


def params_from_draws(
    q: NIW, chi2: torch.Tensor, normals: torch.Tensor, eps: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """(mu, Sigma) from the Bartlett draws: Sigma^-1 ~ Wishart(Psi^-1, nu) as
    (C A)(C A)^T with A lower triangular (sqrt(chi2) on the diagonal, the
    normals below it) and C = chol(Psi)^-T; Sigma symmetrised; then
    mu = m + chol(Sigma) eps / sqrt(kappa)."""
    A = torch.tril(normals, -1) + torch.diag_embed(torch.sqrt(chi2))
    chol_psi = _cholesky(q.psi)
    eye = torch.eye(q.psi.shape[-1], dtype=q.psi.dtype, device=q.psi.device).expand(q.psi.shape)
    C = torch.linalg.solve_triangular(chol_psi.transpose(-1, -2), eye, upper=True)
    CA = C @ A
    sigma = torch.linalg.inv_ex(CA @ CA.transpose(-1, -2)).inverse
    sigma = 0.5 * (sigma + sigma.transpose(-1, -2))
    mu = q.mean + (_cholesky(sigma) @ eps[..., None])[..., 0] / torch.sqrt(q.kappa)[..., None]
    return mu, sigma


def sample_params(generator: torch.Generator, q: NIW) -> tuple[torch.Tensor, torch.Tensor]:
    """Draw (mu, Sigma) ~ NIW(q) per leading element (the Gibbs engine)."""
    return params_from_draws(q, *sample_draws(generator, q))
