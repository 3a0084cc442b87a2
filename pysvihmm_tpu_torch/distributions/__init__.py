from . import diag_gaussian, dirichlet, niw, poisson
from .diag_gaussian import NIG, DiagGaussianStats
from .emissions import DiagonalGaussianNIG, GaussianNIW, MultinomialDirichlet, PoissonGamma
from .niw import NIW, GaussianStats
from .poisson import GammaP, PoissonStats

__all__ = [
    "diag_gaussian",
    "dirichlet",
    "niw",
    "poisson",
    "DiagGaussianStats",
    "DiagonalGaussianNIG",
    "GammaP",
    "GaussianNIW",
    "GaussianStats",
    "MultinomialDirichlet",
    "NIG",
    "NIW",
    "PoissonGamma",
    "PoissonStats",
]
