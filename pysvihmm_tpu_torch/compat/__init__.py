"""Reference-shaped class API (port of ``pysvihmm_tpu/compat``).

The reference exposes engine classes constructed with the observations and
priors, carrying ``var_init / var_tran / var_emit`` attributes and an
``.infer()`` loop. This module wraps the port's functional engines in that
shape:

    from pysvihmm_tpu_torch.compat import VBHMM, SVIHMM
    m = VBHMM(obs, K=4).infer(maxit=50)           # on the card
    m = VBHMM(obs, K=4, device="cpu").infer(maxit=50)
    m.elbo_history; m.var_tran; m.decode(); m.hamming_dist(z_true)

Each constructor takes NumPy arrays or tensors and puts them on ``device``
(the card when None); float observations take torch's default float dtype
(float32), integer ones are the multinomial's symbols. Seeds become
``torch.Generator``s on that device.

Engines: VBHMM (hmmbatchcd), SGDHMM (hmmbatchsgd), SVIHMM (hmmsvi),
MinibatchSVIHMM, MetaObsHMM (hmmsgd_metaobs), GibbsHMM.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import messages
from ..distributions import MultinomialDirichlet
from ..engines import batch_sgd, batch_vb, gibbs, metaobs, svi
from ..engines.base import (
    FEATURE_ROUTES,
    batch_local_step,
    lower_bound,
    predictive_log_likelihood,
    prepare_fused_obs,
    viterbi_decode,
)
from ..engines.base import decode as _decode
from ..eval.metrics import hamming_error
from ..models.hmm import init_params, make_prior, resolve_emission
from ..utils.device import resolve_device


def _numpy(x):
    """A tensor, or a NamedTuple of them, as NumPy on the host."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return type(x)(*(_numpy(v) for v in x))


class _HMMBase:
    """Shared constructor and accessors (the reference's ``VariationalHMMBase``)."""

    def __init__(
        self,
        obs,
        K: int,
        *,
        emission: str | None = None,
        num_symbols: int | None = None,
        alpha_init: float = 1.0,
        alpha_tran: float = 1.0,
        seed: int = 0,
        device: torch.device | str | None = None,
        **emission_kw,
    ):
        self.device = resolve_device(device)
        obs = self._as_obs(obs)
        is_int = not obs.is_floating_point()
        if obs.ndim == 1 or (obs.ndim == 2 and not is_int):
            obs = obs[None]  # one sequence: (T,) symbols or (T, D) floats
        self.obs = obs
        self.K = K

        if emission is None:
            emission = "multinomial" if is_int else "gaussian"
        self.emission = resolve_emission(emission)
        if self.emission is MultinomialDirichlet:
            V = num_symbols if num_symbols is not None else int(obs.max()) + 1
            size_kw = dict(num_symbols=V)
        else:
            size_kw = dict(obs_dim=obs.shape[-1])
        self.prior = make_prior(K, self.emission, alpha_init=alpha_init, alpha_tran=alpha_tran,
                                device=self.device, **size_kw, **emission_kw)
        self.params = init_params(self._generator(seed), self.prior, self.emission, obs)
        self.elbo_history: list[float] = []

    def _as_obs(self, x) -> torch.Tensor:
        """x on the device: floats in torch's default float dtype, ints as int64."""
        x = (x.to(self.device) if isinstance(x, torch.Tensor)
             else torch.tensor(np.asarray(x), device=self.device))
        return x.to(torch.get_default_dtype()) if x.is_floating_point() else x.long()

    def _generator(self, seed: int) -> torch.Generator:
        return torch.Generator(self.device).manual_seed(seed)

    # reference-named accessors -------------------------------------------
    @property
    def var_init(self) -> np.ndarray:
        return _numpy(self.params.init)

    @property
    def var_tran(self) -> np.ndarray:
        return _numpy(self.params.trans)

    @property
    def var_emit(self):
        return _numpy(self.params.emit)

    def lower_bound(self) -> float:
        return float(lower_bound(self.params, self.prior, self.emission, self.obs))

    def full_local_update(self) -> np.ndarray:
        _, gamma = batch_local_step(self.params, self.emission, self.obs)
        return _numpy(gamma)

    def decode(self) -> np.ndarray:
        return _numpy(_decode(self.params, self.emission, self.obs))

    def viterbi(self) -> np.ndarray:
        return _numpy(viterbi_decode(self.params, self.emission, self.obs))

    def hamming_dist(self, true_states) -> float:
        return hamming_error(self.decode(), true_states, self.K)

    def pred_logprob(self, held_out) -> float:
        held = self._as_obs(held_out)
        if held.ndim == self.obs.ndim - 1:
            held = held[None]
        n_obs = held.numel() if self.emission is MultinomialDirichlet else held[..., 0].numel()
        return float(predictive_log_likelihood(self.params, self.emission, held)) / n_obs


class VBHMM(_HMMBase):
    """Batch coordinate-ascent VB (reference ``hmmbatchcd.VBHMM``)."""

    def infer(self, maxit: int = 100, tol: float = 1e-8, method: str = "auto",
              restarts: int = 1, seed: int = 0):
        """Up to ``maxit`` iterations, stopping once the ELBO changes by less
        than ``tol`` relative (one host read an iteration). ``restarts > 1``:
        best of that many seeds by final ELBO, each run the full maxit."""
        if restarts > 1:
            params, elbos, best = batch_vb.fit_restarts(
                self._generator(seed), self.prior, self.obs, self.emission,
                num_iters=maxit, num_restarts=restarts, method=method,
            )
            self.elbo_history = elbos[best].tolist()
            self.params = params
            return self
        method = messages.resolve_method(method, self.obs.device)
        prepared = (prepare_fused_obs(self.params, self.emission, self.obs, method=method)
                    if method in FEATURE_ROUTES else None)
        step = batch_vb.make_step(self.emission, method)
        params, elbos = self.params, []
        for _ in range(maxit):
            params, elbo = step(params, self.prior, self.obs, prepared=prepared)
            elbos.append(float(elbo))
            if len(elbos) > 1 and abs(elbos[-1] - elbos[-2]) < tol * abs(elbos[-2]):
                break
        self.elbo_history = elbos
        self.params = params
        return self


class SGDHMM(_HMMBase):
    """Full-data natural-gradient VB (reference ``hmmbatchsgd``)."""

    def __init__(self, obs, K, *, tau: float = 1.0, kappa: float = 0.6, **kw):
        super().__init__(obs, K, **kw)
        self.tau, self.kappa = tau, kappa

    def infer(self, maxit: int = 100, method: str = "auto"):
        params, elbos = batch_sgd.fit(
            self.params, self.prior, self.obs, self.emission,
            num_iters=maxit, tau=self.tau, kappa=self.kappa, method=method,
        )
        self.elbo_history = elbos.tolist()
        self.params = params
        return self


class SVIHMM(_HMMBase):
    """SVI over buffered subchains of one long chain (reference ``hmmsvi.SVIHMM``)."""

    def __init__(
        self, obs, K, *, batch_size: int = 32, subchain_len: int = 50,
        buffer: int | str = 10, tau: float = 1.0, kappa: float = 0.6, **kw,
    ):
        super().__init__(obs, K, **kw)
        if self.obs.shape[0] != 1:
            raise ValueError("SVIHMM expects a single long chain; use MinibatchSVIHMM for "
                             "sequence collections")
        self._auto_buffer = buffer == "auto"
        if self._auto_buffer:
            # paper §3.2 adaptive buffering at the initial params; re-selected
            # during infer() when rebuffer_every is set
            buffer = svi.select_buffer(self.params, self.obs[0], self.emission, subchain_len,
                                       self._generator(0))
        self.cfg = svi.SVIConfig(batch_size=batch_size, subchain_len=subchain_len,
                                 buffer=buffer, tau=tau, kappa=kappa)

    def infer(self, maxit: int = 500, method: str = "auto", seed: int = 0,
              restarts: int = 1, rebuffer_every: int | None = None):
        """Run maxit SVI steps.

        rebuffer_every: with ``buffer="auto"``, re-run the doubling test
        against the current params every this many steps and continue with
        the buffer it selects (the step count carries across segments).
        Ignored for fixed buffers.
        """
        chain = self.obs[0]
        if restarts > 1:
            # best of N seeds by the exact full-chain ELBO
            state, elbos, best = svi.fit_restarts(
                self._generator(seed), self.prior, chain, self.emission,
                self.cfg, maxit, num_restarts=restarts, method=method,
            )
            self.params = state.params
            self.elbo_history.append(float(elbos[best]))
            return self
        state = svi.init_state(self.params, self._generator(seed))
        state = state._replace(step=torch.tensor(len(self.elbo_history), dtype=torch.int32,
                                                 device=self.device))
        segment = maxit if not (self._auto_buffer and rebuffer_every) else rebuffer_every
        done = 0
        rebuffer = self._generator(seed + 1)
        while done < maxit:
            n = min(segment, maxit - done)
            state, metrics = svi.fit(state, self.prior, chain, self.emission, self.cfg, n,
                                     method)
            self.elbo_history += metrics["noisy_elbo"].tolist()
            done += n
            if done < maxit:
                b = svi.select_buffer(state.params, chain, self.emission,
                                      self.cfg.subchain_len, rebuffer)
                if b != self.cfg.buffer:
                    self.cfg = self.cfg._replace(buffer=b)
        self.params = state.params
        return self


class MinibatchSVIHMM(_HMMBase):
    """SVI over minibatches of whole sequences (sequence-collection regime)."""

    def __init__(self, obs, K, *, batch_size: int = 32, tau: float = 1.0,
                 kappa: float = 0.6, **kw):
        super().__init__(obs, K, **kw)
        self.cfg = svi.SVIConfig(batch_size=batch_size, tau=tau, kappa=kappa)

    def infer(self, maxit: int = 500, method: str = "auto", seed: int = 0):
        state = svi.init_state(self.params, self._generator(seed))
        state, metrics = svi.fit_minibatch(state, self.prior, self.obs, self.emission,
                                           self.cfg, maxit, method)
        self.elbo_history += metrics["noisy_elbo"].tolist()
        self.params = state.params
        return self


class MetaObsHMM(_HMMBase):
    """Parallel meta-observation SVI (reference ``hmmsgd_metaobs``)."""

    def __init__(self, obs, K, *, minibatch: int = 8, block_len: int = 100,
                 buffer: int = 10, tau: float = 1.0, kappa: float = 0.6, **kw):
        super().__init__(obs, K, **kw)
        if self.obs.shape[0] != 1:
            raise ValueError("MetaObsHMM expects a single long chain")
        self.cfg = metaobs.MetaObsConfig(minibatch=minibatch, block_len=block_len,
                                         buffer=buffer, tau=tau, kappa=kappa)

    def infer(self, maxit: int = 500, method: str = "auto", seed: int = 0):
        state = svi.init_state(self.params, self._generator(seed))
        state, metrics = metaobs.fit(state, self.prior, self.obs[0], self.emission, self.cfg,
                                     maxit, method)
        self.params = state.params
        self.elbo_history += metrics["noisy_elbo"].tolist()
        return self


class GibbsHMM(_HMMBase):
    """Blocked Gibbs comparison sampler (FFBS and conjugate draws)."""

    def infer(self, maxit: int = 100, seed: int = 0):
        state = gibbs.init_state(self._generator(seed), self.prior, self.emission, self.obs,
                                 self.K)
        state, metrics = gibbs.run(state, self.prior, self.obs, self.emission, self.K, maxit)
        self.state = state
        self.elbo_history += metrics["marginal_loglik"].tolist()
        return self

    def decode(self) -> np.ndarray:
        if hasattr(self, "state"):
            return _numpy(self.state.z)
        return super().decode()


# Reference module-name aliases.
hmmbatchcd = VBHMM
hmmbatchsgd = SGDHMM
hmmsvi = SVIHMM
hmmsgd_metaobs = MetaObsHMM

__all__ = [
    "VBHMM", "SGDHMM", "SVIHMM", "MinibatchSVIHMM", "MetaObsHMM", "GibbsHMM",
    "hmmbatchcd", "hmmbatchsgd", "hmmsvi", "hmmsgd_metaobs",
]
