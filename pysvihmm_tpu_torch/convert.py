"""Carry HMM parameters between the JAX package and the port as NumPy arrays.

The JAX package's ``HMMParams`` (``init`` (K,), ``trans`` (K, K) and
``emit``) is read by attribute, so this module needs neither JAX nor the JAX
package: any object with those attributes whose leaves convert with
``numpy.asarray`` will do. ``emit`` is read by its field names: those of
``NIW`` (mean, kappa, nu, psi), ``NIG`` (mean, kappa, a, b) or ``GammaP``
(a, b); anything without fields is the multinomial's plain (K, V) array. SVI
states carry their params, step count and adaptive step-size state the same
way; the PRNG key does not cross (JAX's and torch's generators give
different numbers), so the port's state takes a ``torch.Generator`` seeded
on its own. Like the port's other entry points, the converters put their
tensors on the card unless given ``device="cpu"``.
"""

from __future__ import annotations

import numpy as np
import torch

from .distributions.diag_gaussian import NIG
from .distributions.niw import NIW
from .distributions.poisson import GammaP
from .engines.svi import SVIState
from .models.hmm import HMMParams
from .utils.device import resolve_device
from .utils.schedules import AdaptiveState


_EMIT_TYPES = {cls._fields: cls for cls in (NIW, NIG, GammaP)}


def _emit_map(emit, fn):
    """``emit`` with ``fn`` applied to each leaf, as the port's emission type."""
    fields = getattr(emit, "_fields", None)
    if fields is None:
        return fn(emit)
    if fields not in _EMIT_TYPES:
        raise ValueError(f"unknown emission parameters with fields {fields}")
    return _EMIT_TYPES[fields](*(fn(getattr(emit, f)) for f in fields))


def params_from_numpy(
    params, device: torch.device | str | None = None, dtype: torch.dtype = torch.float32
) -> HMMParams:
    """JAX-package (or NumPy-leaved) params of any of the four families ->
    the port's params, on ``device`` (the card when None)."""
    device = resolve_device(device)

    def t(x):
        return torch.tensor(np.asarray(x), dtype=dtype, device=device)

    return HMMParams(init=t(params.init), trans=t(params.trans), emit=_emit_map(params.emit, t))


def params_to_numpy(params: HMMParams) -> HMMParams:
    """The port's params -> the same structure with NumPy leaves (on the host),
    which :func:`params_from_numpy` reads back exactly."""

    def a(x):
        return x.detach().cpu().numpy()

    return HMMParams(init=a(params.init), trans=a(params.trans), emit=_emit_map(params.emit, a))


def svi_state_from_numpy(
    state,
    generator: torch.Generator,
    device: torch.device | str | None = None,
    dtype: torch.dtype = torch.float32,
) -> SVIState:
    """A JAX-package (or NumPy-leaved) ``SVIState`` -> the port's, on
    ``device`` (the card when None), with ``generator`` in place of the key."""
    device = resolve_device(device)
    adapt = state.adapt
    if adapt is not None:
        adapt = AdaptiveState(*(
            torch.tensor(np.asarray(x), dtype=dtype, device=device) for x in adapt
        ))
    return SVIState(
        params=params_from_numpy(state.params, device=device, dtype=dtype),
        step=torch.tensor(int(np.asarray(state.step)), dtype=torch.int32, device=device),
        generator=generator,
        adapt=adapt,
    )


def svi_state_to_numpy(state: SVIState) -> SVIState:
    """The port's SVI state -> the same structure with NumPy leaves (params,
    step, adaptive state) and no generator."""
    adapt = state.adapt
    if adapt is not None:
        adapt = AdaptiveState(*(x.detach().cpu().numpy() for x in adapt))
    return SVIState(
        params=params_to_numpy(state.params),
        step=state.step.detach().cpu().numpy(),
        generator=None,
        adapt=adapt,
    )
