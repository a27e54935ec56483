"""Canonical default parameter set (the splatted-dict config contract).

The same dict as ``baryonification_tpu.default_params``: both packages
take it verbatim, so one parameter dict drives the JAX reference and the
port alike.

    from baryonification_tpu_torch import default_params
    prof = DarkMatterBaryon(**default_params())
"""

import numpy as np

__all__ = ["DEFAULT_PARAMS", "default_params"]

#: Canonical parameters (the BaryonForge example configuration).
DEFAULT_PARAMS = {
    # displacement / profile truncation
    "epsilon_max": 20,          # runner cutoff radius, units of R_Delta
    "epsilon": 4.0,             # CollisionlessMatter truncation
    "cutoff": np.inf,           # real-space profile cutoff [Mpc]
    "proj_cutoff": 1000,        # projection integral cutoff [Mpc]
    # gas shape (Schneider+19 eq. 2.12)
    "theta_ej": 4, "theta_co": 0.1, "M_c": 1e14, "mu_beta": 0.1,
    "gamma": 2.5, "delta": 7,
    "mu_theta_ej": 0.1, "mu_theta_co": 0.0,
    "M_theta_ej": 5e13, "M_theta_co": 5e13, "M_gamma": 5e13, "M_delta": 5e13,
    # gas/star mass fractions (Schneider+19 eq. 2.13-2.15)
    "eta": 0.3, "eta_delta": 0.1, "tau": -1.5, "tau_delta": 0,
    "A": 0.055, "M1": 3e11, "epsilon_h": 0.015,
    # relaxation + Sheth-Tormen
    "a": 0.3, "n": 2.0, "p": 0.3, "q": 0.707,
    # concentration override (None -> Diemer15)
    "cdelta": None,
    # non-thermal pressure fraction (Green+20)
    "alpha_nt": 0.2, "nu_nt": 0.5, "gamma_nt": 0.5,
}


def default_params(**overrides):
    """A fresh copy of :data:`DEFAULT_PARAMS` with optional overrides.

    >>> par = default_params(M_c=10**13.8, theta_ej=6)
    """
    out = dict(DEFAULT_PARAMS)
    unknown = set(overrides) - set(out)
    if unknown:
        raise TypeError(f"unknown parameter(s): {sorted(unknown)}")
    out.update(overrides)
    return out
