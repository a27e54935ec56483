"""Flat w0-CDM cosmology with lookup tables on a chosen device.

The port of ``baryonification_tpu.cosmology.background.Cosmology``:
H(a), comoving and angular-diameter distances, linear growth, critical
and matter densities, the linear and nonlinear (halofit) matter power
spectra, sigma(M), the slope of the linear power spectrum and the linear
matter correlation function xi_mm(r), as closed forms or lookups into
tables built once per instance.

Precision: the tables are float64 and are built on ``device``. The JAX
package builds them on the host CPU because a TPU has no native float64;
an H100 has, so on CUDA the tables are built on the card and never leave
it.
"""

import math

import torch

from .. import constants as const
from ..ops.fftlog import fftlog_transform
from ..utils import geomspace, interp, resolve_device
from .power import eh98_transfer, halofit_pk, sigma_tophat

__all__ = ["Cosmology", "CosmologyDevice", "cosmology_device"]


def _growth_ode(lna_grid, Om, Or, Ok, Ol, w0):
    """Linear growth D(a): RK4 integration of the standard ODE in ln a.

    D'' + (2 + dlnE/dlna) D' = 1.5 Omega_m(a) D, with the Meszaros
    growing-mode initial condition at the grid start. The state is two
    scalars, so the 2047 steps run on Python floats (the ``lax.scan`` of
    the JAX package); ``lna_grid`` is a list of floats.
    """
    def E2(lna):
        a = math.exp(lna)
        return (Om * a**-3 + Or * a**-4 + Ok * a**-2
                + Ol * a ** (-3.0 * (1.0 + w0)))

    def dlnE2_dlna(lna):
        a = math.exp(lna)
        return (-3.0 * Om * a**-3 - 4.0 * Or * a**-4 - 2.0 * Ok * a**-2
                - 3.0 * (1.0 + w0) * Ol * a ** (-3.0 * (1.0 + w0)))

    def rhs(lna, D, Dp):
        e2 = E2(lna)
        damp = 2.0 + 0.5 * dlnE2_dlna(lna) / e2
        source = 1.5 * Om * math.exp(-3.0 * lna) / e2
        return Dp, -damp * Dp + source * D

    a0 = math.exp(lna_grid[0])
    a_eq = Or / Om
    D, Dp = 1.0 + 1.5 * a0 / a_eq, 1.5 * a0 / a_eq
    h = lna_grid[1] - lna_grid[0]
    out = [D]
    for lna in lna_grid[:-1]:
        k1 = rhs(lna, D, Dp)
        k2 = rhs(lna + 0.5 * h, D + 0.5 * h * k1[0], Dp + 0.5 * h * k1[1])
        k3 = rhs(lna + 0.5 * h, D + 0.5 * h * k2[0], Dp + 0.5 * h * k2[1])
        k4 = rhs(lna + h, D + h * k3[0], Dp + h * k3[1])
        D = D + (h / 6.0) * (k1[0] + 2.0 * k2[0] + 2.0 * k3[0] + k4[0])
        Dp = Dp + (h / 6.0) * (k1[1] + 2.0 * k2[1] + 2.0 * k3[1] + k4[1])
        out.append(D)
    return [d / out[-1] for d in out]  # unity today (CCL convention)


def _growth_products(lna, Om, Or, Ok, Ol, w0):
    """The RK4 of :func:`_growth_ode` as tensor operations, so that
    parameters that are tensors carry gradients through D(a).

    The growth ODE is linear in (D, D'), so each RK4 step is a 2x2 matrix
    M_n (built for all steps at once from the coefficients at ln a, the
    half step and the full step), and the state after n steps is the
    product M_{n-1} ... M_0 applied to the initial state; the products
    are taken by a parallel prefix scan (log2 of the steps of batched
    2x2 matrix products) instead of a loop of 2047 steps. ``lna`` is the
    (N,) grid tensor. Returns D on the grid, unity today."""
    h = lna[1] - lna[0]
    x = lna[:-1]

    def coef(y):                     # A(ln a): (D, D')' = A (D, D')
        a = torch.exp(y)
        de = a ** (-3.0 * (1.0 + w0))
        e2 = Om * a**-3 + Or * a**-4 + Ok * a**-2 + Ol * de
        dl = (-3.0 * Om * a**-3 - 4.0 * Or * a**-4 - 2.0 * Ok * a**-2
              - 3.0 * (1.0 + w0) * Ol * de)
        damp = 2.0 + 0.5 * dl / e2
        source = 1.5 * Om * torch.exp(-3.0 * y) / e2
        zero, one = torch.zeros_like(y), torch.ones_like(y)
        return torch.stack([torch.stack([zero, one], -1),
                            torch.stack([source, -damp], -1)], -2)

    eye = torch.eye(2, dtype=lna.dtype, device=lna.device)
    A1, A2, A4 = coef(x), coef(x + 0.5 * h), coef(x + h)
    K2 = A2 @ (eye + 0.5 * h * A1)
    K3 = A2 @ (eye + 0.5 * h * K2)
    K4 = A4 @ (eye + h * K3)
    P = eye + (h / 6.0) * (A1 + 2.0 * K2 + 2.0 * K3 + K4)
    s = 1
    while s < P.shape[0]:            # P[n] = M_n ... M_0
        P = torch.cat([P[:s], P[s:] @ P[:-s]])
        s *= 2
    a0 = torch.exp(lna[0])
    y0 = torch.stack([1.0 + 1.5 * a0 * Om / Or, 1.5 * a0 * Om / Or])
    D = torch.cat([y0[:1], (P @ y0)[:, 0]])
    return D / D[-1]


class Cosmology:
    """Flat w0-CDM cosmology (the cosmo-dict contract of the io objects:
    Omega_m, Omega_b, h, sigma8, n_s, w0).

    ``device`` is where the tables live and where every method computes
    (the card unless the caller asks for the CPU; without a GPU the
    default raises); ``dtype`` is the table dtype (float64: the tables
    need it)."""

    def __init__(self, Omega_m=0.3, Omega_b=0.05, h=0.7, sigma8=0.8,
                 n_s=0.96, w0=-1.0, T_CMB=2.725, Neff=3.044, *,
                 device="cuda", dtype=torch.float64,
                 n_a=2048, n_k=2048, n_m=512):
        self.Omega_m = float(Omega_m)
        self.Omega_b = float(Omega_b)
        self.h = float(h)
        self.sigma8 = float(sigma8)
        self.n_s = float(n_s)
        self.w0 = float(w0)
        self.T_CMB = float(T_CMB)
        self.Neff = float(Neff)
        self.device = resolve_device(device)
        self.dtype = dtype
        self._n_a, self._n_k, self._n_m = int(n_a), int(n_k), int(n_m)
        self._tables = self._build_tables()

    @property
    def Omega_c(self):
        return self.Omega_m - self.Omega_b

    @property
    def cosmodict(self):
        """The plain dict the io catalog objects validate against."""
        return dict(Omega_m=self.Omega_m, Omega_b=self.Omega_b, h=self.h,
                    sigma8=self.sigma8, n_s=self.n_s, w0=self.w0)

    @classmethod
    def from_dict(cls, d, *, device="cuda", dtype=torch.float64):
        keys = ("Omega_m", "Omega_b", "h", "sigma8", "n_s", "w0")
        return cls(**{k: float(d[k]) for k in keys if k in d},
                   device=device, dtype=dtype)

    def tensor(self, x):
        """``x`` as a tensor of the table dtype on the table device."""
        return torch.as_tensor(x, dtype=self.dtype, device=self.device)

    # ----- construction -----
    def _build_tables(self):
        dev, dt = self.device, self.dtype
        h = self.h
        Og = 2.47282e-5 / h**2 * (self.T_CMB / 2.725) ** 4
        Onu = self.Neff * (7.0 / 8.0) * (4.0 / 11.0) ** (4.0 / 3.0) * Og
        Or = Og + Onu
        Ok = 0.0
        Ol = 1.0 - self.Omega_m - Or

        lna = torch.linspace(math.log(1e-5), 0.0, self._n_a, dtype=dt,
                             device=dev)
        a = torch.exp(lna)
        E = torch.sqrt(self.Omega_m * a**-3 + Or * a**-4
                       + Ol * a ** (-3.0 * (1.0 + self.w0)))

        # chi(a) = (c/H0) int_a^1 da'/(a'^2 E); on the log grid the
        # integrand is dlna/(a E), integrated from a=1 downwards
        integrand = 1.0 / (a * E)
        dlna = lna[1] - lna[0]
        incr = 0.5 * (integrand[1:] + integrand[:-1]) * dlna
        chi = torch.cat([torch.cumsum(incr.flip(0), 0).flip(0),
                         torch.zeros(1, dtype=dt, device=dev)])
        chi = chi * const.DH_100 / h

        D = self._growth(lna, Or, Ok, Ol)

        # linear P(k) at z=0, sigma8-normalized
        k = geomspace(1e-5, 1e4, self._n_k, device=dev, dtype=dt)
        T = eh98_transfer(k, self.Omega_m, self.Omega_b, h, self.T_CMB)
        pk_un = k**self.n_s * T**2
        s8_un = sigma_tophat(k, pk_un, 8.0 / h)
        pk0 = pk_un * (self.sigma8 / s8_un) ** 2

        # sigma(M) at z=0 on a wide mass grid (Lagrangian comoving R)
        rho_m0 = self.Omega_m * const.RHO_CRIT_0 * h**2  # Msun / Mpc^3
        lnM = torch.linspace(math.log(1e6), math.log(1e18), self._n_m,
                             dtype=dt, device=dev)
        R_L = (3.0 * torch.exp(lnM) / (4.0 * math.pi * rho_m0)) ** (1.0 / 3.0)
        lnsig = torch.log(sigma_tophat(k, pk0, R_L))

        # xi_lin(r) at z=0 via FFTLog: xi = T3[P]
        r_xi, xi0 = fftlog_transform(k, pk0, 3, 0, plaw=-1.55)

        return dict(Or=Or, Ol=Ol, lna=lna, chi=chi, lnD=torch.log(D),
                    k=k, pk0=pk0, lnM=lnM, lnsig=lnsig,
                    lnr_xi=torch.log(r_xi), xi0=xi0, rho_m0=rho_m0)

    def _growth(self, lna, Or, Ok, Ol):
        return self.tensor(_growth_ode(lna.tolist(), self.Omega_m, Or, Ok,
                                       Ol, self.w0))

    # ----- background -----
    def E(self, a):
        a = self.tensor(a)
        t = self._tables
        return torch.sqrt(self.Omega_m * a**-3 + t["Or"] * a**-4
                          + t["Ol"] * a ** (-3.0 * (1.0 + self.w0)))

    def H(self, a):
        """H(a) in km/s/Mpc."""
        return 100.0 * self.h * self.E(a)

    def comoving_radial_distance(self, a):
        """chi(a) in Mpc (flat: equals the comoving angular distance)."""
        t = self._tables
        return interp(torch.log(self.tensor(a)), t["lna"], t["chi"])

    comoving_angular_distance = comoving_radial_distance

    def angular_diameter_distance(self, a):
        return self.tensor(a) * self.comoving_radial_distance(a)

    def growth_factor(self, a):
        """D(a), normalized to 1 at a=1 (CCL convention)."""
        t = self._tables
        return torch.exp(interp(torch.log(self.tensor(a)), t["lna"],
                                t["lnD"]))

    def rho_crit(self, a, comoving=False):
        """Critical density in Msun/Mpc^3."""
        rc = const.RHO_CRIT_0 * self.h**2 * self.E(a) ** 2
        return rc * self.tensor(a) ** 3 if comoving else rc

    def rho_x(self, a, species="matter", is_comoving=False):
        """Density of a species, Msun/Mpc^3 (mirrors ccl.rho_x)."""
        if species == "matter":
            rho = self._tables["rho_m0"] * a**-3  # physical
        elif species == "critical":
            rho = self.rho_crit(a)
        else:
            raise ValueError(f"unknown species {species!r}")
        return rho * a**3 if is_comoving else rho

    # ----- fluctuations -----
    def P_lin(self, k, a=1.0):
        """Linear matter power spectrum [Mpc^3] at k [1/Mpc]."""
        t = self._tables
        pk = torch.exp(interp(torch.log(self.tensor(k)), torch.log(t["k"]),
                              torch.log(t["pk0"])))
        return pk * self.growth_factor(a) ** 2

    def Omega_m_a(self, a):
        """Matter density parameter at scale factor a."""
        return self.Omega_m * self.tensor(a) ** -3 / self.E(a) ** 2

    def P_nl(self, k, a=1.0):
        """Nonlinear matter power spectrum (halofit, Takahashi+2012), for
        the dP(k)/P(k) suppression prediction (``analysis``)."""
        t = self._tables
        ol_z = t["Ol"] * self.tensor(a) ** (-3.0 * (1.0 + self.w0)) \
            / self.E(a) ** 2
        return halofit_pk(self.tensor(k), t["k"],
                          t["pk0"] * self.growth_factor(a) ** 2,
                          self.Omega_m_a(a), ol_z, self.w0)

    def dlnP_dlnk(self, k):
        """Logarithmic slope of the z=0 linear power spectrum."""
        t = self._tables
        lnk = torch.log(t["k"])
        lnp = torch.log(t["pk0"])
        slope = torch.gradient(lnp)[0] / (lnk[1] - lnk[0])
        return interp(torch.log(self.tensor(k)), lnk, slope)

    def sigmaM(self, M, a=1.0):
        """sigma(M, a) with tophat window (ccl.sigmaM parity)."""
        t = self._tables
        s0 = torch.exp(interp(torch.log(self.tensor(M)), t["lnM"],
                              t["lnsig"]))
        return s0 * self.growth_factor(a)

    def xi_mm(self, r, a=1.0):
        """Linear matter correlation function: D(a)^2 xi(r, z=0)."""
        t = self._tables
        xi0 = interp(torch.log(self.tensor(r)), t["lnr_xi"], t["xi0"])
        return xi0 * self.growth_factor(a) ** 2

    def lagrangian_R(self, M):
        """Comoving Lagrangian radius of mass M."""
        return (3.0 * self.tensor(M)
                / (4.0 * math.pi * self._tables["rho_m0"])) ** (1.0 / 3.0)


class CosmologyDevice(Cosmology):
    """A :class:`Cosmology` whose parameters (Omega_m, Omega_b, h, sigma8,
    n_s, w0) are 0-dim tensors that may require grad: the lookup tables
    (growth, distances, EH98 P(k), sigma(M), xi_mm) are built with them,
    so every method is differentiable with respect to them. The port of
    the JAX package's ``CosmologyDevice``; make one with
    :func:`cosmology_device`. The growth ODE runs as tensor operations
    (:func:`_growth_products`), the only part of the table build that the
    base class computes on Python floats."""

    def __init__(self, Omega_m=0.3, Omega_b=0.05, h=0.7, sigma8=0.8,
                 n_s=0.96, w0=-1.0, T_CMB=2.725, Neff=3.044, *,
                 device="cuda", dtype=torch.float64,
                 n_a=2048, n_k=2048, n_m=512):
        self.device = resolve_device(device)
        self.dtype = dtype
        for name, v in (("Omega_m", Omega_m), ("Omega_b", Omega_b),
                        ("h", h), ("sigma8", sigma8), ("n_s", n_s),
                        ("w0", w0)):
            setattr(self, name, torch.as_tensor(v, dtype=dtype,
                                                device=self.device))
        self.T_CMB = float(T_CMB)
        self.Neff = float(Neff)
        self._n_a, self._n_k, self._n_m = int(n_a), int(n_k), int(n_m)
        self._tables = self._build_tables()

    def _growth(self, lna, Or, Ok, Ol):
        return _growth_products(lna, self.Omega_m, Or, Ok, Ol, self.w0)


_COSMO_KEYS = ("Omega_m", "Omega_b", "h", "sigma8", "n_s", "w0")
_FIXED_KEYS = ("T_CMB", "Neff", "_n_a", "_n_k", "_n_m")


def cosmology_device(params=None, *, device="cuda", **kw):
    """A :class:`CosmologyDevice` from (possibly grad-requiring)
    parameters: any of Omega_m, Omega_b, h, sigma8, n_s, w0 as floats or
    0-dim tensors, in ``params`` and/or keywords (keywords win); T_CMB,
    Neff and the table sizes _n_a, _n_k, _n_m as plain numbers (the JAX
    package's names and defaults). Runs on the card unless ``device``
    asks for the CPU."""
    d = dict(params or {})
    d.update(kw)
    for k in d:
        if k not in _COSMO_KEYS and k not in _FIXED_KEYS:
            raise TypeError(f"unknown cosmology parameter {k!r}")
    return CosmologyDevice(**{k.lstrip("_"): v for k, v in d.items()},
                           device=device)
