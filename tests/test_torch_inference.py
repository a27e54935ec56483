"""The port's inference module against the JAX package's.

Every case of tests/test_inference.py, ported (float64 tensors for the
JAX arrays, ``torch.Generator`` for the PRNG keys, a ``torch.optim``
factory for the optax optimizer), and three parity checks on the same
inputs:

- ``fit``'s trajectory on a quadratic against JAX's ``fit`` (optax Adam)
  to 1e-10;
- ``laplace_covariance`` on a two-parameter table-level chi^2 (the
  displacement table of a Baryonification2D model in ln M_c and
  ln theta_ej) against JAX's, whose Hessian is ``jax.hessian``, to 1e-6;
- ``hmc_sample``: the same chain for the same generator state, and the
  mean and covariance of a Gaussian target within the JAX tests' bars
  (the two PRNGs differ, so there is no bitwise parity).

The JAX package's ``jit=True`` has no counterpart (PyTorch runs eagerly):
its case here holds two eager fits to one trajectory, bit for bit.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from baryonification_tpu import inference as jinf
from baryonification_tpu_torch.inference import (FitResult, fit,
                                                 hmc_sample,
                                                 laplace_covariance)

from test_profiles import PAR

torch.set_num_threads(1)


def t64(x):
    return torch.as_tensor(np.asarray(x, dtype=np.float64))


def gen(seed):
    return torch.Generator().manual_seed(seed)


class TestFit:
    def test_quadratic_scalar(self):
        loss = lambda x: (x - 3.0) ** 2
        res = fit(loss, t64(0.0), steps=200, learning_rate=0.1)
        assert isinstance(res, FitResult)
        assert abs(float(res.params) - 3.0) < 1e-3
        assert res.loss < 1e-6
        assert res.history.shape == (200,)
        assert np.isclose(res.history[0], 9.0)

    def test_pytree_params(self):
        target = {"a": 1.5, "b": t64([2.0, -1.0])}

        def loss(p):
            return ((p["a"] - target["a"]) ** 2
                    + torch.sum((p["b"] - target["b"]) ** 2))

        res = fit(loss, {"a": t64(0.0), "b": torch.zeros(2,
                                                         dtype=torch.float64)},
                  steps=300, learning_rate=0.1)
        assert abs(float(res.params["a"]) - 1.5) < 5e-3
        np.testing.assert_allclose(res.params["b"].numpy(), [2.0, -1.0],
                                   atol=5e-3)

    def test_best_iterate_not_last(self):
        loss = lambda x: (x - 1.0) ** 2
        res = fit(loss, t64(0.9), steps=12, learning_rate=5.0)
        assert res.loss <= min(res.history)
        assert res.loss <= float((res.last_params - 1.0) ** 2) + 1e-12

    def test_callback_early_stop(self):
        calls = []

        def cb(step, params, loss, grad):
            calls.append(loss)
            if loss < 1e-4:
                raise StopIteration

        loss = lambda x: (x - 2.0) ** 2
        res = fit(loss, t64(0.0), steps=500, learning_rate=0.2, callback=cb)
        assert len(calls) < 500
        assert res.history.shape[0] == len(calls)

    def test_nonfinite_loss_at_start_raises(self):
        loss = lambda x: torch.log(x)            # NaN for x < 0
        with pytest.raises(FloatingPointError):
            fit(loss, t64(-1.0), steps=50, learning_rate=1.0)

    def test_nonfinite_loss_after_progress_returns_best(self):
        loss = lambda x: torch.log(x)            # finite, then NaN
        with pytest.warns(RuntimeWarning, match="non-finite loss"):
            res = fit(loss, t64(0.05), steps=50, learning_rate=1.0)
        assert np.isfinite(res.loss)
        assert res.history.shape[0] < 50
        assert not np.isfinite(res.history[-1])
        assert res.loss == min(h for h in res.history if np.isfinite(h))

    def test_steps_zero_evaluates_start(self):
        loss = lambda x: (x - 3.0) ** 2
        res = fit(loss, t64(1.0), steps=0)
        assert res.loss == pytest.approx(4.0)
        assert res.history.shape == (1,)
        assert float(res.params) == 1.0

    def test_jit_mode_matches_eager(self):
        """No jit in the port: two eager fits follow one trajectory, bit
        for bit (the JAX case holds its jit fit to the eager one)."""
        loss = lambda x: torch.sum((x - t64([1.0, -2.0])) ** 2)
        r1 = fit(loss, torch.zeros(2, dtype=torch.float64), steps=40,
                 learning_rate=0.1)
        r2 = fit(loss, torch.zeros(2, dtype=torch.float64), steps=40,
                 learning_rate=0.1)
        np.testing.assert_array_equal(r1.history, r2.history)
        np.testing.assert_array_equal(r1.params.numpy(), r2.params.numpy())

    def test_custom_optimizer(self):
        loss = lambda x: torch.sum((x - torch.arange(3.0,
                                                     dtype=torch.float64))
                                   ** 2)
        res = fit(loss, torch.zeros(3, dtype=torch.float64), steps=400,
                  optimizer=lambda ps: torch.optim.SGD(ps, lr=0.2))
        np.testing.assert_allclose(res.params.numpy(), np.arange(3.0),
                                   atol=1e-3)

    def test_trajectory_matches_jax(self):
        """The default Adam against optax.adam in JAX's fit, on a
        two-parameter quadratic with a cross term."""
        A = np.array([[2.0, 0.3], [0.3, 0.5]])
        mu = np.array([1.0, -2.0])
        j = jinf.fit(lambda x: (x - mu) @ jnp.asarray(A) @ (x - mu),
                     jnp.zeros(2), steps=60, learning_rate=0.1)
        t = fit(lambda x: (x - t64(mu)) @ t64(A) @ (x - t64(mu)),
                torch.zeros(2, dtype=torch.float64), steps=60,
                learning_rate=0.1)
        np.testing.assert_allclose(t.history, np.asarray(j.history),
                                   rtol=1e-10, atol=1e-14)
        np.testing.assert_allclose(t.last_params.numpy(),
                                   np.asarray(j.last_params), rtol=1e-10)


class TestFitCheckpoint:
    @staticmethod
    def LOSS(p):
        return ((p["a"] - 1.5) ** 2
                + torch.sum((p["b"] - t64([2., -1.])) ** 2))

    @staticmethod
    def start():
        return {"a": t64(0.0), "b": torch.zeros(2, dtype=torch.float64)}

    def test_resume_is_bit_exact(self, tmp_path):
        ck = str(tmp_path / "fit.ckpt")
        ref = fit(self.LOSS, self.start(), steps=20, learning_rate=0.1)
        fit(self.LOSS, self.start(), steps=7, learning_rate=0.1,
            checkpoint=ck)
        res = fit(self.LOSS, self.start(), steps=20, learning_rate=0.1,
                  checkpoint=ck)
        np.testing.assert_array_equal(res.history, ref.history)
        np.testing.assert_array_equal(res.params["b"].numpy(),
                                      ref.params["b"].numpy())
        assert float(res.params["a"]) == float(ref.params["a"])

    def test_resume_past_end_returns_saved(self, tmp_path):
        ck = str(tmp_path / "fit.ckpt")
        first = fit(self.LOSS, self.start(), steps=9, learning_rate=0.1,
                    checkpoint=ck)
        again = fit(self.LOSS, self.start(), steps=9, learning_rate=0.1,
                    checkpoint=ck)
        assert again.history.shape == (9,)
        assert again.loss == first.loss

    def test_checkpoint_every(self, tmp_path):
        ck = str(tmp_path / "fit.ckpt")
        fit(self.LOSS, self.start(), steps=13, learning_rate=0.1,
            checkpoint=ck, checkpoint_every=5)
        blob = torch.load(ck, weights_only=True)
        assert blob["step"] == 13
        assert len(blob["history"]) == 13


class TestHMC:
    def test_gaussian_moments(self):
        cov = np.array([[1.0, 0.6], [0.6, 1.0]])
        prec = t64(np.linalg.inv(cov))
        mu = t64([1.0, -2.0])

        def logp(x):
            d = x - mu
            return -0.5 * d @ prec @ d

        # 4x the JAX case's 3000 samples: the adapted step (~0.85 x 8
        # leapfrogs, near a period of the long axis) mixes slowly in both
        # packages, and the PRNGs differ; at 3000 samples the spread of
        # the mean between generator seeds reaches the 0.12 bar
        res = hmc_sample(logp, torch.zeros(2, dtype=torch.float64), gen(0),
                         n_samples=12000, n_warmup=500, step_size=0.3,
                         n_leapfrog=8)
        s = res.samples.numpy()
        assert 0.5 < res.accept_rate <= 1.0
        np.testing.assert_allclose(s.mean(axis=0), mu.numpy(), atol=0.12)
        np.testing.assert_allclose(np.cov(s.T), cov, atol=0.2)
        assert abs(res.accept_rate - 0.8) < 0.15

    def test_mass_matrix_preconditions_anisotropy(self):
        sig = np.array([1.0, 100.0])

        def logp(x):
            return -0.5 * torch.sum((x / t64(sig)) ** 2)

        res = hmc_sample(logp, torch.zeros(2, dtype=torch.float64), gen(1),
                         n_samples=3000, n_warmup=500, step_size=0.3,
                         n_leapfrog=8, mass_covariance=np.diag(sig ** 2))
        s = res.samples.numpy()
        assert res.accept_rate > 0.5
        np.testing.assert_allclose(s.std(axis=0), sig, rtol=0.25)

    def test_deterministic_in_key(self):
        logp = lambda x: -0.5 * torch.sum(x ** 2)
        x0 = torch.zeros(2, dtype=torch.float64)
        a = hmc_sample(logp, x0, gen(7), n_samples=50, n_warmup=20)
        b = hmc_sample(logp, x0, gen(7), n_samples=50, n_warmup=20)
        c = hmc_sample(logp, x0, gen(8), n_samples=50, n_warmup=20)
        np.testing.assert_array_equal(a.samples.numpy(), b.samples.numpy())
        assert not np.array_equal(a.samples.numpy(), c.samples.numpy())

    def test_pytree_params(self):
        def logp(p):
            return -0.5 * ((p["m"] - 1.0) ** 2 + torch.sum(p["v"] ** 2))

        res = hmc_sample(logp, {"m": t64(0.0),
                                "v": torch.zeros(2, dtype=torch.float64)},
                         gen(2), n_samples=400, n_warmup=200)
        assert res.samples["m"].shape == (400,)
        assert res.samples["v"].shape == (400, 2)
        assert abs(float(res.samples["m"].mean()) - 1.0) < 0.3
        assert res.log_probs.shape == (400,)

    def test_nan_proposals_rejected_not_poisoning(self):
        def logp(x):
            return torch.log(1.0 - x[0] ** 2)   # NaN for |x| > 1

        res = hmc_sample(logp, torch.zeros(1, dtype=torch.float64), gen(3),
                         n_samples=500, n_warmup=100, step_size=0.5,
                         n_leapfrog=4)
        s = res.samples.numpy()
        assert np.all(np.isfinite(s))
        assert np.all(np.abs(s) < 1.0)
        assert np.all(np.isfinite(res.log_probs))


class TestLaplace:
    def test_quadratic_covariance(self):
        A = np.array([[2.0, 0.3], [0.3, 0.5]])
        mu = t64([1.0, -2.0])

        def chi2(x):
            d = x - mu
            return d @ t64(A) @ d

        cov, sigma = laplace_covariance(chi2, mu)
        np.testing.assert_allclose(cov, np.linalg.inv(A), atol=1e-6)
        np.testing.assert_allclose(sigma.numpy(),
                                   np.sqrt(np.diag(np.linalg.inv(A))),
                                   atol=1e-6)

    def test_nll_convention(self):
        def nll(x):
            return 0.5 * torch.sum(x ** 2) / 0.25   # sigma = 0.5

        cov, sigma = laplace_covariance(nll, torch.zeros(1,
                                                         dtype=torch.float64),
                                        loss_is_chi2=False)
        np.testing.assert_allclose(cov, [[0.25]], atol=1e-8)
        np.testing.assert_allclose(sigma.numpy(), [0.5], atol=1e-8)

    def test_indefinite_hessian_warns_nan_sigma(self):
        def chi2(x):
            return x[0] ** 2 - x[1] ** 2          # a saddle

        with pytest.warns(RuntimeWarning, match="not positive definite"):
            cov, sigma = laplace_covariance(
                chi2, torch.zeros(2, dtype=torch.float64))
        s = sigma.numpy()
        assert np.isfinite(s[0]) and s[0] > 0
        assert np.isnan(s[1])
        assert cov[1, 1] < 0

    def test_pytree_sigma_shape(self):
        def chi2(p):
            return (p["m"] - 1.0) ** 2 + torch.sum(p["v"] ** 2)

        cov, sigma = laplace_covariance(
            chi2, {"m": t64(1.0), "v": torch.zeros(2, dtype=torch.float64)})
        assert cov.shape == (3, 3)
        assert set(sigma.keys()) == {"m", "v"}
        assert sigma["v"].shape == (2,)


# ----- the table-level pipeline: a Baryonification2D table -----

COSMO = dict(Omega_m=0.3, Omega_b=0.05, h=0.7, sigma8=0.8, n_s=0.96)
Z1 = np.asarray([0.2])
M4 = 10 ** np.linspace(13.5, 14.5, 4)
R32 = np.geomspace(0.1, 20.0, 32)


def _port_table(lnMc, ln_tej=None):
    import baryonification_tpu_torch as T
    par = dict(PAR)
    par['M_c'] = torch.exp(lnMc)
    if ln_tej is not None:
        par['theta_ej'] = torch.exp(ln_tej)
    cosmo = T.Cosmology(**COSMO, device="cpu")
    m = T.Baryonification2D(T.DarkMatterOnly(**par),
                            T.DarkMatterBaryon(**par), cosmo, epsilon_max=20)
    return m.build_table_device(Z1, M4, R32)


class TestPipelineFit:
    def test_recover_mc_from_table_band(self):
        """Fit ln M_c so that a coarse displacement-table band matches a
        mock built at the truth, then drive HMC with the same loss."""
        truth = float(np.log(10 ** 13.9))
        target = _port_table(t64(truth)).detach()

        def chi2(lnMc):
            return torch.sum((_port_table(lnMc) - target) ** 2) * 1e4

        start = float(np.log(10 ** 14.3))
        res = fit(chi2, t64(start), steps=12, learning_rate=0.2)
        assert abs(float(res.params) - truth) < 0.3 * abs(start - truth)
        assert res.loss < res.history[0] / 10

        samp = hmc_sample(lambda lnMc: -0.5 * chi2(lnMc), res.params,
                          gen(0), n_samples=4, n_warmup=2, n_leapfrog=2,
                          step_size=0.02)
        s = samp.samples.numpy()
        assert s.shape == (4,)
        assert np.all(np.isfinite(s))
        assert np.all(np.isfinite(samp.log_probs))

    def test_laplace_matches_jax_hessian(self, cosmo):
        """Two-parameter table-level chi^2 in (ln M_c, ln theta_ej), the
        mock 0.1 off in each: the port's exact Hessian (reverse over
        reverse) against ``jax.hessian`` through the JAX package's
        ``build_table_device``, the covariances to 1e-6."""
        from baryonification_tpu.displacement import Baryonification2D
        from baryonification_tpu.profiles import (DarkMatterOnly,
                                                  DarkMatterBaryon)
        truth = {"lnMc": float(np.log(1e14)), "ln_tej": float(np.log(4.0))}
        at = {"lnMc": truth["lnMc"] + 0.1, "ln_tej": truth["ln_tej"] - 0.1}

        def j_table(p):
            par = dict(PAR)
            par['M_c'] = jnp.exp(p["lnMc"])
            par['theta_ej'] = jnp.exp(p["ln_tej"])
            m = Baryonification2D(DarkMatterOnly(**par),
                                  DarkMatterBaryon(**par), cosmo,
                                  epsilon_max=20)
            return m.build_table_device(Z1, M4, R32)

        j_target = j_table({k: jnp.asarray(v) for k, v in truth.items()})
        t_target = _port_table(t64(truth["lnMc"]),
                               t64(truth["ln_tej"])).detach()
        np.testing.assert_allclose(t_target.numpy(),
                                   np.asarray(j_target).reshape(
                                       t_target.shape),
                                   rtol=1e-8, atol=1e-12)
        j_cov, j_sig = jinf.laplace_covariance(
            lambda p: jnp.sum((j_table(p) - j_target) ** 2) * 1e4,
            {k: jnp.asarray(v) for k, v in at.items()})
        t_cov, t_sig = laplace_covariance(
            lambda p: torch.sum((_port_table(p["lnMc"], p["ln_tej"])
                                 - t_target) ** 2) * 1e4,
            {k: t64(v) for k, v in at.items()})
        assert np.all(np.isfinite(t_cov))
        np.testing.assert_allclose(t_cov, np.asarray(j_cov), rtol=1e-6)
        for k in at:
            np.testing.assert_allclose(float(t_sig[k]), float(j_sig[k]),
                                       rtol=1e-6)
