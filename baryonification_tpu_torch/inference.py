"""Gradient-based parameter inference on the differentiable pipeline.

The port of ``baryonification_tpu.inference``. Every runner family's
``process_device`` and the table builds (``build_table_device``,
``TabulatedProfile.build_tables_device``, ``cosmology_device``) carry
autograd graphs, so one backward pass prices every parameter at once.
This module packages the workflow of examples 14, 16 and 18:

- :func:`fit`: first-order minimisation of a scalar loss over a tensor,
  or a (nested) dict of tensors, with a ``torch.optim`` optimizer (Adam
  by default: the update of ``optax.adam``, eps added to sqrt(v-hat)),
  returning the best iterate seen, with checkpoint and resume;
- :func:`laplace_covariance`: the Laplace covariance at the optimum from
  the exact Hessian (reverse over reverse through the same pipeline, as
  ``jax.hessian`` gives it);
- :func:`hmc_sample`: Hamiltonian Monte Carlo with dual-averaging
  warm-up, its randomness from an explicit ``torch.Generator``.

Parameters are flattened into one vector in the JAX package's
``ravel_pytree`` order (dict keys sorted); ``loss_fn`` gets them back in
their structure as tensors that carry the graph.
"""

import math
import os
import warnings
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

__all__ = ["FitResult", "fit", "laplace_covariance", "HMCResult",
           "hmc_sample"]


def _ravel(params):
    """(flat, unravel): the leaves of ``params`` (a tensor, a number, or
    dicts/lists/tuples of them) as one 1-D tensor, and the function that
    maps a (..., n) tensor back to the structure (leaves of shape
    ``batch + leaf shape``, each in its own dtype). Dict keys are taken
    sorted, as ``jax.flatten_util.ravel_pytree`` takes them."""
    leaves = []

    def walk(p):
        if isinstance(p, dict):
            return ("dict", [(k, walk(p[k])) for k in sorted(p)])
        if isinstance(p, (list, tuple)):
            return (type(p), [walk(v) for v in p])
        t = p if torch.is_tensor(p) else torch.as_tensor(
            np.asarray(p, dtype=np.float64))
        leaves.append(t.detach())
        return ("leaf", len(leaves) - 1)

    tree = walk(params)
    if not leaves:
        raise ValueError("params hold no values")
    dtype = leaves[0].dtype
    for t in leaves[1:]:
        dtype = torch.promote_types(dtype, t.dtype)
    dev = leaves[0].device
    flat = torch.cat([t.reshape(-1).to(device=dev, dtype=dtype)
                      for t in leaves])
    bounds = np.cumsum([0] + [t.numel() for t in leaves])

    def unravel(x):
        def build(node):
            kind, body = node
            if kind == "leaf":
                t = leaves[body]
                v = x[..., bounds[body]:bounds[body + 1]]
                return v.reshape(x.shape[:-1] + t.shape).to(t.dtype)
            if kind == "dict":
                return {k: build(c) for k, c in body}
            return kind(build(c) for c in body)
        return build(tree)

    return flat, unravel


class FitResult(NamedTuple):
    """Outcome of :func:`fit`.

    params : the best parameters seen (lowest loss over all steps,
             the starting point included), in the structure given.
    loss : the loss at ``params``.
    history : (steps,) numpy array of the loss at each iterate visited.
    last_params : the final iterate.
    """
    params: Any
    loss: float
    history: np.ndarray
    last_params: Any


def _save_checkpoint(path, step, x, opt, best, best_loss, history):
    """Write the optimizer's whole state (iterate, optimizer state, best
    iterate, history) with ``torch.save`` to a temporary file and move it
    into place, so that no half-written checkpoint is ever left."""
    tmp = path + ".tmp"
    torch.save(dict(step=step, params=x.detach().cpu(),
                    state=opt.state_dict(), best_params=best.cpu(),
                    best_loss=best_loss, history=list(history)), tmp)
    os.replace(tmp, path)


def fit(loss_fn: Callable, params: Any, steps: int = 100,
        optimizer: Optional[Callable] = None, learning_rate: float = 0.1,
        verbose: bool = False, callback: Optional[Callable] = None,
        checkpoint: Optional[str] = None, checkpoint_every: int = 1):
    """Minimise ``loss_fn(params)`` (a 0-dim tensor that carries its
    graph to ``params``).

    params : a tensor, a number, or a dict (or list) of them.
    optimizer : a callable taking the list of parameter tensors and
        returning a ``torch.optim.Optimizer``; default
        ``torch.optim.Adam(..., lr=learning_rate)``. It optimises the
        flat parameter vector; Adam and SGD act elementwise, so this is
        the same as optimising each leaf.
    callback : ``callback(step, params, loss, grad)`` after each
        evaluation; raising StopIteration stops the fit.
    checkpoint : optional path. Every ``checkpoint_every`` steps (and at
        the last) the whole state is written there; if the file exists
        the fit resumes from it, and the resumed trajectory is the
        uninterrupted one, bit for bit.

    A loss that is not finite at the first evaluation raises
    FloatingPointError; one after progress stops the fit with a
    RuntimeWarning and returns the best iterate. Returns a
    :class:`FitResult`."""
    flat, unravel = _ravel(params)
    x = flat.clone().requires_grad_(True)
    opt = (optimizer or (lambda ps: torch.optim.Adam(
        ps, lr=learning_rate)))([x])
    best_loss, best = math.inf, x.detach().clone()
    history, start = [], 0
    if checkpoint is not None and os.path.exists(checkpoint):
        blob = torch.load(checkpoint, weights_only=True)
        with torch.no_grad():
            x.copy_(blob["params"])
        opt.load_state_dict(blob["state"])
        best = blob["best_params"].to(x.device)
        best_loss, history = blob["best_loss"], list(blob["history"])
        start = blob["step"]
        if verbose:
            print(f"fit: resumed from {checkpoint} at step {start} (best "
                  f"loss {best_loss:.6e})")
    for step in range(start, steps):
        loss = loss_fn(unravel(x))
        (grad,) = torch.autograd.grad(loss, x, allow_unused=True)
        if grad is None:
            grad = torch.zeros_like(x)
        loss_f = float(loss.detach())
        history.append(loss_f)
        if not math.isfinite(loss_f):
            if not math.isfinite(best_loss):
                raise FloatingPointError(
                    f"non-finite loss at step {step}: {loss_f} (check the "
                    f"loss for operations whose backward meets 0 * inf: "
                    f"the double-where pattern)")
            warnings.warn(
                f"fit: non-finite loss at step {step}; stopping early and "
                f"returning the best finite iterate (loss {best_loss:.6e})",
                RuntimeWarning)
            break
        if loss_f < best_loss:
            best_loss, best = loss_f, x.detach().clone()
        if verbose:
            print(f"fit step {step:3d}: loss = {loss_f:.6e}")
        if callback is not None:
            try:
                callback(step, unravel(x.detach().clone()), loss_f,
                         unravel(grad))
            except StopIteration:
                break
        x.grad = grad
        opt.step()
        if checkpoint is not None and (
                (step + 1) % checkpoint_every == 0 or step == steps - 1):
            _save_checkpoint(checkpoint, step + 1, x, opt, best, best_loss,
                             history)
    if not history:
        # no step ran: params and loss still describe the start
        with torch.no_grad():
            best_loss = float(loss_fn(unravel(x)))
        history.append(best_loss)
        best = x.detach().clone()
    return FitResult(params=unravel(best), loss=best_loss,
                     history=np.asarray(history),
                     last_params=unravel(x.detach().clone()))


def laplace_covariance(loss_fn: Callable, params: Any,
                       loss_is_chi2: bool = True):
    """The Laplace covariance at ``params``.

    For a Gaussian likelihood L ~ exp(-chi^2 / 2) the covariance is
    2 H^-1, with H the Hessian of chi^2; with ``loss_is_chi2=False`` the
    loss is a negative log-likelihood and the covariance is H^-1. H is
    exact: each row is the gradient of one component of the gradient
    (reverse over reverse, ``create_graph=True``) through whatever the
    loss runs; on the card the cell-major pass takes its second-order
    kernel there. An indefinite H (not a minimum) gives NaN sigmas for
    the negative variances, with a RuntimeWarning.

    Returns ``(cov, sigma)``: the (n, n) numpy covariance over the flat
    parameter vector (dict keys sorted) and the 1-sigma values in the
    structure of ``params``."""
    flat, unravel = _ravel(params)
    x = flat.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(loss_fn(unravel(x)), x, create_graph=True)
    n = x.shape[0]
    rows = []
    for i in range(n):
        (hi,) = torch.autograd.grad(g[i], x, retain_graph=i < n - 1,
                                    allow_unused=True)
        rows.append(torch.zeros_like(x) if hi is None else hi)
    H = torch.stack(rows).detach().cpu().numpy().astype(np.float64)
    cov = np.linalg.inv(H)
    if loss_is_chi2:
        cov = 2.0 * cov
    var = np.diag(cov)
    if np.any(var < 0):
        bad = np.flatnonzero(var < 0)
        warnings.warn(
            f"laplace_covariance: negative variance for flat parameter "
            f"indices {bad.tolist()}: the Hessian is not positive definite "
            f"at these params (not a local minimum); their sigmas are "
            f"returned as NaN", RuntimeWarning)
    sigma = np.sqrt(np.where(var < 0, np.nan, var))
    return cov, unravel(torch.as_tensor(sigma, dtype=flat.dtype,
                                        device=flat.device))


class HMCResult(NamedTuple):
    """Outcome of :func:`hmc_sample`.

    samples : the post-warm-up chain in the structure of ``params``,
              with a leading (n_samples,) axis on every leaf.
    log_probs : (n_samples,) numpy array of the log-posterior there.
    accept_rate : mean acceptance over the kept samples.
    step_size : the leapfrog step after the dual-averaging warm-up.
    """
    samples: Any
    log_probs: np.ndarray
    accept_rate: float
    step_size: float


def hmc_sample(log_prob_fn: Callable, params: Any,
               generator: torch.Generator, n_samples: int = 500,
               n_warmup: int = 200, step_size: float = 0.1,
               n_leapfrog: int = 16,
               mass_covariance: Optional[np.ndarray] = None,
               target_accept: float = 0.8):
    """Posterior sampling by Hamiltonian Monte Carlo.

    ``log_prob_fn(params)`` is the log-posterior (for a chi^2 pipeline
    loss pass ``lambda p: -0.5 * chi2(p)``). Each transition draws a
    momentum, runs ``n_leapfrog`` leapfrog steps (one backward pass of
    the pipeline each) and accepts by Metropolis; a proposal whose
    log-posterior is NaN is rejected. During the ``n_warmup`` first
    transitions the step size adapts by Nesterov dual averaging (Hoffman
    & Gelman 2014, Algorithm 5) toward ``target_accept``; after it the
    averaged step is used.

    generator : the ``torch.Generator`` that every random draw comes
        from (momenta and acceptances, in float64 on its device): the
        chain is a function of its state. The draws are not the JAX
        package's (its keys are another generator).
    mass_covariance : optional (dim, dim) estimate of the posterior
        covariance over the flat parameter vector (the ``cov`` of
        :func:`laplace_covariance`), used as the inverse mass matrix.

    Returns :class:`HMCResult`."""
    x0, unravel = _ravel(params)
    dim, dtype, dev = x0.shape[0], x0.dtype, x0.device
    if mass_covariance is not None:
        minv = np.asarray(mass_covariance, dtype=np.float64).reshape(dim,
                                                                     dim)
        mass = np.linalg.inv(minv)
        chol_mass = np.linalg.cholesky(0.5 * (mass + mass.T))
    else:
        minv = chol_mass = np.eye(dim)
    minv_d = torch.as_tensor(minv, dtype=dtype, device=dev)
    chol_d = torch.as_tensor(chol_mass, dtype=dtype, device=dev)
    gdev = generator.device

    def logp_and_grad(x):
        x = x.detach().requires_grad_(True)
        lp = log_prob_fn(unravel(x))
        (g,) = torch.autograd.grad(lp, x, allow_unused=True)
        return lp.detach(), (torch.zeros_like(x) if g is None else g)

    def leapfrog(x, p, eps):
        _, g = logp_and_grad(x)
        p = p + 0.5 * eps * g
        lp = None
        for _ in range(n_leapfrog):
            x = x + eps * (minv_d @ p)
            lp, g = logp_and_grad(x)
            p = p + eps * g
        p = p - 0.5 * eps * g            # undo the trailing half-kick
        return x, p, lp

    def kinetic(p):
        return 0.5 * float(p @ (minv_d @ p))

    eps0 = float(step_size)
    # dual-averaging constants (Hoffman & Gelman 2014, Algorithm 5)
    da_mu = math.log(10.0 * eps0)
    da_gamma, da_t0, da_kappa = 0.05, 10.0, 0.75
    log_eps = log_epsbar = math.log(eps0)
    hbar = 0.0
    x = x0.clone()
    with torch.no_grad():
        logp = float(log_prob_fn(unravel(x)))
    xs, logps, accs = [], [], []
    for i in range(n_warmup + n_samples):
        eps = math.exp(log_eps if i < n_warmup else log_epsbar)
        xi = torch.randn(dim, generator=generator, dtype=torch.float64,
                         device=gdev)
        p0 = chol_d @ xi.to(device=dev, dtype=dtype)
        x_new, p_new, lp_new = leapfrog(x, p0, eps)
        lp_new = float(lp_new) if n_leapfrog else logp
        delta = (lp_new - kinetic(p_new)) - (logp - kinetic(p0))
        if math.isnan(delta):
            delta = -math.inf
        alpha = math.exp(min(delta, 0.0))
        u = float(torch.rand((), generator=generator, dtype=torch.float64,
                             device=gdev))
        accept = u < alpha
        if accept:
            x, logp = x_new.detach(), lp_new
        if i < n_warmup:                 # dual averaging
            t = i + 1.0
            eta = 1.0 / (t + da_t0)
            hbar = (1.0 - eta) * hbar + eta * (target_accept - alpha)
            log_eps = da_mu - math.sqrt(t) / da_gamma * hbar
            w = t ** (-da_kappa)
            log_epsbar = w * log_eps + (1.0 - w) * log_epsbar
        else:
            xs.append(x)
            logps.append(logp)
            accs.append(float(accept))
    samples = unravel(torch.stack(xs) if xs else x0.new_zeros((0, dim)))
    return HMCResult(samples=samples, log_probs=np.asarray(logps),
                     accept_rate=float(np.mean(accs)) if accs else math.nan,
                     step_size=math.exp(log_epsbar))
