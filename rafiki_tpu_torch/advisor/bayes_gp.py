"""Bayesian-optimization advisor: GP surrogate + Expected Improvement.

The port's own copy of ``BayesOptAdvisor`` and ``_expected_improvement``
from ``rafiki_tpu/advisor/bayes_gp.py``. The JAX advisor fits
scikit-learn's ``GaussianProcessRegressor`` (Matérn 5/2 over the knob unit
cube); the card's machine has no scikit-learn, so the port keeps its own
:class:`GaussianProcess`, the same arithmetic on scipy's linear algebra
and L-BFGS-B (scipy is imported inside the calls that need it, as the
JAX advisors import it). Candidates and the random stream are the JAX
advisor's, so the same seed and feedback give the same proposals.
Pending proposals are imputed at the posterior mean ("constant liar").
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np

from rafiki_tpu_torch.advisor.base import BaseAdvisor, Proposal, TrialResult
from rafiki_tpu_torch.model.knob import (KnobConfig, PolicyKnob,
                                         knobs_from_unit_vector,
                                         knobs_to_unit_vector, sample_knobs,
                                         shape_signature, tunable_knobs)


class BayesOptAdvisor(BaseAdvisor):
    name = "bayes_gp"

    def __init__(self, knob_config: KnobConfig,
                 total_trials: Optional[int] = None,
                 time_budget_s: Optional[float] = None, seed: int = 0,
                 n_initial_points: int = 8, n_candidates: int = 512,
                 xi: float = 0.01) -> None:
        super().__init__(knob_config, total_trials, time_budget_s, seed)
        self._dims = tunable_knobs(knob_config)
        self._n_initial = max(2, min(n_initial_points,
                                     (total_trials or 10) // 2 or 2))
        self._n_candidates = n_candidates
        self._xi = xi
        self._x: List[List[float]] = []
        self._y: List[float] = []
        self._pending: Dict[int, List[float]] = {}
        self._np_rng = np.random.default_rng(seed)

    # ---- BaseAdvisor hooks (called under the base lock) ----
    def _propose(self, trial_no: int) -> Proposal:
        if not self._dims or len(self._y) < self._n_initial:
            knobs = sample_knobs(self.knob_config, self._rng)
            vec = knobs_to_unit_vector(self.knob_config, knobs)
        else:
            vec = self._suggest()
            knobs = knobs_from_unit_vector(self.knob_config, vec, self._rng)
        self._pending[trial_no] = vec
        warm_start = ""
        # Warm-start from the incumbent only when the proposal's traced
        # shapes match it — otherwise loading its pytree would mis-shape.
        if (self.best is not None and self.best.trial_id
                and shape_signature(self.knob_config, knobs)
                == shape_signature(self.knob_config, self.best.knobs)):
            for n, k in self.knob_config.items():
                if isinstance(k, PolicyKnob) and k.policy == "SHARE_PARAMS":
                    knobs[n] = True
                    warm_start = self.best.trial_id
        return Proposal(trial_no=trial_no, knobs=knobs,
                        warm_start_trial_id=warm_start)

    def _feedback(self, result: TrialResult) -> None:
        vec = self._pending.pop(result.trial_no, None)
        if vec is None:
            vec = knobs_to_unit_vector(self.knob_config, result.knobs)
        self._x.append(vec)
        self._y.append(float(result.score))

    def _on_trial_errored(self, trial_no: int) -> None:
        self._pending.pop(trial_no, None)

    # ---- surrogate ----
    def _fit_gp(self, x: np.ndarray, y: np.ndarray) -> "GaussianProcess":
        gp = GaussianProcess(
            length_scale=np.full(x.shape[1], 0.3), alpha=1e-6,
            n_restarts=1, seed=int(self._np_rng.integers(2 ** 31)))
        gp.fit(x, y)
        return gp

    def _suggest(self) -> List[float]:
        x = np.asarray(self._x, dtype=np.float64)
        y = np.asarray(self._y, dtype=np.float64)
        gp = self._fit_gp(x, y)
        # constant liar: impute pending points at posterior mean
        if self._pending:
            xp = np.asarray(list(self._pending.values()), dtype=np.float64)
            yp = gp.predict(xp)
            gp = self._fit_gp(np.vstack([x, xp]), np.concatenate([y, yp]))
            y_all = np.concatenate([y, yp])
        else:
            y_all = y
        best_y = float(np.max(y_all))
        cand = self._np_rng.random((self._n_candidates, len(self._dims)))
        # include jittered copies of the incumbent for local refinement
        inc = x[int(np.argmax(y))]
        local = np.clip(inc + self._np_rng.normal(
            0, 0.05, (self._n_candidates // 8, len(self._dims))), 0, 1)
        cand = np.vstack([cand, local])
        mu, sigma = gp.predict(cand, return_std=True)
        ei = _expected_improvement(mu, np.maximum(sigma, 1e-9),
                                   best_y, self._xi)
        return cand[int(np.argmax(ei))].tolist()


def _expected_improvement(mu: np.ndarray, sigma: np.ndarray, best_y: float,
                          xi: float) -> np.ndarray:
    from scipy.stats import norm

    imp = mu - best_y - xi
    z = imp / sigma
    return imp * norm.cdf(z) + sigma * norm.pdf(z)


class GaussianProcess:
    """GP regression with a ``C · Matérn(ν = 5/2)`` kernel, one length
    scale per dimension: the port's own copy of the
    ``GaussianProcessRegressor(ConstantKernel(1.0) * Matern(length_scale,
    nu=2.5), alpha, normalize_y=True, n_restarts_optimizer)`` that the
    JAX advisor fits, step for step (``fit``, ``log_marginal_likelihood``
    with its gradient, ``predict``). The hyperparameters (log C, log
    length scales, each in [log 1e-5, log 1e5]) maximize the log marginal
    likelihood by scipy's L-BFGS-B, from the initial point and from
    ``n_restarts`` points drawn uniformly in the bounds by
    ``RandomState(seed)``, as scikit-learn does."""

    BOUNDS = (1e-5, 1e5)

    def __init__(self, length_scale: np.ndarray, alpha: float = 1e-6,
                 n_restarts: int = 1, seed: int = 0) -> None:
        self.theta = np.log(np.concatenate([[1.0], length_scale]))
        self.alpha = alpha
        self.n_restarts = n_restarts
        self.seed = seed

    @staticmethod
    def _matern(theta: np.ndarray, a: np.ndarray,
                b: Optional[np.ndarray] = None, grad: bool = False):
        """C · Matérn 5/2 of ``a`` against ``b`` (None: ``a`` itself),
        and with ``grad`` its gradient in the log hyperparameters."""
        from scipy.spatial.distance import cdist, pdist, squareform

        c, ls = np.exp(theta[0]), np.exp(theta[1:])
        if b is None:
            r = pdist(a / ls, metric="euclidean")
        else:
            r = cdist(a / ls, b / ls, metric="euclidean")
        t = r * math.sqrt(5)
        m = (1.0 + t + t ** 2 / 3.0) * np.exp(-t)
        if b is None:
            m = squareform(m)
            np.fill_diagonal(m, 1)
        k = np.full(m.shape, c) * m
        if not grad:
            return k
        d = (a[:, None, :] - a[None, :, :]) ** 2 / (ls ** 2)
        tmp = np.sqrt(5 * d.sum(-1))[..., None]
        m_grad = 5.0 / 3.0 * d * (tmp + 1) * np.exp(-tmp)
        return k, np.dstack((np.full(m.shape, c)[..., None] * m[..., None],
                             m_grad * np.full(m.shape, c)[..., None]))

    def _neg_lml(self, theta: np.ndarray) -> Tuple[float, np.ndarray]:
        from scipy.linalg import cho_solve, cholesky

        k, k_grad = self._matern(theta, self._x, grad=True)
        k[np.diag_indices_from(k)] += self.alpha
        try:
            chol = cholesky(k, lower=True, check_finite=False)
        except np.linalg.LinAlgError:
            return np.inf, np.zeros_like(theta)
        y = self._y[:, None]
        alpha = cho_solve((chol, True), y, check_finite=False)
        lml = -0.5 * np.einsum("ik,ik->k", y, alpha)
        lml -= np.log(np.diag(chol)).sum()
        lml -= k.shape[0] / 2 * np.log(2 * np.pi)
        inner = np.einsum("ik,jk->ijk", alpha, alpha)
        inner -= cho_solve((chol, True), np.eye(k.shape[0]),
                           check_finite=False)[..., None]
        grad = 0.5 * np.einsum("ijl,jik->kl", inner, k_grad).sum(-1)
        return -lml.sum(-1), -grad

    def fit(self, x: np.ndarray, y: np.ndarray) -> "GaussianProcess":
        from scipy.linalg import cho_solve, cholesky
        from scipy.optimize import minimize

        self._x = np.asarray(x, dtype=np.float64)
        y = np.asarray(y, dtype=np.float64)
        self._y_mean = np.mean(y, axis=0)
        std = np.std(y, axis=0)
        self._y_std = 1.0 if std < 10 * np.finfo(std.dtype).eps else std
        self._y = (y - self._y_mean) / self._y_std
        bounds = np.log(np.tile(self.BOUNDS, (len(self.theta), 1)))

        def optimum(start: np.ndarray) -> Tuple[np.ndarray, float]:
            res = minimize(self._neg_lml, start, method="L-BFGS-B",
                           jac=True, bounds=bounds)
            return res.x, res.fun

        optima = [optimum(self.theta)]
        rng = np.random.RandomState(self.seed)
        for _ in range(self.n_restarts):
            optima.append(optimum(rng.uniform(bounds[:, 0], bounds[:, 1])))
        self.theta = optima[int(np.argmin([f for _, f in optima]))][0]
        k = self._matern(self.theta, self._x)
        k[np.diag_indices_from(k)] += self.alpha
        self._chol = cholesky(k, lower=True, check_finite=False)
        self._alpha = cho_solve((self._chol, True), self._y,
                                check_finite=False)
        return self

    def predict(self, x: np.ndarray, return_std: bool = False):
        from scipy.linalg import solve_triangular

        x = np.asarray(x, dtype=np.float64)
        k_trans = self._matern(self.theta, x, self._x)
        mean = self._y_std * (k_trans @ self._alpha) + self._y_mean
        if not return_std:
            return mean
        v = solve_triangular(self._chol, k_trans.T, lower=True,
                             check_finite=False)
        var = np.full(len(x), np.exp(self.theta[0]))
        var -= np.einsum("ij,ji->i", v.T, v)
        var[var < 0] = 0.0
        return mean, np.sqrt(var * self._y_std ** 2)
