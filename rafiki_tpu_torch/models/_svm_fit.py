"""A C-SVC fit in numpy, standing in for scikit-learn's libsvm, which
the card's machine does not have.

The JAX package fits ``SklearnSVM`` with ``sklearn.svm.SVC``
(``rafiki_tpu/models/sklearn_models.py``); this module has no JAX
counterpart. It follows scikit-learn 1.9.0's copy of libsvm
(``svm/src/libsvm/svm.cpp``):

- ``svm_group_classes``: the classes in ascending label order (sklearn's
  change to libsvm), each class's rows in data order;
- ``svm_train``: one ``svm_train_one`` / ``solve_c_svc`` per class pair
  (i < j), class i's rows labelled +1 then class j's -1, ``C`` per row;
  the model's support vectors grouped by class, ``sv_coef`` of shape
  (K-1, n_SV) laid out as libsvm lays it out, ``rho`` per pair;
- ``Solver::Solve``: the kernel matrix ``Q`` stored in float32
  (``Qfloat``) with a float64 diagonal ``QD``; the second-order working
  set selection (``select_working_set``, later indices winning ties), the
  two-variable update clipped to the box, the gradient and ``G_bar``
  updates, shrinking every min(l, 1000) iterations (``do_shrinking``,
  ``be_shrunk``, ``swap_index``, ``reconstruct_gradient``, unshrinking
  once the gap is within 10·eps), the stop when the gap is below
  ``eps`` (sklearn's ``tol`` 1e-3), and ``calculate_rho``;
- the exported layout of ``SVC``: ``support_vectors_``, ``dual_coef_``,
  ``intercept_`` = -rho (no -0.0), ``n_support_``, negated for two
  classes as ``BaseSVC.fit`` negates them.

The kernels are libsvm's (linear ``x·y``, rbf ``exp(-gamma·(|x|² + |y|²
− 2x·y))``) over float64 rows; the dot products come from one matrix
product rather than libsvm's row-pair BLAS calls, which may move a
float64 kernel value by an ulp, and ``Q`` keeps it only to float32
precision. So the port's solver takes libsvm's steps and reaches its
solution to rounding (the tests hold decision values to 1e-4).
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np

#: libsvm's ``TAU``: the curvature floor of a non-PSD pair
TAU = 1e-12
LOWER, FREE, UPPER = 0, 1, 2


def kernel_matrix(x: np.ndarray, kernel: str, gamma: float) -> np.ndarray:
    """The float64 kernel over the rows of ``x``."""
    g = x @ x.T
    if kernel == "linear":
        return g
    if kernel != "rbf":
        raise ValueError(f"kernel {kernel!r}: the port fits 'linear' and "
                         "'rbf'")
    sq = np.diagonal(g).copy()
    return np.exp(-gamma * (sq[:, None] + sq[None, :] - 2 * g))


class _Solver:
    """``Solver`` of ``svm.cpp`` for one C-SVC problem: every per-row
    array is held in the solver's current (shrunk and swapped) order,
    ``perm`` maps a position to its row."""

    def __init__(self, k: np.ndarray, y: np.ndarray, c: np.ndarray,
                 eps: float) -> None:
        self.l = n = len(y)
        self.qf = (y[:, None] * y[None, :] * k).astype(np.float32)
        self.qd = np.diagonal(k).astype(np.float64).copy()
        self.y = y.astype(np.float64)
        self.c = c.astype(np.float64)
        self.p = -np.ones(n)
        self.alpha = np.zeros(n)
        self.status = np.full(n, LOWER, np.int8)
        self.perm = np.arange(n)
        self.g = self.p.copy()
        self.g_bar = np.zeros(n)
        self.active = n
        self.eps = eps
        self.unshrink = False

    def q_row(self, i: int, length: int) -> np.ndarray:
        """``get_Q(i, length)``: float32 values, widened."""
        return self.qf[self.perm[i], self.perm[:length]].astype(np.float64)

    def _set_status(self, i: int) -> None:
        a, c = self.alpha[i], self.c[i]
        self.status[i] = UPPER if a >= c else LOWER if a <= 0 else FREE

    def swap(self, i: int, j: int) -> None:
        for a in (self.y, self.g, self.status, self.alpha, self.p,
                  self.perm, self.g_bar, self.c, self.qd):
            a[i], a[j] = a[j], a[i]

    def select(self) -> Tuple[int, int, bool]:
        """``select_working_set``: ``(i, j, optimal)``."""
        a = self.active
        y, g, st = self.y[:a], self.g[:a], self.status[:a]
        pos = y > 0
        up = np.where(pos, st != UPPER, st != LOWER)
        val = np.where(pos, -g, g)
        if not up.any():
            return -1, -1, True
        gmax = val[up].max()
        i = int(np.flatnonzero(up & (val == gmax))[-1])
        low = np.where(pos, st != LOWER, st != UPPER)
        v2 = np.where(pos, g, -g)
        gmax2 = v2[low].max() if low.any() else -np.inf
        grad_diff = np.where(pos, gmax + g, gmax - g)
        q_i = self.q_row(i, a)
        quad = np.where(pos, (self.qd[i] + self.qd[:a])
                        - 2.0 * y[i] * q_i,
                        (self.qd[i] + self.qd[:a]) + 2.0 * y[i] * q_i)
        cand = low & (grad_diff > 0)
        if not cand.any() or gmax + gmax2 < self.eps:
            return i, -1, True
        quad = np.where(quad > 0, quad, TAU)
        obj = -(grad_diff * grad_diff) / quad
        obj_min = obj[cand].min()
        j = int(np.flatnonzero(cand & (obj == obj_min))[-1])
        return i, j, False

    def update(self, i: int, j: int) -> None:
        """One step on the pair: the box-clipped alphas, ``G`` and
        ``G_bar``."""
        a = self.active
        q_i, q_j = self.q_row(i, a), self.q_row(j, a)
        c_i, c_j = float(self.c[i]), float(self.c[j])
        old_i, old_j = float(self.alpha[i]), float(self.alpha[j])
        ai, aj = old_i, old_j
        qd_i, qd_j = float(self.qd[i]), float(self.qd[j])
        g_i, g_j = float(self.g[i]), float(self.g[j])
        qij = float(self.qf[self.perm[i], self.perm[j]])
        if self.y[i] != self.y[j]:
            quad = qd_i + qd_j + 2 * qij
            if quad <= 0:
                quad = TAU
            delta = (-g_i - g_j) / quad
            diff = ai - aj
            ai += delta
            aj += delta
            if diff > 0:
                if aj < 0:
                    aj, ai = 0.0, diff
            elif ai < 0:
                ai, aj = 0.0, -diff
            if diff > c_i - c_j:
                if ai > c_i:
                    ai, aj = c_i, c_i - diff
            elif aj > c_j:
                aj, ai = c_j, c_j + diff
        else:
            quad = qd_i + qd_j - 2 * qij
            if quad <= 0:
                quad = TAU
            delta = (g_i - g_j) / quad
            total = ai + aj
            ai -= delta
            aj += delta
            if total > c_i:
                if ai > c_i:
                    ai, aj = c_i, total - c_i
            elif aj < 0:
                aj, ai = 0.0, total
            if total > c_j:
                if aj > c_j:
                    aj, ai = c_j, total - c_j
            elif ai < 0:
                ai, aj = 0.0, total
        self.alpha[i], self.alpha[j] = ai, aj
        self.g[:a] += q_i * (ai - old_i) + q_j * (aj - old_j)
        ui, uj = self.status[i] == UPPER, self.status[j] == UPPER
        self._set_status(i)
        self._set_status(j)
        for t, was, c_t in ((i, ui, c_i), (j, uj, c_j)):
            if was != (self.status[t] == UPPER):
                row = self.q_row(t, self.l)
                if was:
                    self.g_bar -= c_t * row
                else:
                    self.g_bar += c_t * row

    def reconstruct_gradient(self) -> None:
        a, n = self.active, self.l
        if a == n:
            return
        self.g[a:] = self.g_bar[a:] + self.p[a:]
        free = np.flatnonzero(self.status[:a] == FREE)
        if len(free):
            terms = self.alpha[free, None] * self.qf[np.ix_(
                self.perm[free], self.perm[a:])].astype(np.float64)
            self.g[a:] = np.cumsum(
                np.concatenate([self.g[None, a:], terms]), axis=0)[-1]

    def _be_shrunk(self, gmax1: float, gmax2: float) -> np.ndarray:
        a = self.active
        y, g, st = self.y[:a], self.g[:a], self.status[:a]
        pos = y > 0
        upper = np.where(pos, -g > gmax1, -g > gmax2)
        lower = np.where(pos, g > gmax2, g > gmax1)
        return np.where(st == UPPER, upper,
                        np.where(st == LOWER, lower, False))

    def shrink(self) -> None:
        """``do_shrinking``."""
        a = self.active
        y, g, st = self.y[:a], self.g[:a], self.status[:a]
        pos = y > 0
        m1 = np.where(pos, st != UPPER, st != LOWER)
        m2 = np.where(pos, st != LOWER, st != UPPER)
        v1 = np.where(pos, -g, g)
        v2 = np.where(pos, g, -g)
        gmax1 = v1[m1].max() if m1.any() else -np.inf
        gmax2 = v2[m2].max() if m2.any() else -np.inf
        if not self.unshrink and gmax1 + gmax2 <= self.eps * 10:
            self.unshrink = True
            self.reconstruct_gradient()
            self.active = self.l
        flags = self._be_shrunk(gmax1, gmax2).tolist()
        i = 0
        while i < self.active:
            if flags[i]:
                self.active -= 1
                while self.active > i:
                    if not flags[self.active]:
                        self.swap(i, self.active)
                        flags[i], flags[self.active] = \
                            flags[self.active], flags[i]
                        break
                    self.active -= 1
            i += 1

    def rho(self) -> float:
        """``calculate_rho``."""
        a = self.active
        yg = self.y[:a] * self.g[:a]
        st, pos = self.status[:a], self.y[:a] > 0
        free = st == FREE
        if free.any():
            return float(np.cumsum(yg[free])[-1]) / int(free.sum())
        to_ub = ((st == UPPER) & ~pos) | ((st == LOWER) & pos)
        to_lb = ((st == UPPER) & pos) | ((st == LOWER) & ~pos)
        ub = float(yg[to_ub].min()) if to_ub.any() else np.inf
        lb = float(yg[to_lb].max()) if to_lb.any() else -np.inf
        return (ub + lb) / 2

    def solve(self) -> Tuple[np.ndarray, float, int]:
        """``Solve``: (alpha in row order, rho, iterations)."""
        it = 0
        counter = min(self.l, 1000) + 1
        while True:
            counter -= 1
            if counter == 0:
                counter = min(self.l, 1000)
                self.shrink()
            i, j, optimal = self.select()
            if optimal:
                self.reconstruct_gradient()
                self.active = self.l
                i, j, optimal = self.select()
                if optimal:
                    break
                counter = 1
            it += 1
            self.update(i, j)
        rho = self.rho()
        alpha = np.empty(self.l)
        alpha[self.perm] = self.alpha
        return alpha, rho, it


def fit_svc(x: np.ndarray, labels: np.ndarray, *, c: float, kernel: str,
            gamma: float, tol: float = 1e-3) -> Dict[str, Any]:
    """``SVC(C=c, kernel=kernel, gamma=gamma).fit(x, labels)`` in
    sklearn's exported layout: ``support_vectors_``, ``dual_coef_``,
    ``intercept_``, ``n_support_``, ``classes_``, ``support_``,
    ``n_iter_``."""
    x = np.ascontiguousarray(x, np.float64)
    classes, y = np.unique(np.asarray(labels), return_inverse=True)
    n_classes = len(classes)
    perm = np.argsort(y, kind="stable")  # grouped by class, data order
    count = np.bincount(y, minlength=n_classes)
    start = np.concatenate([[0], np.cumsum(count)[:-1]])
    k_all = kernel_matrix(x[perm], kernel, gamma)
    if kernel == "linear":  # libsvm's diagonal: each row's own dot
        np.fill_diagonal(k_all, [float(np.dot(r, r)) for r in x[perm]])
    nonzero = np.zeros(len(x), dtype=bool)
    fits: List[Tuple[np.ndarray, float, int]] = []
    for i in range(n_classes):
        for j in range(i + 1, n_classes):
            rows = np.concatenate([np.arange(start[i], start[i] + count[i]),
                                   np.arange(start[j], start[j] + count[j])])
            yy = np.concatenate([np.ones(count[i]), -np.ones(count[j])])
            solver = _Solver(k_all[np.ix_(rows, rows)], yy,
                             np.full(len(rows), float(c)), tol)
            alpha, rho, it = solver.solve()
            coef = alpha * yy
            nonzero[rows[np.abs(coef) > 0]] = True
            fits.append((coef, rho, it))
    n_sv = np.asarray([int(nonzero[start[i]:start[i] + count[i]].sum())
                       for i in range(n_classes)], np.int32)
    nz_start = np.concatenate([[0], np.cumsum(n_sv)[:-1]])
    sv_coef = np.zeros((max(n_classes - 1, 1), int(n_sv.sum())))
    p = 0
    for i in range(n_classes):
        for j in range(i + 1, n_classes):
            coef = fits[p][0]
            ci = count[i]
            q = nz_start[i]
            for kk in range(ci):
                if nonzero[start[i] + kk]:
                    sv_coef[j - 1, q] = coef[kk]
                    q += 1
            q = nz_start[j]
            for kk in range(count[j]):
                if nonzero[start[j] + kk]:
                    sv_coef[i, q] = coef[ci + kk]
                    q += 1
            p += 1
    support = perm[nonzero]
    intercept = np.asarray([-f[1] if f[1] != 0 else 0.0 for f in fits])
    if n_classes == 2:  # BaseSVC.fit's public sign for two classes
        sv_coef, intercept = -sv_coef, -intercept
    return {"support_vectors_": x[support], "dual_coef_": sv_coef,
            "intercept_": intercept, "n_support_": n_sv,
            "classes_": classes, "support_": support,
            "n_iter_": np.asarray([f[2] for f in fits])}
