"""CART and gradient boosting fits in numpy, standing in for
scikit-learn, which the card's machine does not have.

The JAX package fits its tree templates with scikit-learn
(``rafiki_tpu/models/sklearn_models.py``); this module has no JAX
counterpart. It reproduces, as of scikit-learn 1.9.0:

- :func:`fit_tree`: ``DecisionTreeClassifier(random_state=0)`` and the
  ``DecisionTreeRegressor`` that boosting grows: the depth-first growth
  (``tree/_tree.pyx DepthFirstTreeBuilder.build``: a stack, right child
  pushed first, so nodes are numbered in preorder; a node is a leaf at
  ``max_depth``, below ``min_samples_split``, at an impurity <= EPSILON,
  without a valid split, or when the weighted impurity decrease plus
  EPSILON is below ``min_impurity_decrease``), the best splitter
  (``tree/_splitter.pyx node_split_best``: features visited in the order
  of its Fisher–Yates draw from ``our_rand_r``, seeded per tree by
  ``RandomState.randint(0, RAND_R_MAX)``, known-constant features carried
  to the children; split positions past ties within FEATURE_THRESHOLD;
  the first strictly better proxy wins; the threshold the float64 sum of
  the halves of two float32 values) and the criteria
  (``tree/_criterion.pyx``: Gini, entropy in base 2 as ``_utils.log``,
  squared error; ``proxy_impurity_improvement`` and
  ``impurity_improvement``);
- :func:`fit_gbdt`: ``GradientBoostingClassifier(random_state=0)``
  (``ensemble/_gb.py``): the prior raw score (``DummyClassifier``'s class
  shares through the logit link, scipy's ``logit``, or the symmetric
  multinomial link over scipy's ``gmean``), the
  negative gradients of the half binomial or multinomial loss
  (``_loss/_loss.pyx.tp``), one squared-error tree per class and stage on
  the in-bag rows (``_random_sample_mask`` from the same
  ``RandomState(0)`` stream that seeds the trees), and each leaf's Newton
  step (``_update_terminal_regions``).

Every sum is formed in sklearn's order of operations, so the fits are
sklearn's bit for bit: the Gini proxies from exact class counts; entropy
candidates within 1e-9 of the best computed again with the C library's
``log`` (numpy's vectorized one may differ by an ulp), as are the loss's
``exp``; the squared-error sums one by one in the order sklearn holds a
node's samples (the last sorted feature's order, then the two-pointer
partition) and each split's left sums as ``RegressionCriterion.update``
reaches them. The one order the port cannot know is that of samples
tied on a feature's value after sklearn's unstable introsort: there the
port keeps index order, and a squared-error sum over such a tie may
differ by an ulp.
"""

from __future__ import annotations

import math
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

#: ``tree/_partitioner.pxd``: values closer than this are one value
FEATURE_THRESHOLD = np.float32(1e-7)
#: ``tree/_tree.pyx``
EPSILON = float(np.finfo(np.float64).eps)
#: ``tree/_utils.pxd`` / ``utils/_random.pxd``
RAND_R_MAX = 0x7FFFFFFF
DEFAULT_SEED = 1
TREE_LEAF = -1
TREE_UNDEFINED = -2
#: entropy candidates this close (relative) to the best are recomputed
#: with the C library's log
_EXACT_RTOL = 1e-9
_LN2 = math.log(2.0)


class RandR:
    """``our_rand_r`` / ``rand_int`` of ``utils/_random.pxd``: a 32-bit
    xorshift, reduced modulo 2**31."""

    def __init__(self, seed: int) -> None:
        self.state = int(seed) & 0xFFFFFFFF

    def rand_int(self, low: int, high: int) -> int:
        s = self.state or DEFAULT_SEED
        s ^= (s << 13) & 0xFFFFFFFF
        s ^= s >> 17
        s ^= (s << 5) & 0xFFFFFFFF
        self.state = s
        return low + (s % (RAND_R_MAX + 1)) % (high - low)


def _log2(x: float) -> float:
    return math.log(x) / _LN2


def _entropy(counts: np.ndarray, w: float) -> float:
    """``Entropy``'s impurity of one node or child (C log)."""
    e = 0.0
    for c in counts.tolist():
        if c > 0.0:
            c /= w
            e -= c * _log2(c)
    return e


def _gini(counts: np.ndarray, w: float) -> float:
    sq = 0.0
    for c in counts.tolist():
        sq += c * c
    return 1.0 - sq / (w * w)


class Tree:
    """A fitted tree in sklearn's ``tree_`` layout: ``children_left`` /
    ``children_right`` (-1 at leaves), ``feature`` (-2 at leaves),
    ``threshold`` (float64, -2 at leaves), ``value`` (node, n_values)
    float64: class counts for a classifier, the mean for a regressor."""

    def __init__(self) -> None:
        self.left: List[int] = []
        self.right: List[int] = []
        self.feat: List[int] = []
        self.thr: List[float] = []
        self.val: List[np.ndarray] = []
        self.impurity: List[float] = []
        self.n_node_samples: List[int] = []

    def add_node(self, parent: int, is_left: bool, is_leaf: bool,
                 feature: int, threshold: float, impurity: float,
                 n: int, value: np.ndarray) -> int:
        node = len(self.left)
        if parent != TREE_UNDEFINED:
            if is_left:
                self.left[parent] = node
            else:
                self.right[parent] = node
        self.left.append(TREE_LEAF)
        self.right.append(TREE_LEAF)
        self.feat.append(TREE_UNDEFINED if is_leaf else feature)
        self.thr.append(float(TREE_UNDEFINED) if is_leaf else threshold)
        self.val.append(value)
        self.impurity.append(impurity)
        self.n_node_samples.append(n)
        return node

    def finish(self) -> "Tree":
        self.children_left = np.asarray(self.left, np.int64)
        self.children_right = np.asarray(self.right, np.int64)
        self.feature = np.asarray(self.feat, np.int64)
        self.threshold = np.asarray(self.thr, np.float64)
        self.value = np.stack(self.val).astype(np.float64)
        return self

    def apply(self, x: np.ndarray) -> np.ndarray:
        """Leaf ids of float32 rows (sklearn's ``apply``: the float32
        value, widened, ``<=`` the float64 threshold goes left)."""
        node = np.zeros(len(x), np.int64)
        rows = np.arange(len(x))
        while True:
            feat = self.feature[node]
            inner = feat >= 0
            if not inner.any():
                return node
            v = x[rows, np.maximum(feat, 0)].astype(np.float64)
            nxt = np.where(v <= self.threshold[node],
                           self.children_left[node],
                           self.children_right[node])
            node = np.where(inner, nxt, node)


class _Splitter:
    """The best splitter's state that persists across nodes: the feature
    permutation, the known-constant features and the ``rand_r`` state."""

    def __init__(self, n_features: int, seed: int) -> None:
        self.features = list(range(n_features))
        self.constant_features = [0] * n_features
        self.rand = RandR(seed)

    def visit_order(self, n_known: int, constant: np.ndarray
                    ) -> Tuple[List[int], int, int]:
        """``node_split_best``'s Fisher–Yates loop with ``max_features``
        = all: the non-constant features in the order they are
        evaluated, the node's constant-feature count for its children,
        and the last feature sorted (the order the node's samples are in
        when they are partitioned; -1 if none). ``constant[f]`` is the
        node's constant test of f."""
        features, consts = self.features, self.constant_features
        n_features = len(features)
        f_i = n_features
        n_visited = n_found = n_drawn = 0
        n_total = n_known
        order: List[int] = []
        last = -1
        while f_i > n_total and (n_visited < n_features
                                 or n_visited <= n_found + n_drawn):
            n_visited += 1
            f_j = self.rand.rand_int(n_drawn, f_i - n_found)
            if f_j < n_known:
                features[n_drawn], features[f_j] = \
                    features[f_j], features[n_drawn]
                n_drawn += 1
                continue
            f_j += n_found
            feat = last = features[f_j]
            if constant[feat]:
                features[f_j], features[n_total] = \
                    features[n_total], features[f_j]
                n_found += 1
                n_total += 1
                continue
            f_i -= 1
            features[f_i], features[f_j] = features[f_j], features[f_i]
            order.append(feat)
        features[:n_known] = consts[:n_known]
        consts[n_known:n_known + n_found] = \
            features[n_known:n_known + n_found]
        return order, n_total, last


def _seq_sum(a: np.ndarray, start: float = 0.0) -> float:
    """``start`` plus the elements of ``a`` added one by one, in order,
    as sklearn's loops add them (``np.sum`` adds pairwise)."""
    if not len(a):
        return start
    return float(np.cumsum(np.concatenate(([start], a)))[-1])


def _partition(seq: np.ndarray, go_left: np.ndarray
               ) -> Tuple[np.ndarray, np.ndarray]:
    """``DensePartitioner.partition_samples_final``: the two-pointer
    partition of ``seq`` (the node's samples as its last sort left them),
    which fixes the order each child sums its samples in."""
    s, g = seq.tolist(), go_left.tolist()
    i, j = 0, len(s)
    while i < j:
        if g[i]:
            i += 1
        else:
            j -= 1
            s[i], s[j] = s[j], s[i]
            g[i], g[j] = g[j], g[i]
    return np.asarray(s[:i], np.int64), np.asarray(s[i:], np.int64)


class _Criterion:
    """One criterion over a node's samples ``idx``, in the order sklearn
    holds them. ``stats`` are the node's sums, ``wn`` its weight."""

    def node_stats(self, idx: np.ndarray) -> Tuple[Any, float]:
        raise NotImplementedError

    def node_impurity(self, stats: Any, wn: float) -> float:
        raise NotImplementedError

    def proxies(self, ids: np.ndarray, valid: np.ndarray, stats: Any,
                wn: float) -> np.ndarray:
        """The proxy (m-1, v) at positions 1..m-1 of the sorted samples
        ``ids`` (m, v) of each visited feature; ``valid`` marks the
        positions sklearn evaluates."""
        raise NotImplementedError

    def exact_proxy(self, ids: np.ndarray, pos: int, stats: Any,
                    wn: float) -> float:
        raise NotImplementedError

    def children(self, left: np.ndarray, right: np.ndarray, stats: Any,
                 wn: float) -> Tuple[float, float, float]:
        """``(impurity_left, impurity_right, weighted_n_left)`` of the
        partitioned node (``criterion.update(pos)`` from a reset)."""
        raise NotImplementedError

    def value(self, stats: Any, wn: float) -> np.ndarray:
        raise NotImplementedError


class _Classification(_Criterion):
    def __init__(self, y: np.ndarray, n_classes: int, entropy: bool
                 ) -> None:
        self.y = y
        self.k = n_classes
        self.entropy = entropy
        self.impurity = _entropy if entropy else _gini

    def _counts(self, idx: np.ndarray) -> np.ndarray:
        return np.bincount(self.y[idx], minlength=self.k).astype(np.float64)

    def node_stats(self, idx):
        return self._counts(idx), float(len(idx))

    def node_impurity(self, stats, wn):
        return self.impurity(stats, wn)

    def proxies(self, ids, valid, stats, wn):
        m = len(ids)
        onehot = self.y[ids][..., None] == np.arange(self.k)  # (m, v, K)
        left = np.cumsum(onehot, axis=0, dtype=np.int64)[:-1].astype(
            np.float64)
        right = stats - left
        wl = np.arange(1, m, dtype=np.float64)[:, None]
        wr = wn - wl
        if self.entropy:
            il, ir = np.zeros(left.shape[:2]), np.zeros(left.shape[:2])
            with np.errstate(divide="ignore", invalid="ignore"):
                for c in range(self.k):
                    for acc, cnt, w in ((il, left[..., c], wl),
                                        (ir, right[..., c], wr)):
                        p = cnt / w
                        acc -= np.where(cnt > 0.0, p * (np.log(p) / _LN2),
                                        0.0)
        else:
            sl, sr = np.zeros(left.shape[:2]), np.zeros(left.shape[:2])
            for c in range(self.k):
                sl += left[..., c] * left[..., c]
                sr += right[..., c] * right[..., c]
            il = 1.0 - sl / (wl * wl)
            ir = 1.0 - sr / (wr * wr)
        return -wr * ir - wl * il

    def exact_proxy(self, ids, pos, stats, wn):
        cl = self._counts(ids[:pos])
        wl, wr = float(pos), wn - float(pos)
        return -wr * self.impurity(stats - cl, wr) \
            - wl * self.impurity(cl, wl)

    def children(self, left, right, stats, wn):
        cl = self._counts(left)
        wl = float(len(left))
        return (self.impurity(cl, wl), self.impurity(stats - cl, wn - wl),
                wl)

    def value(self, stats, wn):
        return stats


class _SquaredError(_Criterion):
    """``MSE`` with sklearn's summation orders: the node's totals in its
    sample order, each split's left sums as ``RegressionCriterion.update``
    reaches them (forward from the previous position, or back from the
    end when that is shorter)."""

    def __init__(self, y: np.ndarray, w: np.ndarray) -> None:
        self.y = y
        self.w = w
        self.wy = w * y
        # every fitted row weighs 1 (boosting's in-bag rows): the left
        # weights are the positions, exactly
        self.unit = bool(np.all((w == 0.0) | (w == 1.0)))

    def node_stats(self, idx):
        wy = self.wy[idx]
        return (_seq_sum(wy), _seq_sum(wy * self.y[idx])), \
            _seq_sum(self.w[idx])

    def node_impurity(self, stats, wn):
        s, sq = stats
        return sq / wn - (s / wn) ** 2.0

    def _left_sums(self, ids: np.ndarray, positions: np.ndarray,
                   stats, wn) -> Tuple[np.ndarray, np.ndarray]:
        """sum_left and weighted_n_left at ``positions`` (ascending) of
        one feature's sorted samples ``ids``, as the updates from a reset
        compute them."""
        m = len(ids)
        wy, w = self.wy[ids], self.w[ids]
        prev = np.concatenate(([0], positions[:-1]))
        if not np.any(positions - prev > m - positions):
            return (np.cumsum(wy)[positions - 1],
                    np.cumsum(w)[positions - 1])
        sums, wls = np.empty(len(positions)), np.empty(len(positions))
        s, wl, pos = 0.0, 0.0, 0
        for k, p in enumerate(positions.tolist()):
            if p - pos <= m - p:
                s, wl = _seq_sum(wy[pos:p], s), _seq_sum(w[pos:p], wl)
            else:
                s = _seq_sum(-wy[p:][::-1], stats[0])
                wl = _seq_sum(-w[p:][::-1], wn)
            sums[k], wls[k], pos = s, wl, p
        return sums, wls

    def proxies(self, ids, valid, stats, wn):
        m = len(ids)
        sum_left = np.cumsum(self.wy[ids], axis=0)[:-1]
        if self.unit:
            wl = np.broadcast_to(np.arange(1.0, m)[:, None],
                                 sum_left.shape).copy()
        else:
            wl = np.cumsum(self.w[ids], axis=0)[:-1]
        # a position is reached backwards when the step from the previous
        # valid one is longer than the rest of the node
        at = np.where(valid, np.arange(1, m)[:, None], 0)
        prev = np.maximum.accumulate(
            np.concatenate([np.zeros((1, at.shape[1]), at.dtype),
                            at[:-1]]), axis=0)
        pos = np.arange(1, m)[:, None]
        backwards = valid & (pos - prev > m - pos)
        for v in np.flatnonzero(backwards.any(axis=0)):
            rows = np.flatnonzero(valid[:, v])
            sum_left[rows, v], wl[rows, v] = self._left_sums(
                ids[:, v], rows + 1, stats, wn)
        sum_right = stats[0] - sum_left
        wr = wn - wl
        with np.errstate(divide="ignore", invalid="ignore"):
            return sum_left * sum_left / wl + sum_right * sum_right / wr

    def children(self, left, right, stats, wn):
        s, sq = stats
        m = len(left) + len(right)
        if len(left) <= m - len(left):
            sum_left = _seq_sum(self.wy[left])
            wl = _seq_sum(self.w[left])
        else:
            sum_left = _seq_sum(-self.wy[right][::-1], s)
            wl = _seq_sum(-self.w[right][::-1], wn)
        wr = wn - wl
        sq_left = _seq_sum(self.wy[left] * self.y[left])
        il = sq_left / wl - (sum_left / wl) ** 2.0
        ir = (sq - sq_left) / wr - ((s - sum_left) / wr) ** 2.0
        return il, ir, wl

    def value(self, stats, wn):
        return np.asarray([stats[0] / wn])


class _Sorter:
    """Each feature's ascending order of a node's samples: the tree's
    presort filtered to the node while the node is large, a sort of the
    node's values once it is small."""

    def __init__(self, x: np.ndarray) -> None:
        self.x = x
        self.glob = np.argsort(x, axis=0, kind="stable")

    def sorted_ids(self, idx: np.ndarray, feats: List[int]) -> np.ndarray:
        n = len(self.x)
        if len(idx) * 8 >= n:
            inside = np.zeros(n, dtype=bool)
            inside[idx] = True
            g = self.glob[:, feats]
            sel = inside[g]
            return g.T[sel.T].reshape(len(feats), len(idx)).T
        order = np.argsort(self.x[np.ix_(idx, feats)], axis=0,
                           kind="stable")
        return idx[order]


def _build(x: np.ndarray, crit: _Criterion, samples: np.ndarray,
           w_all: float, max_depth: int, min_samples_split: int,
           min_impurity_decrease: float, seed: int, exact_ties: bool,
           sorter: _Sorter) -> Tree:
    """``DepthFirstTreeBuilder.build`` over the positively weighted
    ``samples``."""
    tree = Tree()
    splitter = _Splitter(x.shape[1], seed)
    # (samples, depth, parent, is_left, impurity, n_constant_features)
    stack: List[Tuple[np.ndarray, int, int, bool, float, int]] = [
        (samples, 0, TREE_UNDEFINED, False, math.inf, 0)]
    first = True
    while stack:
        idx, depth, parent, is_left, impurity, n_const = stack.pop()
        m = len(idx)
        stats, wn = crit.node_stats(idx)
        is_leaf = depth >= max_depth or m < min_samples_split or m < 2
        if first:
            impurity = crit.node_impurity(stats, wn)
            first = False
        is_leaf = is_leaf or impurity <= EPSILON
        split = None
        if not is_leaf:
            split, n_const = _node_split(x, crit, splitter, sorter, idx,
                                         stats, wn, n_const, exact_ties)
            if split is not None:
                _, _, left, right, il, ir, wl = split
                wr = wn - wl
                improvement = (wn / w_all) * (impurity - (wr / wn * ir)
                                              - (wl / wn * il))
                if improvement + EPSILON < min_impurity_decrease:
                    split = None
            is_leaf = split is None
        feat, thr = (split[0], split[1]) if split else (0, 0.0)
        node = tree.add_node(parent, is_left, is_leaf, feat, thr, impurity,
                             m, crit.value(stats, wn))
        if not is_leaf:
            stack.append((split[3], depth + 1, node, False, split[5],
                          n_const))
            stack.append((split[2], depth + 1, node, True, split[4],
                          n_const))
    return tree.finish()


def _node_split(x, crit, splitter, sorter, idx, stats, wn, n_known,
                exact_ties):
    """``node_split_best``: ``((feature, threshold, left samples, right
    samples, impurity_left, impurity_right, weighted_n_left) or None,
    n_constant_features)``."""
    xn = x[idx]
    constant = xn.max(axis=0) <= xn.min(axis=0) + FEATURE_THRESHOLD
    visit, n_total, last = splitter.visit_order(n_known, constant)
    if not visit:
        return None, n_total
    ids = sorter.sorted_ids(idx, visit)            # (m, v)
    xs = x[ids, np.asarray(visit)]                 # (m, v)
    valid = xs[1:] > xs[:-1] + FEATURE_THRESHOLD
    proxy = crit.proxies(ids, valid, stats, wn)
    proxy = np.where(valid, proxy, -np.inf)
    best = proxy.max()
    if best == -np.inf:
        return None, n_total
    if exact_ties:
        # candidates within rounding of the best, in visit then position
        # order, computed again with the C library's log
        near = np.argwhere(proxy.T >= best - _EXACT_RTOL * abs(best))
        best_val, pick = -math.inf, (0, 0)
        for v, p in near:
            pv = crit.exact_proxy(ids[:, v], int(p) + 1, stats, wn)
            if pv > best_val:
                best_val, pick = pv, (int(v), int(p))
        v, p = pick
    else:
        first = np.argmax(proxy, axis=0)
        v = int(np.argmax(proxy[first, np.arange(len(visit))]))
        p = int(first[v])
    f = int(visit[v])
    lo, hi = float(xs[p, v]), float(xs[p + 1, v])
    thr = lo / 2.0 + hi / 2.0
    if thr == hi or math.isinf(thr):
        thr = lo
    seq = ids[:, visit.index(last)] if last in visit \
        else sorter.sorted_ids(idx, [last])[:, 0]
    left, right = _partition(seq, x[seq, f].astype(np.float64) <= thr)
    il, ir, wl = crit.children(left, right, stats, wn)
    return (f, thr, left, right, il, ir, wl), n_total


def fit_tree(x: np.ndarray, y: np.ndarray, *, max_depth: int,
             min_samples_split: int = 2, min_impurity_decrease: float = 0.0,
             criterion: str = "gini", sample_weight: Optional[np.ndarray]
             = None, n_classes: int = 0, seed: Optional[int] = None,
             sorter: Optional[_Sorter] = None) -> Tree:
    """Grow one tree on float32 features ``x``: a classifier over class
    ids ``y`` (0..``n_classes``-1) with ``criterion`` "gini" or
    "entropy", or a regressor (``criterion="squared_error"``) over
    float64 targets with ``sample_weight`` (rows of weight 0 are left
    out, as sklearn leaves them). The splitter's ``rand_r`` seed is
    ``seed``, by default the first draw of ``random_state=0``
    (``RandomState(0).randint(0, RAND_R_MAX)``); ``sorter`` may carry
    the presort of ``x`` across trees."""
    if seed is None:
        seed = int(np.random.RandomState(0).randint(0, RAND_R_MAX))
    x = np.ascontiguousarray(x, np.float32)
    if criterion == "squared_error":
        w = np.ones(len(x)) if sample_weight is None \
            else np.asarray(sample_weight, np.float64)
        crit: _Criterion = _SquaredError(np.asarray(y, np.float64), w)
        samples = np.flatnonzero(w != 0.0)
        w_all = _seq_sum(w)
    elif criterion in ("gini", "entropy"):
        crit = _Classification(np.asarray(y, np.int64), n_classes,
                               criterion == "entropy")
        samples = np.arange(len(x))
        w_all = float(len(x))
    else:
        raise ValueError(f"criterion {criterion!r}: the port fits 'gini', "
                         "'entropy' and 'squared_error'")
    return _build(x, crit, samples, w_all, int(max_depth),
                  int(min_samples_split), float(min_impurity_decrease),
                  seed, criterion == "entropy", sorter or _Sorter(x))


def _random_sample_mask(n: int, n_inbag: int,
                        rs: np.random.RandomState) -> np.ndarray:
    """``ensemble/_gradient_boosting.pyx _random_sample_mask``."""
    rand = rs.uniform(size=n)
    mask = np.zeros(n, dtype=bool)
    n_bagged = 0
    for i in range(n):
        if rand[i] * (n - i) < (n_inbag - n_bagged):
            mask[i] = True
            n_bagged += 1
    return mask


def _c_exp(a: np.ndarray) -> np.ndarray:
    """``exp`` elementwise through the C library, as the loss's Cython
    calls it (numpy's vectorized exp may differ by an ulp)."""
    return np.fromiter(map(math.exp, a.ravel().tolist()), np.float64,
                       a.size).reshape(a.shape)


def _neg_gradient(y: np.ndarray, raw: np.ndarray) -> np.ndarray:
    """Minus the gradient of the half binomial (one raw column) or
    half multinomial loss, as ``_loss.pyx.tp`` computes it."""
    if raw.shape[1] == 1:
        r = raw[:, 0]
        hi = r > -37
        out = np.empty_like(r)
        e = _c_exp(-r[hi])
        yt = y[hi]
        out[hi] = ((1 - yt) - yt * e) / (1 + e)
        out[~hi] = _c_exp(r[~hi]) - y[~hi]
        return -out[:, None]
    mx = raw[:, 0].copy()
    for k in range(1, raw.shape[1]):
        mx = np.where(mx < raw[:, k], raw[:, k], mx)
    p = _c_exp(raw - mx[:, None])
    s = np.zeros(len(raw))
    for k in range(raw.shape[1]):
        s += p[:, k]
    grad = p / s[:, None] - (y[:, None] == np.arange(raw.shape[1]))
    return -grad


def _logit(x: float) -> float:
    """``scipy.special.logit`` (its ``xsf`` formula: log1p near 1/2)."""
    if x < 0.3 or x > 0.65:
        return math.log(x / (1 - x))
    s = 2 * (x - 0.5)
    return math.log1p(s) - math.log1p(-s)


def _safe_divide(num: float, den: float) -> float:
    if abs(den) < 1e-150:
        return 0.0
    return float(num) / float(den)


def fit_gbdt(x: np.ndarray, y: np.ndarray, *, n_estimators: int,
             learning_rate: float, max_depth: int, subsample: float
             ) -> Dict[str, Any]:
    """``GradientBoostingClassifier(random_state=0)`` on float32 ``x``
    and integer labels ``y``. Returns ``{"trees": [[Tree per raw column]
    per stage], "classes", "class_prior", "k"}``; each tree's ``value``
    holds its leaves' Newton steps (internal nodes: the mean target)."""
    x = np.ascontiguousarray(x, np.float32)
    classes, yi = np.unique(np.asarray(y), return_inverse=True)
    n_classes = len(classes)
    if n_classes < 2:
        raise ValueError("GBDT needs at least 2 classes in the data; got "
                         f"{n_classes}")
    n = len(x)
    yf = yi.astype(np.float64)
    sample_weight = np.ones(n)
    counts = np.bincount(yi)
    prior = counts / counts.sum()
    eps = np.finfo(np.float64).eps
    k = 1 if n_classes == 2 else n_classes
    if k == 1:
        p1 = np.clip(np.tile(prior[1], n), eps, 1 - eps, dtype=np.float64)
        raw = np.asarray([_logit(float(v)) for v in p1]).reshape(-1, 1)
    else:
        p = np.clip(np.tile(prior, (n, 1)), eps, 1 - eps, dtype=np.float64)
        # the symmetric link: log(p / gmean(p)), scipy's gmean
        raw = np.log(p / np.exp(np.mean(np.log(p), axis=1))[:, None])
    rs = np.random.RandomState(0)
    n_inbag = max(1, int(subsample * n))
    mask = np.ones(n, dtype=bool)
    sorter = _Sorter(x)
    stages: List[List[Tree]] = []
    with ThreadPoolExecutor(max_workers=min(k, os.cpu_count() or 1)) \
            as pool:
        for _ in range(int(n_estimators)):
            if subsample < 1.0:
                mask = _random_sample_mask(n, n_inbag, rs)
            neg_g = _neg_gradient(yf, raw)
            sw = sample_weight * mask.astype(np.float64) if subsample < 1.0 \
                else sample_weight
            # a stage's trees share its gradients and nothing else: their
            # seeds are drawn in sklearn's order, then they grow in parallel
            seeds = [int(rs.randint(0, RAND_R_MAX)) for _ in range(k)]
            targets = [(yi == c).astype(np.float64) if k > 1 else yf
                       for c in range(k)]
            stage = list(pool.map(
                lambda c: fit_tree(x, neg_g[:, c], max_depth=max_depth,
                                   criterion="squared_error", sample_weight=sw,
                                   sorter=sorter, seed=seeds[c]), range(k)))
            for c, tree in enumerate(stage):
                regions = tree.apply(x)
                masked = np.where(mask, regions, -1)
                for leaf in np.nonzero(tree.children_left == TREE_LEAF)[0]:
                    ix = np.nonzero(masked == leaf)[0]
                    g = neg_g[:, c].take(ix, axis=0)
                    prob = targets[c].take(ix, axis=0) - g
                    num = np.average(g, weights=sw[ix])
                    if k > 1:
                        num *= (n_classes - 1) / n_classes
                    den = np.average(prob * (1 - prob), weights=sw[ix])
                    tree.value[leaf, 0] = _safe_divide(num, den)
                raw[:, c] += learning_rate * tree.value[:, 0].take(regions)
            stages.append(stage)
    return {"trees": stages, "classes": classes, "class_prior": prior,
            "k": k}
