"""sklearn model inference, host (numpy) half (port of
models/sklearn_infer.py).

The acoustic sentiment heads (a StandardScaler, an SVC for the client,
a RandomForestClassifier for the agent) are microscopic (38-dim
inputs), so at runtime they run on the host in numpy
(pipeline/sentiment.py). This module holds what that runtime uses: the
fit-time converters and the ``*_np`` functions, with sklearn's numerics:

- SVC.predict is one-vs-one *voting* (not argmax of probabilities).
- SVC.predict_proba is libsvm's pairwise Platt sigmoids combined with
  the Wu-Lin coupling iteration, including its early-exit tolerance.
- RandomForest.predict_proba is the mean of per-tree leaf class
  distributions; predict is its argmax.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np


# ----------------------------------------------------------------------
# Converters (fit-time, host side)
# ----------------------------------------------------------------------

def convert_scaler(scaler) -> Dict[str, np.ndarray]:
    return {"mean": np.asarray(scaler.mean_, np.float32),
            "scale": np.asarray(scaler.scale_, np.float32)}


def convert_svc(svc) -> Dict[str, Any]:
    if svc.kernel not in ("rbf", "linear", "poly", "sigmoid"):
        raise NotImplementedError(f"kernel {svc.kernel!r} not supported")
    if not hasattr(svc, "probA_") or svc.probA_.size == 0:
        raise ValueError("SVC must be fitted with probability=True")
    dual = np.asarray(svc.dual_coef_, np.float32)
    intercept = np.asarray(svc.intercept_, np.float32)
    if len(svc.classes_) == 2:
        # sklearn stores the *negated* libsvm duals/intercept for the
        # binary case (sign-flip in svm/_base.py); undo it so the ovo
        # voting rule and Platt coefficients see raw libsvm decisions.
        dual = -dual
        intercept = -intercept
    return {
        "support_vectors": np.asarray(svc.support_vectors_, np.float32),
        "dual_coef": dual,
        "intercept": intercept,
        "n_support": np.asarray(svc.n_support_, np.int32),
        "prob_a": np.asarray(svc.probA_, np.float32),
        "prob_b": np.asarray(svc.probB_, np.float32),
        "gamma": np.float32(svc._gamma),
        "kernel": svc.kernel,
        "coef0": np.float32(svc.coef0),
        "degree": int(svc.degree),
        "classes": np.asarray(svc.classes_),
    }


def convert_forest(rf) -> Dict[str, Any]:
    trees = [est.tree_ for est in rf.estimators_]
    n_nodes = max(t.node_count for t in trees)
    n_trees = len(trees)
    k = rf.n_classes_
    left = np.full((n_trees, n_nodes), -1, np.int32)
    right = np.full((n_trees, n_nodes), -1, np.int32)
    feature = np.zeros((n_trees, n_nodes), np.int32)
    threshold = np.zeros((n_trees, n_nodes), np.float32)
    value = np.zeros((n_trees, n_nodes, k), np.float32)
    for i, t in enumerate(trees):
        n = t.node_count
        left[i, :n] = t.children_left
        right[i, :n] = t.children_right
        feature[i, :n] = np.maximum(t.feature, 0)
        threshold[i, :n] = t.threshold
        v = t.value[:, 0, :]  # class "counts" (weighted fractions)
        value[i, :n] = v / np.maximum(v.sum(-1, keepdims=True), 1e-38)
    return {
        "left": left, "right": right, "feature": feature,
        "threshold": threshold, "value": value,
        "max_depth": int(max(t.max_depth for t in trees)),
        "classes": np.asarray(rf.classes_),
    }


# ----------------------------------------------------------------------
# Host (numpy) inference
# ----------------------------------------------------------------------

def _pair_index(k: int) -> List[Tuple[int, int]]:
    return [(i, j) for i in range(k) for j in range(i + 1, k)]


def scaler_transform_np(scaler, x: np.ndarray) -> np.ndarray:
    return (np.asarray(x) - scaler["mean"]) / scaler["scale"]


def _svc_decision_values_np(model, x: np.ndarray) -> np.ndarray:
    sv = model["support_vectors"]
    x = np.asarray(x, np.float32)
    kind = model.get("kernel", "rbf")
    xs = x @ sv.T
    if kind == "rbf":
        d2 = (np.sum(x * x, -1, keepdims=True)
              + np.sum(sv * sv, -1)[None] - 2.0 * xs)
        kern = np.exp(-model["gamma"] * np.maximum(d2, 0.0))
    elif kind == "linear":
        kern = xs
    elif kind == "poly":
        kern = (model["gamma"] * xs + model["coef0"]) ** model["degree"]
    else:  # sigmoid
        kern = np.tanh(model["gamma"] * xs + model["coef0"])
    n_support = np.asarray(model["n_support"])
    starts = np.concatenate([[0], np.cumsum(n_support)])
    k = len(n_support)
    dual = model["dual_coef"]
    decs = []
    for p, (i, j) in enumerate(_pair_index(k)):
        si, ei = int(starts[i]), int(starts[i + 1])
        sj, ej = int(starts[j]), int(starts[j + 1])
        decs.append(kern[:, si:ei] @ dual[j - 1, si:ei]
                    + kern[:, sj:ej] @ dual[i, sj:ej]
                    + model["intercept"][p])
    return np.stack(decs, -1)


def svc_predict_np(model, x: np.ndarray) -> np.ndarray:
    dec = _svc_decision_values_np(model, x)
    k = len(np.asarray(model["n_support"]))
    votes = np.zeros((x.shape[0], k), np.int32)
    for p, (i, j) in enumerate(_pair_index(k)):
        win = dec[:, p] > 0
        votes[:, i] += win
        votes[:, j] += ~win
    return np.argmax(votes, -1)


def svc_predict_proba_np(model, x: np.ndarray) -> np.ndarray:
    dec = _svc_decision_values_np(model, x)
    k = len(np.asarray(model["n_support"]))
    B = x.shape[0]
    min_prob = 1e-7
    r = np.full((B, k, k), 0.5, np.float64)
    for p_idx, (i, j) in enumerate(_pair_index(k)):
        f = dec[:, p_idx] * model["prob_a"][p_idx] + model["prob_b"][p_idx]
        pij = np.clip(np.where(f >= 0, np.exp(-f) / (1 + np.exp(-f)),
                               1.0 / (1 + np.exp(f))),
                      min_prob, 1 - min_prob)
        r[:, i, j] = pij
        r[:, j, i] = 1.0 - pij

    # libsvm multiclass_probability (Wu & Lin method 2), per sample.
    eps = 0.005 / k
    out = np.empty((B, k))
    for b in range(B):
        Q = np.empty((k, k))
        for t in range(k):
            Q[t, t] = np.sum(r[b, :, t][np.arange(k) != t] ** 2)
            for j in range(k):
                if j != t:
                    Q[t, j] = -r[b, j, t] * r[b, t, j]
        p = np.full(k, 1.0 / k)
        for _ in range(max(100, k)):
            Qp = Q @ p
            pQp = float(p @ Qp)
            if np.max(np.abs(Qp - pQp)) < eps:
                break
            for t in range(k):
                diff = (-Qp[t] + pQp) / Q[t, t]
                p[t] += diff
                pQp = (pQp + diff * (diff * Q[t, t] + 2 * Qp[t])) \
                    / (1 + diff) ** 2
                Qp = (Qp + diff * Q[t, :]) / (1 + diff)
                p /= 1 + diff
        out[b] = p
    return out


def forest_predict_proba_np(model, x: np.ndarray) -> np.ndarray:
    x = np.asarray(x, np.float32)
    left, right = model["left"], model["right"]
    feature, threshold = model["feature"], model["threshold"]
    n_trees = left.shape[0]
    B = x.shape[0]
    node = np.zeros((n_trees, B), np.int32)
    ar = np.arange(n_trees)[:, None]
    for _ in range(model["max_depth"] + 1):
        f = feature[ar, node]
        th = threshold[ar, node]
        l = left[ar, node]
        rgt = right[ar, node]
        xv = x[np.arange(B)[None, :], f]
        nxt = np.where(xv <= th, l, rgt)
        node = np.where(l == -1, node, nxt)
    dist = model["value"][ar, node]                      # [T, B, k]
    return dist.mean(axis=0)


def forest_predict_np(model, x: np.ndarray) -> np.ndarray:
    return np.argmax(forest_predict_proba_np(model, x), -1)
