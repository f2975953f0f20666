"""sklearn model inference (port of models/sklearn_infer.py).

The acoustic sentiment heads (a StandardScaler, an SVC for the client,
a RandomForestClassifier for the agent) are microscopic (38-dim
inputs), so at runtime they run on the host in numpy
(pipeline/sentiment.py), as in the reference. This module holds the
fit-time converters, the ``*_np`` functions the runtime uses, and the
device heads (``scaler_transform``, ``svc_*``, ``forest_*``): plain
torch functions that run on the device of their input ``x``, taking the
converters' dicts (numpy arrays, or tensors from :func:`to_device`).
Both halves have sklearn's numerics:

- SVC.predict is one-vs-one *voting* (not argmax of probabilities).
- SVC.predict_proba is libsvm's pairwise Platt sigmoids combined with
  the Wu-Lin coupling iteration, including its early-exit tolerance.
- RandomForest.predict_proba is the mean of per-tree leaf class
  distributions; predict is its argmax.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from audio_processor_tpu_torch.dsp.stft import require_true_fp32


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


def _pair_index(k: int) -> List[Tuple[int, int]]:
    return [(i, j) for i in range(k) for j in range(i + 1, k)]


# ----------------------------------------------------------------------
# Device (torch) inference
# ----------------------------------------------------------------------

# Shape data that the functions read on the host, as the reference does.
_HOST_KEYS = ("n_support", "classes")


def to_device(model: Dict[str, Any], device) -> Dict[str, Any]:
    """A converted dict with its weight arrays as tensors on ``device``
    (the class labels, ``n_support`` and scalars stay on the host), so
    repeated calls upload nothing."""
    return {k: torch.from_numpy(v).to(device)
            if isinstance(v, np.ndarray) and v.ndim and k not in _HOST_KEYS
            else v for k, v in model.items()}


def _on(x: torch.Tensor, a) -> torch.Tensor:
    return torch.as_tensor(a, device=x.device)


def scaler_transform(scaler: Dict[str, Any], x: torch.Tensor
                     ) -> torch.Tensor:
    return (x - _on(x, scaler["mean"])) / _on(x, scaler["scale"])


def svc_decision_values(model: Dict[str, Any], x: torch.Tensor
                        ) -> torch.Tensor:
    """[B, d] -> [B, k*(k-1)/2] libsvm ovo decision values. The x·svᵀ
    product is true fp32 (the reference's Precision.HIGHEST): the RBF
    distance |x|² + |s|² − 2x·s cancels, and TF32 would move it."""
    require_true_fp32(x.device)
    sv = _on(x, model["support_vectors"])
    kind = model.get("kernel", "rbf")
    xs = x @ sv.T
    if kind == "rbf":
        x2 = (x * x).sum(-1, keepdim=True)
        s2 = (sv * sv).sum(-1)[None, :]
        kern = torch.exp(-float(model["gamma"])
                         * torch.clamp(x2 + s2 - 2.0 * xs, min=0.0))
    elif kind == "linear":
        kern = xs
    elif kind == "poly":
        kern = (float(model["gamma"]) * xs
                + float(model["coef0"])) ** int(model["degree"])
    else:  # sigmoid
        kern = torch.tanh(float(model["gamma"]) * xs
                          + float(model["coef0"]))

    n_support = np.asarray(model["n_support"])
    starts = np.concatenate([[0], np.cumsum(n_support)])
    dual = _on(x, model["dual_coef"])
    intercept = _on(x, model["intercept"])
    decs = []
    for p, (i, j) in enumerate(_pair_index(len(n_support))):
        si, ei = int(starts[i]), int(starts[i + 1])
        sj, ej = int(starts[j]), int(starts[j + 1])
        decs.append((kern[:, si:ei] * dual[j - 1, si:ei]).sum(-1)
                    + (kern[:, sj:ej] * dual[i, sj:ej]).sum(-1)
                    + intercept[p])
    return torch.stack(decs, -1)


def svc_predict(model: Dict[str, Any], x: torch.Tensor) -> torch.Tensor:
    """One-vs-one voting -> class *indices* into model['classes']."""
    dec = svc_decision_values(model, x)
    k = len(model["n_support"])
    votes = torch.zeros((x.shape[0], k), dtype=torch.int32,
                        device=x.device)
    for p, (i, j) in enumerate(_pair_index(k)):
        win_i = (dec[:, p] > 0).to(torch.int32)
        votes[:, i] += win_i
        votes[:, j] += 1 - win_i
    return torch.argmax(votes, -1)


def _multiclass_coupling(r: torch.Tensor, k: int,
                         max_iter: int = 100) -> torch.Tensor:
    """libsvm multiclass_probability (Wu & Lin method 2), batched.

    r: [B, k, k] pairwise probabilities (r[:,i,j] = P(class i | i or j)).
    A row is frozen once its error is under eps (its ``diff`` is 0, which
    leaves p, Qp and pQp as they are), and the loop stops when every row
    is: ``done.all()`` syncs with the device once per iteration, which
    gives the reference's ``while_loop`` numbers at a few iterations'
    cost."""
    eps = 0.005 / k
    rT = r.transpose(1, 2)
    # Q[t,t] = sum_{j!=t} r[j,t]^2 ; Q[t,j] = -r[j,t] r[t,j]
    eye = torch.eye(k, dtype=torch.bool, device=r.device)[None]
    diag = ((rT ** 2) * (~eye)).sum(2)                     # [B, k]
    Q = torch.where(eye, diag[:, :, None], -rT * r)
    p = torch.full((r.shape[0], k), 1.0 / k, dtype=r.dtype, device=r.device)
    done = torch.zeros(r.shape[0], dtype=torch.bool, device=r.device)
    for _ in range(max_iter):
        Qp = torch.einsum("btj,bj->bt", Q, p)
        pQp = (p * Qp).sum(-1)
        done = done | ((Qp - pQp[:, None]).abs().amax(-1) < eps)
        if bool(done.all()):
            break
        # The reference's scan over t, in its order: p, then pQp, then
        # Qp, then the renormalisation.
        for t in range(k):
            diff = (-Qp[:, t] + pQp) / Q[:, t, t]
            diff = torch.where(done, torch.zeros_like(diff), diff)
            p[:, t] += diff
            pQp = (pQp + diff * (diff * Q[:, t, t] + 2.0 * Qp[:, t])) \
                / ((1.0 + diff) ** 2)
            Qp = (Qp + diff[:, None] * Q[:, t, :]) / (1.0 + diff)[:, None]
            p = p / (1.0 + diff)[:, None]
    return p


def svc_predict_proba(model: Dict[str, Any], x: torch.Tensor
                      ) -> torch.Tensor:
    """[B, d] -> [B, k] probabilities in classes_ order."""
    dec = svc_decision_values(model, x)
    k = len(model["n_support"])
    prob_a, prob_b = _on(x, model["prob_a"]), _on(x, model["prob_b"])
    min_prob = 1e-7
    r = torch.full((x.shape[0], k, k), 0.5, dtype=torch.float32,
                   device=x.device)
    for p, (i, j) in enumerate(_pair_index(k)):
        f = dec[:, p] * prob_a[p] + prob_b[p]
        pij = torch.clamp(torch.sigmoid(-f), min_prob, 1.0 - min_prob)
        r[:, i, j] = pij
        r[:, j, i] = 1.0 - pij
    return _multiclass_coupling(r, k)


def forest_predict_proba(model: Dict[str, Any], x: torch.Tensor
                         ) -> torch.Tensor:
    """[B, d] -> [B, k] mean of per-tree leaf distributions: every tree
    walks ``max_depth + 1`` levels at once by gathers over [T, N]; a node
    stays put once it is a leaf (left == -1)."""
    left = _on(x, model["left"]).long()
    right = _on(x, model["right"]).long()
    feature = _on(x, model["feature"]).long()
    threshold = _on(x, model["threshold"])
    value = _on(x, model["value"])
    B = x.shape[0]
    rows = torch.arange(B, device=x.device)[None, :]
    node = torch.zeros((left.shape[0], B), dtype=torch.long,
                       device=x.device)
    for _ in range(int(model["max_depth"]) + 1):
        f = torch.gather(feature, 1, node)                 # [T, B]
        th = torch.gather(threshold, 1, node)
        lft = torch.gather(left, 1, node)
        rgt = torch.gather(right, 1, node)
        nxt = torch.where(x[rows, f] <= th, lft, rgt)
        node = torch.where(lft == -1, node, nxt)
    dist = torch.gather(value, 1,
                        node[:, :, None].expand(-1, -1, value.shape[-1]))
    return dist.mean(0)                                    # [B, k]


def forest_predict(model: Dict[str, Any], x: torch.Tensor) -> torch.Tensor:
    return torch.argmax(forest_predict_proba(model, x), -1)


# ----------------------------------------------------------------------
# Host (numpy) inference
# ----------------------------------------------------------------------


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
