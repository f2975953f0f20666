"""Plain reference of the acoustic sentiment heads and the late fusion, in
float64 (``dtype=torch.bfloat16`` rounds inputs and intermediates for the
control): a standard scaler; an RBF SVC with one-vs-one votes and libsvm's
probability estimates (Platt sigmoids, then Wu, Lin and Weng's pairwise
coupling); a random forest's mean leaf distribution; and the pipeline's
documented late fusion (client 0.42 text + 0.58 acoustic, agent 0.54 +
0.46; an agent "aggressive" below 0.7 is demoted unless the text says
"aggressive" with 0.8 or more). Imports nothing of the program."""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch


def _r(t: torch.Tensor, dtype) -> torch.Tensor:
    return t.to(dtype).double() if dtype != torch.float64 else t


def scale(scaler: Dict, x: np.ndarray, dtype=torch.float64) -> torch.Tensor:
    x = torch.from_numpy(np.asarray(x, np.float64))
    mean = torch.from_numpy(np.asarray(scaler["mean"], np.float64))
    sd = torch.from_numpy(np.asarray(scaler["scale"], np.float64))
    return _r((_r(x, dtype) - mean) / sd, dtype)


def _pairs(k: int):
    return [(i, j) for i in range(k) for j in range(i + 1, k)]


def svc(model: Dict, x: torch.Tensor, dtype=torch.float64):
    """(labels by one-vs-one votes [B], probabilities [B, k])."""
    sv = _r(torch.from_numpy(np.asarray(model["support_vectors"],
                                        np.float64)), dtype)
    d2 = ((x[:, None, :] - sv[None]) ** 2).sum(-1)
    kern = _r(torch.exp(-float(model["gamma"]) * d2), dtype)
    n_sup = [int(n) for n in model["n_support"]]
    starts = np.concatenate([[0], np.cumsum(n_sup)])
    dual = torch.from_numpy(np.asarray(model["dual_coef"], np.float64))
    k = len(n_sup)
    B = x.shape[0]
    votes = torch.zeros(B, k, dtype=torch.long)
    r = torch.full((B, k, k), 0.5, dtype=torch.float64)
    for p, (i, j) in enumerate(_pairs(k)):
        si, ei, sj, ej = starts[i], starts[i + 1], starts[j], starts[j + 1]
        dec = (kern[:, si:ei] @ dual[j - 1, si:ei]
               + kern[:, sj:ej] @ dual[i, sj:ej]
               + float(model["intercept"][p]))
        votes[:, i] += (dec > 0).long()
        votes[:, j] += (dec <= 0).long()
        f = dec * float(model["prob_a"][p]) + float(model["prob_b"][p])
        pij = torch.sigmoid(-f).clamp(1e-7, 1 - 1e-7)
        r[:, i, j] = pij
        r[:, j, i] = 1 - pij
    probs = torch.stack([_couple(r[b], k) for b in range(B)])
    return votes.argmax(-1), _r(probs, dtype)


def _couple(r: torch.Tensor, k: int) -> torch.Tensor:
    """libsvm ``multiclass_probability`` for one row of pairwise r."""
    Q = torch.empty(k, k, dtype=torch.float64)
    for t in range(k):
        Q[t, t] = sum(float(r[j, t]) ** 2 for j in range(k) if j != t)
        for j in range(k):
            if j != t:
                Q[t, j] = -r[j, t] * r[t, j]
    p = torch.full((k,), 1.0 / k, dtype=torch.float64)
    eps = 0.005 / k
    for _ in range(max(100, k)):
        Qp = Q @ p
        pQp = float(p @ Qp)
        if float((Qp - pQp).abs().max()) < eps:
            break
        for t in range(k):
            diff = (-float(Qp[t]) + pQp) / float(Q[t, t])
            p[t] += diff
            pQp = (pQp + diff * (diff * float(Q[t, t]) + 2 * float(Qp[t]))) \
                / (1 + diff) ** 2
            Qp = (Qp + diff * Q[t]) / (1 + diff)
            p = p / (1 + diff)
    return p


def forest(model: Dict, x: torch.Tensor, dtype=torch.float64
           ) -> torch.Tensor:
    """Mean leaf class distribution [B, k] over the trees."""
    left, right = model["left"], model["right"]
    feat, thr = model["feature"], model["threshold"]
    value = np.asarray(model["value"], np.float64)
    xs = x.numpy()
    thr = _r(torch.from_numpy(np.asarray(thr, np.float64)), dtype).numpy()
    out = np.zeros((xs.shape[0], value.shape[-1]))
    for b in range(xs.shape[0]):
        for t in range(left.shape[0]):
            n = 0
            while left[t, n] != -1:
                n = left[t, n] if xs[b, feat[t, n]] <= thr[t, n] \
                    else right[t, n]
            out[b] += value[t, n]
    return torch.from_numpy(out / left.shape[0])


WEIGHTS = {"client": (0.42, 0.58), "agent": (0.54, 0.46)}


def fuse(speaker: str, text_label: str, text_conf: float,
         text_probs: Sequence[float], ac_label: str,
         ac_probs: Sequence[float], classes: List[str]) -> tuple:
    """(label, margin of the fused top two) of one chunk and speaker; the
    margin is None where no fused sum was taken."""
    if not (text_label and ac_label and len(text_probs) and len(ac_probs)):
        return (text_label or ac_label or ""), None
    wt, wa = WEIGHTS[speaker]
    fused = wt * np.asarray(text_probs, np.float64) \
        + wa * np.asarray(ac_probs, np.float64)
    order = np.argsort(fused)[::-1]
    idx = int(order[0])
    label = classes[idx]
    margin = float(fused[order[0]] - fused[order[1]])
    if speaker != "client" and label == "aggressive":
        if fused[idx] < 0.7 and (text_label != "aggressive"
                                 or text_conf < 0.8):
            for alt in order[1:]:
                if classes[int(alt)] not in ("aggressive", "agressif"):
                    label = classes[int(alt)]
                    break
        margin = min(margin, abs(float(fused[idx]) - 0.7))
    return label, margin
