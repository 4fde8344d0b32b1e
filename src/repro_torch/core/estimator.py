"""Impact Estimator (paper §3.3).

Predicts per-request *prefill latency* and *KV-cache footprint* from request
metadata, using profiling data:

  * text     — ordinary linear regression on prompt length (closed form),
    "consistent with prior works" [paper].
  * image / video — quantile regression at q=0.90 (pinball loss, fitted with
    Adam in torch f32) "to avoid underestimation and protect SLO
    compliance" [paper].

KV footprint is fitted with per-modality linear regression on
(text_tokens, mm_units) — vision tokenizers are near-deterministic in the
input size, so this is essentially exact.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .profiler import Profile


def _design(X: np.ndarray) -> np.ndarray:
    return np.concatenate([np.ones((len(X), 1)), X], axis=1)


def fit_linreg(X: np.ndarray, y: np.ndarray) -> np.ndarray:
    A = _design(X)
    w, *_ = np.linalg.lstsq(A, y, rcond=None)
    return w


def fit_quantile(X: np.ndarray, y: np.ndarray, q: float = 0.9,
                 steps: int = 2000, lr: float = 0.05) -> np.ndarray:
    """Pinball-loss quantile regression via Adam in torch f32, on the
    column-scaled design (the same iteration as the JAX package's)."""
    A = torch.as_tensor(_design(X), dtype=torch.float32)
    yt = torch.as_tensor(y, dtype=torch.float32)
    scale = torch.clamp(A.abs().amax(dim=0), min=1e-9)
    An = A / scale
    n = An.shape[0]
    w = torch.zeros(A.shape[1])
    m = torch.zeros_like(w)
    v = torch.zeros_like(w)
    b1, b2 = torch.tensor(0.9), torch.tensor(0.999)
    for i in range(steps):
        resid = yt - An @ w
        # d/dw mean(max(q r, (q-1) r)): slope q where q r wins, else q-1
        slope = torch.where(q * resid >= (q - 1) * resid,
                            torch.tensor(q), torch.tensor(q - 1.0))
        g = -(An.T @ slope) / n
        m = 0.9 * m + 0.1 * g
        v = 0.999 * v + 0.001 * g * g
        # bias corrections in f32, as the JAX iteration computes them
        step = torch.tensor(i + 1.0)
        mh = m / (1 - torch.pow(b1, step))
        vh = v / (1 - torch.pow(b2, step))
        w = w - lr * mh / (torch.sqrt(vh) + 1e-8)
    return (w / scale).numpy()


@dataclass
class ModalityModel:
    w_time: np.ndarray   # prefill-time weights (1, text_tokens, mm_units)
    w_kv: np.ndarray     # kv-token weights
    kind: str            # "linreg" | "quantile"


class ImpactEstimator:
    """Trained once per (model, modality) from the Workload Profiler's data;
    at runtime predicts (prefill_latency_s, kv_tokens) per request."""

    QUANTILE_MODALITIES = ("image", "video", "audio")

    def __init__(self):
        self.models: dict[str, ModalityModel] = {}

    @classmethod
    def train(cls, profile: Profile) -> "ImpactEstimator":
        est = cls()
        for modality in sorted({r.modality for r in profile.records}):
            X, t, kv = profile.features(modality)
            if modality in cls.QUANTILE_MODALITIES:
                w_time = fit_quantile(X, t, q=0.9)
                kind = "quantile"
            else:
                w_time = fit_linreg(X, t)
                kind = "linreg"
            w_kv = fit_linreg(X, kv)
            est.models[modality] = ModalityModel(w_time, w_kv, kind)
        return est

    def predict(self, modality: str, text_tokens: int,
                mm_units: int = 0) -> tuple[float, float]:
        m = self.models[modality]
        x = np.array([1.0, text_tokens, mm_units])
        prefill = float(max(x @ m.w_time, 1e-4))
        kv = float(max(x @ m.w_kv, 1.0))
        return prefill, kv

    def errors(self, profile: Profile) -> dict[str, np.ndarray]:
        """Absolute prediction errors per modality (paper Fig. 7)."""
        out = {}
        for modality, m in self.models.items():
            X, t, _ = profile.features(modality)
            pred = _design(X) @ m.w_time
            out[modality] = np.abs(pred - t)
        return out
