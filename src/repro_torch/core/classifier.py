"""Request Classifier (paper §3.4).

Smart classifier: k-means (k=3, Lloyd iterations in torch) over resource-aware
features — (log prefill-latency estimate, log KV-token estimate) — trained
on profiling data. Clusters are ranked by centroid magnitude: smallest =
motorcycles, middle = cars, largest = trucks.

Naive classifier (the paper's ablation): modality -> class
(text->motorcycle, image->car, video->truck).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.serving.request import Modality, VehicleClass

from .estimator import ImpactEstimator
from .profiler import Profile

CLASS_ORDER = [VehicleClass.MOTORCYCLE, VehicleClass.CAR, VehicleClass.TRUCK]


def _features(prefill: np.ndarray, kv: np.ndarray) -> np.ndarray:
    return np.stack([np.log10(np.maximum(prefill, 1e-5)),
                     np.log10(np.maximum(kv, 1.0))], axis=1)


def kmeans(x: torch.Tensor, k: int = 3, iters: int = 50,
           seed: int = 0) -> torch.Tensor:
    """Lloyd's algorithm in f32; deterministic quantile-spread init."""
    x = torch.as_tensor(x, dtype=torch.float32)
    # init: spread over the feature range by quantile (deterministic)
    qs = torch.linspace(0.05, 0.95, k)
    cent = torch.quantile(x, qs, dim=0)
    for _ in range(iters):
        d = torch.linalg.norm(x[:, None] - cent[None], dim=-1)  # (n,k)
        assign = torch.argmin(d, dim=1)
        oh = torch.nn.functional.one_hot(assign, k).to(x.dtype)  # (n,k)
        counts = oh.sum(0)[:, None]
        new = (oh.T @ x) / torch.clamp(counts, min=1.0)
        cent = torch.where(counts > 0, new, cent)
    return cent


class SmartClassifier:
    """Resource-aware clustering classifier."""

    def __init__(self, estimator: ImpactEstimator, centroids: np.ndarray):
        self.estimator = estimator
        # rank clusters: ascending by centroid L2 (log-space) => M, C, T
        order = np.argsort(np.linalg.norm(centroids, axis=1))
        self.centroids = centroids[order]

    @classmethod
    def train(cls, estimator: ImpactEstimator,
              profile: Profile) -> "SmartClassifier":
        preds = np.array([
            estimator.predict(r.modality, r.text_tokens, r.mm_units)
            for r in profile.records])
        feats = _features(preds[:, 0], preds[:, 1])
        cent = kmeans(torch.as_tensor(feats, dtype=torch.float32)).numpy()
        return cls(estimator, cent)

    def classify(self, modality: str, text_tokens: int,
                 mm_units: int = 0) -> tuple[VehicleClass, float, float]:
        """Returns (class, est_prefill_s, est_kv_tokens)."""
        prefill, kv = self.estimator.predict(modality, text_tokens, mm_units)
        f = _features(np.array([prefill]), np.array([kv]))[0]
        d = np.linalg.norm(self.centroids - f[None], axis=1)
        return CLASS_ORDER[int(np.argmin(d))], prefill, kv


class NaiveClassifier:
    """Pure modality mapping (ablation baseline)."""

    def __init__(self, estimator: ImpactEstimator | None = None):
        self.estimator = estimator

    def classify(self, modality: str, text_tokens: int,
                 mm_units: int = 0) -> tuple[VehicleClass, float, float]:
        mapping = {
            Modality.TEXT.value: VehicleClass.MOTORCYCLE,
            Modality.IMAGE.value: VehicleClass.CAR,
            Modality.VIDEO.value: VehicleClass.TRUCK,
            Modality.AUDIO.value: VehicleClass.CAR,
        }
        prefill, kv = (0.0, float(text_tokens + mm_units))
        if self.estimator is not None:
            prefill, kv = self.estimator.predict(modality, text_tokens, mm_units)
        return mapping[modality], prefill, kv
