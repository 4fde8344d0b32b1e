"""Workload Profiler (paper §3.2).

Offline component: executes a representative per-modality workload against
the target model ONE REQUEST AT A TIME (no contention) and records
preprocess / encode / prefill times plus KV token counts. The resulting
profile trains the Impact Estimator and the Request Classifier.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.serving.request import Request


@dataclass
class ProfileRecord:
    modality: str
    text_tokens: int
    mm_units: int
    prompt_tokens: int      # KV footprint of the prompt (tokens)
    preprocess_time: float
    encode_time: float
    prefill_time: float

    @property
    def ttft(self) -> float:
        return self.preprocess_time + self.encode_time + self.prefill_time


@dataclass
class Profile:
    model: str
    records: list[ProfileRecord] = field(default_factory=list)

    def by_modality(self, modality: str) -> list[ProfileRecord]:
        return [r for r in self.records if r.modality == modality]

    def features(self, modality: str):
        """(X, prefill_times, prompt_tokens) arrays for estimator training."""
        rs = self.by_modality(modality)
        X = np.array([[r.text_tokens, r.mm_units] for r in rs], np.float64)
        t = np.array([r.prefill_time for r in rs], np.float64)
        kv = np.array([r.prompt_tokens for r in rs], np.float64)
        return X, t, kv


class WorkloadProfiler:
    """Runs isolated requests through an executor and collects a Profile.

    `executor` must expose ``isolated_run(request) -> ProfileRecord`` — both
    the real JAX executor and the calibrated simulation executor do.
    """

    def __init__(self, executor, model_name: str):
        self.executor = executor
        self.model_name = model_name

    def build(self, requests: list[Request]) -> Profile:
        profile = Profile(self.model_name)
        for req in requests:
            profile.records.append(self.executor.isolated_run(req))
        return profile
