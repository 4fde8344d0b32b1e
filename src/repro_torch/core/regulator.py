"""Priority Regulator (paper §3.6).

    Priority_c = StaticPriority_c + (1 - exp(-k_c * waiting_time^{p_c}))
    Score_c    = -log(Priority_c)           (lower score -> scheduled earlier)

Paper constants (§4.1 Configuration):
    StaticPriority: M=0.1,  C=0.05,  T=0.0
    p:              M=3.5,  C=2.5,   T=1.1
    k:              M=0.05, C=0.003, T=0.00075
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

from repro_torch.serving.request import Request, VehicleClass

PAPER_PARAMS = {
    VehicleClass.MOTORCYCLE: dict(static=0.10, k=0.05, p=3.5),
    VehicleClass.CAR: dict(static=0.05, k=0.003, p=2.5),
    VehicleClass.TRUCK: dict(static=0.00, k=0.00075, p=1.1),
}

EPS = 1e-12


@dataclass
class PriorityRegulator:
    params: dict = field(default_factory=lambda: dict(PAPER_PARAMS))

    def priority(self, vclass: VehicleClass, waiting_time: float) -> float:
        c = self.params[vclass]
        wait = max(0.0, waiting_time)
        age = 1.0 - math.exp(-c["k"] * (wait ** c["p"]))
        return c["static"] + age

    def score(self, vclass: VehicleClass, waiting_time: float) -> float:
        """-log(priority): lower = earlier (vLLM-style score ordering)."""
        return -math.log(max(self.priority(vclass, waiting_time), EPS))

    def request_score(self, req: Request, now: float) -> float:
        """Inlined ``score(vclass, waiting_time)`` — the scheduler hot path
        calls this per queue-head comparison, so skip the method hops while
        keeping the exact expression order (bit-identical results)."""
        c = self.params[req.vclass]
        wait = max(0.0, now - req.enqueue_time)
        age = 1.0 - math.exp(-c["k"] * (wait ** c["p"]))
        return -math.log(max(c["static"] + age, EPS))
