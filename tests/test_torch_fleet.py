"""The port's fleet tier against the JAX package's.

Real mode (reduced chatglm3-6b in f32, the JAX weights carried over by the
bridge): a video request is prefilled on one replica, its KV page chain
migrated with its payload bytes to a second replica, and finished there —
as ``benchmarks/fleet_tolerance.run_real_migration_parity`` does. The
port's migrated run must emit exactly the tokens of the port's unmigrated
oracle and of the JAX package's migrated run; with the target's payload
import turned into a no-op, the same migration must part from them (so
the test sees the bytes, not only the page accounting).

Sim mode: ``Router`` with a replica kill and ``Fleet`` with a drain, a kill
with a warm restart and migration chunk faults give the JAX package's
per-request timeline and placement bit for bit, on the JAX classifier's
weights.

Every engine loop is bounded (``max_steps``, bounded step loops), so the
reference engine's two-request livelock (ROADMAP.md §3) fails a test in
seconds instead of running to the time limit.
"""
import dataclasses
import importlib
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch_parity import bridge, jax_cfg_f32, jax_params_numpy

jax = pytest.importorskip("jax")

from conftest import sim_stack_cached  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402

ARCH, MAX_LEN, PAGES = "chatglm3-6b", 128, 64
JITTER = 0.05
POLICY = "tcm"
# the chunk fault rates of benchmarks/fleet_tolerance.py's chaos run
MIG_RATES = dict(migration_timeout_prob=0.12, migration_corrupt_prob=0.08,
                 permanent_frac=0.05)


def _pkg(root: str):
    """The serving modules of one package ('repro' or 'repro_torch')."""
    mods = {n: importlib.import_module(f"{root}.serving.{n}")
            for n in ("engine", "executors", "faults", "fleet", "migration",
                      "request", "router", "workload")}
    mods["make_policy"] = importlib.import_module(
        f"{root}.core.scheduler").make_policy
    return SimpleNamespace(**mods)


J, T = _pkg("repro"), _pkg("repro_torch")


def _classifier(pkg):
    """The JAX sim stack's classifier, or its weights and centroids in the
    port's types (as tests/test_torch_core.py holds it)."""
    _, jcls, _, _, jest = sim_stack_cached()
    if pkg is J:
        return jcls
    from repro_torch.core import classifier as tcls
    from repro_torch.core import estimator as test_
    est = test_.ImpactEstimator()
    est.models = {m: test_.ModalityModel(jm.w_time.copy(), jm.w_kv.copy(),
                                         jm.kind)
                  for m, jm in jest.models.items()}
    return tcls.SmartClassifier(est, jcls.centroids.copy())


def _run_until(engine, req, pred, max_steps):
    """Step ``engine`` on ``req`` until ``pred()``; fail at the bound."""
    pending = [req]
    for _ in range(max_steps):
        pending = engine.step(pending)
        if pred():
            return
    raise AssertionError(f"{req.rid}: not done after {max_steps} steps "
                         f"(state {req.state})")


# ---------------- real mode: page-chain payloads move the KV ----------------

def _video(pkg, rid="mig-parity"):
    # 64 mm units + 16 text tokens: four full shareable pages of video KV,
    # then the private text tail (the chain boundary)
    R = pkg.request
    return R.Request(rid=rid, modality=R.Modality.VIDEO, arrival=0.0,
                     text_tokens=16, mm_units=64, prompt_tokens=80,
                     output_tokens=8, mm_hash="parity-vid")


def _executors(pkg, n):
    """``n`` replicas of the reduced model on the same bridged weights."""
    jc = jax_cfg_f32(jconfigs.get_reduced(ARCH))
    xcfg = dict(max_slots=2, max_len=MAX_LEN, num_pages=PAGES)
    if pkg is J:
        import repro.models.params as jparams
        real = jparams.init_params
        # the weights are replaced below: draw none (eager jax.random
        # draws take seconds)
        jparams.init_params = lambda decls, key, dtype=None: \
            jparams.tree_map_decls(
                lambda d: jax.numpy.zeros(d.shape, dtype or d.dtype), decls)
        try:
            out = [J.executors.ModelExecutor(
                jc, J.executors.ExecutorConfig(**xcfg)) for _ in range(n)]
        finally:
            jparams.init_params = real
        params = jax.tree.map(jax.numpy.asarray,
                              jax_params_numpy(jc, jitter=JITTER))
        for ex in out:
            ex.params = params
        return out
    tc = dataclasses.replace(tconfigs.get_reduced(ARCH), dtype=torch.float32)
    first = T.executors.ModelExecutor(
        tc, T.executors.ExecutorConfig(**xcfg), device="cpu",
        params=bridge(jax_params_numpy(jc, jitter=JITTER), tc))
    return [first] + [T.executors.ModelExecutor(
        tc, T.executors.ExecutorConfig(**xcfg), device="cpu",
        params=first.params, layers=first.layers) for _ in range(n - 1)]


def _engine(pkg, ex):
    return pkg.engine.Engine(pkg.make_policy(POLICY), ex, _classifier(pkg),
                             pkg.engine.EngineConfig(kv_pages=PAGES))


def _oracle_tokens(pkg):
    (ex,) = _executors(pkg, 1)
    req = _video(pkg)
    _run_until(_engine(pkg, ex), req, lambda: req.is_terminal, 2000)
    assert req.state is pkg.request.State.FINISHED
    return ex.emitted[req.rid]


def _migrated(pkg, import_payload=True):
    """Prefill the video on a source replica until it decodes, migrate it
    to a target replica, finish it there: (tokens, result, source, target,
    request)."""
    ex_s, ex_d = _executors(pkg, 2)
    if not import_payload:
        ex_d.import_page_payload = lambda pages, payloads: None
    src, dst = _engine(pkg, ex_s), _engine(pkg, ex_d)
    req = _video(pkg)
    State = pkg.request.State
    _run_until(src, req, lambda: req.state is State.RUNNING, 200)
    res = pkg.migration.migrate(src, dst, req, src.now,
                                pkg.migration.MigrationConfig())
    _run_until(dst, req, lambda: req.is_terminal, 2000)
    return ex_d.emitted.get(req.rid), res, src, dst, req


_CACHE = {}


def _jax_migrated_tokens():
    if "jax" not in _CACHE:
        _CACHE["jax"] = _migrated(J)[0]
    return _CACHE["jax"]


def test_real_migration_matches_oracle_and_jax():
    tokens, res, src, dst, req = _migrated(T)
    assert res.status == "migrated"
    assert res.pages_imported >= 2           # 64 mm tokens: 4 pages
    assert req.state is T.request.State.FINISHED
    assert req.cached_prefix_tokens == 16 * res.pages_imported
    assert src.allocator.used_pages == 0 and dst.allocator.used_pages == 0
    src.allocator.check_invariants()
    dst.allocator.check_invariants()
    assert tokens == _oracle_tokens(T)
    assert len(tokens) == req.output_tokens
    assert tokens == _jax_migrated_tokens()


def test_real_migration_payload_bytes_land_on_the_target():
    """The payload a migration ships is the source's page bytes, and the
    target's pages export those bytes back."""
    ex_s, ex_d = _executors(T, 2)
    src, dst = _engine(T, ex_s), _engine(T, ex_d)
    sent, received = [], []
    export, imp = ex_s.export_page_payload, ex_d.import_page_payload

    def spy_export(pages):
        out = export(pages)
        sent.extend(out)
        return out

    def spy_import(pages, payloads):
        received.append((list(pages), list(payloads)))
        imp(pages, payloads)
    ex_s.export_page_payload, ex_d.import_page_payload = spy_export, \
        spy_import
    req = _video(T)
    _run_until(src, req, lambda: req.state is T.request.State.RUNNING, 200)
    res = T.migration.migrate(src, dst, req, src.now,
                              T.migration.MigrationConfig())
    (pages, blobs), = received
    assert len(pages) == res.pages_imported == len(sent) >= 2
    assert blobs == sent == [r.payload for r in res.delivered]
    assert ex_d.export_page_payload(pages) == sent


def test_real_migration_without_payload_import_parts_from_the_oracle():
    """Negative control: the target installs the chain but never writes
    its bytes, so the claimed prefix reads zeros and the tokens part."""
    tokens, res, _, _, req = _migrated(T, import_payload=False)
    assert res.status == "migrated" and res.pages_imported >= 2
    assert req.state is T.request.State.FINISHED
    assert tokens != _oracle_tokens(T)
    assert tokens != _jax_migrated_tokens()


# ---------------- sim mode: bit-identical fleet timelines -------------------

def _snapshot(reqs):
    return {r.rid: (r.state.value, r.finish_time, r.first_token_time,
                    r.decoded, r.preemptions, r.cached_prefix_tokens,
                    r.migrations, r.redispatches)
            for r in reqs}


def _placement(router):
    engines = list(enumerate(router.engines)) + \
        list(getattr(router, "retired", []))
    return [(i, sorted(r.rid for r in eng.finished)) for i, eng in engines]


def _assert_clean(router, reqs):
    for eng in list(router.engines) + \
            [e for _i, e in getattr(router, "retired", [])]:
        eng.allocator.check_invariants()
        assert eng.allocator.used_pages == 0
    assert all(r.is_terminal for r in reqs), "max_steps hit"
    assert not router.lost


# a 40-request run takes under a thousand co-sim steps; this bound stops
# the reference engine's livelock within seconds
MAX_STEPS = 30_000


def _sim_run(pkg, kind, rate, seed, drain_at):
    wl = pkg.workload
    reqs = wl.generate(wl.WorkloadConfig(
        mix="MH", num_requests=40, seed=seed, rate=rate, duplicate_prob=0.3,
        shared_prefix_prob=0.3))
    kill_t, drain_t = reqs[24].arrival, reqs[drain_at].arrival
    cm = pkg.executors.make_cost_model("llava-7b")
    exes = [pkg.executors.SimExecutor(cm) for _ in range(3)]
    cfg = pkg.engine.EngineConfig(kv_pages=2048, token_budget=512)
    F = pkg.faults
    if kind == "router":
        plan = F.FaultPlan(seed=seed, replica_kills={2: kill_t})
        router = pkg.router.Router(exes, _classifier(pkg), cfg,
                                   policy=POLICY, routing="prefix-aware",
                                   faults=plan)
    else:
        plan = F.FaultPlan(seed=seed, rates=F.FaultRates(**MIG_RATES),
                           replica_kills={2: kill_t})
        router = pkg.fleet.Fleet(
            exes, _classifier(pkg), cfg, policy=POLICY,
            routing="least-loaded", faults=plan,
            fleet=pkg.fleet.FleetConfig(
                drains={0: drain_t}, restarts={2: 1.0},
                restart_warm_pages=64))
    router.run_stepped(reqs, max_steps=MAX_STEPS)
    _assert_clean(router, reqs)
    counters = {k: v for k, v in vars(router).items()
                if isinstance(v, (int, float)) and not isinstance(v, bool)}
    events = [router.kill_events] + [
        getattr(router, k, None) for k in ("drain_events", "restart_events",
                                           "health_events")]
    return (_snapshot(reqs), _placement(router), counters, events,
            dict(plan.injected), router)


# (kind, arrival rate, workload seed, request whose arrival starts the
# drain): each fleet case's drain finds a request with prefilled pages on
# replica 0, so a migration ships pages (most drain times find none)
SIM_CASES = [("router", 3.0, 0, 8), ("router", 6.0, 3, 8),
             ("fleet", 3.0, 0, 8), ("fleet", 6.0, 0, 16),
             ("fleet", 10.0, 1, 20)]


@pytest.mark.parametrize("case", SIM_CASES, ids=str)
def test_sim_timeline_and_placement_bit_identical_to_jax(case):
    kind = case[0]
    want = _sim_run(J, *case)
    got = _sim_run(T, *case)
    for name, a, b in zip(("snapshot", "placement", "counters", "events",
                           "injected"), got[:5], want[:5]):
        assert a == b, name
    router = got[5]
    assert router.kill_events and router.redispatched > 0
    if kind == "fleet":
        assert router.drain_events and router.restart_events
        warm = router.restart_events[0]["warm_pages_imported"]
        assert router.restart_events[0]["warm_source"] is not None
        assert warm > 0
        assert router.migrations_succeeded >= 1
        assert router.migrated_pages > warm     # the drain moved pages
        assert sum(got[4].values()) > 0      # chunk faults were injected


def test_fleet_restart_reuses_an_executor_without_fresh():
    """A restarted slot binds ``fresh()`` where the executor has one (the
    sim executor) and otherwise keeps the executor object (a real
    ``ModelExecutor`` has none), as the reference does."""
    assert hasattr(T.executors.SimExecutor, "fresh")
    assert not hasattr(T.executors.ModelExecutor, "fresh")
    *_, router = _sim_run(T, *SIM_CASES[2])
    (i, old), = router.retired
    assert router.executors[i] is not old.executor
    assert np.isclose(router.restart_events[0]["died"] + 1.0,
                      router.restart_events[0]["restarted"])


def _chip_smoke():
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    # its dataclasses resolve their annotations through sys.modules
    sys.modules.setdefault(spec.name, smoke)
    spec.loader.exec_module(smoke)
    return smoke


class _Jittered(T.executors.SimExecutor):
    """A sim executor whose iterations take a random multiple (drawn from
    a seeded stream) of the cost model's time: the spread of the measured
    step times that set a real-mode fleet's clocks."""

    def __init__(self, cm, rng, lo, hi):
        super().__init__(cm)
        self.rng, self.lo, self.hi = rng, lo, hi

    def run_iteration(self, *work):
        return super().run_iteration(*work) * self.rng.uniform(self.lo,
                                                               self.hi)

    def fresh(self):
        return _Jittered(self.cm, self.rng, self.lo, self.hi)


# (timing scale, jitter seed): at scale 10 these seeds made a drain set at
# the first prefilled page start just as replica 2's kill fell due, so its
# one migration aborted and moved no page
DRAIN_CASES = [(1.0, 0), (10.0, 41), (10.0, 48), (10.0, 55)]


@pytest.mark.parametrize("scale,seed", DRAIN_CASES, ids=str)
def test_chip_smoke_fleet_drain_always_migrates_pages(scale, seed):
    """chip_smoke.py's fleet serve phase (three replicas, replica 0
    drained from request 6's arrival, replica 2 killed at request 10's
    and restarted warm) on sim replicas of qwen2-vl-2b whose step times
    are spread 0.3-3x around the cost model's, and ten times slower:
    wherever the measured clocks put the drain, it migrates payload pages
    (the phase's gate), and the run stays clean."""
    import random
    smoke = _chip_smoke()
    from repro_torch.launch.serve import build_stack
    base, classifier, engine_cfg, _, _ = build_stack("qwen2-vl-2b", "sim")
    engine_cfg = dataclasses.replace(engine_cfg, kv_pages=4096)
    rng = random.Random(seed)
    reqs = T.workload.generate(T.workload.WorkloadConfig(
        mix="MH", rate=4.0, num_requests=16, seed=0, duplicate_prob=0.3,
        shared_prefix_prob=0.3))
    fleet = smoke.drain_when_prefilled(T.fleet.Fleet)(
        [_Jittered(base.cm, rng, 0.3 * scale, 3.0 * scale)
         for _ in range(smoke.FLEET_REPLICAS)],
        classifier, engine_cfg, policy="tcm", routing="least-loaded",
        faults=T.faults.FaultPlan(replica_kills={2: reqs[10].arrival}),
        fleet=T.fleet.FleetConfig(restarts={2: 1.0}, restart_warm_pages=256),
        drain_from=6, arrivals=tuple(r.arrival for r in reqs))
    done = fleet.run_stepped(reqs, max_steps=smoke.FLEET_MAX_STEPS)
    assert len(done) == len(reqs)
    assert fleet.drain_events and fleet.kill_events and fleet.restart_events
    warm = sum(e["warm_pages_imported"] for e in fleet.restart_events)
    assert warm > 0
    assert fleet.migrated_pages - warm > 0
    assert not any(smoke.fleet_audit(fleet, reqs).values())
