"""The paper's pipeline in the port against the JAX package, on the sim
profile (tests/conftest.py's ``sim_stack``): the impact estimator (its
closed-form parts identical, its Adam quantile fit within 1e-3 relative of
JAX's iterate step for step), the k-means classifier (same centroids and
the same class for every profiling record), and then — with the JAX
classifier's weights and centroids loaded into the port's classifier — a
sim-mode ``Engine`` run of a 300-request MH workload whose (rid, class,
first-token time, finish time) timeline must be bit-identical to the JAX
package's."""
import numpy as np
import pytest

pytest.importorskip("jax")

from repro.core.scheduler import make_policy as jmake_policy  # noqa: E402
from repro.serving import engine as jengine  # noqa: E402
from repro.serving import workload as jworkload  # noqa: E402
from repro_torch.core import classifier as tcls  # noqa: E402
from repro_torch.core import estimator as test_  # noqa: E402
from repro_torch.core import profiler as tprof  # noqa: E402
from repro_torch.core.scheduler import make_policy  # noqa: E402
from repro_torch.serving import engine as tengine  # noqa: E402
from repro_torch.serving import executors as texec  # noqa: E402
from repro_torch.serving import workload as tworkload  # noqa: E402


def _port_profile(jprofile):
    return tprof.Profile(jprofile.model, [
        tprof.ProfileRecord(**vars(r)) for r in jprofile.records])


def _port_estimator_from_jax(jest):
    """The JAX estimator's fitted weights in the port's types."""
    est = test_.ImpactEstimator()
    est.models = {m: test_.ModalityModel(jm.w_time.copy(), jm.w_kv.copy(),
                                         jm.kind)
                  for m, jm in jest.models.items()}
    return est


def test_estimator_closed_form_parts_match_jax(sim_stack):
    """Text prefill (least squares) and every KV model are identical."""
    _, _, _, jprofile, jest = sim_stack
    est = test_.ImpactEstimator.train(_port_profile(jprofile))
    assert sorted(est.models) == sorted(jest.models)
    for m, jm in jest.models.items():
        assert est.models[m].kind == jm.kind
        np.testing.assert_allclose(est.models[m].w_kv, jm.w_kv, rtol=1e-9)
        if jm.kind == "linreg":
            np.testing.assert_allclose(est.models[m].w_time, jm.w_time,
                                       rtol=1e-9)


@pytest.mark.parametrize("steps", [10, 100])
@pytest.mark.parametrize("modality", ["image", "video"])
def test_quantile_fit_tracks_jax_step_for_step(sim_stack, modality, steps):
    """Adam on the pinball loss: the same iterate as JAX's, step for step,
    on the sim profile. (After a few hundred steps the two part: the fit
    never converges — constant-rate Adam on a non-smooth loss keeps
    jumping around the optimum — so its final iterate is set by rounding.
    The estimator's *decisions* are held below by loading the JAX
    weights.)"""
    from repro.core.estimator import fit_quantile as jfit
    _, _, _, jprofile, _ = sim_stack
    X, t, _ = jprofile.features(modality)
    A = np.concatenate([np.ones((len(X), 1)), X], 1)
    np.testing.assert_allclose(A @ test_.fit_quantile(X, t, steps=steps),
                               A @ jfit(X, t, steps=steps), rtol=1e-3)


def test_classifier_matches_jax_on_every_profiling_record(sim_stack):
    """k-means in torch over the same estimator's predictions: the same
    centroids and the same class for every profiling record."""
    _, jcls, _, jprofile, jest = sim_stack
    est = _port_estimator_from_jax(jest)
    cls = tcls.SmartClassifier.train(est, _port_profile(jprofile))
    np.testing.assert_allclose(cls.centroids, jcls.centroids, rtol=1e-5,
                               atol=1e-6)
    for r in jprofile.records:
        got = cls.classify(r.modality, r.text_tokens, r.mm_units)
        want = jcls.classify(r.modality, r.text_tokens, r.mm_units)
        assert got[0].value == want[0].value
        assert got[1:] == want[1:]


def test_kmeans_matches_jax():
    import jax.numpy as jnp
    from repro.core.classifier import kmeans as jkmeans
    g = np.random.default_rng(9)
    x = np.concatenate([g.normal(c, 0.2, (40, 2)) for c in (-2, 0, 3)]
                       ).astype(np.float32)
    np.testing.assert_allclose(tcls.kmeans(x).numpy(),
                               np.asarray(jkmeans(jnp.asarray(x))),
                               rtol=1e-5, atol=1e-5)


def _timeline(reqs):
    return [(r.rid, r.vclass.value if r.vclass else None, r.first_token_time,
             r.finish_time, r.state.value) for r in reqs]


def test_sim_engine_timeline_bit_identical(sim_stack):
    jexecutor, jcls, jcfg, _, jest = sim_stack
    # the JAX classifier's fitted weights and centroids, in the port's types
    cls = tcls.SmartClassifier(_port_estimator_from_jax(jest),
                               jcls.centroids.copy())
    np.testing.assert_array_equal(cls.centroids, jcls.centroids)
    cm = texec.make_cost_model("llava-7b")
    assert vars(cm) == vars(jexecutor.cm)
    wl = dict(mix="MH", rate=2.0, num_requests=300, seed=0)

    jeng = jengine.Engine(jmake_policy("tcm"),
                          type(jexecutor)(jexecutor.cm), jcls,
                          jengine.EngineConfig(**vars(jcfg)))
    jreqs = jworkload.generate(jworkload.WorkloadConfig(**wl))
    jeng.run(jreqs)

    eng = tengine.Engine(make_policy("tcm"), texec.SimExecutor(cm), cls,
                         tengine.EngineConfig(**vars(jcfg)))
    reqs = tworkload.generate(tworkload.WorkloadConfig(**wl))
    eng.run(reqs)

    assert _timeline(reqs) == _timeline(jreqs)
    assert eng.iterations == jeng.iterations and eng.now == jeng.now
    assert all(r.first_token_time is not None for r in reqs)
