"""Test configuration.

Provides the shared sim-stack cache (one expensive profiler/estimator
build per test session, usable both as the ``sim_stack`` fixture and —
for ``@given`` tests, which the shim below runs without fixture support —
via the plain ``sim_stack_cached()`` helper), plus a minimal
seeded-random fallback for ``hypothesis`` when the real package is
absent, covering exactly the API surface these tests use (``given``,
``settings``, and the ``strategies`` constructors). When the real
hypothesis is installed it is used unchanged.
"""
import sys

import pytest

_SIM_STACK = None


def sim_stack_cached():
    """(executor, classifier, engine_cfg, profile, estimator), built once."""
    global _SIM_STACK
    if _SIM_STACK is None:
        from repro.launch.serve import build_stack
        _SIM_STACK = build_stack("chatglm3-6b", "sim",
                                 model_preset="llava-7b")
    return _SIM_STACK


@pytest.fixture(scope="session")
def sim_stack():
    return sim_stack_cached()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device (the port's kernels); skips "
        "without one")

try:
    import hypothesis  # noqa: F401  (real package wins when available)
except ModuleNotFoundError:
    import types
    import zlib

    import numpy as np

    _DEFAULT_MAX_EXAMPLES = 20

    class _Strategy:
        """A draw function over a seeded numpy Generator."""

        def __init__(self, draw):
            self.draw = draw

    def floats(min_value=0.0, max_value=1.0, **_):
        return _Strategy(lambda rng: float(rng.uniform(min_value, max_value)))

    def integers(min_value=0, max_value=1 << 30):
        return _Strategy(
            lambda rng: int(rng.integers(min_value, max_value + 1)))

    def booleans():
        return _Strategy(lambda rng: bool(rng.integers(0, 2)))

    def sampled_from(options):
        opts = list(options)
        return _Strategy(lambda rng: opts[int(rng.integers(len(opts)))])

    def lists(elements, min_size=0, max_size=10, **_):
        def draw(rng):
            n = int(rng.integers(min_size, max_size + 1))
            return [elements.draw(rng) for _ in range(n)]
        return _Strategy(draw)

    def tuples(*elements):
        return _Strategy(lambda rng: tuple(e.draw(rng) for e in elements))

    def given(**strategy_kwargs):
        def decorate(fn):
            # Zero-arg runner so pytest does not mistake the strategy
            # parameter names for fixtures.
            def runner():
                n = getattr(runner, "_max_examples", _DEFAULT_MAX_EXAMPLES)
                base = zlib.crc32(fn.__qualname__.encode())
                for i in range(n):
                    rng = np.random.default_rng((base + i) % (1 << 32))
                    fn(**{k: s.draw(rng)
                          for k, s in strategy_kwargs.items()})
            runner.__name__ = fn.__name__
            runner.__doc__ = fn.__doc__
            runner.__module__ = fn.__module__
            return runner
        return decorate

    def settings(max_examples=_DEFAULT_MAX_EXAMPLES, deadline=None, **_):
        def decorate(fn):
            fn._max_examples = max_examples
            return fn
        return decorate

    _shim = types.ModuleType("hypothesis")
    _shim.given = given
    _shim.settings = settings
    _shim.__is_repro_shim__ = True
    _st = types.ModuleType("hypothesis.strategies")
    for _f in (floats, integers, booleans, sampled_from, lists, tuples):
        setattr(_st, _f.__name__, _f)
    _shim.strategies = _st
    sys.modules["hypothesis"] = _shim
    sys.modules["hypothesis.strategies"] = _st
