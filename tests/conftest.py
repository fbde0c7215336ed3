"""Test-suite bootstrap.

The property tests use ``hypothesis`` when it is installed (CI installs it
via ``requirements-dev.txt``). Environments without it — the tier-1
command must run everywhere — get a minimal deterministic stand-in that
implements exactly the surface these tests use (``given``, ``settings``,
the ``integers``/``booleans``/``tuples``/``lists``/``none``/``just``/
``sampled_from``/``one_of``/``builds``/``map`` strategy combinators and
``composite``). The stand-in draws from a fixed-seed numpy generator, so
runs are reproducible; it performs no shrinking.
"""
from __future__ import annotations

import functools
import inspect
import sys
import types

import numpy as np

try:  # pragma: no cover - exercised implicitly when hypothesis exists
    import hypothesis  # noqa: F401
except ModuleNotFoundError:
    class _Strategy:
        def __init__(self, draw):
            self._draw = draw

        def map(self, fn):
            return _Strategy(lambda rng: fn(self._draw(rng)))

        def example(self, rng):
            return self._draw(rng)

    def integers(min_value, max_value):
        return _Strategy(lambda rng: int(rng.integers(min_value,
                                                      max_value + 1)))

    def booleans():
        return _Strategy(lambda rng: bool(rng.integers(0, 2)))

    def tuples(*elems):
        return _Strategy(lambda rng: tuple(e._draw(rng) for e in elems))

    def lists(elem, min_size=0, max_size=None):
        hi = 32 if max_size is None else max_size

        def draw(rng):
            n = int(rng.integers(min_size, hi + 1))
            return [elem._draw(rng) for _ in range(n)]

        return _Strategy(draw)

    def none():
        return _Strategy(lambda rng: None)

    def just(value):
        return _Strategy(lambda rng: value)

    def sampled_from(options):
        options = list(options)
        return _Strategy(
            lambda rng: options[int(rng.integers(0, len(options)))])

    def one_of(*strategies):
        return _Strategy(
            lambda rng: strategies[int(rng.integers(0,
                                                    len(strategies)))]
            ._draw(rng))

    def builds(target, *args, **kwargs):
        def draw(rng):
            return target(*[s._draw(rng) for s in args],
                          **{k: s._draw(rng) for k, s in kwargs.items()})
        return _Strategy(draw)

    def composite(fn):
        def make(*args, **kwargs):
            def draw_all(rng):
                return fn(lambda s: s._draw(rng), *args, **kwargs)
            return _Strategy(draw_all)
        return make

    def settings(max_examples=None, deadline=None, **_kw):
        def deco(fn):
            fn._stub_settings = {"max_examples": max_examples}
            return fn
        return deco

    def given(*strategies):
        def deco(fn):
            @functools.wraps(fn)
            def wrapper(*args, **kwargs):
                conf = (getattr(wrapper, "_stub_settings", None)
                        or getattr(fn, "_stub_settings", None) or {})
                examples = conf.get("max_examples") or 20
                rng = np.random.default_rng(0xE71CA)
                for _ in range(examples):
                    drawn = tuple(s._draw(rng) for s in strategies)
                    fn(*args, *drawn, **kwargs)
            # pytest must not mistake the drawn parameters for fixtures:
            # hide the wrapped signature and present a parameterless one
            del wrapper.__wrapped__
            wrapper.__signature__ = inspect.Signature([])
            return wrapper
        return deco

    stub = types.ModuleType("hypothesis")
    stub.given = given
    stub.settings = settings
    strategies_mod = types.ModuleType("hypothesis.strategies")
    strategies_mod.integers = integers
    strategies_mod.booleans = booleans
    strategies_mod.tuples = tuples
    strategies_mod.lists = lists
    strategies_mod.none = none
    strategies_mod.just = just
    strategies_mod.sampled_from = sampled_from
    strategies_mod.one_of = one_of
    strategies_mod.builds = builds
    strategies_mod.composite = composite
    stub.strategies = strategies_mod
    stub.__is_stub__ = True
    sys.modules["hypothesis"] = stub
    sys.modules["hypothesis.strategies"] = strategies_mod


# The property suites compile hundreds of distinct executable shapes
# (every hypothesis-drawn trace length is its own jit cache entry).
# Left to accumulate over the whole run, the CPU backend eventually
# segfaults inside XLA's backend_compile, so bound the live-executable
# population by dropping jit caches at every module boundary. Costs a
# few recompiles per module; buys a suite-length-independent process.
import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA CUDA device (the port's kernels); "
        "skips itself without one")


@pytest.fixture(autouse=True, scope="module")
def _bounded_jit_cache():
    yield
    import jax
    jax.clear_caches()
