"""Metric hot-swap and static parameter baking (port of
``geodesic_raytracing_tpu.runtime.hotswap``).

The reference's two-program scheme (metric_manager.hpp): on a metric switch
a *dynamic* program serves at once, with the parameters read at launch,
while a *static* program with the slider values baked in as literals builds
in the background and is swapped in when ready (check_substitution,
metric_manager.hpp:172-219).

The port's equivalents:

* dynamic program: the ray-march kernel's library of the metric, which
  takes the parameters as launch arguments (the struct ``ops/emit.py``
  writes from the metric's function);
* static program: the same kernel built with the parameters as
  compile-time constants (``ops.raymarch.emitted_instance`` with the
  values: a header traced with them as Python floats), so that ``nvcc``
  folds them through the step; on the CPU, ``bake``'s function evaluates
  the metric with the values as Python floats;
* hot swap: ``nvcc`` runs on a worker thread and the dispatch switches
  atomically once the library is loaded.  A call never waits for a build;
  a failed build leaves the dynamic program serving and is kept in
  ``static_error``.
"""

from __future__ import annotations

import dataclasses
import sys
import threading
import time
from typing import Any, Callable

from ..metrics.base import BakedFn, Metric


def bake(metric: Metric, params: dict) -> Metric:
    """A Metric whose parameters are compile-time constants (the
    reference's ``build_concrete`` substitution, metric.hpp:495): its
    function (and a rank-1 metric's decomposition) ignores the parameters
    it is called with and evaluates the metric with these values as Python
    floats, and on the card it launches the baked build of its kernel
    instance."""
    if isinstance(metric.fn, BakedFn):
        metric = dataclasses.replace(metric, fn=metric.fn.fn, rank1=(
            metric.rank1.fn if isinstance(metric.rank1, BakedFn)
            else metric.rank1))
    const = tuple((k, float(v)) for k, v in params.items())
    return dataclasses.replace(
        metric, fn=BakedFn(metric.fn, const),
        rank1=None if metric.rank1 is None else BakedFn(metric.rank1, const))


class HotSwapProgram:
    """Dynamic-now / static-later program pair.

    ``build_static(params)`` returns a ready callable (its library built
    and loaded); it runs on a worker thread.  ``prepare(params)``, where
    given, runs first on the requesting thread (the port traces an emitted
    metric there) and its result is passed to ``build_static`` as a second
    argument.  ``__call__(params, ...)`` dispatches to the static program
    if one for these parameters is ready, else to the dynamic one, and
    never waits for a build (metric_manager.hpp:83-167).  ``served`` counts
    the calls each program served, ``build_seconds`` the last build's wall
    time, ``static_error`` the last build's failure (or None)."""

    def __init__(self, dynamic: Callable, build_static: Callable,
                 prepare: Callable | None = None):
        self._dynamic = dynamic
        self._build_static = build_static
        self._prepare = prepare
        self._lock = threading.Lock()
        self._static: Callable | None = None
        self._static_key: tuple | None = None
        self._pending_key: tuple | None = None
        self._thread: threading.Thread | None = None
        self.served = {"dynamic": 0, "static": 0}
        self.build_seconds: float | None = None
        self.static_error: str | None = None

    @staticmethod
    def _key(params: dict) -> tuple:
        return tuple(sorted((k, float(v)) for k, v in params.items()))

    def request_static(self, params: dict) -> None:
        """Start a background build of the static program for these
        parameter values (once per value set)."""
        key = self._key(params)
        with self._lock:
            if key in (self._static_key, self._pending_key):
                return
            self._pending_key = key
            self.static_error = None
        try:
            prepared = (None if self._prepare is None
                        else self._prepare(dict(params)))
        except Exception as e:
            self._failed(key, e)
            return

        def worker():
            t0 = time.perf_counter()
            try:
                fn = (self._build_static(dict(params)) if self._prepare is None
                      else self._build_static(dict(params), prepared))
            except Exception as e:
                self._failed(key, e)
                return
            with self._lock:
                self.build_seconds = time.perf_counter() - t0
                if self._pending_key == key:
                    self._static = fn
                    self._static_key = key
                    self._pending_key = None

        t = threading.Thread(target=worker, daemon=True)
        with self._lock:
            self._thread = t
        t.start()

    def _failed(self, key, e: Exception) -> None:
        msg = f"{type(e).__name__}: {e}"
        with self._lock:
            if self._pending_key == key:
                self._pending_key = None
            self.static_error = msg
        print(f"[grt_torch] static program build failed; the dynamic "
              f"program keeps serving: {msg}", file=sys.stderr, flush=True)

    def __call__(self, params: dict, *args, **kwargs) -> Any:
        key = self._key(params)
        with self._lock:
            static = self._static if self._static_key == key else None
            self.served["static" if static is not None else "dynamic"] += 1
        if static is not None:
            return static(*args, **kwargs)
        return self._dynamic(params, *args, **kwargs)

    @property
    def static_ready(self) -> bool:
        with self._lock:
            return self._static is not None

    @property
    def static_key(self) -> tuple | None:
        with self._lock:
            return self._static_key

    def wait(self, timeout: float | None = None) -> None:
        t = self._thread
        if t is not None:
            t.join(timeout)


def kernel_program(metric: Metric, run: Callable) -> HotSwapProgram:
    """The hot-swap pair of ``metric``'s ray-march kernel:
    ``run(metric, params, *args, **kwargs)`` renders (or marches) with a
    metric; the dynamic program passes ``metric`` itself, the static one
    ``bake(metric, params)`` once its baked library is built and loaded
    (``ops.raymarch.emitted_instance``: the metric is traced on the
    requesting thread, ``nvcc`` runs on the worker)."""
    from ..ops import raymarch

    def dynamic(params, *args, **kwargs):
        return run(metric, params, *args, **kwargs)

    def prepare(params):
        return raymarch.emitted_instance(metric, params)

    def build_static(params, inst):
        raymarch.get_lib(inst)
        baked = bake(metric, params)

        def static(*args, **kwargs):
            return run(baked, params, *args, **kwargs)

        return static

    return HotSwapProgram(dynamic, build_static, prepare)
