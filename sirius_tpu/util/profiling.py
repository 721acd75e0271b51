"""Span-style profiling: host timers + optional jax.profiler traces.

Replaces the reference's `tracing` span instrumentation (SURVEY.md §5):
span names mirror the reference's hot-phase names (sps, witness_commit,
sangria_cha, fold_plonk_instance, fold_witness, compute_F/G/K, ...), and the
JSON stream mirrors `.scripts/build_profiling.py`'s input format so the same
style of time-annotated tree reporting works.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import Optional

_state = threading.local()


@dataclass
class Span:
    name: str
    start: float
    children: list = field(default_factory=list)
    elapsed: float = 0.0


class Profiler:
    """Collects a span tree; enable with SIRIUS_TPU_PROFILE=1 or
    `profiler.enable()`.  A span ends by waiting for every live device
    array, so it holds its device work and not only its dispatch."""

    def __init__(self):
        self.enabled = os.environ.get("SIRIUS_TPU_PROFILE", "0") not in ("0", "")
        self.roots: list[Span] = []
        self.json_stream = os.environ.get("SIRIUS_TPU_PROFILE_JSON")

    def enable(self):
        self.enabled = True

    @contextlib.contextmanager
    def span(self, name: str):
        if not self.enabled:
            yield
            return
        stack = getattr(_state, "stack", None)
        if stack is None:
            stack = _state.stack = []
        s = Span(name, time.perf_counter())
        (stack[-1].children if stack else self.roots).append(s)
        stack.append(s)
        try:
            yield
        finally:
            import jax

            jax.block_until_ready(jax.live_arrays())
            stack.pop()
            s.elapsed = time.perf_counter() - s.start
            if self.json_stream:
                with open(self.json_stream, "a") as f:
                    f.write(
                        json.dumps(
                            {"span": s.name, "elapsed_ms": s.elapsed * 1e3, "depth": len(stack)}
                        )
                        + "\n"
                    )

    def report(self, out=sys.stderr):
        def walk(spans, depth):
            for s in spans:
                print(f"{'  ' * depth}{s.name}: {s.elapsed * 1e3:.2f} ms", file=out)
                walk(s.children, depth + 1)

        walk(self.roots, 0)


profiler = Profiler()
span = profiler.span
