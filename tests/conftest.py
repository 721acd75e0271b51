"""Test configuration: run everything on a virtual 8-device CPU mesh.

GPU runs are `chip_smoke.py` and `bench.py`; unit/integration tests use the
CPU backend with 8 virtual devices so multi-chip sharding paths are exercised
without hardware (the analogue of the reference's single-process `cargo test`,
SURVEY.md §4).

The platform is forced programmatically, before any backend initializes, so
that the suite stays on the CPU whatever the environment sets.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

jax.config.update("jax_platforms", "cpu")
# NO persistent compilation cache for the CPU suite: XLA:CPU's executable
# (de)serialization segfaults on some of the limb-first programs (observed
# in both cache read and write paths), and entries AOT-compiled with other
# machines' CPU feature sets SIGILL on load.  GPU runs (chip_smoke.py,
# bench.py, scripts) keep theirs (`util/cache.py`).

import numpy as np
import pytest


@pytest.fixture(scope="module", autouse=True)
def _clear_compiled_caches():
    """Drop compiled-program caches between test modules.

    The suite accumulates hundreds of live executables (jitted closures in
    the protocol-level caches pin their structures and device buffers);
    past ~90 tests XLA:CPU's compiler deterministically aborts compiling
    the next big program.  Per-module clearing keeps the working set
    bounded; the affected modules recompile their own programs anyway.
    """
    yield
    import jax

    from sirius_tpu.nifs import protogalaxy as _pg
    from sirius_tpu.nifs import sangria as _sg
    from sirius_tpu.plonk import eval as _ev
    from sirius_tpu.plonk import permutation as _pm

    _pg._PG_COMPILED.clear()
    _sg._FOLD_COMPILED.clear()
    _ev._COMPILED_CACHE.clear()
    _pm._PERM_IDX_CACHE.clear()
    jax.clear_caches()


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0xC0FFEE)
