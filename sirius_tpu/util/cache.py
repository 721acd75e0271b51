"""Where the program keeps what it builds at run time, inside the checkout.

- The persistent XLA compile cache.  Its directory is part of the key under
  which JAX finds a compiled program again, so it is one fixed path:
  `JAX_COMPILATION_CACHE_DIR` when the environment sets it (JAX reads that
  variable itself), otherwise `<checkout>/.jax_cache`.
- `DATA_DIR`: commitment keys and the native host libraries built from
  `native/*.cpp`; `SIRIUS_TPU_CACHE` overrides `<checkout>/.cache`.
"""

from __future__ import annotations

import os
from pathlib import Path

_CHECKOUT = Path(__file__).resolve().parents[2]
DEFAULT_DIR = str(_CHECKOUT / ".jax_cache")
DATA_DIR = os.environ.get("SIRIUS_TPU_CACHE") or str(_CHECKOUT / ".cache")


def setup_compile_cache() -> str:
    """Turn on jax's persistent compilation cache and return its directory.
    Call before the first jit runs."""
    import jax

    path = os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_DIR
    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    return path
