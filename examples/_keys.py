"""Shared commitment-key selection for the examples.

Real Pedersen keys (device SVDW setup + device MSM commits — the reference's
always-real configuration, `src/commitment.rs:81-90`) are the default on the
GPU; the CPU backend defaults to the non-binding
MockCommitmentKey so the examples stay runnable in seconds.  Override with
SIRIUS_TPU_REAL_KEYS=1/0.
"""

from __future__ import annotations

import os


def example_keys(k_primary: int, k_support: int | None = None, label: str = "example"):
    # NB: the cyclefold support circuit at SUPPORT_K=14 needs ~2^17 key points
    import jax

    from sirius_tpu.curves.jpoint import BN256_G1, GRUMPKIN

    env = os.environ.get("SIRIUS_TPU_REAL_KEYS")
    real = env not in ("0", "false") if env is not None else jax.default_backend() == "gpu"
    if not real:
        from sirius_tpu.util.testing import MockCommitmentKey

        return MockCommitmentKey(BN256_G1), MockCommitmentKey(GRUMPKIN), "mock"

    from sirius_tpu.ops.commitment import CommitmentKey

    k2 = k_support if k_support is not None else k_primary
    ck1 = CommitmentKey.setup(BN256_G1, k_primary, f"{label}-primary".encode())
    ck2 = CommitmentKey.setup(GRUMPKIN, k2, f"{label}-support".encode())
    return ck1, ck2, "real"
