#!/usr/bin/env python
"""Minimal end-to-end Sangria IVC run (reference `examples/sangria_trivial.rs`).

Canonical API usage: build PublicParams for a 2-cycle, run IVC::new, fold a
few steps, verify.  By default uses the homomorphic mock commitment so it
runs anywhere; pass --real-commitments on a GPU for the full MSM path.
"""

import argparse
import sys
import time

sys.path.insert(0, ".")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--fold-steps", type=int, default=1)
    ap.add_argument("--k", type=int, default=16, help="table size (2^k rows)")
    ap.add_argument("--real-commitments", action="store_true")
    ap.add_argument("--cpu", action="store_true", help="force the CPU backend")
    args = ap.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    __import__("sirius_tpu.util.cache", fromlist=["setup_compile_cache"]).setup_compile_cache()

    from sirius_tpu.curves.jpoint import BN256_G1, GRUMPKIN
    from sirius_tpu.ivc.sangria_ivc import IVC, PublicParams
    from sirius_tpu.ivc.step_circuit import TrivialStepCircuit
    from sirius_tpu.util.profiling import profiler, span

    profiler.enable()

    if args.real_commitments:
        from sirius_tpu.ops.commitment import CommitmentKey

        ck1 = CommitmentKey.setup(BN256_G1, args.k + 3, b"sangria-trivial", window_bits=8)
        ck2 = CommitmentKey.setup(GRUMPKIN, args.k + 3, b"sangria-trivial", window_bits=8)
    else:
        from sirius_tpu.util.testing import MockCommitmentKey

        ck1, ck2 = MockCommitmentKey(BN256_G1), MockCommitmentKey(GRUMPKIN)

    with span("public_params"):
        pp = PublicParams(
            TrivialStepCircuit(arity=1), TrivialStepCircuit(arity=1),
            k1=args.k, k2=args.k, ck1=ck1, ck2=ck2,
        )
    with span("ivc_new"):
        ivc = IVC(pp, [0x11], [0x22])
    for i in range(args.fold_steps):
        t0 = time.time()
        with span("ivc_fold_step"):
            ivc.fold_step()
        print(f"fold step {i}: {time.time() - t0:.2f}s")
    with span("ivc_verify"):
        errors = ivc.verify()
    print("verify:", "OK" if not errors else errors)
    profiler.report()
    return 0 if not errors else 1


if __name__ == "__main__":
    sys.exit(main())
