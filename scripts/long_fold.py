"""Long-fold endurance run: N cyclefold steps through checkpoint/resume.

First concrete evidence toward the BASELINE.json north star (fold 2^16
Poseidon steps): run `--steps` cyclefold IVC steps in `--segments`
checkpoint/resume segments (each segment re-enters through
`CyclefoldIVC.resume`, exactly the code path a production 2^16-step fold
would use after preemption), assert `verify()` is clean at the end, and
report amortized s/step.

Mock commitment keys (homomorphic s*G, `util/testing.py`) keep the run
CPU-feasible; `--real-keys` switches to real Pedersen MSM commitments for
GPU runs.  Either way the full protocol executes: PG prove/fold, support
Sangria folds, taped SFC synthesis, transcript chains, marker hashes.

Usage:
  python scripts/long_fold.py --steps 1024 --segments 4          # CPU, mock
  python scripts/long_fold.py --steps 1024 --real-keys           # GPU
Emits one JSON line at the end; appends per-segment JSON to --out.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=1024)
    ap.add_argument("--segments", type=int, default=2)
    ap.add_argument("--k", type=int, default=17)
    ap.add_argument("--step-circuit", default="trivial", choices=["trivial", "poseidon"])
    ap.add_argument("--real-keys", action="store_true")
    ap.add_argument("--cpu", action="store_true", help="force the CPU backend")
    ap.add_argument("--ckpt", default=".cache/long_fold_ckpt")
    ap.add_argument("--out", default=".cache/long_fold.jsonl")
    ap.add_argument(
        "--verify-every-segment",
        action="store_true",
        help="run the full verify() at each segment boundary, not just the end",
    )
    args = ap.parse_args()

    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")
    else:
        from sirius_tpu.util.cache import setup_compile_cache

        setup_compile_cache()
    import jax

    from sirius_tpu.curves.jpoint import BN256_G1, GRUMPKIN
    from sirius_tpu.fields.constants import bn256_fr
    from sirius_tpu.ivc.cyclefold_ivc import SUPPORT_K, CyclefoldIVC, CyclefoldPublicParams
    from sirius_tpu.ivc.step_circuit import TrivialStepCircuit
    from sirius_tpu.util.testing import MockCommitmentKey

    t_start = time.time()

    def log(msg):
        print(f"[long_fold +{time.time() - t_start:8.1f}s] {msg}", file=sys.stderr, flush=True)

    if args.real_keys:
        from sirius_tpu.ops.commitment import CommitmentKey

        key_k = max(args.k + 3, 14)
        ck1 = CommitmentKey.setup(BN256_G1, key_k, b"bench-primary", use_cache=True)
        ck2 = CommitmentKey.setup(GRUMPKIN, SUPPORT_K + 3, b"bench-support", use_cache=True)
    else:
        ck1 = MockCommitmentKey(BN256_G1)
        ck2 = MockCommitmentKey(GRUMPKIN)
    log(f"keys ready (real={args.real_keys}, backend={jax.default_backend()})")

    if args.step_circuit == "trivial":
        sc = TrivialStepCircuit(arity=1)
    else:
        from sirius_tpu.gadgets.poseidon_step_circuit import PoseidonStepCircuit

        sc = PoseidonStepCircuit(bn256_fr, repeat_count=1)

    pp = CyclefoldPublicParams(sc, k=args.k, ck_primary=ck1, ck_support=ck2)
    log("pp built")

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    seg_sizes = [args.steps // args.segments] * args.segments
    seg_sizes[-1] += args.steps - sum(seg_sizes)

    total_fold_s = 0.0
    steps_done = 0
    for seg, seg_steps in enumerate(seg_sizes):
        if seg == 0:
            t0 = time.time()
            ivc = CyclefoldIVC(pp, [0x42])
            new_s = time.time() - t0
            steps_done = 1  # IVC::new performs the first step (step counter = 1)
            log(f"segment 0: new() in {new_s:.1f}s")
        else:
            t0 = time.time()
            ivc = CyclefoldIVC.resume(pp, args.ckpt)
            log(f"segment {seg}: resumed at step {ivc.step} in {time.time() - t0:.1f}s")
            assert ivc.step == steps_done, (ivc.step, steps_done)

        t_seg = time.time()
        target = min(steps_done + seg_steps, args.steps) if seg < args.segments - 1 else args.steps
        while ivc.step < target:
            t0 = time.time()
            ivc.next()
            dt = time.time() - t0
            total_fold_s += dt
            steps_done = ivc.step
            if steps_done % 32 == 0 or steps_done <= 4:
                log(
                    f"step {steps_done}/{args.steps} ({dt:.2f}s/step, "
                    f"avg {total_fold_s / max(steps_done - 1, 1):.2f})"
                )
        seg_s = time.time() - t_seg

        ivc.checkpoint(args.ckpt)
        seg_rec = {
            "segment": seg,
            "steps_done": steps_done,
            "segment_s": round(seg_s, 2),
            "z_i": [hex(v) for v in ivc.z_i],
        }
        if args.verify_every_segment:
            t0 = time.time()
            errors = ivc.verify()
            seg_rec["verify_s"] = round(time.time() - t0, 2)
            seg_rec["verify_errors"] = [str(e) for e in errors]
            assert not errors, errors
        with open(args.out, "a") as f:
            f.write(json.dumps(seg_rec) + "\n")
        log(f"segment {seg} checkpointed at step {steps_done}")
        del ivc  # the resume in the next segment must come from disk state

    ivc = CyclefoldIVC.resume(pp, args.ckpt)
    t0 = time.time()
    errors = ivc.verify()
    verify_s = time.time() - t0
    result = {
        "metric": f"cyclefold_{args.step_circuit}_k{args.k}_long_fold",
        "steps": args.steps,
        "segments": args.segments,
        "real_keys": args.real_keys,
        "backend": jax.default_backend(),
        "amortized_next_s": round(total_fold_s / max(args.steps - 1, 1), 3),
        "total_fold_s": round(total_fold_s, 1),
        "final_verify_s": round(verify_s, 1),
        "verify_errors": [str(e) for e in errors],
        "z_final": [hex(v) for v in ivc.z_i],
    }
    with open(args.out, "a") as f:
        f.write(json.dumps(result) + "\n")
    print(json.dumps(result), flush=True)
    assert not errors, errors


if __name__ == "__main__":
    main()
