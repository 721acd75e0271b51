"""Benchmark driver: real-commitment cyclefold IVC wall-clock + hot kernels.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, ...}

Headline: cyclefold IVC::next (one fold step) with REAL Pedersen commitments
on the device MSM — the reference's benchmark workload
(`benches/cyclefold_poseidon.rs`, BASELINE.md: trivial new/next/verify =
7.03/5.4/1.45 s on a 64-core EPYC 7702 at primary k=20, 2^23-2^24 keys).
vs_baseline = baseline_seconds / ours (>1 means faster than the reference).

Needs a GPU (exits non-zero otherwise); the output names the device as JAX
reports it and the card's name and power limit as `nvidia-smi` reports them.

Stage order: keys -> NTT -> IVC (headline) -> MSM -> poseidon IVC -> native.
The IVC warmup itself compiles+warms the commit MSM program, so the MSM
bench afterwards is nearly free.  Every stage records progressively into the
output dict, so a watchdog kill still reports the furthest stage reached.

Budget discipline: every stage is gated on a deadline
(SIRIUS_TPU_BENCH_BUDGET_S, default 1700 s) and the best-so-far JSON line is
ALWAYS printed.

Scope control (the default is the full set):
  SIRIUS_TPU_BENCH_SCOPE=msm   kernels only (fast)
  SIRIUS_TPU_BENCH_K           primary circuit k (default 17; the reference
                               cyclefold report rows are k=20)
  SIRIUS_TPU_BENCH_BUDGET_S    wall-clock budget in seconds
"""

from __future__ import annotations

import json
import os
import sys
import time

_T0 = time.time()
_BUDGET = float(os.environ.get("SIRIUS_TPU_BENCH_BUDGET_S", "1700"))


def _remaining() -> float:
    return _BUDGET - (time.time() - _T0)


def _stage(msg: str) -> None:
    """Progress marker on stderr (stdout stays one JSON line)."""
    print(f"[bench +{time.time() - _T0:7.1f}s] {msg}", file=sys.stderr, flush=True)

import jax

from sirius_tpu.util.cache import setup_compile_cache

setup_compile_cache()

import jax.numpy as jnp
import numpy as np

BASELINE_MSM_POINTS_PER_SEC = 1.5e6
# EPYC 7702 64c threaded recursive radix-2 (`src/fft.rs:118-155`): measured
# proxy ~8 M elems/s at 2^20; used as the NTT bar.
BASELINE_NTT_ELEMS_PER_SEC = 8.0e6
# docs/cyclefold_report.md:171-195 (EPYC 7702 64c, k=20, 2^23-2^24 keys)
BASELINES = {
    "trivial": {"new": 7.03, "next": 5.4, "verify": 1.45},
    "poseidon": {"new": 8.88, "next": 6.04, "verify": 2.00},
    "sha256": {"new": 105.0, "next": 91.0, "verify": 10.7},
}
BASELINE_TRIVIAL = BASELINES["trivial"]


def bench_msm(curve, log_n: int, ck):
    """MSM points/s at 2^log_n on the default commit path (gold-checked)."""
    from sirius_tpu.fields import gold
    from sirius_tpu.ops.msm import best_msm
    from sirius_tpu.curves.jpoint import Points

    n = 1 << log_n
    # Vectorized scalar generation: 16x16-bit limbs with the top 4 bits of
    # the high limb cleared -> uniform over [0, 2^252) < p, no bigint mod.
    rng = np.random.default_rng(42)
    limbs = rng.integers(0, 1 << 16, size=(n, 16), dtype=np.uint32)
    limbs[:, 15] &= 0x0FFF
    arr = jnp.asarray(limbs)

    # correctness spot-check vs the gold model on a small prefix
    m = 64
    scalars_m = [
        sum(int(v) << (16 * i) for i, v in enumerate(row)) for row in limbs[:m]
    ]
    prefix = Points(ck.points.x[:m], ck.points.y[:m], ck.points.z[:m])
    got = best_msm(curve, arr[:m], prefix, assume_distinct=True)
    # decode only the prefix: ck.host_points() materializes ALL 2^log_n
    # generators as Python objects (minutes at 2^20)
    want = gold.msm(scalars_m, curve.decode(prefix))
    assert got == want, "MSM kernel disagrees with gold model"

    _stage("msm: gold ok; compile+warm full MSM")
    pts = Points(ck.points.x[:n], ck.points.y[:n], ck.points.z[:n])
    best_msm(curve, arr, pts, assume_distinct=True)  # compile + warm
    _stage("msm: timing")
    t0 = time.time()
    res = best_msm(curve, arr, pts, assume_distinct=True)
    dt = time.time() - t0
    return n / dt


def bench_native(curve, ck, log_n: int):
    from sirius_tpu import native

    if not native.available():
        return 0.0
    n = 1 << log_n
    rng = np.random.default_rng(42)
    scalars = [
        (int(a) | (int(b) << 63) | (int(c) << 126) | (int(d) << 189)) % curve.fs.p
        for a, b, c, d in rng.integers(0, 2**63, size=(n, 4))
    ]
    from sirius_tpu.curves.jpoint import Points

    host_pts = curve.decode(Points(ck.points.x[:n], ck.points.y[:n], ck.points.z[:n]))
    native.native_msm(curve.spec, host_pts, scalars)  # warm
    t0 = time.time()
    native.native_msm(curve.spec, host_pts, scalars)
    return n / (time.time() - t0)


def bench_ntt(log_n: int):
    """Limb-first NTT elems/s at 2^log_n (native (L, n) entry, no boundary
    transpose in the timed region)."""
    from sirius_tpu.fields.constants import bn256_fr
    from sirius_tpu.fields.jfield import FR
    from sirius_tpu.fields.jfield_lf import to_lf
    from sirius_tpu.ops.ntt import NTT

    n = 1 << log_n
    rng = np.random.default_rng(7)
    ntt = NTT(FR, log_n)
    coeffs = to_lf(FR.encode([int(x) for x in rng.integers(0, 2**62, size=n)]))
    coeffs = jnp.asarray(coeffs)
    ntt.fft_lf(coeffs).block_until_ready()
    t0 = time.time()
    ntt.fft_lf(coeffs).block_until_ready()
    return n / (time.time() - t0)


def _make_step(kind: str):
    from sirius_tpu.fields.constants import bn256_fr
    from sirius_tpu.ivc.step_circuit import TrivialStepCircuit

    if kind == "trivial":
        return TrivialStepCircuit(arity=1)
    if kind == "poseidon":
        from sirius_tpu.gadgets.poseidon_step_circuit import PoseidonStepCircuit

        return PoseidonStepCircuit(bn256_fr, repeat_count=1)
    if kind == "sha256":
        from sirius_tpu.gadgets.spread_sha256 import SpreadSha256StepCircuit

        return SpreadSha256StepCircuit(bn256_fr, half_bits=16)
    raise ValueError(kind)


def bench_cyclefold_ivc(k: int, ck1, ck2, out: dict, step_kind: str = "trivial", prefix: str = "ivc"):
    """Cyclefold IVC with REAL commitment keys: pp/new/next/verify
    wall-clock (the BASELINE.md workloads; step_kind picks the row).

    Records progressively into `out` so a watchdog kill mid-stage still
    reports everything finished so far (`{prefix}_pp_s`, `{prefix}_warm_s`,
    then the steady-state `{prefix}_{new,next,verify}_s`)."""
    from sirius_tpu.ivc.cyclefold_ivc import CyclefoldIVC, CyclefoldPublicParams

    t0 = time.time()
    pp = CyclefoldPublicParams(_make_step(step_kind), k=k, ck_primary=ck1, ck_support=ck2)
    out[f"{prefix}_pp_s"] = round(time.time() - t0, 2)
    _stage(f"{prefix}: pp built in {out[f'{prefix}_pp_s']}s; warmup fold")

    # criterion-style warmup (the reference bench also runs warmup
    # iterations): compile every program shape once on a throwaway IVC, then
    # measure steady-state new/next/verify on a fresh IVC over the same pp
    t0 = time.time()
    warm = CyclefoldIVC(pp, [0x42])
    out[f"{prefix}_warm_new_s"] = round(time.time() - t0, 2)
    _stage(f"{prefix}: cold new {out[f'{prefix}_warm_new_s']}s; warmup next")
    t0 = time.time()
    warm.next()
    out[f"{prefix}_warm_next_s"] = round(time.time() - t0, 2)
    _stage(f"{prefix}: cold next {out[f'{prefix}_warm_next_s']}s; warmup verify")
    t0 = time.time()
    errors = warm.verify()
    assert not errors, errors
    out[f"{prefix}_warm_s"] = round(time.time() - t0, 2)
    _stage(f"{prefix}: warm; measuring steady-state")

    t0 = time.time()
    ivc = CyclefoldIVC(pp, [0x42])
    out[f"{prefix}_new_s"] = round(time.time() - t0, 2)

    t0 = time.time()
    ivc.next()
    out[f"{prefix}_next_s"] = round(time.time() - t0, 2)

    t0 = time.time()
    errors = ivc.verify()
    out[f"{prefix}_verify_s"] = round(time.time() - t0, 2)
    assert not errors, errors


def main():
    from sirius_tpu.curves.jpoint import BN256_G1, GRUMPKIN
    from sirius_tpu.ivc.cyclefold_ivc import SUPPORT_K
    from sirius_tpu.ops.commitment import CommitmentKey

    import subprocess

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench.py measures the GPU; JAX found {dev.platform!r}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    scope = os.environ.get("SIRIUS_TPU_BENCH_SCOPE", "full")
    log_n = 20
    # primary table size: default 17 (the sangria bench config scale,
    # `benches/sangria_poseidon.rs:29-31`); the reference cyclefold rows are
    # k=20 — set SIRIUS_TPU_BENCH_K=20 for the full-scale run
    ivc_k = int(os.environ.get("SIRIUS_TPU_BENCH_K", "17"))
    key_k = max(ivc_k + 3, 14, log_n)
    step_kind = os.environ.get("SIRIUS_TPU_BENCH_STEP", "trivial")
    if step_kind == "sha256":
        ivc_k = max(ivc_k, 18)  # the 3-W-commitment SFC needs 2^18 rows
    if step_kind in ("poseidon", "sha256"):
        # gate-adding step circuits widen the SFC (observed: poseidon at
        # k=17 commits 14 columns = 1.75M elems > a 2^20 key)
        key_k = max(ivc_k + 4, key_k)

    out: dict = {
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "card": card,
        "budget_s": _BUDGET,
    }

    flushed = []

    def flush_best():
        """Emit the best-so-far metric line exactly once."""
        if flushed:
            return
        flushed.append(True)
        if "metric" not in out:
            base = BASELINES[step_kind]
            if "ivc_next_s" in out:
                out.update(
                    {
                        "metric": f"cyclefold_{step_kind}_k{ivc_k}_ivc_next_s",
                        "value": out["ivc_next_s"],
                        "unit": "s",
                        "vs_baseline": round(base["next"] / out["ivc_next_s"], 4),
                        "ivc_new_vs_baseline": round(base["new"] / out["ivc_new_s"], 4),
                        "ivc_verify_vs_baseline": round(
                            base["verify"] / out["ivc_verify_s"], 4
                        ),
                        "baseline": "EPYC 7702 64c, docs/cyclefold_report.md:171-195 (k=20, 2^23-2^24 keys)",
                    }
                )
            elif "msm_points_per_sec" in out:
                out.update(
                    {
                        "metric": f"commit_msm_points_per_sec_2^{log_n}",
                        "value": out["msm_points_per_sec"],
                        "unit": "points/s",
                        "vs_baseline": out.get("msm_vs_baseline", 0.0),
                    }
                )
            elif out.get("ntt_elems_per_sec"):
                out.update(
                    {
                        "metric": f"ntt_elems_per_sec_2^{out.get('ntt_log_n', log_n)}",
                        "value": out["ntt_elems_per_sec"],
                        "unit": "elems/s",
                        "vs_baseline": round(
                            out["ntt_elems_per_sec"] / BASELINE_NTT_ELEMS_PER_SEC, 4
                        ),
                    }
                )
            elif "ivc_warm_next_s" in out:
                # watchdog fired before the steady-state pass: the cold next
                # (includes one-time compiles) is still a real IVC wall-clock
                out.update(
                    {
                        "metric": f"cyclefold_{step_kind}_k{ivc_k}_ivc_next_cold_s",
                        "value": out["ivc_warm_next_s"],
                        "unit": "s",
                        "vs_baseline": round(base["next"] / out["ivc_warm_next_s"], 4),
                        "baseline": "EPYC 7702 64c, docs/cyclefold_report.md:172 (cold incl. compile)",
                    }
                )
            elif "ivc_warm_new_s" in out:
                # even earlier kill: cold new() (compile-inclusive) is still
                # an IVC wall-clock datapoint
                out.update(
                    {
                        "metric": f"cyclefold_{step_kind}_k{ivc_k}_ivc_new_cold_s",
                        "value": out["ivc_warm_new_s"],
                        "unit": "s",
                        "vs_baseline": round(base["new"] / out["ivc_warm_new_s"], 4),
                        "baseline": "EPYC 7702 64c, docs/cyclefold_report.md:171 (cold incl. compile)",
                    }
                )
            else:
                out.update({"metric": "bench_incomplete", "value": 0.0, "unit": "", "vs_baseline": 0.0})
        print(json.dumps(out), flush=True)

    # Budget enforcement is deterministic: an exception raised from a signal
    # handler can be swallowed by a library `except Exception` block (jax's
    # persistent-cache read has one), so stage-boundary `_remaining()` gates
    # (below) + the daemon hard-kill watchdog are the only mechanisms.
    import threading

    def watchdog():
        time.sleep(max(_remaining(), 1))
        _stage("watchdog: budget wall hit mid-stage; flushing")
        out["budget_exceeded"] = "watchdog"
        flush_best()
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(0)

    threading.Thread(target=watchdog, daemon=True).start()

    try:
        # ---- keys (shared between the IVC primary and the MSM bench);
        # disk-cached from previous runs ----
        _stage(f"keys: primary 2^{key_k} + support 2^{SUPPORT_K + 3}")
        ck1 = CommitmentKey.setup(BN256_G1, key_k, b"bench-primary", use_cache=True)
        ck2 = CommitmentKey.setup(GRUMPKIN, SUPPORT_K + 3, b"bench-support", use_cache=True)
        out["key_s"] = round(time.time() - _T0, 1)

        # ---- NTT first (independent, cheap cold compile): a watchdog kill
        # during the IVC cold compiles still leaves a kernel metric, which
        # the flush prefers over cold-IVC partials ----
        if _remaining() > 100:
            _stage(f"ntt: start 2^{log_n}")
            try:
                out["ntt_elems_per_sec"] = round(bench_ntt(log_n), 1)
                out["ntt_log_n"] = log_n
                _stage(f"ntt done: {out['ntt_elems_per_sec']:.0f} elems/s")
            except Exception as exc:
                _stage(f"ntt failed: {exc!r}")

        # ---- IVC wall-clock (headline; BASELINE.md rows).  Its
        # warmup compiles+warms the one chunked MSM kernel, so the MSM bench
        # below rides the same executable ----
        if scope == "full" and _remaining() > 120:
            _stage(f"ivc: start k={ivc_k} key_k={key_k} step={step_kind}")
            bench_cyclefold_ivc(ivc_k, ck1, ck2, out, step_kind)
            _stage(f"ivc done; remaining {_remaining():.0f}s")

        # ---- MSM (BASELINE.json kernel metric) ----
        if _remaining() > 90:
            _stage(f"msm: start 2^{log_n}")
            msm_pts = bench_msm(BN256_G1, log_n, ck1)
            out.update(
                {
                    "msm_points_per_sec": round(msm_pts, 1),
                    "msm_log_n": log_n,
                    "msm_vs_baseline": round(msm_pts / BASELINE_MSM_POINTS_PER_SEC, 4),
                }
            )
            _stage(f"msm done: {msm_pts:.0f} pts/s; remaining {_remaining():.0f}s")

        # ---- poseidon IVC row (BASELINE poseidon 8.88/6.04/2.00 s), time
        # permitting: shares keys and most compiled programs with trivial ----
        if scope == "full" and step_kind == "trivial" and _remaining() > 500:
            _stage("poseidon ivc: start")
            try:
                # the poseidon SFC commits 14 columns at 2^17 rows — needs a
                # 2^21 key (disk-cached after the first setup)
                ck1p = (
                    ck1
                    if key_k >= ivc_k + 4
                    else CommitmentKey.setup(
                        BN256_G1, ivc_k + 4, b"bench-primary", use_cache=True
                    )
                )
                bench_cyclefold_ivc(ivc_k, ck1p, ck2, out, "poseidon", prefix="pos_ivc")
                if "pos_ivc_next_s" in out:
                    b = BASELINES["poseidon"]
                    out["pos_ivc_next_vs_baseline"] = round(
                        b["next"] / out["pos_ivc_next_s"], 4
                    )
                _stage(f"poseidon ivc done; remaining {_remaining():.0f}s")
            except Exception as exc:
                _stage(f"poseidon ivc failed: {exc!r}")

        # ---- secondary kernels, time permitting ----
        if scope == "full" and _remaining() > 120:
            _stage("native msm: start")
            out["native_points_per_sec"] = round(
                bench_native(BN256_G1, ck1, min(log_n, 16)), 1
            )
    finally:
        flush_best()


if __name__ == "__main__":
    main()
