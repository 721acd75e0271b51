"""Smoke test of the cyclefold IVC on one NVIDIA GPU, with real keys.

    python chip_smoke.py          # one GPU: phases 1-4 below
    python chip_smoke.py --four   # four GPUs: sharded commit MSM + sharded folds

One process drives the card(s).  Phases, in order; any failure exits
non-zero and nothing is caught and passed over:

  1. device        a GPU is required; card name and power limit, compile
                   cache, native host libraries
  2. compile only  the commit-MSM programs at their real shapes (bn256 2^20,
                   grumpkin 2^17) and the ProtoGalaxy gate-leaf program of the
                   k=17 step: compile seconds and memory analysis
  3. kernels       every device kernel against an independent reference at
                   real widths: bucket MSM vs the C++ host Pippenger, field
                   multiply vs the C++ host field, NTT round trip and gold
                   vector, Poseidon golden vector
  4. main path     CyclefoldIVC new / next x3 / verify at k=17 with a 2^20
                   bn256 key and a 2^17 grumpkin key; cold and warm seconds,
                   span split, peak device memory

The last line of stdout is one JSON object:
  {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

PRIMARY_KEY_LOG = 20  # bn256 commitment key, 2^20 points
SUPPORT_KEY_LOG = 17  # grumpkin commitment key, 2^17 points
STEP_K = 17  # primary circuit rows, 2^17
NEXT_STEPS = 3
FOUR_MSM_LOG = 22  # sharded commit MSM size for --four
SEED = 20260
T0 = time.perf_counter()


def log(msg: str = "") -> None:
    print(f"[{time.perf_counter() - T0:8.1f}s] {msg}", flush=True)


def card_line() -> str:
    """`nvidia-smi` name and power limit (a child process, off JAX)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip()


def require_gpu():
    """The first device, which must be a GPU; exits 1 otherwise."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: needs a GPU, JAX found {dev.platform!r}", file=sys.stderr)
        sys.exit(1)
    return dev


def _timed(fn, *args, **kwargs):
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    return out, time.perf_counter() - t0


def random_scalars(rng: np.random.Generator, n: int, modulus: int) -> np.ndarray:
    """(n, 16) uint32 16-bit limbs of uniform-ish values below `modulus`
    (the top limb is drawn below the modulus' top limb, so every window of
    the MSM, the top one included, sees live digits)."""
    limbs = rng.integers(0, 1 << 16, size=(n, 16), dtype=np.uint32)
    limbs[:, 15] %= np.uint32(modulus >> 240)
    return limbs


def limbs_to_u64(a: np.ndarray) -> np.ndarray:
    """(n, 16) 16-bit limbs -> (n, 4) little-endian uint64 words."""
    a = np.asarray(a, dtype=np.uint64).reshape(-1, 4, 4)
    return a[..., 0] | (a[..., 1] << 16) | (a[..., 2] << 32) | (a[..., 3] << 48)


def host_ints(a) -> list[int]:
    from sirius_tpu import native

    return native.u64_to_ints(limbs_to_u64(np.asarray(a)))


# ---------------------------------------------------------------------------
# phase 1
# ---------------------------------------------------------------------------


def phase_device():
    from sirius_tpu import native
    from sirius_tpu.util.cache import setup_compile_cache

    dev = require_gpu()
    log("== phase 1: device")
    log(f"device_kind: {dev.device_kind}  count: {len(jax.devices())}  jax: {jax.__version__}")
    log(f"card: {card_line()}")
    log(f"compile cache: {setup_compile_cache()}")
    log(f"native host field library loaded: {native.available()} ({native.load_error()})")
    log(f"native witness-tape library loaded: {native.tape_available()} ({native.tape_load_error()})")
    if not native.available():
        raise RuntimeError(f"native host field library failed: {native.load_error()}")
    if not native.tape_available():
        raise RuntimeError(f"witness-tape library failed: {native.tape_load_error()}")
    return dev


# ---------------------------------------------------------------------------
# phase 2
# ---------------------------------------------------------------------------


def _report_compiled(name: str, lowered) -> float:
    compiled, dt = _timed(lowered.compile)
    log(f"compile {name}: {dt:.2f} s")
    log(f"  memory_analysis: {compiled.memory_analysis()}")
    return dt


def compile_commit_msm(curve, n: int) -> float:
    """Lower and compile the commit MSM program `best_msm` runs at n points."""
    from sirius_tpu.curves.jpoint import Points
    from sirius_tpu.ops import msm

    sds = jax.ShapeDtypeStruct((n, 16), jnp.uint32)
    fn = msm._msm_bucket_fused_jit(curve, 4, msm.fused_groups(n), True)
    return _report_compiled(f"commit MSM {curve.spec.name} n=2^{n.bit_length() - 1}",
                            fn.lower(sds, Points(sds, sds, sds)))


def compile_pg_leaves(S) -> float:
    """Lower and compile the ProtoGalaxy gate-leaf sweep of structure S."""
    from sirius_tpu.nifs import protogalaxy as pg
    from sirius_tpu.plonk.structure import PlonkWitness

    f = S.field
    challenges = [f.zeros(()) for _ in range(S.num_challenges)]
    W = PlonkWitness.zeros(f, S.round_sizes).W
    lowered = pg._leaves_fn(S).lower(S.selectors_jax, S.fixed_jax, challenges, W)
    return _report_compiled(f"ProtoGalaxy gate leaves k={S.k}", lowered)


def make_key(curve, log_n: int, label: bytes):
    """A real commitment key of 2^log_n points, made on the device."""
    from sirius_tpu.ops.commitment import CommitmentKey

    t0 = time.perf_counter()
    ck = CommitmentKey.setup(curve, log_n, label, use_cache=False)
    ck.points.x.block_until_ready()
    log(f"key set-up {curve.spec.name} 2^{log_n}: {time.perf_counter() - t0:.2f} s")
    return ck


def setup_keys():
    from sirius_tpu.curves.jpoint import BN256_G1, GRUMPKIN

    return (make_key(BN256_G1, PRIMARY_KEY_LOG, b"smoke-primary"),
            make_key(GRUMPKIN, SUPPORT_KEY_LOG, b"smoke-support"))


def build_pp(ck1, ck2):
    from sirius_tpu.ivc.cyclefold_ivc import CyclefoldPublicParams
    from sirius_tpu.ivc.step_circuit import TrivialStepCircuit

    pp, dt = _timed(CyclefoldPublicParams, TrivialStepCircuit(arity=1), k=STEP_K,
                    ck_primary=ck1, ck_support=ck2)
    log(f"public params k={STEP_K}: {dt:.2f} s")
    return pp


def phase_compile(ck1, ck2, pp):
    log("== phase 2: compile only")
    compile_commit_msm(ck1.curve, 1 << PRIMARY_KEY_LOG)
    compile_commit_msm(ck2.curve, 1 << SUPPORT_KEY_LOG)
    compile_pg_leaves(pp.S_primary)


# ---------------------------------------------------------------------------
# phase 3
# ---------------------------------------------------------------------------


def check_msm(ck, log_n: int, seed: int = SEED) -> float:
    """`best_msm` over the first 2^log_n key points vs the C++ host
    Pippenger; a commit of 7/8 of them through `commit_device` (the IVC's
    commit lengths: 917504 = 7 * 2^17 of a 2^20 key, 114688 = 7 * 2^14 of
    a 2^17 key), padded to 2^log_n with key points, vs the host Pippenger;
    and with all but the first 64 scalars zeroed vs `gold.msm` of those 64.
    Bit-exact; returns the warm device seconds of the full MSM."""
    from sirius_tpu import native
    from sirius_tpu.curves.jpoint import Points
    from sirius_tpu.fields import gold
    from sirius_tpu.ops.msm import best_msm

    curve = ck.curve
    n = 1 << log_n
    rng = np.random.default_rng(seed)
    limbs = random_scalars(rng, n, curve.fs.p)
    scalars = jnp.asarray(limbs)
    pts = Points(ck.points.x[:n], ck.points.y[:n], ck.points.z[:n])

    got, cold = _timed(best_msm, curve, scalars, pts, assume_distinct=True)
    again, warm = _timed(best_msm, curve, scalars, pts, assume_distinct=True)
    assert again == got, "best_msm is not deterministic"

    one = curve.fb.one_mont_limbs
    assert bool(jnp.all(pts.z == jnp.asarray(one))), "key points must be affine (z = 1)"
    xs = host_ints(curve.fb.from_mont(pts.x))
    ys = host_ints(curve.fb.from_mont(pts.y))
    ints = host_ints(limbs)
    field = native.get_field(curve.fb.p, curve.spec.b)
    (x, y, inf), host_s = _timed(field.msm, xs, ys, None, ints)
    assert not inf and not got.is_identity
    assert (got.x, got.y) == (x, y), f"best_msm {curve.spec.name} 2^{log_n} != host Pippenger"

    c = n - n // 8
    commit, commit_s = _timed(ck.commit_device, curve.fs.to_mont(scalars[:c]))
    x, y, inf = field.msm(xs[:c], ys[:c], None, ints[:c])
    assert not inf and (commit.x, commit.y) == (x, y), f"commit of {c} points != host Pippenger"

    m = 64
    prefix = Points(pts.x[:m], pts.y[:m], pts.z[:m])
    head = np.zeros_like(limbs)
    head[:m] = limbs[:m]
    small = best_msm(curve, jnp.asarray(head), pts, assume_distinct=True)
    assert small == gold.msm(ints[:m], curve.decode(prefix)), "best_msm != gold.msm (64 points)"
    log(f"MSM {curve.spec.name} 2^{log_n}: bit-exact vs host Pippenger and gold (64 pts); "
        f"device cold {cold:.3f} s, warm {warm:.3f} s, host Pippenger {host_s:.3f} s; "
        f"commit of {c} points (padded with key points) bit-exact, {commit_s:.3f} s")
    return warm


def check_msm_many(ck, log_n: int, t: int, seed: int = SEED + 1) -> None:
    """`msm_many`'s batched program over t scalar vectors equals t calls of
    `best_msm`; both timed warm."""
    from sirius_tpu.curves.jpoint import Points
    from sirius_tpu.ops.msm import best_msm, msm_many

    curve = ck.curve
    n = 1 << log_n
    rng = np.random.default_rng(seed)
    batch = jnp.asarray(np.stack([random_scalars(rng, n, curve.fs.p) for _ in range(t)]))
    pts = Points(ck.points.x[:n], ck.points.y[:n], ck.points.z[:n])

    def one_by_one():
        return [best_msm(curve, batch[i], pts, assume_distinct=True) for i in range(t)]

    got, cold = _timed(msm_many, curve, batch, pts, assume_distinct=True)
    want = one_by_one()
    assert got == want, "msm_many != best_msm"
    _, batched = _timed(msm_many, curve, batch, pts, assume_distinct=True)
    _, looped = _timed(one_by_one)
    log(f"msm_many {curve.spec.name} t={t} n=2^{log_n}: equal to best_msm; batched cold "
        f"{cold:.3f} s, warm {batched:.3f} s; {t} best_msm calls warm {looped:.3f} s")


def check_field_mul(log_n: int, seed: int = SEED + 2) -> None:
    """FR Montgomery multiply over 2^log_n pairs vs the C++ host field."""
    from sirius_tpu import native
    from sirius_tpu.fields.jfield import FR

    n = 1 << log_n
    rng = np.random.default_rng(seed)
    a = random_scalars(rng, n, FR.p)
    b = random_scalars(rng, n, FR.p)
    da, db = FR.to_mont(jnp.asarray(a)), FR.to_mont(jnp.asarray(b))
    FR.mul(da, db).block_until_ready()
    prod, dt = _timed(lambda: FR.mul(da, db).block_until_ready())
    got = host_ints(FR.from_mont(prod))
    want = native.get_field(FR.p).mul(host_ints(a), host_ints(b))
    assert got == want, "FR.mul != host field multiply"
    log(f"FR.mul 2^{log_n}: bit-exact vs host field; warm {dt:.4f} s")


def check_ntt(log_n: int, gold_log_n: int = 12, seed: int = SEED + 3) -> None:
    """NTT at 2^log_n: ifft(fft(a)) == a and X[0], X[1] against host sums;
    NTT at 2^gold_log_n against the gold model."""
    from sirius_tpu.fields import gold
    from sirius_tpu.fields.constants import bn256_fr
    from sirius_tpu.fields.jfield import FR
    from sirius_tpu.ops.ntt import NTT

    p = FR.p
    rng = np.random.default_rng(seed)
    n = 1 << log_n
    limbs = random_scalars(rng, n, p)
    a = jnp.asarray(limbs)
    ntt = NTT(FR, log_n)
    ntt.fft(a).block_until_ready()
    out, dt = _timed(lambda: ntt.fft(a).block_until_ready())
    back = ntt.ifft(out)
    assert bool(jnp.array_equal(back, a)), f"NTT 2^{log_n} round trip"
    vals = host_ints(limbs)
    x01 = host_ints(out[:2])
    omega = gold.omega_for_k(bn256_fr, log_n)
    assert x01[0] == sum(vals) % p, "NTT X[0]"
    acc, w = 0, 1
    for v in vals:
        acc += v * w
        w = w * omega % p
    assert x01[1] == acc % p, "NTT X[1]"

    small = random_scalars(rng, 1 << gold_log_n, p)
    got = host_ints(NTT(FR, gold_log_n).fft(jnp.asarray(small)))
    assert got == gold.fft(host_ints(small), bn256_fr), f"NTT 2^{gold_log_n} != gold.fft"
    log(f"NTT 2^{log_n}: round trip and X[0], X[1] exact, warm fft {dt:.4f} s; "
        f"2^{gold_log_n} equal to gold.fft")


def check_poseidon() -> None:
    from sirius_tpu.fields.constants import pasta_fp
    from sirius_tpu.ops.poseidon import PoseidonHash, poseidon_spec

    out = PoseidonHash(poseidon_spec(pasta_fp, 3, 2, 4, 3)).absorb_iter(range(5)).squeeze(128)
    assert out == 277726250230731218669330566268314254439, out
    log("Poseidon golden vector: equal")


def phase_kernels(ck1, ck2, pp):
    log("== phase 3: kernels vs references (integer arithmetic: bit-exact, tolerance zero)")
    check_msm(ck1, PRIMARY_KEY_LOG)
    check_msm(ck2, SUPPORT_KEY_LOG)
    # the shape the support Sangria fold commits its cross terms at
    check_msm_many(ck2, pp.S_support.k, max(pp.num_cross_terms_support(), 2))
    check_field_mul(20)
    check_ntt(20)
    check_poseidon()


# ---------------------------------------------------------------------------
# phase 4
# ---------------------------------------------------------------------------


def _spans(roots, depth: int = 0) -> None:
    for s in roots:
        log(f"    {'  ' * depth}{s.name}: {s.elapsed:.3f} s")
        _spans(s.children, depth + 1)


def phase_main_path(pp, dev):
    from sirius_tpu.ivc.cyclefold_ivc import CyclefoldIVC
    from sirius_tpu.util.profiling import profiler

    log(f"== phase 4: CyclefoldIVC k={STEP_K}, keys bn256 2^{PRIMARY_KEY_LOG} / grumpkin 2^{SUPPORT_KEY_LOG}")
    profiler.enable()

    def call(label, fn):
        profiler.roots = []
        out, dt = _timed(fn)
        log(f"  {label}: {dt:.3f} s")
        _spans(profiler.roots)
        return out

    ivc = call("new (cold)", lambda: CyclefoldIVC(pp, [0x42]))
    call("new (warm)", lambda: CyclefoldIVC(pp, [0x42]))
    for i in range(NEXT_STEPS):
        call(f"next #{i + 1} ({'cold' if i == 0 else 'warm'})", ivc.next)
    for label in ("verify (cold)", "verify (warm)"):
        errors = call(label, ivc.verify)
        assert not errors, errors
    log(f"  verify: no errors after {NEXT_STEPS} steps")
    log(f"peak device memory: {dev.memory_stats()['peak_bytes_in_use']} bytes")


# ---------------------------------------------------------------------------
# --four
# ---------------------------------------------------------------------------


def four_cards():
    from sirius_tpu.curves.jpoint import BN256_G1, Points
    from sirius_tpu.ops.msm import best_msm, msm_sharded
    from sirius_tpu.parallel.mesh import make_mesh

    import __graft_entry__

    devs = jax.devices()
    if len(devs) < 4:
        raise RuntimeError(f"--four needs 4 GPUs, JAX found {len(devs)}")
    mesh = make_mesh(4)
    log(f"== --four: rows mesh over {[d.id for d in mesh.devices.flat]}")

    n = 1 << FOUR_MSM_LOG
    ck = make_key(BN256_G1, FOUR_MSM_LOG, b"smoke-four")
    scalars = jnp.asarray(random_scalars(np.random.default_rng(SEED + 4), n, BN256_G1.fs.p))
    pts = Points(*ck.points)

    sharded, cold = _timed(msm_sharded, BN256_G1, scalars, pts, mesh, assume_distinct=True)
    again, warm = _timed(msm_sharded, BN256_G1, scalars, pts, mesh, assume_distinct=True)
    assert again == sharded
    log(f"msm_sharded 2^{FOUR_MSM_LOG} on 4 GPUs: cold {cold:.3f} s, warm {warm:.3f} s")
    shard_bytes = 3 * (n // 4) * 16 * 4
    for d in mesh.devices.flat:
        peak = d.memory_stats()["peak_bytes_in_use"]
        log(f"  device {d.id}: peak {peak} bytes")
        assert peak >= shard_bytes, f"device {d.id} never held its shard of the key"
    single, cold1 = _timed(best_msm, BN256_G1, scalars, pts, assume_distinct=True)
    _, warm1 = _timed(best_msm, BN256_G1, scalars, pts, assume_distinct=True)
    log(f"best_msm 2^{FOUR_MSM_LOG} on one GPU: cold {cold1:.3f} s, warm {warm1:.3f} s")
    assert sharded == single, "msm_sharded on 4 GPUs != best_msm on one"
    log("msm_sharded == best_msm: bit-exact")

    t0 = time.perf_counter()
    __graft_entry__.sharded_folds(4)
    log(f"sharded Sangria + ProtoGalaxy folds on 4 GPUs: verified, {time.perf_counter() - t0:.2f} s")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the sharded MSM and sharded folds on four GPUs")
    args = ap.parse_args(argv)

    dev = phase_device()
    if args.four:
        four_cards()
    else:
        ck1, ck2 = setup_keys()
        pp = build_pp(ck1, ck2)
        phase_compile(ck1, ck2, pp)
        phase_kernels(ck1, ck2, pp)
        phase_main_path(pp, dev)
    log(f"card: {card_line()}")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": len(jax.devices()),
    }}), flush=True)


if __name__ == "__main__":
    main()
