"""sirius_tpu — a JAX Plonkish folding framework for IVC on NVIDIA GPUs.

A from-scratch JAX/XLA re-design of the capabilities of the reference
Rust library (snarkify/sirius): Sangria and ProtoGalaxy folding (NIFS),
Sangria / Cyclefold IVC drivers, a Plonkish special-sound prover, and the
compute core (Pippenger MSM, radix-2 NTT, Poseidon sponge, row-parallel gate
evaluation) as limb-decomposed field kernels, shardable over a device mesh.

Layer map (mirrors SURVEY.md §1):
  fields/   limbed Montgomery field arithmetic (JAX) + python-int gold model
  curves/   elliptic curve point kernels, hash-to-curve
  ops/      MSM, NTT, Poseidon, batch-invert, sparse matmul
  poly/     expression IR, grouped polys, univariate, lagrange
  plonk/    Plonkish structure, SPS protocol, lookups, permutation
  frontend/ circuit builder + runner (halo2-free witness synthesis)
  gadgets/  on-circuit chips (main gate, poseidon, ecc, bignum, fold)
  nifs/     Sangria + ProtoGalaxy folding schemes (off-circuit)
  ivc/      IVC drivers and the StepCircuit user API
  parallel/ device mesh + sharding policy
  util/     transcript RO, digests, spans/profiling
"""

__version__ = "0.1.0"
