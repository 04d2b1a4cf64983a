"""VisionX-SLAM in JAX: a visual SLAM framework compiled by XLA.

A from-scratch rebuild of the capabilities of the reference C++ system
QinZiwen/VisionX-SLAM (ORB features -> Hamming matching -> Essential/PnP
RANSAC -> keyframe triangulation -> sliding-window bundle adjustment),
designed for an accelerator (today one NVIDIA H100):

- fixed shapes + validity masks everywhere (no dynamic control flow on device)
- the map is an immutable pytree of fixed-capacity SoA tables
- descriptor matching is a bit-plane GEMM
- RANSAC is a fixed batch of vmapped hypotheses + argmax
- bundle adjustment is batched 6x6/3x3 block Gauss-Newton under lax.scan

Layout:
    ops/       low-level numerics: SE(3)/SO(3), camera models, small solves
    models/    pipeline stages: ORB extractor, matcher, RANSAC estimators, BA
    parallel/  device meshes, shard_map batch-mapping (throughput mode)
    data/      TUM RGB-D loader, PNG codec, synthetic dataset generator
    tracking/  host-side state machine + map state pytree
    eval/      trajectory export (TUM format), ATE/RPE metrics
    utils/     config (reference-compatible flags), logging, compile cache
    cli/       command-line runners
"""

__version__ = "0.1.0"

import jax as _jax

# Geometry (DLT/RANSAC/BA normal equations) is float32 and precision-critical.
# On the GPU the default precision runs float32 matrix products in TF32 (10
# mantissa bits, ~1e-3 relative error), which visibly corrupts triangulation
# and normal-equation solves. Force full float32 products framework-wide;
# kernels that want narrow arithmetic (the Hamming and BRIEF GEMMs, the
# bf16 detection passes) choose their input dtypes explicitly.
_jax.config.update("jax_default_matmul_precision", "highest")
