"""FLOP / byte accounting and roofline shares for the SLAM pipelines.

Method: XLA's own cost analysis (``jit(f).lower(args).compile()
.cost_analysis()``) per STAGE function. Two XLA caveats shape the design:

- loop bodies (``lax.scan`` / ``lax.map`` / ``while``) are counted ONCE,
  not per trip — so whole-pipeline lowering undercounts by the trip
  count. Stages are therefore lowered STANDALONE and multiplied by their
  per-run execution counts (frames, keyframe events, BA iterations).
- ``lax.cond`` counts BOTH branches — another reason to count stage
  functions individually instead of the scan step (whose event branch
  would be attributed to every frame).

The per-stage counts feed ``detail.mfu`` / ``detail.roofline`` in
bench.py's JSON. XLA's "flops" metric is dtype-agnostic (2 x MACs for a
matmul regardless of precision), so utilization is reported against the
bf16 dense peak.

Peaks: one row per ``device_kind``, from NVIDIA's H100 data sheet (SXM
part, dense rates without sparsity, at the full 700 W power limit). A
device that is not in the table is an error, not a default.
"""

from __future__ import annotations

from dataclasses import dataclass

# published peaks by exact jax ``device_kind``
DEVICE_PEAKS = {
    # NVIDIA H100 Tensor Core GPU data sheet, H100 SXM column
    "NVIDIA H100 80GB HBM3": dict(
        flops_bf16=989e12, flops_int8=1979e12, hbm_Bps=3.35e12),
}


def device_peaks(device=None) -> dict:
    """Peaks of ``device`` (default: the first JAX device); raises
    ``KeyError`` for a device kind the table does not list."""
    import jax

    kind = (device or jax.devices()[0]).device_kind
    if kind not in DEVICE_PEAKS:
        raise KeyError(
            f"no published peaks for device_kind {kind!r} "
            f"(known: {sorted(DEVICE_PEAKS)})")
    return dict(DEVICE_PEAKS[kind], device_kind=kind)


def xla_cost(fn, *args, **kwargs) -> dict:
    """{'flops', 'bytes'} of one jitted call via XLA cost analysis.

    Costs are for ONE execution of the lowered program (loop bodies once —
    callers multiply by their own trip counts; see module docstring)."""
    import jax

    lowered = jax.jit(fn).lower(*args, **kwargs)
    ca = lowered.compile().cost_analysis()
    d = ca[0] if isinstance(ca, (list, tuple)) else (ca or {})
    return {
        "flops": float(d.get("flops", 0.0)),
        "bytes": float(d.get("bytes accessed", 0.0)),
    }


@dataclass
class StageCost:
    name: str
    flops_per_exec: float
    bytes_per_exec: float
    execs_per_frame: float   # amortized execution count per frame

    @property
    def flops_per_frame(self) -> float:
        return self.flops_per_exec * self.execs_per_frame

    @property
    def bytes_per_frame(self) -> float:
        return self.bytes_per_exec * self.execs_per_frame


def scan_stage_costs(
    cam,
    opts,
    img_hw: tuple[int, int],
    *,
    n_features: int = 1024,
    kf_capacity: int = 64,
    lm_capacity: int = 1 << 17,
    orb_kwargs: dict | None = None,
    events_per_frame: float = 1.0 / 3.0,
    ba_iters_avg: float = 3.0,
) -> list[StageCost]:
    """Per-stage XLA cost inventory of the ONLINE scan (BASELINE config 1).

    ``events_per_frame``: measured keyframe-event rate of the run
    (sum(is_keyframe)/T); ``ba_iters_avg``: average local-BA GN
    iterations actually applied (the early-exit while body is counted
    once by XLA, so it multiplies here).
    """
    import jax
    import jax.numpy as jnp

    from ..models import matching
    from ..models.estimation import pnp_prior
    from ..models.local_ba import BAOptions, local_ba
    from ..models.orb_jax import orb_extract
    from ..ops.se3 import identity_pose
    from ..tracking import mapstate as msl
    from ..tracking import stages
    from ..tracking.scan_pipeline import initial_state

    H, W = img_hw
    N = n_features
    orb_kw = dict(orb_kwargs or {})
    orb_kw.setdefault("n_slots", N)

    key = jax.random.PRNGKey(0)
    g8 = jnp.zeros((8, H, W), jnp.uint8)
    desc = jnp.zeros((N, 32), jnp.uint8)
    vmask = jnp.ones((N,), bool)
    px = jnp.zeros((N, 2), jnp.float32)
    pts3 = jnp.zeros((N, 3), jnp.float32)

    # a populated-shape MapState for the event stages (contents are zeros;
    # cost analysis is shape-driven)
    st = initial_state(N, kf_capacity, lm_capacity)
    ms = st.ms

    costs: list[StageCost] = []

    def add(name, fn, args, execs):
        c = xla_cost(fn, *args)
        costs.append(StageCost(name, c["flops"], c["bytes"], execs))

    # 1 extraction (chunk of 8 frames, exactly the extract_sequence body)
    add(
        "extract",
        lambda g: jax.vmap(lambda im: orb_extract(im, **orb_kw))(g),
        (g8,),
        1.0 / 8.0,
    )
    # 2 matcher: one knn2 GEMM per frame (the event re-uses the raw match)
    add(
        "match",
        lambda a, b: matching.knn2_ratio_match(a, vmask, b, vmask),
        (desc, desc),
        1.0,
    )
    # 3 PnP (steady-state prior tier)
    add(
        "pnp_prior",
        lambda p3, p2: pnp_prior(cam, p3, p2, vmask, identity_pose(),
                                 opts.max_reproj_error, refine_iters=2),
        (pts3, px),
        1.0,
    )
    # 4 keyframe event: insert + depth landmarks + triangulation
    def event_fn(ms, pxq, d, dsc):
        obs_links = jnp.full((N,), -1, jnp.int32)
        ms2, slot = msl.insert_keyframe(
            ms, jnp.int32(3), identity_pose(), pxq, dsc, vmask, obs_links,
            d, fresh_links=True)
        ms2 = stages.depth_landmarks(ms2, cam, slot, identity_pose())
        ms2 = stages.triangulate_pair(
            ms2, cam, jnp.int32(0), slot,
            opts.triangulation_min_angle_deg,
            opts.triangulation_max_reproj_error)
        return ms2
    add(
        "kf_event(insert+depth_lm+tri)",
        event_fn,
        (ms, px, jnp.ones((N,), jnp.float32), desc),
        events_per_frame,
    )
    # 5 local BA — one GN iteration (while body), x measured avg iterations
    ba_opts = BAOptions(
        window_size=opts.ba_window_size, max_iterations=1,
        min_pose_observations=opts.ba_min_pose_observations,
        min_point_observations=opts.ba_min_point_observations,
        huber_delta=opts.ba_huber_delta,
        max_reproj_error=opts.ba_max_reproj_error,
        rel_tol=opts.ba_rel_tol, early_exit=False,
    )
    if opts.enable_local_ba:
        add(
            "local_ba(per GN iter)",
            lambda m: local_ba(m, cam, ba_opts)[0],
            (ms,),
            events_per_frame * ba_iters_avg,
        )
    return costs


def offline_stage_costs(
    cam,
    opts,
    img_hw: tuple[int, int],
    *,
    n_features: int = 1024,
    kf_capacity: int = 128,
    orb_kwargs: dict | None = None,
    keyframes_per_frame: float = 1.0 / 3.0,
    gba_calls_per_frame: float = 1.0 / 240.0,
) -> list[StageCost]:
    """Stage cost inventory of the OFFLINE pipeline (the bench headline).

    LOWER BOUND: the global-BA solver's GN/CG loops are XLA while-loops
    (counted once — see module docstring) and the map-build scatter work
    is omitted; the listed stages carry most of the pipeline's FLOPs
    (extraction's BRIEF GEMM dominates)."""
    import jax
    import jax.numpy as jnp

    from ..models import matching
    from ..models.estimation import pnp_ransac
    from ..models.orb_jax import orb_extract
    from ..ops.se3 import identity_pose

    H, W = img_hw
    N = n_features
    orb_kw = dict(orb_kwargs or {})
    orb_kw.setdefault("n_slots", N)
    g8 = jnp.zeros((8, H, W), jnp.uint8)
    desc = jnp.zeros((N, 32), jnp.uint8)
    vmask = jnp.ones((N,), bool)
    px = jnp.zeros((N, 2), jnp.float32)
    pts3 = jnp.zeros((N, 3), jnp.float32)
    key = jax.random.PRNGKey(0)

    costs: list[StageCost] = []

    def add(name, fn, args, execs):
        c = xla_cost(fn, *args)
        costs.append(StageCost(name, c["flops"], c["bytes"], execs))

    add("extract",
        lambda g: jax.vmap(lambda im: orb_extract(im, **orb_kw))(g),
        (g8,), 1.0 / 8.0)
    # matcher GEMMs: consecutive-pair + keyframe-chain (amortized) +
    # re-track = ~2.3 matches/frame
    add("match",
        lambda a, b: matching.match_frames(a, vmask, b, vmask),
        (desc, desc), 2.0 + keyframes_per_frame)
    # pair-stage PnP (16 hyp, refine 2) + re-track PnP (8 hyp, refine 3)
    add("pnp_pair",
        lambda p3, p2: pnp_ransac(cam, p3, p2, vmask, key,
                                  opts.max_reproj_error,
                                  n_hypotheses=16, refine_iters=2,
                                  init_pose=identity_pose()),
        (pts3, px), 1.0)
    add("pnp_retrack",
        lambda p3, p2: pnp_ransac(cam, p3, p2, vmask, key,
                                  opts.max_reproj_error,
                                  n_hypotheses=8, refine_iters=3,
                                  init_pose=identity_pose()),
        (pts3, px), 1.0)
    return costs


def summarize(costs: list[StageCost], t_per_frame_s: float,
              peaks: dict | None = None) -> dict:
    """Aggregate a stage inventory against a measured per-frame time
    (``peaks`` default: ``device_peaks()``, which raises off the table)."""
    peaks = peaks or device_peaks()
    flops = sum(c.flops_per_frame for c in costs)
    byts = sum(c.bytes_per_frame for c in costs)
    out = {
        "flops_per_frame": flops,
        "bytes_per_frame": byts,
        "achieved_gflops": flops / t_per_frame_s / 1e9,
        "achieved_gbs": byts / t_per_frame_s / 1e9,
        "arithmetic_intensity": flops / max(byts, 1.0),
        "device_kind": peaks.get("device_kind"),
    }
    out["mfu_vs_bf16_peak"] = flops / t_per_frame_s / peaks["flops_bf16"]
    out["bw_util_vs_hbm_peak"] = byts / t_per_frame_s / peaks["hbm_Bps"]
    # roofline: time lower bounds from compute and bandwidth
    t_compute = flops / peaks["flops_bf16"]
    t_bw = byts / peaks["hbm_Bps"]
    out["roofline_bound"] = "compute" if t_compute > t_bw else "bandwidth"
    out["roofline_floor_us_per_frame"] = max(t_compute, t_bw) * 1e6
    return out
