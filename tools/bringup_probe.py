"""Device-side probes behind two bring-up decisions (see PERF.md):

1. ``detect`` — how much of the offline pipeline's device time per frame
   goes to the dense detection + blur passes of ORB extraction
   (``_detect_score`` and ``_sep_conv``, named scopes ``orb_detect`` and
   ``orb_blur`` in models/orb_jax.py). The offline pipeline at bench shape
   (240 frames, extract chunk 8) runs under ``jax.profiler``; each device
   kernel event is mapped through its ``hlo_op`` to the op_name metadata of
   the optimized HLO and summed per scope (with XLA's command buffers off,
   which would hide the kernels inside CUDA graphs). The same passes are
   also timed alone, vmapped over a chunk of 8 atlases.
2. ``gemm`` — what the int8 x int8 GEMMs with a bf16 result (Hamming bit
   planes, BRIEF difference banks) lower to, whether they are exact, and
   how they time against the same GEMMs with an int32 result.

    python tools/bringup_probe.py [detect|gemm|all] [--out probe_out]

Needs a GPU; prints one summary line per probe and writes the details
(optimized-HLO excerpts, top kernels) to ``<out>/bringup_probe.txt``.
"""

from __future__ import annotations

import argparse
import collections
import glob
import os
import re
import statistics
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

SCOPES = ("orb_detect", "orb_blur")


def _median_time(fn, make_args, runs=20):
    """Median seconds of ``fn(*make_args(i))`` with inputs varied per run
    and completion awaited inside the timed region."""
    import jax

    jax.block_until_ready(fn(*make_args(0)))
    ts = []
    for i in range(1, runs + 1):
        args = make_args(i)
        jax.block_until_ready(args)
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts)


# ------------------------------------------------------------- HLO mapping
_COMP = re.compile(r"^(?:ENTRY )?%?([\w.\-]+) .*\{$")
_INSTR = re.compile(r"^\s*(?:ROOT )?%?([\w.\-]+) = ")
_OPNAME = re.compile(r'op_name="([^"]*)"')
_CALLS = re.compile(r"calls=%?([\w.\-]+)")


def hlo_op_names(hlo_text: str) -> dict[str, list[str]]:
    """instruction name -> op_name metadata of it and, for a fusion or
    call, of every instruction in the computation it calls."""
    comp_ops: dict[str, list[str]] = collections.defaultdict(list)
    own: dict[str, list[str]] = {}
    calls: dict[str, str] = {}
    comp = None
    for line in hlo_text.splitlines():
        m = _COMP.match(line)
        if m and "=" not in line.split("{")[0]:
            comp = m.group(1)
            continue
        m = _INSTR.match(line)
        if not m:
            continue
        name = m.group(1)
        ops = _OPNAME.findall(line)
        own[name] = ops
        if comp is not None:
            comp_ops[comp].extend(ops)
        c = _CALLS.search(line)
        if c:
            calls[name] = c.group(1)
    out = {}
    for name, ops in own.items():
        inner = comp_ops.get(calls.get(name, ""), [])
        out[name] = ops + inner
    return out


def _scope(op_name: str) -> str:
    return next((s for s in SCOPES
                 if f"/{s}/" in op_name or op_name.endswith(f"/{s}")),
                "other")


def classify(op_names: list[str]) -> str:
    """Scope of a kernel: its own instruction's scope when that has one
    (op_names[0], see hlo_op_names), else the scope most of the
    instructions it fuses belong to."""
    if not op_names:
        return "other"
    if _scope(op_names[0]) != "other":
        return _scope(op_names[0])
    return collections.Counter(map(_scope, op_names)).most_common(1)[0][0]


def device_kernel_events(trace_dir: str):
    """(hlo_op, start_ns, duration_ns) of every kernel on the first GPU's
    stream lines of the newest trace under ``trace_dir``."""
    import jax

    path = sorted(glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                            recursive=True))[-1]
    pd = jax.profiler.ProfileData.from_file(path)
    events, lines_seen = [], set()
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU:0"):
            continue
        for line in plane.lines:
            lines_seen.add(line.name)
            if not line.name.startswith("Stream"):
                continue
            for ev in line.events:
                stats = dict(ev.stats)
                events.append((str(stats.get("hlo_op", ev.name)),
                               ev.start_ns, ev.duration_ns))
    return events, sorted(lines_seen)


def busy_ns(events) -> float:
    """Union of the event intervals (device busy time)."""
    total, end = 0.0, -1.0
    for _, s, d in sorted(events, key=lambda e: e[1]):
        if s + d <= end:
            continue
        total += s + d - max(s, end)
        end = s + d
    return total


# ------------------------------------------------------------------ probes
def probe_detect(report, runs: int = 3, n_frames: int = 240) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from visionx_slam_tpu.data import synthetic, tum
    from visionx_slam_tpu.models import orb_jax as OJ
    from visionx_slam_tpu.ops.camera import make_camera
    from visionx_slam_tpu.tracking.offline_pipeline import build_offline_pipeline
    from visionx_slam_tpu.utils.config import TrackingOptions

    with tempfile.TemporaryDirectory(prefix="vxs_probe_") as root:
        synthetic.generate_sequence(root, n_frames=n_frames, seed=5)
        ds = tum.TumDataset(root, "rgbd_dataset_freiburg3_synthetic")
        ds.load()
        grays = np.stack([tum.load_rgb_gray(e.rgb_path) for e in ds.entries])
        depths = np.stack([tum.load_depth_m(e.depth_path)
                           for e in ds.entries])
    cam = make_camera(synthetic.FX, synthetic.FY, synthetic.CX, synthetic.CY)
    run = build_offline_pipeline(None, TrackingOptions())
    gd, dd = jax.device_put(grays), jax.device_put(depths)
    t0 = time.perf_counter()
    compiled = jax.jit(run).lower(cam, gd, dd).compile()
    compile_s = time.perf_counter() - t0
    names = hlo_op_names(compiled.as_text())

    def go(i):
        g = gd.at[0, 0, 0].set(jnp.uint8(i + 1))
        return float(jnp.sum(compiled(cam, g, dd)[1].n_inliers))

    go(0)
    t0 = time.perf_counter()
    for i in range(runs):
        go(i + 1)
    wall_per_frame = (time.perf_counter() - t0) / (runs * n_frames)
    with tempfile.TemporaryDirectory(prefix="vxs_trace_") as trace_dir:
        with jax.profiler.trace(trace_dir):
            for i in range(runs):
                go(100 + i)
        events, lines = device_kernel_events(trace_dir)
    per_scope = collections.Counter()
    per_op = collections.Counter()
    for op, _, d in events:
        per_scope[classify(names.get(op, []))] += d
        per_op[op] += d
    frames = runs * n_frames
    busy = busy_ns(events) / frames
    det = per_scope["orb_detect"] / frames
    blur = per_scope["orb_blur"] / frames
    kern = sum(per_scope.values()) / frames

    # the same passes alone: one vmapped chunk of 8 atlases
    _, rows, mask = OJ._atlas_layout(480, 640, 8, 1.2, 31)
    allowed = jnp.asarray(mask)
    k = OJ._gaussian_kernel1d()
    passes = jax.jit(jax.vmap(lambda a: (
        OJ._detect_score(a, allowed, 20.0), OJ._sep_conv(a, k))))
    rng = np.random.default_rng(0)
    base = jnp.asarray(rng.integers(0, 256, (8, rows, 640)), jnp.bfloat16)
    alone = _median_time(passes, lambda i: (base + jnp.bfloat16(i % 7),)) / 8

    share = (det + blur) / busy
    report(f"detect: device busy {busy / 1e3:.2f} us/frame (kernel sum "
           f"{kern / 1e3:.2f}), wall {wall_per_frame * 1e6:.2f} us/frame; "
           f"orb_detect {det / 1e3:.2f} + orb_blur {blur / 1e3:.2f} "
           f"us/frame = {100 * share:.2f}% of device busy time; the same "
           f"passes alone (8-atlas chunk, [{rows},640] bf16): "
           f"{alone * 1e6:.2f} us/frame; pipeline compile {compile_s:.1f} s",
           detail=[f"device lines: {lines}",
                   f"kernel events: {len(events)} over {frames} frames"]
           + [f"  {d / frames / 1e3:9.2f} us/frame  "
              f"{classify(names.get(op, [])):10s} {op}  "
              f"{(names.get(op) or ['?'])[0][:110]}"
              for op, d in per_op.most_common(40)])


def probe_gemm(report) -> None:
    """Each GEMM in three forms — int8 operands with an int32 result (the
    code's form), int8 with a bf16 result (the earlier form) and bf16
    operands with an f32 result: does it compile and run, is it exact,
    its median time, and what the optimized HLO made of it."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from visionx_slam_tpu.models.orb_jax import PATCH_S, _brief_bank

    rng = np.random.default_rng(1)
    forms = {"s8xs8->s32": (jnp.int8, jnp.int32),
             "s8xs8->bf16": (jnp.int8, jnp.bfloat16),
             "bf16xbf16->f32": (jnp.bfloat16, jnp.float32)}

    def gemm_lines(compiled):
        return [ln.strip()[:220] for ln in compiled.as_text().splitlines()
                if re.search(r"custom-call|cublas|gemm|triton|dot\(", ln)
                and " = " in ln][:4]

    def one(name, lhs, rhs, dims, ref):
        detail = [f"{name}:"]
        line = []
        for form, (op_t, out_t) in forms.items():
            f = jax.jit(lambda x, y, op_t=op_t, out_t=out_t:
                        jax.lax.dot_general(x.astype(op_t), y.astype(op_t),
                                            dims, preferred_element_type=out_t))
            try:
                out = np.asarray(f(lhs, rhs)).astype(np.float64)
            except jax.errors.JaxRuntimeError as e:
                line.append(f"{form} fails ({str(e).splitlines()[0][:80]})")
                detail.append(f"  {form}: {e}".splitlines()[0])
                continue
            exact = bool(np.array_equal(out, ref))
            dl = jax.device_put(lhs)
            t = _median_time(f, lambda i: (dl.at[0, 0].set(i % 100), rhs))
            line.append(f"{form} exact {exact} {t * 1e6:.2f} us")
            detail += [f"  {form}:"] + [
                f"    {x}" for x in gemm_lines(f.lower(lhs, rhs).compile())]
        return f"{name}: " + ", ".join(line), detail

    # Hamming inner product: [1024, 256] x [1024, 256]^T 0/1 bit planes
    a = rng.integers(0, 2, (1024, 256), dtype=np.int8)
    b = rng.integers(0, 2, (1024, 256), dtype=np.int8)
    ham = one("hamming 1024x1024", a, jnp.asarray(b),
              (((1,), (1,)), ((), ())), a.astype(np.int64) @ b.T)
    # BRIEF: [1024, 961] centred patches x [961, 32*256] +-1 banks
    bank = _brief_bank().astype(np.int8)
    patches = rng.integers(-128, 128, (1024, PATCH_S * PATCH_S),
                           dtype=np.int8)
    brief = one("BRIEF [1024,961]x[961,8192]", patches, jnp.asarray(bank),
                (((1,), (0,)), ((), ())),
                patches.astype(np.int64) @ bank.astype(np.int64))
    report("gemm: " + "; ".join([ham[0], brief[0]]),
           detail=ham[1] + brief[1])


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("probe", nargs="?", default="all",
                   choices=["detect", "gemm", "all"])
    p.add_argument("--out", default="probe_out")
    args = p.parse_args(argv)
    if args.probe in ("detect", "all"):
        # kernels inside a CUDA graph (XLA's command buffers) reach the
        # trace as one "command_buffer" event with no per-kernel hlo_op,
        # so per-scope attribution needs them off in this process
        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                                   + " --xla_gpu_enable_command_buffer=")

    import jax

    if jax.devices()[0].platform != "gpu":
        print("bringup_probe: needs a GPU", file=sys.stderr)
        return 2
    from visionx_slam_tpu.utils.cache import enable_compile_cache
    from visionx_slam_tpu.utils.device import gpu_name_and_power_limit

    enable_compile_cache()
    card = gpu_name_and_power_limit()
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "bringup_probe.txt"), "a") as f:
        def report(line, detail=()):
            print(f"[{card}] {line}", flush=True)
            f.write(f"[{card}] {line}\n" + "".join(f"{d}\n" for d in detail))

        if args.probe in ("gemm", "all"):
            probe_gemm(report)
        if args.probe in ("detect", "all"):
            probe_detect(report)
    return 0


if __name__ == "__main__":
    sys.exit(main())
