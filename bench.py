#!/usr/bin/env python
"""Headline benchmark on one GPU: Mrays/s forward+backward on the Cornell
box at 500x500.

The north-star metric (BASELINE.json): a full differentiable render step —
forward wavefront trace + reverse-mode sweep producing gradients w.r.t.
material albedo, emission, and sphere/triangle geometry — at the reference's
default Cornell configuration (500x500, 32-bounce cap, cmdline_parser.h:6-15).
The forward-only rate of render_auto is reported beside it.

Baseline: MEASURED, not estimated — we built the reference headless as a
test oracle (REFERENCE_PARITY.md) and ran it on a CPU: scene 5 (Cornell),
500x500 x 16 spp x depth 32, 8 threads -> 12.19M rays / 1.52 s = 8.0
Mrays/s, forward only (the reference has no backward pass at all).

Every time is a host-clock interval around work that ends in
block_until_ready, after a warm-up call that compiles; each metric is the
median of --reps intervals, all of which are recorded. The result names
the device (JAX's platform, device_kind and count, nvidia-smi's name and
power limit). Without a GPU the script exits non-zero and prints nothing.

Prints exactly one JSON line.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

BASELINE_MRAYS = 8.0  # measured: reference CPU, Cornell 500x500, 8 threads


def _timed(fn, reps):
    import jax

    jax.block_until_ready(fn())  # compile + warm
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        times.append(time.perf_counter() - t0)
    return times


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--width", type=int, default=500)
    ap.add_argument("--height", type=int, default=500)
    ap.add_argument("--bounces", type=int, default=32)
    ap.add_argument("--fwd-spp", type=int, default=64)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--pack", type=int, default=16,
                    help="samples per lane in the packed AD scan")
    ap.add_argument("--spp-step", type=int, default=8,
                    help="samples per pixel per train step")
    ap.add_argument("--scan-steps", type=int, default=0,
                    help="AD scan trip count (0 = pack*6 + bounces + 1)")
    ap.add_argument("--scene", type=str, default="cornell_box")
    args = ap.parse_args()

    import jax

    if jax.default_backend() != "gpu":
        sys.exit(f"bench: needs a GPU; JAX's backend is "
                 f"{jax.default_backend()!r}")
    from miniraytracer_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    import jax.numpy as jnp

    from miniraytracer_tpu.models import integrator as integ
    from miniraytracer_tpu.models import scenes as S
    from miniraytracer_tpu.parallel import (extract_params, make_mesh,
                                            make_train_step)

    W, H, B = args.width, args.height, args.bounces
    scene = getattr(S, args.scene)(W / H)
    dev = jax.devices()[0]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]

    # ---- forward (render_auto's renderer) ----
    fwd = {}

    def _fwd():
        fwd["frame"], fwd["stats"] = integ.render_auto(
            scene, W, H, args.fwd_spp, max_bounces=B)
        return fwd["frame"]

    fwd_secs = _timed(_fwd, args.reps)
    fwd_rays = fwd["stats"]["rays"]

    # ---- forward + backward train step (headline) ----
    mesh = make_mesh(1, 1)
    step = make_train_step(mesh, width=W, height=H, max_bounces=B,
                           pack=args.pack, scan_steps=args.scan_steps,
                           spp_step=args.spp_step)
    offs, _ = integ.sample_offsets(args.fwd_spp)
    target = jnp.asarray(fwd["frame"]).reshape(-1, 3)
    params = extract_params(scene)
    lr = jnp.float32(0.0)
    out = {}

    def _step():
        _, out["loss"], _ = step(params, scene, target, jnp.int32(0), offs, lr)
        return out["loss"]

    step_secs = _timed(_step, args.reps)
    # rays one step traces: the packed scan's exact item list, with the
    # items the claim-gated scan leaves unstarted discounted
    n_items = W * H * args.spp_step
    pad = (-n_items) % args.pack
    pix = jnp.tile(jnp.arange(W * H, dtype=jnp.uint32), args.spp_step)
    samp = jnp.repeat(jnp.arange(args.spp_step, dtype=jnp.int32), W * H)
    if pad:
        pix = jnp.concatenate([pix, jnp.full((pad,), W * H - 1, jnp.uint32)])
        samp = jnp.concatenate([samp, samp[-1:].repeat(pad)])
    off = offs[samp % offs.shape[0]]
    _, done, step_rays = jax.jit(
        lambda p, s, o: integ.sample_radiance_packed(
            scene, p, s, o, width=W, height=H, max_bounces=B,
            pack=args.pack, scan_steps=args.scan_steps))(pix, samp, off)
    step_rays = float(step_rays)

    fwd_s = statistics.median(fwd_secs)
    step_s = statistics.median(step_secs)
    fwdbwd = step_rays / step_s / 1e6
    print(json.dumps({
        "metric": "cornell_500x500_mrays_per_s_fwdbwd",
        "value": fwdbwd,
        "unit": "Mrays/s",
        "vs_baseline": fwdbwd / BASELINE_MRAYS,
        "extra": {
            "fwd_mrays_per_s": fwd_rays / fwd_s / 1e6,
            "fwd_seconds": fwd_secs,
            "fwd_renderer": fwd["stats"].get("renderer"),
            "fwd_rays": fwd_rays,
            "step_seconds": step_secs,
            "step_rays": step_rays,
            "done_frac": float(done.mean()),
            "loss": float(out["loss"]),
            "scene": scene.name,
            "bounces": B,
            "pack": args.pack,
            "spp_step": args.spp_step,
            "scan_steps": args.scan_steps,
            "platform": dev.platform,
            "device_kind": dev.device_kind,
            "devices": len(jax.devices()),
            "nvidia_smi": card,
        },
    }))


if __name__ == "__main__":
    main()
