"""Command-line renderer — the reference's CLI surface, headless.

Mirrors cmdline_parser.h's flags and defaults (cmdline_parser.h:5-18,
flag handling cmdline_parser.cpp:78-124): -width -height -samples -tilesize
-threads -depth -scene -mode -maxlum (-delay accepted and ignored — it only
gated window capture). Since there is no window, output goes to a PNG/PPM
file (tone-mapped with the reference's Drago operator by default,
main.cpp:416-444) and the metrics that lived in the window title — elapsed,
percent, ETA, final Mrays/s and us/ray (main.cpp:393-412) — print to stdout.

Extra flags beyond the reference (all optional): -out, -tonemap, -renderer
(wavefront = one fused device program; progressive = per-sample passes with
live progress + checkpointing), -checkpoint/-resume, -devices.

Usage: python -m miniraytracer_tpu [flags]
"""

from __future__ import annotations

import argparse
import sys
import time


def build_parser():
    p = argparse.ArgumentParser(
        prog="miniraytracer_tpu",
        description="GPU path tracer in JAX (MiniRayTracer capability set)",
    )
    # reference flags + defaults (cmdline_parser.h:5-18); argparse accepts
    # both -width and --width for single-dash long names
    p.add_argument("-width", type=int, default=500, help="image width [16,8192]")
    p.add_argument("-height", type=int, default=500, help="image height [16,8192]")
    p.add_argument("-samples", type=int, default=128,
                   help="samples per pixel [1,1000000] (rounded down to a square)")
    p.add_argument("-tilesize", type=int, default=32,
                   help="tile size [1,512] — granularity of the inverted-"
                        "Hilbert preview sweep in progressive -preview mode")
    p.add_argument("-threads", type=int, default=0, help="accepted for parity; the device count sets the parallelism")
    p.add_argument("-depth", type=int, default=32, help="max bounces")
    p.add_argument("-scene", type=int, default=8, help="scene index 0-8 (scene.h:6-17)")
    p.add_argument("-mode", type=int, default=1, help="0 = one-pass (wavefront), 1 = progressive passes")
    p.add_argument("-maxlum", type=float, default=1000.0, help="luminance clamp")
    p.add_argument("-delay", action="store_true", help="accepted for parity (no window to capture)")
    p.add_argument("-live", action="store_true",
                   help="ANSI truecolor in-terminal live view, refreshed "
                        "per progressive pass (the reference window's "
                        "headless stand-in)")
    # headless output / runtime extensions
    p.add_argument("-out", type=str, default="render.png", help="output image path (.png or .ppm)")
    p.add_argument("-tonemap", type=str, default="drago", choices=["drago", "reinhard", "gamma", "linear"])
    p.add_argument("-renderer", type=str, default=None,
                   choices=["wavefront", "progressive", "workqueue", "auto"],
                   help="override -mode's renderer choice (workqueue = "
                        "throughput mode with a global sample queue; "
                        "auto = per-scene choice, the fused kernel where "
                        "the scene fits it)")
    p.add_argument("-preview", type=str, default=None,
                   help="progressive mode: write a tone-mapped preview PNG "
                        "here at every checkpoint interval (the headless "
                        "stand-in for the reference's live window)")
    p.add_argument("-checkpoint", type=str, default=None, help="write progressive checkpoints here")
    p.add_argument("-checkpoint-every", type=int, default=16, help="passes between checkpoints")
    p.add_argument("-resume", type=str, default=None, help="resume from a checkpoint file")
    p.add_argument("-devices", type=int, default=0, help="limit device count (0 = all)")
    p.add_argument("-fast-perlin", action="store_true",
                   help="table-free hash-gradient Perlin (statistically "
                        "equivalent but non-parity noise field)")
    p.add_argument("-seed-check", action="store_true", help=argparse.SUPPRESS)
    return p


def _validate(args):
    # min/max validation like cmdline_parser.cpp:78-107
    def clamp(name, v, lo, hi):
        if v < lo or v > hi:
            print(f"warning: {name}={v} out of [{lo},{hi}], clamping")
        return max(lo, min(hi, v))

    args.width = clamp("width", args.width, 16, 8192)
    args.height = clamp("height", args.height, 16, 8192)
    args.samples = clamp("samples", args.samples, 1, 1_000_000)
    args.tilesize = clamp("tilesize", args.tilesize, 1, 512)
    args.depth = clamp("depth", args.depth, 1, 1024)
    args.scene = clamp("scene", args.scene, 0, 8)
    return args


def main(argv=None):
    args = _validate(build_parser().parse_args(argv))

    import jax
    import jax.numpy as jnp
    import numpy as np

    from miniraytracer_tpu.models import integrator as integ
    from miniraytracer_tpu.models import scenes as S
    from miniraytracer_tpu.parallel import make_mesh, auto_mesh_shape
    from miniraytracer_tpu.parallel.render import (
        render_distributed, render_wavefront_distributed,
    )
    from miniraytracer_tpu.utils import tonemap as tm
    from miniraytracer_tpu.utils.checkpoint import save_checkpoint, load_checkpoint
    from miniraytracer_tpu.utils.compile_cache import enable_compile_cache
    from miniraytracer_tpu.utils.image import save_png, save_ppm

    enable_compile_cache()
    devices = jax.devices()
    if args.devices > 0:
        devices = devices[: args.devices]
    n_dp, n_sp = auto_mesh_shape(len(devices))
    mesh = make_mesh(n_dp, n_sp, devices)

    t0 = time.perf_counter()
    scene = S.select_scene(args.scene, args.width / args.height)
    if args.fast_perlin:
        import dataclasses

        scene = dataclasses.replace(scene, fast_perlin=True)
    print(f"scene '{scene.name}' built in {time.perf_counter()-t0:.2f} s "
          f"({scene.n_spheres} spheres, {scene.n_rects} rects, "
          f"{scene.n_tris} tris, {scene.n_volumes} volumes); "
          f"{len(devices)} device(s) mesh {n_dp}x{n_sp}")

    renderer = args.renderer or ("progressive" if args.mode == 1 else "wavefront")

    if renderer == "workqueue":
        from miniraytracer_tpu.models.integrator import render_workqueue

        frame, stats = render_workqueue(
            scene, args.width, args.height, args.samples,
            max_bounces=args.depth, max_lum=args.maxlum,
        )
        frame = np.asarray(frame)
    elif renderer == "auto":
        print(f"auto renderer: {integ.pick_renderer(scene)}")
        frame, stats = integ.render_auto(
            scene, args.width, args.height, args.samples,
            max_bounces=args.depth, max_lum=args.maxlum,
        )
        frame = np.asarray(frame)
    elif renderer == "wavefront":
        frame, stats = render_wavefront_distributed(
            scene, args.width, args.height, args.samples, mesh,
            max_bounces=args.depth, max_lum=args.maxlum,
        )
    else:
        start_pass = 0
        init_frame = None
        if args.resume:
            ck_frame, start_pass, cfg = load_checkpoint(args.resume)
            if (cfg["width"], cfg["height"], cfg["scene"]) != (args.width, args.height, args.scene):
                sys.exit("checkpoint config mismatch: " + str(cfg))
            init_frame = ck_frame.reshape(-1, 3)
            print(f"resumed at pass {start_pass}")

        offs, ns = integ.sample_offsets(args.samples)
        frame_flat = (jnp.asarray(init_frame) if init_frame is not None
                      else jnp.zeros((args.width * args.height, 3), jnp.float32))
        ray_counts = []  # device scalars; summed once at the end
        t_start = time.perf_counter()
        ml = jnp.float32(args.maxlum)

        # -preview: sweep each pass in inverted-Hilbert tile-order batches
        # (work_queue.cpp:84-127) so the preview refines uniformly like the
        # reference's live window; refreshed at most ~2 Hz (main.cpp:387-488
        # refreshes on a timer, not per tile)
        batches = None
        last_preview = [0.0]
        if args.preview or args.live:
            from miniraytracer_tpu.utils.runtime import tile_pixel_batches

            batches = [jnp.asarray(b, jnp.uint32) for b in
                       tile_pixel_batches(args.width, args.height, args.tilesize)]

        # -live: in-terminal window stand-in (Drago per refresh, like the
        # reference's UI thread)
        live = None
        if args.live:
            from miniraytracer_tpu.utils.terminal import LiveView

            live = LiveView()

        def write_preview(force=False, status=""):
            now = time.perf_counter()
            if not force and now - last_preview[0] < 0.5:
                return
            last_preview[0] = now
            pv = np.asarray(frame_flat).reshape(args.height, args.width, 3)
            img = np.asarray(tm.drago(jnp.asarray(pv)))
            if args.preview:
                save_png(args.preview, img)
            if live is not None:
                live.update(img[::-1], status=status)

        for i in range(start_pass, ns):
            if batches is not None:
                for pix in batches:
                    rows, rays = integ.render_tile_pass(
                        scene, frame_flat[pix], pix, jnp.int32(i), offs[i], ml,
                        width=args.width, height=args.height,
                        max_bounces=args.depth, loop="while",
                    )
                    frame_flat = frame_flat.at[pix].set(rows)
                    ray_counts.append(rays)
                    write_preview(status=f"pass {i+1}/{ns}")
            else:
                frame_flat, rays = integ.render_pass(
                    scene, frame_flat, jnp.int32(i), offs[i], ml,
                    width=args.width, height=args.height,
                    max_bounces=args.depth, loop="while",
                )
                ray_counts.append(rays)
            if (i + 1) % max(args.checkpoint_every, 1) == 0 or i == ns - 1:
                frame_flat.block_until_ready()
                elapsed = time.perf_counter() - t_start
                done = i + 1 - start_pass
                pct = 100.0 * (i + 1) / ns
                eta = elapsed / max(done, 1) * (ns - i - 1)
                rays_so_far = float(sum(float(r) for r in ray_counts))
                mrays = rays_so_far / elapsed / 1e6 if elapsed > 0 else 0.0
                print(f"pass {i+1}/{ns}  {pct:5.1f}%  elapsed {elapsed:6.1f}s  "
                      f"eta {eta:6.1f}s  {mrays:.2f} Mrays/s")
                if args.checkpoint:
                    written = save_checkpoint(
                        args.checkpoint, np.asarray(frame_flat), i + 1,
                        {"width": args.width, "height": args.height,
                         "scene": args.scene, "samples": ns, "depth": args.depth},
                    )
                    print(f"checkpoint -> {written}")
                if args.preview or args.live:
                    write_preview(force=True,
                                  status=f"pass {i+1}/{ns}  {pct:5.1f}%  "
                                         f"{mrays:.2f} Mrays/s")
        frame = np.asarray(frame_flat).reshape(args.height, args.width, 3)
        rays_total = float(sum(float(r) for r in ray_counts))
        elapsed = time.perf_counter() - t_start
        stats = {"seconds": elapsed, "spp": ns, "rays": rays_total,
                 "mrays_per_s": rays_total / elapsed / 1e6 if elapsed > 0 else 0.0}

    if stats.get("rays"):
        us_per_ray = stats["seconds"] / stats["rays"] * 1e6
        print(f"done in {stats['seconds']:.2f} s  {stats['mrays_per_s']:.2f} Mrays/s  "
              f"{us_per_ray:.3f} us/ray  ({stats['spp']} spp)")
    else:
        print(f"done in {stats['seconds']:.2f} s  ({stats['spp']} spp)")

    # tone map for display (linear buffer is ground truth, main.cpp:57-58)
    if args.tonemap == "linear":
        out = np.clip(np.asarray(frame), 0.0, 1.0)
    else:
        out = np.asarray(tm.OPERATORS[args.tonemap](jnp.asarray(frame)))
    if args.out.endswith(".ppm"):
        save_ppm(args.out, out)
    else:
        save_png(args.out, out)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
