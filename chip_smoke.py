#!/usr/bin/env python
"""Smoke test of the renderer's main path on a GPU, at the reference's
default size (500x500, 32 bounces, cmdline_parser.h:6-15).

    python chip_smoke.py           # one GPU: every phase below
    python chip_smoke.py --four    # four GPUs: the (dp=2, sp=2) mesh only

Phases, one line each; any failed check raises and the script exits
non-zero:

  device  JAX's GPU, nvidia-smi's name and power limit, whether the native
          runtime library (csrc/libmrt_runtime.so) or its NumPy fallback
          serves BVH/OBJ/tile work.
  fused   Cornell 500x500, 64 spp, 32 bounces through the fused Triton
          kernel and through the XLA wavefront: both finite, channel means
          within 0.5%, mean absolute pixel difference under MAD_BOUND, and
          the warm time of each (median of 3).
  parity  The eight scenes that build from the repository through
          render_auto at the reference archive's setting (100x100, 64 spp,
          depth 16): channel means within 1% of tests/reference_renders.npz.
  book2   book2_final through render_auto at 500x500, 16 spp.
  train   Three fwd+bwd steps of parallel.make_train_step on Cornell 500x500
          (pack 16, spp_step 8, formula scan): loss and gradients finite;
          the step's compiled memory analysis and peak device memory.
  cli     cli.main renders scene 5 at 500x500, 64 spp with -renderer auto
          in this process and the PNG is read back.

With --four, only the mesh phase runs: render_wavefront_distributed and a
train step on a (dp=2, sp=2) mesh of four GPUs, each against the same
configuration on one of them.

Everything runs in this one process, which holds the card(s). The last line
of standard output is one JSON object: {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from functools import partial

W = H = 500
BOUNCES = 32
SPP = 64
# Mean absolute per-pixel difference allowed between the fused kernel and
# the XLA wavefront on the Cornell frame. The two are the same estimator up
# to float reassociation, which flips a small share of branch decisions
# (the paths they seed then decorrelate). A wrong sampler, slot or branch
# would decorrelate every pixel, i.e. reach the difference between two
# frames with independent samples (printed beside it, and required to be
# at least ten times the kernel's difference). 2e-3 is about 7x what
# reassociation produced on an H100.
MAD_BOUND = 2e-3
CHANNEL_TOL = 0.005  # fused vs XLA, and four cards vs one
PARITY_TOL = 0.01  # vs the reference renderer (REFERENCE_PARITY.md)
LOSS_TOL = 0.01  # four-card vs one-card train loss, see four_card_phase


def smi() -> str:
    """nvidia-smi's name and power limit of each card, '; '-joined."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return "; ".join(line.strip() for line in out.splitlines() if line.strip())


def warm_median(fn, n=3):
    """Call fn once to compile, then n timed calls ending in
    block_until_ready. Returns (median seconds, last result)."""
    import jax

    jax.block_until_ready(fn())
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn())
        times.append(time.perf_counter() - t0)
    return statistics.median(times), out


def channel_rel(a, b):
    """Largest relative difference of the per-channel means of two frames."""
    import numpy as np

    ma = np.asarray(a, np.float64).reshape(-1, 3).mean(0)
    mb = np.asarray(b, np.float64).reshape(-1, 3).mean(0)
    return float(np.max(np.abs(ma - mb) / np.maximum(np.abs(mb), 1e-6)))


def count_dots(hlo_text: str) -> int:
    return hlo_text.count("dot_general") + hlo_text.count(" dot(")


def device_phase(card: str):
    import jax

    from miniraytracer_tpu.utils import runtime

    d = jax.devices()[0]
    native = ("csrc/libmrt_runtime.so loaded" if runtime.native_available()
              else "NumPy fallback (libmrt_runtime.so not built)")
    print(f"[device] platform={d.platform} kind={d.device_kind} "
          f"count={len(jax.devices())} | nvidia-smi: {card} | native runtime: "
          f"{native}", flush=True)


def fused_phase(card: str):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from miniraytracer_tpu.models import integrator as integ
    from miniraytracer_tpu.models import scenes as S
    from miniraytracer_tpu.ops import bounce

    scene = S.cornell_box(W / H)
    assert bounce.can_fuse(scene), "cornell_box must take the fused kernel"
    t_f, (f_f, st_f) = warm_median(
        lambda: bounce.render_wavefront_fused(scene, W, H, SPP, BOUNCES))
    t_x, (f_x, st_x) = warm_median(
        lambda: integ.render_wavefront(scene, W, H, SPP, BOUNCES))
    f_f, f_x = np.asarray(f_f), np.asarray(f_x)
    # the same kernel on samples 64..127: a frame with independent samples
    pix = jnp.arange(W * H, dtype=jnp.uint32)
    acc, cnt, _ = jax.jit(partial(
        bounce.render_wavefront_fused_pixels, width=W, height=H,
        max_bounces=BOUNCES, spp_sq=16))(
        scene, pix, jnp.int32(SPP), jnp.int32(SPP), jnp.float32(1000.0))
    f_ind = np.asarray((acc * (1.0 / jnp.maximum(cnt, 1))).arr).reshape(H, W, 3)
    assert np.isfinite(f_f).all() and np.isfinite(f_x).all(), "non-finite frame"
    rel = channel_rel(f_f, f_x)
    mad = float(np.abs(f_f - f_x).mean())
    mad_ind = float(np.abs(f_ind - f_x).mean())
    dots = count_dots(bounce._fused_frame_jit.lower(
        scene, jnp.float32(1000.0), width=W, height=H, ns=SPP, sq=8,
        max_bounces=BOUNCES, interpret=False,
        lanes=bounce.LANES).as_text()) + count_dots(
        integ._render_wavefront_jit.lower(
            scene, jnp.float32(1000.0), width=W, height=H, spp=SPP,
            max_bounces=BOUNCES).as_text())
    print(f"[fused] cornell {W}x{H} {SPP}spp {BOUNCES} bounces on {card}: "
          f"fused kernel {t_f * 1e3:.2f} ms ({st_f['rays'] / t_f / 1e6:.1f} "
          f"Mrays/s), XLA wavefront {t_x * 1e3:.2f} ms "
          f"({st_x['rays'] / t_x / 1e6:.1f} Mrays/s), warm medians of 3 | "
          f"channel rel {rel:.2e} (< {CHANNEL_TOL}) | mean |diff| {mad:.3e} "
          f"(< {MAD_BOUND}; independent-sample frames {mad_ind:.3e}) | "
          f"rays {st_f['rays']:.0f} vs {st_x['rays']:.0f} | dots in lowered "
          f"HLO {dots}", flush=True)
    assert rel < CHANNEL_TOL, rel
    assert mad < MAD_BOUND and mad < 0.1 * mad_ind, (mad, mad_ind)
    assert dots == 0, f"{dots} dot ops in the forward renders"
    return f_f


def parity_phase():
    import numpy as np

    from miniraytracer_tpu.models import integrator as integ
    from miniraytracer_tpu.models import scenes as S

    ref_path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "tests", "reference_renders.npz")
    with np.load(ref_path) as z:
        refs = {k: z[k] for k in z.files}
    parts, worst = [], {}
    for sid, name in enumerate(S.SCENE_NAMES):
        if name == "triangles":
            continue  # its OBJ meshes are not part of the repository
        scene = S.select_scene(sid, 1.0)
        frame, _ = integ.render_auto(scene, 100, 100, 64, max_bounces=16)
        frame = np.asarray(frame)
        assert np.isfinite(frame).all(), name
        if name == "earth" and not S.earthmap_available():
            # the reference frame was rendered with earthmap.jpg; with the
            # procedural fallback texture compare two renderers instead
            other, _ = integ.render_workqueue(scene, 100, 100, 64,
                                              max_bounces=16)
            rel = channel_rel(frame, other)
            parts.append(f"{name}[{integ.pick_renderer(scene)}] {rel:.2e} "
                         f"vs workqueue (procedural earth map)")
        else:
            rel = channel_rel(frame, refs[name])
            parts.append(f"{name}[{integ.pick_renderer(scene)}] {rel:.2e}")
        worst[name] = rel
    print(f"[parity] 100x100 64spp depth 16, channel-mean rel diff (< "
          f"{PARITY_TOL}): " + ", ".join(parts), flush=True)
    bad = {k: v for k, v in worst.items() if not v < PARITY_TOL}
    assert not bad, bad


def book2_phase(card: str):
    import numpy as np

    from miniraytracer_tpu.models import integrator as integ
    from miniraytracer_tpu.models import scenes as S

    scene = S.book2_final(W / H)
    t0 = time.perf_counter()
    frame, st = integ.render_auto(scene, W, H, 16, max_bounces=BOUNCES)
    cold = time.perf_counter() - t0
    frame = np.asarray(frame)
    assert frame.shape == (H, W, 3) and np.isfinite(frame).all()
    assert frame.mean() > 0.05, frame.mean()
    print(f"[book2] {W}x{H} 16spp via {integ.pick_renderer(scene)}: finite, "
          f"mean {frame.mean():.4f}, {st['rays']:.0f} rays, render "
          f"{st['seconds']:.2f} s, {cold:.1f} s with compile, on {card}",
          flush=True)


def train_phase(target_frame, card: str):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from miniraytracer_tpu.models import integrator as integ
    from miniraytracer_tpu.models import scenes as S
    from miniraytracer_tpu.parallel import (extract_params, make_mesh,
                                            make_train_step)

    scene = S.cornell_box(W / H)
    mesh = make_mesh(1, 1)
    step = make_train_step(mesh, width=W, height=H, max_bounces=BOUNCES,
                           pack=16, spp_step=8, scan_steps=0)
    offs, _ = integ.sample_offsets(SPP)
    target = jnp.asarray(np.asarray(target_frame).reshape(-1, 3))
    params = extract_params(scene)
    lr = jnp.float32(1e-3)
    t0 = time.perf_counter()
    params1, loss1, g1 = step(params, scene, target, jnp.int32(0), offs, lr)
    jax.block_until_ready(loss1)
    cold = time.perf_counter() - t0
    # step 2 compiles once more: the fed-back params carry the step's own
    # output shardings; step 3 runs warm
    t0 = time.perf_counter()
    params2, loss2, g2 = step(params1, scene, target, jnp.int32(1), offs, lr)
    jax.block_until_ready(loss2)
    second = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, loss3, g3 = step(params2, scene, target, jnp.int32(2), offs, lr)
    jax.block_until_ready(loss3)
    third = time.perf_counter() - t0
    leaves = jax.tree_util.tree_leaves((g1, g2, g3))
    finite = all(bool(jnp.isfinite(g).all()) for g in leaves)
    losses = [float(loss1), float(loss2), float(loss3)]
    assert np.isfinite(losses).all(), losses
    assert finite, "non-finite gradient"
    lowered = step.lower(params, scene, target, jnp.int32(0), offs, lr)
    dots = count_dots(lowered.as_text())
    mem = lowered.compile().memory_analysis()
    stats = jax.devices()[0].memory_stats() or {}
    peak = stats.get("peak_bytes_in_use")
    print(f"[train] cornell {W}x{H} pack 16 spp_step 8: losses "
          f"{' '.join(f'{v:.6e}' for v in losses)}, all gradients finite | "
          f"step 1 {cold:.1f} s with compile, step 2 {second:.1f} s, step 3 "
          f"{third:.3f} s warm, on {card} | dots in "
          f"lowered HLO {dots} | memory_analysis: {mem} | peak_bytes_in_use "
          f"{peak}", flush=True)
    assert dots == 0, f"{dots} dot ops in the train step"


def cli_phase():
    import numpy as np

    from miniraytracer_tpu import cli
    from miniraytracer_tpu.utils.image import load_png

    with tempfile.TemporaryDirectory() as d:
        out = os.path.join(d, "cornell.png")
        rc = cli.main(["-scene", "5", "-width", str(W), "-height", str(H),
                       "-samples", str(SPP), "-renderer", "auto", "-out", out])
        img = load_png(out)
    assert rc == 0, rc
    assert img.shape == (H, W, 3) and img.max() > 0, img.shape
    print(f"[cli] cli.main -scene 5 {W}x{H} {SPP}spp -renderer auto: PNG "
          f"{img.shape}, mean {img.mean():.1f}/255", flush=True)


def four_card_phase(devices, width=W, height=H, spp=SPP, bounces=BOUNCES,
                    card=""):
    """The (dp=2, sp=2) mesh over four devices against one of them.

    Render: render_wavefront_distributed on both meshes; sp splits the
    samples into two blocks whose sums are combined, so the frames agree up
    to float order — channel means within CHANNEL_TOL.

    Train: on the 2x2 mesh each sp cell renders spp_step 8 samples of its
    dp half; on one device spp_step 16 renders the same 16 samples per
    pixel. The losses differ only where the claim-gated packed scan leaves
    a few items unstarted (which items depends on the lane layout) — within
    LOSS_TOL relative. Returns (render rel, loss rel)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from miniraytracer_tpu.models import integrator as integ
    from miniraytracer_tpu.models import scenes as S
    from miniraytracer_tpu.parallel import (extract_params, make_mesh,
                                            make_train_step)
    from miniraytracer_tpu.parallel.render import render_wavefront_distributed

    assert len(devices) == 4, devices
    scene = S.cornell_box(width / height)
    mesh4 = make_mesh(2, 2, devices)
    mesh1 = make_mesh(1, 1, devices[:1])
    # each render twice: the first compiles, the second is timed warm
    f4, st4 = [render_wavefront_distributed(scene, width, height, spp, mesh4,
                                            max_bounces=bounces)
               for _ in range(2)][-1]
    f1, st1 = [render_wavefront_distributed(scene, width, height, spp, mesh1,
                                            max_bounces=bounces)
               for _ in range(2)][-1]
    assert np.isfinite(f4).all() and np.isfinite(f1).all()
    rel_frame = channel_rel(f4, f1)

    offs, _ = integ.sample_offsets(spp)
    target = jnp.asarray(np.asarray(f1).reshape(-1, 3))
    params = extract_params(scene)
    lr = jnp.float32(1e-3)
    step4 = make_train_step(mesh4, width=width, height=height,
                            max_bounces=bounces, pack=16, spp_step=8)
    step1 = make_train_step(mesh1, width=width, height=height,
                            max_bounces=bounces, pack=16, spp_step=16)
    _, loss4, g4 = step4(params, scene, target, jnp.int32(0), offs, lr)
    _, loss1, g1 = step1(params, scene, target, jnp.int32(0), offs, lr)
    loss4, loss1 = float(loss4), float(loss1)
    rel_loss = abs(loss4 - loss1) / max(abs(loss1), 1e-12)
    finite = all(bool(jnp.isfinite(g).all())
                 for g in jax.tree_util.tree_leaves((g4, g1)))
    print(f"[four] cornell {width}x{height} {spp}spp on a (dp=2, sp=2) mesh "
          f"vs one device ({card}): warm render {st4['seconds'] * 1e3:.2f} ms "
          f"vs {st1['seconds'] * 1e3:.2f} ms ({st4['renderer']}), channel rel "
          f"{rel_frame:.2e} (< {CHANNEL_TOL}) | train loss {loss4:.6e} vs "
          f"{loss1:.6e}, rel {rel_loss:.2e} (< {LOSS_TOL}), gradients finite "
          f"{finite}", flush=True)
    assert rel_frame < CHANNEL_TOL, rel_frame
    assert rel_loss < LOSS_TOL, rel_loss
    assert finite, "non-finite gradient"
    return rel_frame, rel_loss


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-GPU (dp=2, sp=2) mesh phase")
    args = ap.parse_args(argv)

    import jax

    if jax.default_backend() != "gpu":
        sys.exit(f"chip_smoke: needs a GPU; JAX's backend is "
                 f"{jax.default_backend()!r}")
    from miniraytracer_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    want = 4 if args.four else 1
    devices = jax.devices()
    if len(devices) < want:
        sys.exit(f"chip_smoke: needs {want} GPU(s); JAX found {len(devices)}")
    card = smi()
    t0 = time.perf_counter()
    device_phase(card)
    if args.four:
        four_card_phase(devices[:4], card=card)
    else:
        frame = fused_phase(card)
        parity_phase()
        book2_phase(card)
        train_phase(frame, card)
        cli_phase()
    d = devices[0]
    print(f"[done] {time.perf_counter() - t0:.1f} s on {card}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
