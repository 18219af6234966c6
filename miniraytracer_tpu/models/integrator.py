"""Wavefront path-tracing integrator + progressive render driver.

The reference integrator is a recursive `trace()` (main.cpp:66-118). Here
recursion and divergence are replaced by a *wavefront*: all rays advance in
lockstep through a bounded bounce loop carrying
(origin, dir, time, isInside, throughput, radiance, alive). The recursion

    result(d) = emitted_d + f_d * result(d+1)

unrolls to  L += beta * emitted_d;  beta *= f_d  with the reference's exact
branch semantics:
- specular bounce drops `emitted` (main.cpp:81-83)
- miss adds the background: sky lerp for scenes below Cornell, else black
  (main.cpp:110-116)
- depth cap / light hit terminates with emission only (main.cpp:105-107)

All per-ray state is componentwise SoA (vecmath.V3) so every op is a
full-width elementwise pass; the (H*W, 3) array form exists only at the
framebuffer boundary.

Renderers:
- `render_wavefront` — the fast forward path: ONE device program for the
  whole frame; lanes regenerate onto their pixel's next sample the moment a
  path dies (~100% lane occupancy vs ~1/avg-path-length for pass loops).
- `render` — progressive per-sample passes (draw2, work_queue.cpp:158-175),
  used for live preview semantics and as the AD-friendly path (`loop='scan'`
  with per-bounce remat).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from miniraytracer_tpu.models import camera as cam_mod
from miniraytracer_tpu.models import materials as mat_mod
from miniraytracer_tpu.ops import intersect as ix
from miniraytracer_tpu.ops import lookup, rng, vecmath as vm
from miniraytracer_tpu.ops.vecmath import V3, vwhere
from miniraytracer_tpu.scene import types as T


class PathState(NamedTuple):
    ro: V3
    rd: V3
    time: jnp.ndarray
    inside: jnp.ndarray
    beta: V3  # throughput
    radiance: V3
    alive: jnp.ndarray  # (N,) bool
    keys: jnp.ndarray  # (N,) u32 per-path root key
    rays_traced: jnp.ndarray  # () f32 counter (metrics, main.cpp:68)


def _background(scene: T.SceneData, rd: V3) -> V3:
    if scene.use_sky:
        t = 0.5 * (rd.y + 1.0)
        return V3(
            (1.0 - t) + t * 0.5,
            (1.0 - t) + t * 0.7,
            (1.0 - t) + t * 1.0,
        )
    return V3.zeros(rd.x.shape)


def _shade_and_advance(scene, rays, keys_b, depth_ok, alive, beta, radiance):
    """Shared bounce core: intersect, shade, accumulate; returns
    (rec, sc, cont, beta', radiance')."""
    if scene.n_volumes > 0:
        u_vol = jnp.stack(
            [rng.uniform(keys_b, mat_mod.SLOT_VOL + vi) for vi in range(scene.n_volumes)],
            axis=-1,
        )
    else:
        u_vol = None
    rec = ix.scene_hit(scene, rays, u_vol)
    sc = mat_mod.shade(scene, rays, rec, keys_b, depth_ok)

    # miss -> background, path dies
    miss = alive & ~rec.hit
    radiance = radiance + vwhere(miss, beta * _background(scene, rays.rd), V3.zeros(miss.shape))
    # emission (skipped on the specular-scatter branch)
    emit_mask = alive & rec.hit & sc.add_emitted
    radiance = radiance + vwhere(emit_mask, beta * sc.emitted, V3.zeros(miss.shape))

    cont = alive & rec.hit & sc.scattered
    beta = vwhere(cont, beta * sc.weight, beta)
    # kill zero-throughput paths (estimator-identical, saves traversal work)
    cont = cont & ((beta.x > 0.0) | (beta.y > 0.0) | (beta.z > 0.0))
    return rec, sc, cont, beta, radiance


def _bounce(scene: T.SceneData, state: PathState, depth, max_bounces) -> PathState:
    """One wavefront bounce for every ray (dead lanes masked)."""
    rays = ix.Rays(ro=state.ro, rd=state.rd, time=state.time, inside=state.inside)
    keys_b = rng.fold(state.keys, depth)
    depth_ok = depth < max_bounces
    rec, sc, cont, beta, radiance = _shade_and_advance(
        scene, rays, keys_b, depth_ok, state.alive, state.beta, state.radiance
    )
    return PathState(
        ro=vwhere(cont, rec.p, state.ro),
        rd=vwhere(cont, sc.new_rd, state.rd),
        time=state.time,
        inside=jnp.where(cont, sc.new_inside, state.inside),
        beta=beta,
        radiance=radiance,
        alive=cont,
        keys=state.keys,
        rays_traced=state.rays_traced + jnp.sum(state.alive.astype(jnp.float32)),
    )


def trace_paths(scene: T.SceneData, rays0: ix.Rays, keys, max_bounces: int, loop: str = "while"):
    """Integrate radiance for a batch of primary rays.

    Returns (radiance V3, rays_traced ()). `loop='scan'` gives the
    AD-compatible fixed-trip-count variant (with per-bounce remat).
    """
    n = rays0.time.shape[0]
    state = PathState(
        ro=rays0.ro,
        rd=rays0.rd,
        time=rays0.time,
        inside=rays0.inside,
        beta=V3.fill((n,), 1.0, 1.0, 1.0),
        radiance=V3.zeros((n,)),
        alive=jnp.ones((n,), bool),
        keys=keys,
        rays_traced=jnp.float32(0.0),
    )
    # depth runs 0..max_bounces inclusive: at depth==max_bounces only
    # emission/background is collected (scatter gated by depth_ok)
    if loop == "scan":
        # remat each bounce: the backward sweep re-runs the forward bounce
        # instead of keeping every per-bounce intermediate live — trades
        # FLOPs for HBM, required at 500x500 x 33 bounces
        bounce = jax.checkpoint(
            lambda sc_, s, depth: _bounce(sc_, s, depth, max_bounces)
        )

        def body(s, depth):
            return bounce(scene, s, depth), None

        state, _ = jax.lax.scan(body, state, jnp.arange(max_bounces + 1))
    else:
        def cond(carry):
            depth, s = carry
            return (depth <= max_bounces) & jnp.any(s.alive)

        def body(carry):
            depth, s = carry
            return depth + 1, _bounce(scene, s, depth, max_bounces)

        _, state = jax.lax.while_loop(cond, body, (jnp.int32(0), state))
    return state.radiance, state.rays_traced


# ---------------------------------------------------------------------------
# Packed differentiable renderer (regeneration-in-scan for the AD path)
# ---------------------------------------------------------------------------


class PackedState(NamedTuple):
    out: V3  # (L, pack) per-item radiance written on completion
    count: jnp.ndarray  # (L,) i32 items completed = slot of the current item
    ro: V3
    rd: V3
    time: jnp.ndarray
    inside: jnp.ndarray
    beta: V3
    radiance: V3
    depth: jnp.ndarray  # (L,) per-lane bounce depth of the current item
    alive: jnp.ndarray  # (L,) lane is tracing a path
    keys: jnp.ndarray
    rays_traced: jnp.ndarray


def _select_slot(table2d: jnp.ndarray, slot: jnp.ndarray, pack: int):
    """(L, pack) table, (L,) slot in [0, pack) -> (L,) row values.
    Static masked-select loop (pack is small); no gather."""
    acc = table2d[:, 0]
    for k in range(1, pack):
        acc = jnp.where(slot == k, table2d[:, k], acc)
    return acc


def _write_slot(table2d: jnp.ndarray, slot: jnp.ndarray, val, mask, pack: int):
    """Write `val` (L,) into row-slot `slot` where `mask` — masked one-hot
    column updates (differentiable; the transpose is the same select, so
    no scatter)."""
    cols = []
    for k in range(pack):
        sel = mask & (slot == k)
        cols.append(jnp.where(sel, val, table2d[:, k]))
    return jnp.stack(cols, axis=1)


def sample_radiance_packed(
    scene: T.SceneData,
    pix: jnp.ndarray,  # (I,) u32 pixel ids, I % pack == 0
    sample_idx,  # () i32, or (I,) i32 per-item sample indices
    offset: jnp.ndarray,  # (2,) subpixel offset, or (I, 2) per-item offsets
    *,
    width: int,
    height: int,
    max_bounces: int,
    pack: int = 8,
    scan_steps: int = 0,
):
    """Differentiable radiance for each listed pixel (one sample each), with
    `pack` items statically assigned per lane and lane regeneration inside a
    fixed-trip-count `lax.scan` (reverse AD cannot differentiate a
    while_loop, and the unpacked scan pays max_bounces+1 full-width
    iterations for an average path length of ~3 — <10% occupancy).

    Lane j owns items [j*pack, (j+1)*pack); when its path terminates, the
    item's radiance is written into slot `count` via masked one-hot column
    updates (no scatter) and the lane claims its next item. Claims are gated
    to steps < scan_steps - (max_bounces+1), so every STARTED item finishes
    within the scan — an item is either completed exactly (same counter-keyed
    RNG path as the unpacked renderer) or never started. Never-started items
    (`done` False) are a function of the SIBLING items' path lengths only,
    never of their own value, so estimators that drop them stay unbiased;
    callers choose scan_steps so that done is all-True in practice (the
    returned mask makes truncation observable, not silent).

    The estimator semantics (per-sample radiance, NaN policy left to the
    caller) match `sample_radiance(loop='scan')`: with all-True `done` the
    outputs are identical up to float reassociation.

    Returns (radiance V3 (I,), done (I,) bool, rays_traced ()).
    Matches the reference's keep-lanes-busy dynamic queue semantics
    (work_queue.cpp:158-175), differentiably.
    """
    n_items = pix.shape[0]
    assert n_items % pack == 0, (n_items, pack)
    lanes = n_items // pack
    if scan_steps <= 0:
        # default: ~6 bounces/item of budget + the completion tail
        scan_steps = pack * 6 + max_bounces + 1
    claim_limit = scan_steps - (max_bounces + 1)
    assert claim_limit >= 0, (scan_steps, max_bounces)

    pix2d = pix.reshape(lanes, pack)
    # per-item sample index / subpixel offset (scalars broadcast): lets a
    # caller batch SEVERAL samples of the same pixel list in one scan
    # (parallel.train's spp_step) — more lanes per scan step amortizes the
    # per-op dispatch overhead that dominates at small lane counts
    samp = jnp.broadcast_to(
        jnp.asarray(sample_idx, jnp.int32).reshape(-1), (n_items,)
    )
    off = jnp.asarray(offset, jnp.float32)
    if off.ndim == 1:
        off = jnp.broadcast_to(off[None, :], (n_items, 2))
    samp2d = samp.reshape(lanes, pack)
    offx2d = off[:, 0].reshape(lanes, pack)
    offy2d = off[:, 1].reshape(lanes, pack)

    def camera_rays(pix_cur, samp_cur, ox, oy):
        x = (pix_cur % width).astype(jnp.float32)
        y = (pix_cur // width).astype(jnp.float32)
        ss = (x + ox) / width
        tt = (y + oy) / height
        keys = rng.ray_key(pix_cur, samp_cur.astype(jnp.uint32))
        return cam_mod.get_rays(scene.camera, ss, tt, keys), keys

    rays0, keys0 = camera_rays(pix2d[:, 0], samp2d[:, 0], offx2d[:, 0],
                               offy2d[:, 0])
    state = PackedState(
        out=V3.zeros((lanes, pack)),
        count=jnp.zeros((lanes,), jnp.int32),
        ro=rays0.ro, rd=rays0.rd, time=rays0.time, inside=rays0.inside,
        beta=V3.fill((lanes,), 1.0, 1.0, 1.0),
        radiance=V3.zeros((lanes,)),
        depth=jnp.zeros((lanes,), jnp.int32),
        alive=jnp.ones((lanes,), bool),
        keys=keys0,
        rays_traced=jnp.float32(0.0),
    )

    def step(scene_, s: PackedState, t):
        rays = ix.Rays(ro=s.ro, rd=s.rd, time=s.time, inside=s.inside)
        keys_b = rng.fold(s.keys, s.depth)
        depth_ok = s.depth < max_bounces
        rec, sc, cont, beta, radiance = _shade_and_advance(
            scene_, rays, keys_b, depth_ok, s.alive, s.beta, s.radiance
        )
        finished = s.alive & ~cont
        out = V3(
            _write_slot(s.out.x, s.count, radiance.x, finished, pack),
            _write_slot(s.out.y, s.count, radiance.y, finished, pack),
            _write_slot(s.out.z, s.count, radiance.z, finished, pack),
        )
        count = jnp.where(finished, s.count + 1, s.count)

        regen = finished & (count < pack) & (t < claim_limit)
        slot_new = jnp.minimum(count, pack - 1)
        pix_new = _select_slot(pix2d, slot_new, pack)
        samp_new = _select_slot(samp2d, slot_new, pack)
        ox_new = _select_slot(offx2d, slot_new, pack)
        oy_new = _select_slot(offy2d, slot_new, pack)
        new_rays, new_keys = camera_rays(pix_new, samp_new, ox_new, oy_new)
        return PackedState(
            out=out,
            count=count,
            ro=vwhere(regen, new_rays.ro, vwhere(cont, rec.p, s.ro)),
            rd=vwhere(regen, new_rays.rd, vwhere(cont, sc.new_rd, s.rd)),
            time=jnp.where(regen, new_rays.time, s.time),
            inside=jnp.where(
                regen, new_rays.inside, jnp.where(cont, sc.new_inside, s.inside)
            ),
            beta=vwhere(regen, V3.fill(regen.shape, 1.0, 1.0, 1.0), beta),
            radiance=vwhere(regen, V3.zeros(regen.shape), radiance),
            depth=jnp.where(regen, 0, s.depth + 1),
            alive=cont | regen,
            keys=jnp.where(regen, new_keys, s.keys),
            rays_traced=s.rays_traced + jnp.sum(s.alive.astype(jnp.float32)),
        )

    # remat each step: same FLOPs-for-HBM trade as the unpacked scan path
    step_ck = jax.checkpoint(step)

    def body(s, t):
        return step_ck(scene, s, t), None

    state, _ = jax.lax.scan(body, state, jnp.arange(scan_steps))
    radiance = V3(
        state.out.x.reshape(-1), state.out.y.reshape(-1), state.out.z.reshape(-1)
    )
    slot = jnp.tile(jnp.arange(pack, dtype=jnp.int32), (lanes,))
    done = slot < jnp.repeat(state.count, pack)
    return radiance, done, state.rays_traced


# ---------------------------------------------------------------------------
# Regenerating wavefront renderer (the fast forward path)
# ---------------------------------------------------------------------------


class WaveState(NamedTuple):
    accum: V3  # clamped-running-average * count, per pixel
    count: jnp.ndarray  # (N,) i32 samples completed per pixel
    ro: V3
    rd: V3
    time: jnp.ndarray
    inside: jnp.ndarray
    beta: V3
    radiance: V3  # per-path radiance so far
    depth: jnp.ndarray  # (N,) i32 per-lane bounce depth
    alive: jnp.ndarray  # (N,) bool lane is tracing a path
    keys: jnp.ndarray
    rays_traced: jnp.ndarray


def _wave_bounce(scene, s: WaveState, max_bounces) -> WaveState:
    """One wavefront step with per-lane depth (regeneration variant of
    _bounce; same estimator semantics, SURVEY.md section 3.3)."""
    rays = ix.Rays(ro=s.ro, rd=s.rd, time=s.time, inside=s.inside)
    keys_b = rng.fold(s.keys, s.depth)
    depth_ok = s.depth < max_bounces
    rec, sc, cont, beta, radiance = _shade_and_advance(
        scene, rays, keys_b, depth_ok, s.alive, s.beta, s.radiance
    )
    return s._replace(
        ro=vwhere(cont, rec.p, s.ro),
        rd=vwhere(cont, sc.new_rd, s.rd),
        inside=jnp.where(cont, sc.new_inside, s.inside),
        beta=beta,
        radiance=radiance,
        depth=s.depth + 1,
        alive=cont,
        rays_traced=s.rays_traced + jnp.sum(s.alive.astype(jnp.float32)),
    )


def render_wavefront_pixels(
    scene: T.SceneData,
    pix: jnp.ndarray,  # (N,) u32 pixel ids (one lane per pixel)
    offsets: jnp.ndarray,  # (ns, 2) stratified subpixel offsets
    sample_lo,  # () i32 first absolute sample index (may be traced)
    n_samples,  # () i32 number of samples per pixel (may be traced)
    max_lum,
    *,
    width: int,
    height: int,
    max_bounces: int,
):
    """Render samples [sample_lo, sample_lo+n_samples) for each listed pixel
    with lane regeneration: when a lane's path terminates it immediately
    folds the sample into its pixel's running average (draw2 merge + NaN
    guard + luminance clamp, main.cpp:214-229) and restarts on its next
    sample.

    Unlike the one-pass-per-sample host loop this keeps every lane busy
    (~100% occupancy instead of ~1/avg-path-length) and renders the whole
    frame in ONE device program. Returns
    (accum V3 = running-average*count, count (N,), rays_traced) so
    sample-sharded callers can combine partial results.
    """
    n = pix.shape[0]
    ns = n_samples
    x = (pix % width).astype(jnp.float32)
    y = (pix // width).astype(jnp.float32)

    def camera_rays(sample_idx):
        """sample_idx: (N,) i32 absolute sample index per lane."""
        ci = jnp.clip(sample_idx, 0, offsets.shape[0] - 1)
        off_x, off_y = lookup.lookup_cols(ci, (offsets[:, 0], offsets[:, 1]))
        ss = (x + off_x) / width
        tt = (y + off_y) / height
        keys = rng.ray_key(pix, sample_idx.astype(jnp.uint32))
        rays = cam_mod.get_rays(scene.camera, ss, tt, keys)
        return rays, keys

    rays0, keys0 = camera_rays(jnp.full((n,), sample_lo, jnp.int32))
    state = WaveState(
        accum=V3.zeros((n,)),
        count=jnp.zeros((n,), jnp.int32),
        ro=rays0.ro, rd=rays0.rd, time=rays0.time, inside=rays0.inside,
        beta=V3.fill((n,), 1.0, 1.0, 1.0),
        radiance=V3.zeros((n,)),
        depth=jnp.zeros((n,), jnp.int32),
        alive=jnp.ones((n,), bool) & (jnp.asarray(ns) > 0),
        keys=keys0,
        rays_traced=jnp.float32(0.0),
    )

    def cond(s):
        return jnp.any(s.alive)

    def body(s):
        s = _wave_bounce(scene, s, max_bounces)
        finished = ~s.alive & (s.count < ns)
        # ---- fold the finished sample into the running average ----
        cnt_f = s.count.astype(jnp.float32)
        has_prev = s.count > 0
        inv_prev = 1.0 / jnp.maximum(cnt_f, 1.0)
        prev_avg = vwhere(has_prev, s.accum * inv_prev, V3.zeros(cnt_f.shape))
        finite = (
            jnp.isfinite(s.radiance.x)
            & jnp.isfinite(s.radiance.y)
            & jnp.isfinite(s.radiance.z)
        )
        color = vwhere(finite, s.radiance, prev_avg)  # NaN guard
        new_avg = vwhere(
            has_prev,
            prev_avg + (color - prev_avg) * (1.0 / (cnt_f + 1.0)),
            color,
        )
        lum = vm.vluminance(new_avg)
        scale = jnp.where(lum > max_lum, max_lum / jnp.maximum(lum, 1e-12), 1.0)
        new_avg = new_avg * scale
        accum = vwhere(finished, new_avg * (cnt_f + 1.0), s.accum)
        count = jnp.where(finished, s.count + 1, s.count)

        # ---- regenerate lanes that still have samples left ----
        regen = finished & (count < ns)
        sample_idx = sample_lo + count
        new_rays, new_keys = camera_rays(sample_idx)
        return WaveState(
            accum=accum,
            count=count,
            ro=vwhere(regen, new_rays.ro, s.ro),
            rd=vwhere(regen, new_rays.rd, s.rd),
            time=jnp.where(regen, new_rays.time, s.time),
            inside=jnp.where(regen, new_rays.inside, s.inside),
            beta=vwhere(regen, V3.fill(regen.shape, 1.0, 1.0, 1.0), s.beta),
            radiance=vwhere(regen, V3.zeros(regen.shape), s.radiance),
            depth=jnp.where(regen, 0, s.depth),
            alive=s.alive | regen,
            keys=jnp.where(regen, new_keys, s.keys),
            rays_traced=s.rays_traced,
        )

    state = jax.lax.while_loop(cond, body, state)
    return state.accum, state.count, state.rays_traced


@partial(jax.jit, static_argnames=("width", "height", "spp", "max_bounces"))
def _render_wavefront_jit(scene, max_lum, *, width, height, spp, max_bounces):
    offs, ns = sample_offsets(spp)
    pix = jnp.arange(width * height, dtype=jnp.uint32)
    accum, count, rays = render_wavefront_pixels(
        scene, pix, offs, jnp.int32(0), jnp.int32(ns), max_lum,
        width=width, height=height, max_bounces=max_bounces,
    )
    inv = 1.0 / jnp.maximum(count.astype(jnp.float32), 1.0)
    return (accum * inv).arr, rays


def render_wavefront(
    scene: T.SceneData,
    width: int,
    height: int,
    spp: int,
    max_bounces: int = 32,
    max_lum: float = 1000.0,
):
    """Full-frame wavefront render in one device program.

    Returns (frame (H,W,3) linear, stats). Estimator-identical to `render`
    (same per-(pixel,sample) RNG keys, merge order, NaN and clamp policy) —
    only the schedule differs.
    """
    import time as _time

    t0 = _time.perf_counter()
    frame, rays = _render_wavefront_jit(
        scene, jnp.float32(max_lum),
        width=width, height=height, spp=spp, max_bounces=max_bounces,
    )
    frame.block_until_ready()
    elapsed = _time.perf_counter() - t0
    total = float(rays)
    stats = {
        "seconds": elapsed,
        "rays": total,
        "mrays_per_s": total / elapsed / 1e6 if elapsed > 0 else 0.0,
        "spp": int(jnp.sqrt(spp)) ** 2,
        "renderer": "wavefront",
    }
    return frame.reshape(height, width, 3), stats


# ---------------------------------------------------------------------------
# Work-queue wavefront (throughput mode: lanes decoupled from pixels)
# ---------------------------------------------------------------------------


class WQState(NamedTuple):
    accum: V3  # (P+1,) per-pixel sums (row P = dummy for masked scatters)
    count: jnp.ndarray  # (P+1,)
    next_item: jnp.ndarray  # () i32 global work counter
    item: jnp.ndarray  # (N,) i32 current (pixel, sample) work item per lane
    ro: V3
    rd: V3
    time: jnp.ndarray
    inside: jnp.ndarray
    beta: V3
    radiance: V3
    depth: jnp.ndarray
    alive: jnp.ndarray
    keys: jnp.ndarray
    rays_traced: jnp.ndarray


def render_workqueue_pixels(
    scene: T.SceneData,
    n_pix: int,
    n_lanes: int,
    offsets: jnp.ndarray,
    n_samples,  # may be traced (sharded sample blocks)
    max_lum,
    *,
    width: int,
    height: int,
    max_bounces: int,
    pix_base=0,  # may be traced (sharded pixel ranges)
    sample_base=0,
):
    """Whole-frame render with a GLOBAL work queue: the data-parallel
    equivalent of the reference's atomic tile counter
    (work_queue.cpp:133-175), at per-sample granularity. Work item w = (pixel w % n_pix, sample w // n_pix)
    (sample-major, so early items sweep the full frame like the progressive
    queue). When a lane's path terminates it scatter-adds the sample into
    the framebuffer and immediately claims the next item via a prefix-sum
    over finished lanes — so lane occupancy stays ~100% even when a few
    pixels (e.g. through glass) need 10x the bounces of the rest, where the
    pixel-pinned wavefront (render_wavefront_pixels) serializes a pixel's
    samples on one lane and stalls the whole array on stragglers.

    Estimator deviations from draw2 (documented): samples accumulate
    out-of-order, the luminance clamp applies to the final mean (not the
    running average), and non-finite samples are dropped rather than
    replaced by the previous average. Identical in expectation; use the
    pixel-pinned wavefront for reference-exact merge semantics.

    Returns (accum V3 (P,), count (P,), rays_traced).
    """
    total_items = n_pix * n_samples

    def item_local(item):
        return item % n_pix

    def item_pixel(item):
        # clamp: padded shards can address past the true frame; their rows
        # re-render the last pixel and are dropped by the caller's slice
        return jnp.clip(item % n_pix + pix_base, 0, width * height - 1).astype(jnp.uint32)

    def item_sample(item):
        return (item // n_pix).astype(jnp.int32) + sample_base

    x_of = lambda pix: (pix % width).astype(jnp.float32)
    y_of = lambda pix: (pix // width).astype(jnp.float32)

    def camera_rays(item):
        pix = item_pixel(item)
        samp = item_sample(item)
        ci = jnp.clip(samp, 0, offsets.shape[0] - 1)
        off_x, off_y = lookup.lookup_cols(ci, (offsets[:, 0], offsets[:, 1]))
        ss = (x_of(pix) + off_x) / width
        tt = (y_of(pix) + off_y) / height
        keys = rng.ray_key(pix, samp.astype(jnp.uint32))
        return cam_mod.get_rays(scene.camera, ss, tt, keys), keys

    n = n_lanes
    items0 = jnp.arange(n, dtype=jnp.int32)
    rays0, keys0 = camera_rays(items0)
    state = WQState(
        accum=V3.zeros((n_pix + 1,)),
        count=jnp.zeros((n_pix + 1,), jnp.float32),
        next_item=jnp.int32(n),
        item=items0,
        ro=rays0.ro, rd=rays0.rd, time=rays0.time, inside=rays0.inside,
        beta=V3.fill((n,), 1.0, 1.0, 1.0),
        radiance=V3.zeros((n,)),
        depth=jnp.zeros((n,), jnp.int32),
        alive=items0 < total_items,
        keys=keys0,
        rays_traced=jnp.float32(0.0),
    )

    def cond(s):
        return jnp.any(s.alive)

    def body(s):
        rays = ix.Rays(ro=s.ro, rd=s.rd, time=s.time, inside=s.inside)
        keys_b = rng.fold(s.keys, s.depth)
        depth_ok = s.depth < max_bounces
        rec, sc, cont, beta, radiance = _shade_and_advance(
            scene, rays, keys_b, depth_ok, s.alive, s.beta, s.radiance
        )
        p_next, adv_rd, adv_inside = rec.p, sc.new_rd, sc.new_inside
        finished = s.alive & ~cont

        # ---- scatter finished samples into the frame ----
        finite = (
            jnp.isfinite(radiance.x)
            & jnp.isfinite(radiance.y)
            & jnp.isfinite(radiance.z)
        )
        ok = finished & finite  # non-finite samples dropped
        # per-sample luminance clamp (deviation: reference clamps the
        # running average, main.cpp:226-229)
        lum = vm.vluminance(radiance)
        scale = jnp.where(lum > max_lum, max_lum / jnp.maximum(lum, 1e-12), 1.0)
        rad_c = radiance * scale
        target = jnp.where(ok, item_local(s.item), n_pix).astype(jnp.int32)
        accum = V3(
            s.accum.x.at[target].add(jnp.where(ok, rad_c.x, 0.0)),
            s.accum.y.at[target].add(jnp.where(ok, rad_c.y, 0.0)),
            s.accum.z.at[target].add(jnp.where(ok, rad_c.z, 0.0)),
        )
        count = s.count.at[target].add(jnp.where(ok, 1.0, 0.0))

        # ---- claim new work items (prefix sum = the atomic fetch_add) ----
        fin_i = finished.astype(jnp.int32)
        claim = s.next_item + jnp.cumsum(fin_i) - fin_i  # exclusive scan
        new_item = jnp.where(finished, claim, s.item)
        have_work = new_item < total_items
        regen = finished & have_work
        new_rays, new_keys = camera_rays(jnp.where(regen, new_item, 0))

        return WQState(
            accum=accum,
            count=count,
            next_item=s.next_item + jnp.sum(fin_i),
            item=new_item,
            ro=vwhere(regen, new_rays.ro, vwhere(cont, p_next, s.ro)),
            rd=vwhere(regen, new_rays.rd, vwhere(cont, adv_rd, s.rd)),
            time=jnp.where(regen, new_rays.time, s.time),
            inside=jnp.where(regen, new_rays.inside, jnp.where(cont, adv_inside, s.inside)),
            beta=vwhere(regen, V3.fill(regen.shape, 1.0, 1.0, 1.0), beta),
            radiance=vwhere(regen, V3.zeros(regen.shape), radiance),
            depth=jnp.where(regen, 0, s.depth + 1),
            alive=cont | regen,
            keys=jnp.where(regen, new_keys, s.keys),
            rays_traced=s.rays_traced + jnp.sum(s.alive.astype(jnp.float32)),
        )

    state = jax.lax.while_loop(cond, body, state)
    accum = V3(state.accum.x[:n_pix], state.accum.y[:n_pix], state.accum.z[:n_pix])
    return accum, state.count[:n_pix], state.rays_traced


WQ_MAX_LANES = 131_072


def wq_auto_lanes(n_pix: int) -> int:
    """Lane budget for the work queue: one lane per pixel up to
    WQ_MAX_LANES. More lanes amortize per-iteration fixed costs, but the
    per-lane stages (scatter merges, claim prefix sums) grow with the lane
    count. Not tuned on the H100."""
    return min(n_pix, WQ_MAX_LANES)


@partial(jax.jit, static_argnames=("width", "height", "spp", "max_bounces",
                                   "n_lanes"))
def _render_workqueue_jit(scene, max_lum, *, width, height, spp, max_bounces,
                          n_lanes):
    offs, ns = sample_offsets(spp)
    n_pix = width * height
    accum, count, rays = render_workqueue_pixels(
        scene, n_pix, n_lanes or wq_auto_lanes(n_pix), offs, ns,
        max_lum,
        width=width, height=height, max_bounces=max_bounces,
    )
    inv = 1.0 / jnp.maximum(count, 1.0)
    return (accum * inv).arr, rays


@partial(
    jax.jit,
    static_argnames=("width", "height", "spp", "max_bounces", "n_lanes",
                     "chunk"),
)
def _render_workqueue_chunk_jit(scene, max_lum, base, *, width, height, spp,
                                max_bounces, n_lanes, chunk):
    """One sample-block [base, base+chunk) of a spp-stratified work-queue
    render (`base` is traced — all chunks share one compilation). Returns
    raw (accum (P,3), count (P,), rays) so the host can merge blocks (the
    mean is taken once, after the last block)."""
    offs, _ = sample_offsets(spp)
    n_pix = width * height
    accum, count, rays = render_workqueue_pixels(
        scene, n_pix, n_lanes or wq_auto_lanes(n_pix), offs, chunk,
        max_lum,
        width=width, height=height, max_bounces=max_bounces,
        sample_base=base,
    )
    return accum.arr, count, rays


def render_workqueue(
    scene: T.SceneData,
    width: int,
    height: int,
    spp: int,
    max_bounces: int = 32,
    max_lum: float = 1000.0,
    n_lanes: int = 0,
    chunk: int = 0,
):
    """Whole-frame work-queue render (throughput mode). n_lanes = 0 uses
    wq_auto_lanes. `chunk` > 0 splits the render into sample blocks of that
    size, one device dispatch each (bounds single-dispatch runtime and
    gives natural checkpoint boundaries); stratification spans the FULL
    spp, so the estimator is identical to the one-shot render up to
    accumulation order. Returns (frame (H,W,3), stats)."""
    import time as _time

    t0 = _time.perf_counter()
    if chunk and chunk < spp:
        _, ns_total = sample_offsets(spp)  # spp rounds to a square grid
        acc = None
        cnt = None
        ray_parts = []  # device scalars; transferred once after the chain
        base = 0
        while base < ns_total:
            nb = min(chunk, ns_total - base)
            a, c, r = _render_workqueue_chunk_jit(
                scene, jnp.float32(max_lum), jnp.int32(base),
                width=width, height=height, spp=spp,
                max_bounces=max_bounces, n_lanes=n_lanes, chunk=nb,
            )
            # no per-chunk sync: dispatches queue back-to-back on the
            # device; each chunk is still its own bounded execution
            acc = a if acc is None else acc + a
            cnt = c if cnt is None else cnt + c
            ray_parts.append(r)
            base += nb
        frame = acc / jnp.maximum(cnt, 1.0)[:, None]
        jax.block_until_ready(frame)
        rays = float(sum(float(r) for r in ray_parts))
    else:
        frame, rays = _render_workqueue_jit(
            scene, jnp.float32(max_lum),
            width=width, height=height, spp=spp, max_bounces=max_bounces,
            n_lanes=n_lanes,
        )
        frame.block_until_ready()
    elapsed = _time.perf_counter() - t0
    total = float(rays)
    return frame.reshape(height, width, 3), {
        "seconds": elapsed,
        "rays": total,
        "mrays_per_s": total / elapsed / 1e6 if elapsed > 0 else 0.0,
        "spp": int(jnp.sqrt(spp)) ** 2,
        "renderer": "workqueue",
    }


def pick_renderer(scene: T.SceneData) -> str:
    """Forward-renderer choice. Scenes that fit the fused kernel
    (ops/bounce.can_fuse: small const/checker/Perlin scenes, GPU backend)
    run the whole wavefront body in one kernel. Scenes whose per-bounce
    primitive sweep is nontrivial go to the compacting work queue, which
    keeps lanes busy when a few paths run long; the rest take the
    pixel-pinned XLA wavefront. The split between the two XLA renderers is
    not tuned on the H100."""
    from miniraytracer_tpu.ops import bounce

    if bounce.can_fuse(scene):
        return "fused"
    # a box prim costs ~6 rect tests in the sweep (box.h decomposition)
    heavy = scene.n_tris + scene.n_spheres + 6 * scene.n_boxes
    if heavy >= 64:
        return "workqueue"
    return "wavefront"


def render_auto(scene, width, height, spp, max_bounces=32, max_lum=1000.0):
    """Render with the forward renderer pick_renderer chooses."""
    which = pick_renderer(scene)
    if which == "workqueue":
        return render_workqueue(scene, width, height, spp, max_bounces, max_lum)
    if which == "fused":
        from miniraytracer_tpu.ops import bounce

        return bounce.render_wavefront_fused(
            scene, width, height, spp, max_bounces, max_lum)
    return render_wavefront(scene, width, height, spp, max_bounces, max_lum)


# ---------------------------------------------------------------------------
# Progressive full-frame renderer (draw2 semantics)
# ---------------------------------------------------------------------------


def sample_offsets(spp: int):
    """Stratified sqrt(spp)^2 regular grid of subpixel offsets
    (main.cpp:316-332). Returns (ns, 2) float32 and ns."""
    import numpy as np

    sq = int(np.sqrt(spp))
    ns = sq * sq
    offs = np.zeros((ns, 2), np.float32)
    for i in range(sq):
        for j in range(sq):
            offs[i * sq + j] = ((i + 0.5) / sq, (j + 0.5) / sq)
    return jnp.asarray(offs), ns


def sample_radiance(
    scene: T.SceneData,
    pix: jnp.ndarray,  # (N,) u32 pixel ids (index = x + y*width, bottom row 0)
    sample_idx: jnp.ndarray,  # () i32
    offset: jnp.ndarray,  # (2,) subpixel offset
    *,
    width: int,
    height: int,
    max_bounces: int,
    loop: str = "while",
):
    """One radiance sample for each listed pixel. Returns (V3, rays ())."""
    x = (pix % width).astype(jnp.float32)
    y = (pix // width).astype(jnp.float32)
    s = (x + offset[0]) / width
    t = (y + offset[1]) / height
    keys = rng.ray_key(pix, jnp.full(pix.shape, sample_idx, jnp.uint32))
    rays = cam_mod.get_rays(scene.camera, s, t, keys)
    return trace_paths(scene, rays, keys, max_bounces, loop=loop)


def merge_pass(frame, color, sample_idx, n_new, max_lum):
    """Fold `n_new` fresh per-pixel sample averages (`color`, (N,3)) into the
    running average `frame` (N,3) that already holds `sample_idx` samples —
    draw2 semantics (main.cpp:221-229): incremental average then luminance
    clamp on the running average. `color` must already be NaN-guarded."""
    k = sample_idx.astype(jnp.float32)
    new_frame = jnp.where(
        sample_idx > 0,
        frame + (color - frame) * (n_new / (k + n_new)),
        color,
    )
    lum = vm.luminance(new_frame)
    scale = jnp.where(lum > max_lum, max_lum / jnp.maximum(lum, 1e-12), 1.0)
    return new_frame * scale[:, None]


def render_pixels(
    scene: T.SceneData,
    frame: jnp.ndarray,  # (N, 3) running average rows for `pix`
    pix: jnp.ndarray,  # (N,) u32 pixel ids
    sample_idx: jnp.ndarray,  # () i32
    offset: jnp.ndarray,  # (2,)
    max_lum: jnp.ndarray,  # ()
    *,
    width: int,
    height: int,
    max_bounces: int,
    loop: str = "while",
):
    """One progressive pass over an arbitrary pixel subset (shard-friendly
    core). Returns (frame', rays_traced)."""
    radiance_v, rays_traced = sample_radiance(
        scene, pix, sample_idx, offset,
        width=width, height=height, max_bounces=max_bounces, loop=loop,
    )
    radiance = radiance_v.arr
    # NaN policy (main.cpp:214-219): non-finite -> previous pixel (or 0)
    finite = jnp.all(jnp.isfinite(radiance), axis=-1, keepdims=True)
    prev = jnp.where(sample_idx > 0, frame, jnp.zeros_like(frame))
    color = jnp.where(finite, radiance, prev)
    return merge_pass(frame, color, sample_idx, 1.0, max_lum), rays_traced


@partial(jax.jit, static_argnames=("width", "height", "max_bounces", "loop"))
def render_tile_pass(
    scene: T.SceneData,
    frame_rows: jnp.ndarray,  # (B, 3) running-average rows for `pix`
    pix: jnp.ndarray,  # (B,) u32 pixel ids (one Hilbert-ordered tile batch)
    sample_idx: jnp.ndarray,  # () i32
    offset: jnp.ndarray,  # (2,)
    max_lum: jnp.ndarray,  # ()
    *,
    width: int,
    height: int,
    max_bounces: int,
    loop: str = "while",
):
    """One progressive pass over one tile batch (the device program behind
    the CLI's -preview mode, which sweeps the frame in the reference's
    inverted-Hilbert tile order per pass — work_queue.cpp:84-127,
    main.cpp:416-444). Returns (frame_rows', rays_traced)."""
    return render_pixels(
        scene, frame_rows, pix, sample_idx, offset, max_lum,
        width=width, height=height, max_bounces=max_bounces, loop=loop,
    )


@partial(jax.jit, static_argnames=("width", "height", "max_bounces", "loop"))
def render_pass(
    scene: T.SceneData,
    frame: jnp.ndarray,  # (H*W, 3) running average
    sample_idx: jnp.ndarray,  # () i32
    offset: jnp.ndarray,  # (2,) subpixel offset
    max_lum: jnp.ndarray,  # ()
    *,
    width: int,
    height: int,
    max_bounces: int,
    loop: str = "while",
):
    """One progressive pass: 1 sample for every pixel, merged draw2-style.

    Pixel layout matches the reference framebuffer: index = x + y*width with
    v measured from the bottom (main.cpp:156-157) — flip rows for display.
    Returns (frame', rays_traced).
    """
    pix = jnp.arange(width * height, dtype=jnp.uint32)
    return render_pixels(
        scene, frame, pix, sample_idx, offset, max_lum,
        width=width, height=height, max_bounces=max_bounces, loop=loop,
    )


def render(
    scene: T.SceneData,
    width: int,
    height: int,
    spp: int,
    max_bounces: int = 32,
    max_lum: float = 1000.0,
    loop: str = "while",
    progress=None,
):
    """Full progressive render. Returns (frame (H,W,3) linear, stats dict).

    Host loop over sample passes (the reference's work_queue_dynamic outer
    dimension, work_queue.cpp:158-175); each pass is one fused device program
    over all pixels.
    """
    import time as _time

    offs, ns = sample_offsets(spp)
    frame = jnp.zeros((width * height, 3), jnp.float32)
    ray_counts = []  # device scalars; summed once at the end (no per-pass sync)
    t0 = _time.perf_counter()
    ml = jnp.float32(max_lum)
    for i in range(ns):
        frame, rays_traced = render_pass(
            scene, frame, jnp.int32(i), offs[i], ml,
            width=width, height=height, max_bounces=max_bounces, loop=loop,
        )
        ray_counts.append(rays_traced)
        if progress is not None:
            progress(i + 1, ns, frame)
    frame.block_until_ready()
    elapsed = _time.perf_counter() - t0
    total_rays = float(sum(ray_counts))
    stats = {
        "seconds": elapsed,
        "rays": total_rays,
        "mrays_per_s": total_rays / elapsed / 1e6 if elapsed > 0 else 0.0,
        "spp": ns,
        "renderer": "progressive",
    }
    return frame.reshape(height, width, 3), stats
