"""Sharded progressive rendering over a (dp, sp) device mesh.

Replaces the reference's tile work queue + worker pool (work_queue.cpp,
main.cpp:338-382) with static SPMD sharding:

- pixels are split evenly over the `dp` axis (the Hilbert-shuffled tile
  queue exists only to load-balance *threads*; after wavefront flattening
  every pixel costs the same program, so a static split is optimal),
- each `sp` slice renders a different progressive sample pass
  (work_queue_dynamic's pass index, work_queue.cpp:158-175); passes are
  mean-reduced on-device with `psum` and folded into the running average
  with draw2 semantics (main.cpp:221-229),
- the scene tables are replicated in device memory on every device; the only
  cross-device traffic is the O(1) `psum` of the pass colors over `sp` and
  the scalar ray-counter reduction.
"""

from __future__ import annotations

from functools import lru_cache, partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from miniraytracer_tpu.models import integrator as integ


def _padded_size(n: int, ndp: int) -> int:
    return -(-n // ndp) * ndp


@lru_cache(maxsize=32)
def _make_pass_fn(mesh: Mesh, width: int, height: int, max_bounces: int, loop: str):
    ndp = mesh.shape["dp"]
    nsp = mesh.shape["sp"]
    n_pix = width * height
    n_pad = _padded_size(n_pix, ndp)
    local = n_pad // ndp

    def body(scene, frame_l, sample_idx, offset_all, max_lum, n_active):
        # global pixel ids for this dp shard; padding lanes re-render pixel 0
        # (their rows are sliced off on output)
        base = jax.lax.axis_index("dp") * local
        pix = base + jnp.arange(local, dtype=jnp.uint32)
        pix = jnp.minimum(pix, jnp.uint32(n_pix - 1))
        # this sp slice renders pass sample_idx + sp_index; slices past
        # n_active (the final partial step when spp % nsp != 0) are masked
        # out of the merge so no pixel ever gets more than spp samples
        sp_i = jax.lax.axis_index("sp")
        active = sp_i < n_active
        my_sample = sample_idx + jnp.minimum(sp_i, n_active - 1)
        offset = offset_all[sp_i % offset_all.shape[0]]

        radiance_v, rays = integ.sample_radiance(
            scene, pix, my_sample, offset,
            width=width, height=height, max_bounces=max_bounces, loop=loop,
        )
        radiance = radiance_v.arr
        # NaN guard per sample: non-finite -> running average (main.cpp:214-219)
        finite = jnp.all(jnp.isfinite(radiance), axis=-1, keepdims=True)
        prev = jnp.where(sample_idx > 0, frame_l, jnp.zeros_like(frame_l))
        color = jnp.where(finite & active, radiance, jnp.where(active, prev, 0.0))
        # mean over the active sp passes rendered this step
        n_act_f = n_active.astype(jnp.float32)
        color = jax.lax.psum(color, "sp") / n_act_f
        new_frame = integ.merge_pass(frame_l, color, sample_idx, n_act_f, max_lum)
        rays = jax.lax.psum(jnp.where(active, rays, 0.0), ("dp", "sp"))
        return new_frame, rays

    # check_vma off: the wavefront while_loop carry mixes varying (rays) and
    # invariant (fresh zeros/ones) leaves, which the VMA checker rejects even
    # though the program is correct
    sharded = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(P(), P("dp"), P(), P(), P(), P()),
        out_specs=(P("dp"), P()),
        check_vma=False,
    )
    return jax.jit(sharded)


def render_pass_sharded(
    scene, frame, sample_idx, offsets, max_lum, *,
    width: int, height: int, max_bounces: int, mesh: Mesh, loop: str = "while",
    n_active=None,
):
    """One sharded progressive step: renders min(nsp, n_active) sample passes
    (indices sample_idx ..) over all pixels.

    `frame` is the padded (padded_n, 3) running average sharded P('dp');
    `offsets` is the full (ns, 2) stratified offset table (each sp slice
    picks its row). `n_active` (traced ok) caps how many sp slices merge —
    the final partial step of a render with spp % nsp != 0.
    Returns (frame', total rays this step).
    """
    fn = _make_pass_fn(mesh, width, height, max_bounces, loop)
    if n_active is None:
        n_active = mesh.shape["sp"]
    return fn(scene, frame, sample_idx, offsets, max_lum,
              jnp.int32(n_active) if not hasattr(n_active, "dtype") else n_active)


@lru_cache(maxsize=32)
def _make_wavefront_fn(mesh: Mesh, width: int, height: int, spp: int,
                       max_bounces: int, fused: bool = False,
                       interpret: bool = False):
    ndp = mesh.shape["dp"]
    nsp = mesh.shape["sp"]
    n_pix = width * height
    n_pad = _padded_size(n_pix, ndp)
    local = n_pad // ndp
    offs, ns = integ.sample_offsets(spp)
    sq = int(ns**0.5)
    base_n, rem = divmod(ns, nsp)

    def body(scene, max_lum):
        base = jax.lax.axis_index("dp") * local
        pix = base + jnp.arange(local, dtype=jnp.uint32)
        pix = jnp.minimum(pix, jnp.uint32(n_pix - 1))
        # contiguous sample block for this sp slice (sizes differ by <=1)
        sp = jax.lax.axis_index("sp")
        lo = sp * base_n + jnp.minimum(sp, rem)
        cnt = base_n + (sp < rem).astype(jnp.int32)
        if fused:
            from miniraytracer_tpu.ops import bounce

            accum, count, rays = bounce.render_wavefront_fused_pixels(
                scene, pix, lo, cnt, max_lum,
                width=width, height=height, max_bounces=max_bounces,
                spp_sq=sq, interpret=interpret,
            )
        else:
            accum, count, rays = integ.render_wavefront_pixels(
                scene, pix, offs, lo, cnt, max_lum,
                width=width, height=height, max_bounces=max_bounces,
            )
        # sample-weighted combine across sp blocks (clamp/NaN-guard applied
        # per block — identical to single-device when nsp == 1)
        accum = jax.lax.psum(accum, "sp")  # V3 pytree psum
        count = jax.lax.psum(count, "sp")
        inv = 1.0 / jnp.maximum(count.astype(jnp.float32), 1.0)
        avg = (accum * inv).arr
        rays = jax.lax.psum(rays, ("dp", "sp"))
        return avg, rays

    sharded = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(P(), P()),
        out_specs=(P("dp"), P()),
        check_vma=False,
    )
    return jax.jit(sharded)


def render_wavefront_distributed(
    scene,
    width: int,
    height: int,
    spp: int,
    mesh: Mesh,
    max_bounces: int = 32,
    max_lum: float = 1000.0,
    fused: bool | None = None,
    interpret: bool = False,
):
    """Whole-frame wavefront render as ONE SPMD program: pixels over dp,
    contiguous sample blocks over sp, lane regeneration inside.

    `fused=None` auto-selects the fused Pallas kernel (ops/bounce.py) when
    the scene is eligible (bounce.can_fuse: small const/checker/Perlin
    scenes on the GPU) — same estimator, path state kept in registers for
    the whole render instead of a device-memory round trip per bounce.

    Returns (frame (H,W,3) on host, stats)."""
    import time as _time

    if fused is None:
        from miniraytracer_tpu.ops import bounce

        fused = bounce.can_fuse(scene)
    fn = _make_wavefront_fn(mesh, width, height, spp, max_bounces,
                            bool(fused), interpret)
    t0 = _time.perf_counter()
    frame, rays = fn(scene, jnp.float32(max_lum))
    frame.block_until_ready()
    elapsed = _time.perf_counter() - t0
    total = float(rays)
    stats = {
        "seconds": elapsed,
        "rays": total,
        "mrays_per_s": total / elapsed / 1e6 if elapsed > 0 else 0.0,
        "spp": int(spp**0.5) ** 2,
        "devices": mesh.devices.size,
        "renderer": "wavefront-fused" if fused else "wavefront",
    }
    host = jax.device_get(frame)[: width * height]
    return host.reshape(height, width, 3), stats


@lru_cache(maxsize=32)
def _make_workqueue_fn(mesh: Mesh, width: int, height: int, spp: int,
                       max_bounces: int, lanes_per_shard: int):
    ndp = mesh.shape["dp"]
    nsp = mesh.shape["sp"]
    n_pix = width * height
    n_pad = _padded_size(n_pix, ndp)
    local = n_pad // ndp
    offs, ns = integ.sample_offsets(spp)
    base_n, rem = divmod(ns, nsp)

    def body(scene, max_lum):
        # each (dp, sp) cell runs an independent work queue over its pixel
        # range x sample block (the reference's per-thread atomic counter
        # becomes a per-shard prefix-sum queue)
        dp = jax.lax.axis_index("dp")
        sp = jax.lax.axis_index("sp")
        lo = sp * base_n + jnp.minimum(sp, rem)
        cnt = base_n + (sp < rem).astype(jnp.int32)
        # sample window [lo, lo+cnt): shift the offset table so local
        # sample index 0 maps to absolute sample lo
        accum, count, rays = integ.render_workqueue_pixels(
            scene, local, lanes_per_shard, offs, cnt, max_lum,
            width=width, height=height, max_bounces=max_bounces,
            pix_base=dp * local, sample_base=lo,
        )
        accum = jax.lax.psum(accum, "sp")
        count = jax.lax.psum(count, "sp")
        inv = 1.0 / jnp.maximum(count, 1.0)
        avg = (accum * inv).arr
        rays = jax.lax.psum(rays, ("dp", "sp"))
        return avg, rays

    sharded = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(P(), P()),
        out_specs=(P("dp"), P()),
        check_vma=False,
    )
    return jax.jit(sharded)


def render_workqueue_distributed(
    scene,
    width: int,
    height: int,
    spp: int,
    mesh: Mesh,
    max_bounces: int = 32,
    max_lum: float = 1000.0,
    lanes_per_shard: int = 0,
):
    """Work-queue renderer sharded over the mesh: pixels split over dp,
    sample blocks over sp, an independent queue per cell."""
    import time as _time

    ndp = mesh.shape["dp"]
    if lanes_per_shard == 0:
        lanes_per_shard = _padded_size(width * height, ndp) // ndp
    fn = _make_workqueue_fn(mesh, width, height, spp, max_bounces, lanes_per_shard)
    t0 = _time.perf_counter()
    frame, rays = fn(scene, jnp.float32(max_lum))
    frame.block_until_ready()
    elapsed = _time.perf_counter() - t0
    total = float(rays)
    stats = {
        "seconds": elapsed,
        "rays": total,
        "mrays_per_s": total / elapsed / 1e6 if elapsed > 0 else 0.0,
        "spp": int(spp**0.5) ** 2,
        "devices": mesh.devices.size,
    }
    host = jax.device_get(frame)[: width * height]
    return host.reshape(height, width, 3), stats


def make_frame(width: int, height: int, mesh: Mesh):
    """Zero-initialized running-average framebuffer, padded to the dp axis and
    device-sharded (device-resident accumulation, SURVEY.md section 2.2)."""
    n_pad = _padded_size(width * height, mesh.shape["dp"])
    sharding = NamedSharding(mesh, P("dp"))
    return jax.device_put(jnp.zeros((n_pad, 3), jnp.float32), sharding)


def render_distributed(
    scene,
    width: int,
    height: int,
    spp: int,
    mesh: Mesh,
    max_bounces: int = 32,
    max_lum: float = 1000.0,
    loop: str = "while",
    progress=None,
):
    """Full progressive render sharded over `mesh`.

    Host loop over ceil(spp/nsp) steps; each step is one fused SPMD program.
    Returns (frame (H,W,3) on host, stats dict).
    """
    import time as _time

    offs, ns = integ.sample_offsets(spp)
    nsp = mesh.shape["sp"]
    frame = make_frame(width, height, mesh)
    ml = jnp.float32(max_lum)
    ray_counts = []
    t0 = _time.perf_counter()
    i = 0
    while i < ns:
        # roll the offset table so sp slice j reads row (i+j) % ns
        offs_i = jnp.roll(offs, -i, axis=0) if i else offs
        frame, rays = render_pass_sharded(
            scene, frame, jnp.int32(i), offs_i, ml,
            width=width, height=height, max_bounces=max_bounces,
            mesh=mesh, loop=loop, n_active=min(nsp, ns - i),
        )
        ray_counts.append(rays)
        i += nsp
        if progress is not None:
            progress(min(i, ns), ns, frame)
    frame.block_until_ready()
    elapsed = _time.perf_counter() - t0
    total_rays = float(sum(ray_counts))
    stats = {
        "seconds": elapsed,
        "rays": total_rays,
        "mrays_per_s": total_rays / elapsed / 1e6 if elapsed > 0 else 0.0,
        "spp": ns,
        "devices": mesh.devices.size,
    }
    # gather to host, drop padding (all_gather of the sharded buffer)
    host = jax.device_get(frame)[: width * height]
    return host.reshape(height, width, 3), stats
