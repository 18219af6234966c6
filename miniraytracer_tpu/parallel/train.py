"""Distributed differentiable render step ("training step").

The north-star capability (BASELINE.json): pixel gradients w.r.t. material
albedo, emission, and sphere/triangle geometry, with the loss and parameter
gradients reduced across the mesh. The analogue of a data-parallel training
step: each (dp, sp) mesh cell renders its pixel shard for its sample pass,
the loss is `psum`-reduced over the whole mesh, and reverse-mode AD through
`shard_map` inserts the gradient all-reduce (the transpose of replicating
the scene params to every device is exactly the `psum` over their
per-device partial gradients — overlapped with the backward sweep by XLA).

The bounce loop uses the `lax.scan` variant (static trip count) — reverse
AD cannot differentiate a `while_loop`.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from miniraytracer_tpu.models import integrator as integ
from miniraytracer_tpu.ops.vecmath import V3
from miniraytracer_tpu.scene import types as T


class TrainParams(NamedTuple):
    """Differentiable scene-parameter subset (north-star gradient targets)."""

    tex_c0: jnp.ndarray  # albedo / emission colors (X,3)
    tex_c1: jnp.ndarray  # checker odd colors (X,3)
    mat_param: jnp.ndarray  # gloss / ior / emission scale (M,)
    sph_c0: jnp.ndarray  # sphere centers (S,3)
    sph_radius: jnp.ndarray  # (S,)
    tri_m: jnp.ndarray  # triangle base vertices (T,3)


def extract_params(scene: T.SceneData) -> TrainParams:
    return TrainParams(
        tex_c0=scene.tex_c0,
        tex_c1=scene.tex_c1,
        mat_param=scene.mat_param,
        sph_c0=scene.sph_c0,
        sph_radius=scene.sph_radius,
        tri_m=scene.tri_m,
    )


def apply_params(scene: T.SceneData, p: TrainParams) -> T.SceneData:
    return dataclasses.replace(
        scene,
        tex_c0=p.tex_c0,
        tex_c1=p.tex_c1,
        mat_param=p.mat_param,
        sph_c0=p.sph_c0,
        sph_radius=p.sph_radius,
        tri_m=p.tri_m,
    )


@lru_cache(maxsize=16)
def _make_step(mesh: Mesh, width: int, height: int, max_bounces: int,
               pack: int = 1, scan_steps: int = 0, spp_step: int = 1):
    ndp = mesh.shape["dp"]
    nsp = mesh.shape["sp"]
    n_pix = width * height
    n_pad = -(-n_pix // ndp) * ndp
    local = n_pad // ndp
    # packed mode renders a pack-aligned item list (tail items repeat the
    # last pixel and are sliced off) so the frame/target padding rule stays
    # the render layer's (render.make_frame). With spp_step > 1 the item
    # list is the pixel list tiled spp_step times (sample-major) — the scan
    # has spp_step x the lanes for the SAME trip count, amortizing the
    # per-iteration fixed cost that dominates the packed step at one
    # sample/pixel.
    n_items = local * spp_step
    local_p = -(-n_items // pack) * pack

    def shard_loss(scene, target_l, sample0, offset_all):
        """Per-mesh-cell partial: render local pixels for this cell's sample
        pass, average over sp, return replicated scalar SSE."""
        base = jax.lax.axis_index("dp") * local
        pix = base + jnp.arange(local, dtype=jnp.uint32)
        in_image = pix < jnp.uint32(n_pix)
        pix = jnp.minimum(pix, jnp.uint32(n_pix - 1))
        sp_i = jax.lax.axis_index("sp")
        offset = offset_all[sp_i % offset_all.shape[0]]

        if pack > 1:
            # packed regeneration-in-scan: ~pack items per lane instead of
            # (max_bounces+1) full-width iterations per item (the unpacked
            # scan runs at <10% lane occupancy for short average paths).
            # Items are (pixel, sample) pairs: the local pixel list tiled
            # spp_step times, each tile with its own absolute sample index
            # (this sp cell consumes samples [sample0 + sp_i*spp_step,
            # ... + spp_step)) and the matching stratified offset row.
            s_ids = jnp.repeat(
                jnp.arange(spp_step, dtype=jnp.int32), local
            )
            samp_items = sample0 * spp_step + sp_i * spp_step + s_ids
            off_items = offset_all[
                samp_items % offset_all.shape[0]
            ] if spp_step > 1 else jnp.broadcast_to(
                offset[None, :], (n_items, 2)
            )
            pix_items = jnp.tile(pix, spp_step)
            if local_p != n_items:
                tail = local_p - n_items
                pix_items = jnp.concatenate(
                    [pix_items, jnp.full((tail,), pix[-1], jnp.uint32)]
                )
                samp_items = jnp.concatenate(
                    [samp_items, samp_items[-1:].repeat(tail)]
                )
                off_items = jnp.concatenate(
                    [off_items, jnp.broadcast_to(off_items[-1:], (tail, 2))]
                )
            radiance_v, done, _ = integ.sample_radiance_packed(
                scene, pix_items, samp_items, off_items,
                width=width, height=height, max_bounces=max_bounces,
                pack=pack, scan_steps=scan_steps,
            )
            rad = radiance_v.arr[:n_items].reshape(spp_step, local, 3)
            done = done[:n_items].reshape(spp_step, local, 1)
            val = done & jnp.isfinite(rad)
            # fold the spp_step samples of each pixel locally (masked sum;
            # the sp-axis psum below completes the mean)
            radiance = jnp.where(val, rad, 0.0).sum(axis=0)
            n_valid_local = val.astype(jnp.float32).sum(axis=0)
            n_valid = jax.lax.psum(
                jnp.broadcast_to(n_valid_local, radiance.shape), "sp"
            )
            mean_color = jax.lax.psum(radiance, "sp") / jnp.maximum(n_valid, 1.0)
            err = jnp.where(
                in_image[:, None] & (n_valid > 0), mean_color - target_l, 0.0
            )
            sse = jnp.sum(err * err)
            # mean_color is identical on every sp cell of a dp shard, so
            # each shard's SSE is counted nsp times by the mesh-wide psum
            return jax.lax.psum(sse, ("dp", "sp")) / nsp
        else:
            radiance_v, _ = integ.sample_radiance(
                scene, pix, sample0 + sp_i, offset,
                width=width, height=height, max_bounces=max_bounces, loop="scan",
            )
            valid = True
        radiance = radiance_v.arr
        radiance = jnp.where(jnp.isfinite(radiance) & valid, radiance, 0.0)
        # per-pixel mean over the sp samples that completed (all of them in
        # practice — `done` guards scan_steps mis-sizing from biasing silently)
        n_valid = jax.lax.psum(
            jnp.broadcast_to(
                jnp.asarray(valid & jnp.isfinite(radiance), jnp.float32),
                radiance.shape,
            ),
            "sp",
        )
        mean_color = jax.lax.psum(radiance, "sp") / jnp.maximum(n_valid, 1.0)
        err = jnp.where(in_image[:, None] & (n_valid > 0), mean_color - target_l, 0.0)
        sse = jnp.sum(err * err)
        return jax.lax.psum(sse, ("dp", "sp")) / nsp

    # check_vma off: see parallel.render — the scan carry mixes varying and
    # invariant leaves. With the checker off the shard_map transpose still
    # psums gradients of replicated inputs (the scene params all-reduce).
    sharded = jax.shard_map(
        shard_loss,
        mesh=mesh,
        in_specs=(P(), P("dp"), P(), P()),
        out_specs=P(),
        check_vma=False,
    )

    def loss_fn(params, scene, target, sample0, offsets):
        scene = apply_params(scene, params)
        return sharded(scene, target, sample0, offsets) / (n_pix * 3.0)

    def step(params, scene, target, sample0, offsets, lr):
        loss, grads = jax.value_and_grad(loss_fn)(params, scene, target, sample0, offsets)
        new_params = jax.tree_util.tree_map(lambda p, g: p - lr * g, params, grads)
        return new_params, loss, grads

    return jax.jit(step)


def make_train_step(mesh: Mesh, *, width: int, height: int, max_bounces: int,
                    pack: int = 1, scan_steps: int = 0, spp_step: int = 1):
    """Jitted SPMD train step.

    step(params, scene, target, sample0, offsets, lr)
      -> (params', loss, grads)

    `target` must be the padded (padded_n, 3) flat image (see
    render.make_frame for the padding rule), sharded or shardable P('dp').

    `pack` > 1 enables the packed regeneration-in-scan renderer
    (integ.sample_radiance_packed): ~pack samples per lane, `scan_steps`
    scan iterations (0 = the renderer's default heuristic). Estimator-equal
    to pack=1 whenever all items complete; under-budgeted scan_steps drops
    whole (value-independently selected) samples rather than biasing.

    `spp_step` > 1 (pack mode only) renders that many samples per pixel per
    step in ONE scan — spp_step x the lanes for the same trip count. The
    loss then compares the spp_step*nsp-sample pixel mean against the
    target (lower-variance gradients), and each step consumes
    nsp*spp_step consecutive sample indices.
    """
    return _make_step(mesh, width, height, max_bounces, pack, scan_steps,
                      spp_step)
