"""Microbenchmark suite — the reference's Benchmarks/ (Google Benchmark over
SIMD variants) translated to this build's hot primitives.

Each benchmark chains the op N times inside one `lax.scan` program (the data
dependency prevents elision) and times the call with block_until_ready
after a compiling warm-up; the per-iteration cost is the median of --reps
calls over N. Needs a GPU (exits non-zero otherwise) unless --cpu is given,
in which case the numbers are the CPU's, not the card's.

Run:  python benchmarks/microbench.py [--n 250000] [--json]
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=250000, help="ray/lane count")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = ap.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    elif jax.default_backend() != "gpu":
        sys.exit("microbench: needs a GPU (or --cpu)")
    import jax.numpy as jnp

    from miniraytracer_tpu.models.scenes import cornell_box
    from miniraytracer_tpu.ops import intersect as ix, lookup, rng
    from miniraytracer_tpu.ops.vecmath import V3, vnormalize, vcross, vdot

    N = args.n
    key = jax.random.PRNGKey(0)
    dev = jax.devices()[0]
    results = []

    def bench(name, step, init, iters=20):
        chain = jax.jit(lambda x: jax.lax.scan(
            lambda c, _: (step(c), None), x, None, length=iters)[0])
        jax.block_until_ready(chain(init))
        times = []
        for _ in range(args.reps):
            t0 = time.perf_counter()
            jax.block_until_ready(chain(init))
            times.append(time.perf_counter() - t0)
        per = statistics.median(times) / iters
        results.append({"name": name, "us_per_iter": per * 1e6,
                        "ns_per_lane": per / N * 1e9,
                        "device_kind": dev.device_kind})
        if not args.json:
            print(f"{name:34s} {per*1e6:10.1f} us/iter  {per/N*1e9:8.3f} "
                  f"ns/lane  ({dev.device_kind})", flush=True)

    x0 = jax.random.normal(key, (N,))

    # --- vec core (bench_vec3.cpp analogues) ---
    v1 = V3(x0, x0 * 0.5, x0 * 0.25)
    bench("v3 dot+mul chain", lambda x: x + vdot(v1, v1) * 1e-9, x0)
    bench("v3 cross+normalize", lambda x: x + vnormalize(vcross(v1, V3(x, x, x))).x * 1e-9, x0)
    bench("rng pcg_hash+uniform", lambda x: x + rng.uniform(x.astype(jnp.uint32), 0) * 1e-9, x0)

    # --- table lookup (gather) ---
    K = 512
    tab = jax.random.normal(key, (K,))
    idx0 = jax.random.randint(key, (N,), 0, K)
    bench("lookup 1 col K=512", lambda i: (i + lookup.lookup_cols(i, (tab,))[0].astype(jnp.int32)) % K, idx0)

    # --- intersection sweep on a real scene ---
    cornell = cornell_box(1.0)
    ro = V3(jnp.full((N,), 278.0), jnp.full((N,), 278.0), jnp.full((N,), -790.0))
    rd = vnormalize(V3(x0 * 0.1, x0 * 0.05, jnp.ones((N,))))
    zeros_i = jnp.zeros((N,), jnp.int32)

    def mkrays(xx):
        return ix.Rays(ro=V3(xx * 0 + 278.0, ro.y, ro.z), rd=rd, time=jnp.zeros(N), inside=zeros_i)

    bench("scene_hit cornell",
          lambda xx: xx + ix.scene_hit(cornell, mkrays(xx)).t * 1e-12, x0)

    if args.json:
        print(json.dumps(results))


if __name__ == "__main__":
    main()
