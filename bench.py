"""Kernel throughput of the GPU SSV scan at the engine's chunk shape.

Times one ``ssv_gpu_scan`` dispatch over a 2^24-symbol × 8160-row chunk
(the engine's default ``chunk_symbols`` × ``chunk_rows``) with
``block_until_ready`` around each call, after a compile-and-warm call, and
prints ONE JSON line with the best and median GCUPS beside the device and
the card's name and power limit. Fails without a GPU.

    python bench.py [--symbols N] [--rows P] [--iters K]
"""

import argparse
import json
import time

import numpy as np


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--symbols", type=int, default=1 << 24)
    ap.add_argument("--rows", type=int, default=8160)
    ap.add_argument("--iters", type=int, default=5)
    args = ap.parse_args()

    from havac.utils.compile_cache import enable_compile_cache
    from havac.utils.device import card_line, require_gpu

    enable_compile_cache()
    device = require_gpu()
    import jax
    import jax.numpy as jnp

    from havac.ops.ssv_gpu import ssv_gpu_scan
    from havac.scoring.reprojection import project_models
    from havac.testing.generator import model_from_consensus

    L, P = args.symbols, args.rows
    rng = np.random.default_rng(0)
    models, total = [], 0
    while total < P:  # real projected scores, so the hit density is real
        n = min(int(rng.integers(60, 200)), P - total)
        models.append(model_from_consensus(
            rng.integers(0, 4, size=max(n, 8)).astype(np.uint8)))
        total += models[-1].model_length
    scores = jnp.asarray(project_models(models, 0.02)[:P])
    symbols = jnp.asarray(rng.integers(0, 4, size=L).astype(np.uint8))
    istate = jnp.zeros(L, jnp.int32)
    icarry = jnp.zeros(P + 1, jnp.int32)

    def call():
        return jax.block_until_ready(
            ssv_gpu_scan(symbols, scores, istate, icarry, cap=1 << 20))

    t0 = time.perf_counter()
    n_hits = int(call()[2])
    compile_s = time.perf_counter() - t0
    times = []
    for _ in range(args.iters):
        t0 = time.perf_counter()
        call()
        times.append(time.perf_counter() - t0)
    times.sort()
    print(card_line())
    print(json.dumps({
        "metric": "ssv_kernel_throughput", "unit": "GCUPS",
        "value": L * P / times[0] / 1e9,
        "median": L * P / times[len(times) // 2] / 1e9,
        "seconds": times, "compile_and_first_call_s": compile_s,
        "symbols": L, "rows": P, "hits": n_hits, "device": device,
    }))


if __name__ == "__main__":
    main()
