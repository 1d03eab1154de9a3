#!/usr/bin/env python3
"""Lane kernel vs XLA scan on the GPU: the keep-or-delete measurement for
ops/lane_coder.lane_encode_pallas.

  alone — both encoders on one full dispatch group (8192 lanes x 16384
          bins of random squash-image p1), median of 5 timed calls each;
  e2e   — parallel.pipeline.device_compress(scope="gop",
          substream_bins=16384) on data/bench_1080p_hq.mp4 with each
          encoder as the lane kernel, median of 3 timed calls each.

Runs in turns (kernel, scan, scan, kernel) in one process and prints one
JSON line with the card's name and power limit.  Needs a GPU.

    python tools/lane_kernel_bench.py
"""

import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402
import chip_smoke  # noqa: E402
from avrecode_tpu.ops import lane_coder  # noqa: E402
from avrecode_tpu.parallel.pipeline import device_compress  # noqa: E402


def median_s(fn, n):
    """Median wall time of n calls of fn, which returns only when its
    device work is done, after one untimed call (compile + warm)."""
    fn()
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts)


def main():
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"lane_kernel_bench: needs a GPU, found {dev.platform}")
    bitp1, lens = chip_smoke.random_problem(0)
    x, n = jax.device_put(bitp1), jax.device_put(lens)
    data = chip_smoke.clip("bench_1080p_hq.mp4")
    chip_smoke.build_native()
    encoders = {"pallas": lane_coder.lane_encode_pallas,
                "scan": lane_coder.lane_encode_scan}
    choose = lane_coder.choose_lane_kernel
    res = {"card": chip_smoke.card(), "device_kind": dev.device_kind,
           "alone_s": {k: [] for k in encoders},
           "e2e_s": {k: [] for k in encoders}}
    try:
        for k in ("pallas", "scan", "scan", "pallas"):
            res["alone_s"][k].append(median_s(
                lambda: jax.block_until_ready(encoders[k](x, n)), 5))
            lane_coder.choose_lane_kernel = lambda k=k: k
            res["e2e_s"][k].append(median_s(lambda: device_compress(
                data, scope="gop", substream_bins=16384), 3))
            print(k, res["alone_s"][k][-1], res["e2e_s"][k][-1], flush=True)
    finally:
        lane_coder.choose_lane_kernel = choose
    res["shape"] = list(bitp1.shape)
    res["clip_bytes"] = len(data)
    print(json.dumps(res))


if __name__ == "__main__":
    main()
