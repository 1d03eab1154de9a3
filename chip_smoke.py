#!/usr/bin/env python3
"""On-card smoke test of the device entropy stage.

Builds the native host library, then drives the device path through the
entry points a user calls (device_compress, device_compress_corpus,
device_decompress) on real clips, and checks every output byte for byte
against the plain references: the XLA scan on JAX's CPU device, the numpy
finalize, the Python range coder, the Python codec and the native codec.
The lane coder is int32 arithmetic with no floating-point product, so every
comparison is exact (tolerance zero; TF32 does not apply).

    python chip_smoke.py           # phases (a)-(f) on one GPU
    python chip_smoke.py --four    # the four-GPU mesh phase only

Any failure raises (non-zero exit, no result line); so does a run where JAX
finds no GPU.  The last stdout line is
    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
DATA = os.path.join(ROOT, "data")

L_FULL = 8192      # lanes in one full dispatch group
B_FULL = 16384     # bins per lane (substream_bins of the corpus benchmark)
N_SAMPLED = 64     # lanes re-encoded by the Python range coder
CLIPS = ("bench_1080p_hq.mp4", "bench_cavlc_ll480.mp4")


def log(*a):
    print(*a, flush=True)


def check(cond, what):
    if not cond:
        raise AssertionError(what)
    log("  ok:", what)


def card():
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return r.stdout.strip()


def build_native():
    subprocess.run(["make", "-C", os.path.join(ROOT, "avrecode_tpu", "host")],
                   check=True, capture_output=True)


def clip(name):
    """A clip of bench.py's corpus (rt_gop.mp4: the test suite's small
    clip), generated by tools/genvideo from its seed when not present."""
    import bench

    path = os.path.join(DATA, name)
    if not os.path.exists(path):
        gen = bench.GEN
        if not os.path.exists(gen):
            subprocess.run(["gcc", "-O2", "-o", gen, gen + ".c", "-lavformat",
                            "-lavcodec", "-lavutil", "-lm"], check=True)
        args = {n: a for n, *a in bench.CORPUS}.get(
            name, [192, 160, 12, 30, 4, 1, 26, 9, 1])
        subprocess.run([gen, path, *map(str, args)], check=True,
                       capture_output=True)
    with open(path, "rb") as f:
        return f.read()


def sync(x):
    import jax

    return [np.asarray(a) for a in jax.block_until_ready(x)]


def random_problem(seed):
    """Random squash-image p1 with bits drawn at that probability; ragged
    lens, some zero."""
    from avrecode_tpu.ops.lane_coder import _squash_tables

    rng = np.random.default_rng(seed)
    sq = _squash_tables()[0]
    p1 = sq[rng.integers(0, 4096, (L_FULL, B_FULL))]
    bit = (rng.integers(0, 1 << 16, (L_FULL, B_FULL)) < p1).astype(np.int32)
    lens = np.full(L_FULL, B_FULL, np.int32)
    ragged = rng.choice(L_FULL, L_FULL // 8, replace=False)
    lens[ragged] = rng.integers(0, B_FULL, len(ragged))
    return p1 | (bit << 16), lens


def trace_problem(data):
    """Real traces of one clip at B_FULL bins per lane, lanes repeated or
    cut to L_FULL."""
    from avrecode_tpu.ops.lane_coder import split_lanes
    from avrecode_tpu.parallel.pipeline import extract_traces

    traces = extract_traces(data, scope="gop", want_slots=False)[3]
    bitp1, lens, _ = split_lanes(traces, B_FULL)
    rows = np.resize(np.arange(len(lens)), L_FULL)
    return bitp1[rows], lens[rows]


def phase_kernel(name, bitp1, lens, cpu):
    """(b) kernel at real width: tokens vs the CPU scan, device finalize vs
    numpy finalize, sampled lanes vs the Python range coder."""
    import jax

    from avrecode_tpu.ops.lane_coder import (_finalize_device, finalize_lanes,
                                             lane_encode_pallas,
                                             lane_encode_scan)
    from avrecode_tpu.ops.rangecoder import RangeEncoder

    log(f"(b) kernel on {name}: {bitp1.shape[0]} lanes x {bitp1.shape[1]} "
        f"bins, {int(lens.sum())} coded")
    tok_d = lane_encode_pallas(bitp1, lens)
    got = sync(tok_d)
    want = sync(lane_encode_scan(jax.device_put(bitp1, cpu),
                                 jax.device_put(lens, cpu)))
    check(all(np.array_equal(a, b) for a, b in zip(got, want)),
          f"{name}: kernel tokens == XLA scan on the CPU device")
    M = B_FULL // 4 + 8
    out, nbytes, overflow = sync(_finalize_device(*tok_d, M))
    check(not overflow, f"{name}: streams fit the {M}-byte readback")
    dev_streams = [bytes(out[i, :nbytes[i]]) for i in range(len(lens))]
    host_streams = []
    for lo in range(0, len(lens), 1024):
        host_streams += finalize_lanes(*(a[lo:lo + 1024] for a in want),
                                       lens[lo:lo + 1024])
    check(dev_streams == host_streams,
          f"{name}: _finalize_device == finalize_lanes on every lane")
    rng = np.random.default_rng(1)
    for i in rng.choice(len(lens), N_SAMPLED, replace=False):
        rc = RangeEncoder()
        for x in bitp1[i, :lens[i]].tolist():
            rc.put(x >> 16, x & 0xFFFF)
        if rc.finish() != dev_streams[i]:
            raise AssertionError(f"{name}: lane {i} != Python RangeEncoder")
    check(True, f"{name}: {N_SAMPLED} sampled lanes == Python RangeEncoder")


def one_card():
    import jax

    from avrecode_tpu import codec
    from avrecode_tpu.host import native
    from avrecode_tpu.ops.lane_coder import (GROUP_LANES, _pipeline_fn,
                                             choose_lane_kernel,
                                             encode_traces_lanes)
    from avrecode_tpu.parallel.pipeline import (device_compress,
                                                device_compress_corpus,
                                                device_decompress,
                                                extract_traces)

    gpu = jax.devices()[0]
    cpu = jax.devices("cpu")[0]
    name_limit = card()
    kernel = choose_lane_kernel()
    check(kernel == "pallas", f"kernel chosen for the GPU: {kernel}")

    log("(a) card (nvidia-smi name, power.limit):")
    log(name_limit)
    log("  device_kind:", gpu.device_kind)
    sds = jax.ShapeDtypeStruct
    M = B_FULL // 4 + 8
    compiled = _pipeline_fn(True, kernel, M, None).lower(
        sds((GROUP_LANES, 3 * B_FULL // 2), np.uint8),
        sds((GROUP_LANES, B_FULL // 32), np.int32),
        sds((GROUP_LANES,), np.int32)).compile()
    log("  one dispatch group (%d lanes x %d bins): %s"
        % (GROUP_LANES, B_FULL, compiled.memory_analysis()))

    datas = {n: clip(n) for n in CLIPS}
    datas["rt_gop.mp4"] = clip("rt_gop.mp4")

    phase_kernel("random p1", *random_problem(0), cpu)
    phase_kernel("bench_1080p_hq.mp4 traces",
                 *trace_problem(datas["bench_1080p_hq.mp4"]), cpu)

    log("(c) device_compress(scope='gop', substream_bins=%d)" % B_FULL)
    per_file = {}
    for n in CLIPS:
        data = datas[n]
        out = device_compress(data, scope="gop", substream_bins=B_FULL)
        check(native.decompress(out, 0) == data,
              f"{n}: native.decompress(out) == data")
        with jax.default_device(cpu):
            ref = device_compress(data, scope="gop", substream_bins=B_FULL)
        check(out == ref, f"{n}: == the same pipeline on the CPU device")
        per_file[n] = out

    log("(d) rt_gop.mp4 against the Python and native codecs")
    data = datas["rt_gop.mp4"]
    for scope in ("gop", "slice"):
        out = device_compress(data, scope=scope, substream_bins=4096)
        check(out == codec.compress(data, scope=scope, substream_bins=4096),
              f"scope={scope}, B=4096: == codec.compress")
        if scope == "gop":
            blob = out
    out = device_compress(data, scope="slice", substream_bins=0)
    check(out == native.compress(data, "slice", 1),
          "substream_bins=0: == native.compress(scope='slice')")
    check(device_decompress(blob) == data, "device_decompress(blob) == data")

    log("(e) device_compress_corpus")
    inputs = [datas[n] for n in CLIPS] + [datas["rt_gop.mp4"], b"not a video"]
    stats = {}
    outs = device_compress_corpus(inputs, scope="gop", substream_bins=B_FULL,
                                  stats=stats)
    per_file["rt_gop.mp4"] = device_compress(
        datas["rt_gop.mp4"], scope="gop", substream_bins=B_FULL)
    per_file["literal"] = device_compress(b"not a video", scope="gop",
                                          substream_bins=B_FULL)
    for n, out in zip(list(CLIPS) + ["rt_gop.mp4", "literal"], outs):
        check(out == per_file[n], f"corpus output for {n} == per-file output")
    check(stats["dispatches"] >= 1,
          f"batched path ran: {stats['dispatches']} dispatches, "
          f"{stats['bins']} bins")

    log(f"(f) informational, on {name_limit}")
    for n in CLIPS:
        data = datas[n]
        t0 = time.perf_counter()
        device_compress(data, scope="gop", substream_bins=B_FULL)
        t_all = time.perf_counter() - t0
        t0 = time.perf_counter()
        traces = extract_traces(data, scope="gop", want_slots=False)[3]
        t_host = time.perf_counter() - t0
        t0 = time.perf_counter()
        encode_traces_lanes(traces, B_FULL)
        t_dev = time.perf_counter() - t0
        log(f"  {n}: device_compress {len(data) / 1e6 / t_all:.3f} MB/s "
            f"({t_all:.3f} s), host extract {t_host:.3f} s, device stage "
            f"{t_dev:.3f} s [{name_limit}]")
    log(f"  peak_bytes_in_use {gpu.memory_stats()['peak_bytes_in_use']} "
        f"[{name_limit}]")


def four_cards():
    import jax

    from avrecode_tpu.host import native
    from avrecode_tpu.ops.lane_coder import lane_dispatch_compact, split_lanes_recs
    from avrecode_tpu.parallel.pipeline import (device_compress,
                                                extract_traces, make_mesh)

    devs = jax.devices()
    check(len(devs) >= 4, f"{len(devs)} GPUs visible")
    log("cards (nvidia-smi name, power.limit):")
    log(card())
    mesh = make_mesh(4)
    name = "bench_1080p_hq.mp4"
    data = clip(name)
    one = device_compress(data, scope="gop", substream_bins=B_FULL)
    four = device_compress(data, mesh=mesh, scope="gop", substream_bins=B_FULL)
    check(four == one, f"{name}: 4-GPU mesh container == 1-GPU container")
    check(native.decompress(four, 0) == data, f"{name}: round-trips")
    traces = extract_traces(data, scope="gop", want_slots=False)[3]
    p1u16, bitw, lens, _ = split_lanes_recs(traces, B_FULL)
    held = set()
    for _, _, (out, _, _, _) in lane_dispatch_compact(p1u16, bitw, lens,
                                                      mesh=mesh):
        held |= {s.device for s in out.addressable_shards if s.data.size}
    check(held == set(devs[:4]), "all four GPUs held lane shards")


def main():
    import jax

    four = "--four" in sys.argv[1:]
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"chip_smoke: needs a GPU, JAX found {dev.platform}")
    build_native()
    t0 = time.perf_counter()
    four_cards() if four else one_card()
    log(f"all phases passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))

if __name__ == "__main__":
    main()
