#!/usr/bin/env python3
"""Benchmark driver: corpus recode on the DEVICE path (native trace
extraction + lane-parallel device entropy coding) with the native host path as
the comparison baseline, printing ONE JSON line to stdout:

  {"metric": ..., "value": <device compress MB/s>, "unit": "MB/s",
   "vs_baseline": <space saving % / 5% target>, ...detail...}

The corpus is generated deterministically (tools/genvideo against the
system libx264) if missing, mirroring the reference's corpus test
(`./recode test ./recordings`, test.cpp:113-148).  Every file must
roundtrip bit-exact; any failure zeroes the metric.
"""

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
DATA = os.path.join(ROOT, "data")
GEN = os.path.join(ROOT, "tools", "genvideo")

CORPUS = [
    # name, W, H, frames, fps, gop, bframes, crf, seed, slices[, extra[, fmt]]
    ("bench_720p_ipp.mp4", 1280, 720, 48, 30, 24, 0, 23, 101, 1),
    ("bench_720p_b.mp4", 1280, 720, 48, 30, 24, 2, 23, 202, 1),
    ("bench_1080p_ms.mp4", 1920, 1080, 30, 30, 30, 2, 26, 303, 4),
    ("bench_480p.mp4", 854, 480, 60, 30, 30, 1, 22, 404, 1),
    # long multi-GOP stream: exercises GOP-thread scaling (config 3 of
    # BASELINE.md: multi-GOP stream, GOPs sharded across cores/chips)
    ("bench_long_720p.mp4", 1280, 720, 240, 30, 24, 2, 23, 7, 1),
    # production-scale entries: big enough to amortize per-dispatch
    # latency; dominate the corpus-total headline
    ("bench_1080p_long.mp4", 1920, 1080, 360, 30, 30, 2, 24, 909, 1),
    ("bench_4k.mp4", 3840, 2160, 48, 30, 24, 1, 26, 808, 4),
    ("bench_1080p_hq.mp4", 1920, 1080, 240, 30, 30, 2, 18, 505, 1),
    # hostile-syntax entries (round 4): custom quant matrices + 16 refs,
    # MBAFF interlace, intra-refresh + 8 slices, 10-bit 4:2:2 MBAFF
    ("bench_cqm_720p.mp4", 1280, 720, 48, 30, 24, 2, 23, 707, 1,
     "cqm=jvt:ref=16"),
    ("bench_mbaff_720p.mp4", 1280, 720, 36, 30, 18, 2, 24, 606, 1,
     "interlaced=1"),
    ("bench_ir_1080p.mp4", 1920, 1080, 40, 30, 20, 0, 24, 808, 8,
     "intra-refresh=1"),
    ("bench_422mbaff10.mp4", 960, 540, 30, 30, 15, 2, 25, 909, 1,
     "interlaced=1", "x2210"),
    # CAVLC entries (round 5): the reference recodes only CABAC, so these
    # measure coverage BEYOND it (baseline-profile / --no-cabac streams)
    ("bench_cavlc_720p.mp4", 1280, 720, 48, 30, 24, 0, 23, 111, 1,
     "cabac=0"),
    ("bench_cavlc_b_480p.mp4", 854, 480, 60, 30, 30, 2, 24, 222, 1,
     "cabac=0:ref=4"),
    # x264 LOSSLESS output (High 4:4:4 Predictive + CAVLC by default):
    # archival/screen-capture class; the reference passes it through
    ("bench_cavlc_ll480.mp4", 854, 480, 24, 30, 12, 0, 0, 333, 1,
     "cabac=0:qp=0", "x444"),
]

# per-file generator environment (genvideo content knobs)
CORPUS_ENV = {
    "bench_mbaff_720p.mp4": {"AVT_COMB": "1", "AVT_NOISE": "12"},
}

# hand-authored conformance streams folded into the headline corpus: the
# syntax x264 cannot emit (I_PCM, PAFF fields, monochrome, separate
# colour planes, SP/SI) — generated by tools/gen_*.py
CONFORMANCE = [
    ("pcm_big.264", ["tools/gen_pcm.py", "data/pcm_big.264", "8x6", "4"]),
    ("paff.264", ["tools/gen_paff.py", "data/paff.264"]),
    ("mono.264", ["tools/gen_mono.py", "data/mono.264", "16x12", "6"]),
    ("sep.264", ["tools/gen_sep.py", "data/sep.264", "8x6", "4"]),
    ("spsi.264", ["tools/gen_sp.py", "data/spsi.264", "16x12"]),
]

SUBSTREAM_BINS = "auto"  # two-tier adaptive (lane_coder.auto_substream_bins)
CORPUS_B = 16384  # batched corpus: the grid fills from ALL files, so long
# lanes win twice (fewer dispatch groups + 4x less envelope overhead)


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def ensure_corpus():
    os.makedirs(DATA, exist_ok=True)
    paths = []
    for name, *args in CORPUS:
        p = os.path.join(DATA, name)
        if not os.path.exists(p):
            if not os.path.exists(GEN):
                subprocess.run(
                    ["gcc", "-O2", "-o", GEN, GEN + ".c", "-lavformat",
                     "-lavcodec", "-lavutil", "-lm"],
                    check=True,
                )
            env = {**os.environ, **CORPUS_ENV.get(name, {})}
            subprocess.run([GEN, p, *map(str, args)], check=True,
                           capture_output=True, env=env)
        paths.append(p)
    for name, gen in CONFORMANCE:
        p = os.path.join(DATA, name)
        if not os.path.exists(p):
            subprocess.run([sys.executable] + gen, check=True, cwd=ROOT,
                           capture_output=True)
        paths.append(p)
    return paths


def ensure_native():
    from avrecode_tpu.host import native

    if not native.available():
        subprocess.run(["make", "-C", os.path.join(ROOT, "avrecode_tpu", "host")],
                       check=True, capture_output=True)
        native._TRIED = False
    return native if native.available() else None


def device_corpus(paths):
    """Device-path corpus loop (runs inside the subprocess, the only process
    that opens the card): the batched corpus pipeline over every file
    (native extract + lane kernel + container), each output decompressed
    bit-exact by the native host path."""
    import jax

    from avrecode_tpu.host import native
    from avrecode_tpu.ops.lane_coder import (choose_lane_kernel,
                                             encode_traces_lanes)
    from avrecode_tpu.parallel.pipeline import (device_compress_corpus,
                                                extract_traces)

    dev0 = jax.devices()[0]
    files = []
    total_in = total_out = 0
    failures = 0
    # batched corpus pipeline (BASELINE config 4): per-file extraction
    # overlaps the previous files' async device dispatches.  The first pass
    # compiles every dispatch shape and is not timed.
    pass_s = []
    for i in range(3):
        corpus_stats = {}
        t0 = time.time()
        comps = device_compress_corpus(paths, scope="gop",
                                       substream_bins=CORPUS_B,
                                       stats=corpus_stats)
        dt = time.time() - t0
        log("device corpus pass%s: %.3fs" % (" (warm-up)" if i == 0 else "",
                                             dt))
        if i:
            pass_s.append(dt)
    total_ct = min(pass_s)
    for p, comp in zip(paths, comps):
        data = open(p, "rb").read()
        ok = native.decompress(comp, 0) == data
        failures += 0 if ok else 1
        total_in += len(data)
        total_out += len(comp)
        files.append(
            {
                "file": os.path.basename(p),
                "mb": round(len(data) / 1e6, 3),
                "ratio_pct": round(100 * len(comp) / len(data), 2),
                "roundtrip": "OK" if ok else "FAIL",
            }
        )
        log("device:", files[-1])
    # split the stage times once (extraction vs device) on the largest file
    data = open(max(paths, key=os.path.getsize), "rb").read()
    t0 = time.time()
    _, _, _, traces, _ = extract_traces(data, scope="gop")
    t_parse = time.time() - t0
    n_bins = int(sum(len(t) for t in traces))
    encode_traces_lanes(traces, CORPUS_B)  # compiles this file's shapes
    t0 = time.time()
    encode_traces_lanes(traces, CORPUS_B)
    t_dev = time.time() - t0
    return {
        "device": {"platform": dev0.platform, "kind": dev0.device_kind,
                   "count": len(jax.devices())},
        "kernel": choose_lane_kernel(),
        "substream_bins": CORPUS_B,
        "files": files,
        "compress_mb_s": round(total_in / 1e6 / max(total_ct, 1e-9), 3),
        "pass_s": [round(s, 3) for s in pass_s],
        "pass_mb_s": sorted((round(total_in / 1e6 / max(s, 1e-9), 3)
                             for s in pass_s), reverse=True),
        "ratio_pct": round(100.0 * total_out / max(total_in, 1), 2),
        "roundtrip_failures": failures,
        "dispatches": corpus_stats.get("dispatches"),
        "corpus_bins": corpus_stats.get("bins"),
        "stage_split_largest": {
            "host_extract_s": round(t_parse, 3),
            "device_entropy_s": round(t_dev, 3),
            "bins": n_bins,
            "device_bins_per_s": round(n_bins / max(t_dev, 1e-9)),
        },
        "total_in": total_in,
        "total_out": total_out,
    }


def card():
    """The card's name and power limit as nvidia-smi reports them (None
    without nvidia-smi); read from a child process, not through JAX."""
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return r.stdout.strip() if r.returncode == 0 else None


def bench_device(paths, budget_s=2400):
    """Run the device corpus in a subprocess under a hard timeout, so this
    process stays off JAX and the child is the card's only process."""
    if os.environ.get("AVT_BENCH_NO_DEVICE"):
        return None
    try:
        r = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--device-corpus",
             *paths],
            env={**os.environ, "AVT_BENCH_DEVICE_INNER": "1"},
            capture_output=True,
            text=True,
            timeout=budget_s,
        )
        sys.stderr.write(r.stderr[-2000:])
        for line in reversed(r.stdout.splitlines()):
            if line.startswith("{"):
                return json.loads(line)
        log(f"device bench subprocess produced no result: {r.stderr[-400:]}")
        return None
    except subprocess.TimeoutExpired:
        log(f"device bench skipped: exceeded {budget_s}s budget")
        return None
    except Exception as e:
        log(f"device bench skipped: {e!r}")
        return None


def main():
    if len(sys.argv) > 2 and sys.argv[1] == "--device-corpus":
        res = device_corpus(sys.argv[2:])
        print(json.dumps(res), flush=True)
        return 0
    paths = ensure_corpus()
    native = ensure_native()
    detail = {"files": []}
    total_in = total_out = 0
    total_ct = total_dt = 0.0
    failures = 0

    for p in paths:
        data = open(p, "rb").read()
        if native:
            # host baseline: gop scope (parallel-decodable) + all cores
            t0 = time.time()
            comp = native.compress(data, "gop", 0)
            t1 = time.time()
            dec = native.decompress(comp, 0)
            t2 = time.time()
        else:
            from avrecode_tpu.codec import compress, decompress

            t0 = time.time()
            comp = compress(data, scope="gop")
            t1 = time.time()
            dec = decompress(comp)
            t2 = time.time()
        ok = dec == data
        if not ok:
            failures += 1
        total_in += len(data)
        total_out += len(comp)
        total_ct += t1 - t0
        total_dt += t2 - t1
        detail["files"].append(
            {
                "file": os.path.basename(p),
                "mb": round(len(data) / 1e6, 3),
                "ratio_pct": round(100 * len(comp) / len(data), 2),
                "compress_mb_s": round(len(data) / 1e6 / max(t1 - t0, 1e-9), 3),
                "decompress_mb_s": round(len(data) / 1e6 / max(t2 - t1, 1e-9), 3),
                "roundtrip": "OK" if ok else "FAIL",
            }
        )
        log(detail["files"][-1])

    host_mb_s = total_in / 1e6 / max(total_ct, 1e-9)
    host_ratio = 100.0 * total_out / max(total_in, 1)
    dev = bench_device(paths)
    if dev:
        dev["card"] = card()
        detail["device"] = dev
        # the device corpus rides substream_bins=CORPUS_B (lane-parallel
        # coder resets), a deliberate format tradeoff vs the host's single
        # stream — surface the ratio delta explicitly instead of leaving
        # two different corpus-ratio numbers in one file
        dev["ratio_delta_vs_host_pts"] = round(
            dev["ratio_pct"] - host_ratio, 2)
        log("device headline:", dev.get("compress_mb_s"), "MB/s,",
            "ratio delta vs host: %+.2f pts (sub-stream coder resets)"
            % dev["ratio_delta_vs_host_pts"])

    # HEADLINE: the fastest clean path of the two
    use_dev = (bool(dev) and dev.get("roundtrip_failures") == 0
               and dev.get("compress_mb_s", 0) > host_mb_s)
    if use_dev:
        ratio = dev["ratio_pct"]
        value = dev["compress_mb_s"]
    else:
        ratio = 100.0 * total_out / max(total_in, 1)
        value = 0.0 if failures else round(host_mb_s, 3)
    saving = 100.0 - ratio
    result = {
        "metric": "recode MB/s per chip; compression ratio %; bit-exact roundtrip pass rate",
        "value": value,
        "unit": "MB/s",
        # target band: >=5% size reduction (BASELINE.md); 1.0 == on target
        "vs_baseline": round(saving / 5.0, 3) if not failures else 0.0,
        "path": "device" if use_dev else "host",
        "ratio_pct": round(ratio, 2),
        "space_saving_pct": round(saving, 2),
        "host_compress_mb_s": round(host_mb_s, 3),
        # headline-level honesty about the device capture: all measured
        # pass speeds (best first), not just the min used for the value
        "device_pass_mb_s": (dev or {}).get("pass_mb_s"),
        "decompress_mb_s": round(total_in / 1e6 / max(total_dt, 1e-9), 3),
        "roundtrip_failures": failures + (dev or {}).get("roundtrip_failures", 0),
        "native": bool(native),
        "detail": detail,
    }
    print(json.dumps(result), flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
