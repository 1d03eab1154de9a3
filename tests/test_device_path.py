"""Differential tests: the JAX device path (estimator scan + range-encoder
scan) must produce streams BYTE-IDENTICAL to the host RecodeModel +
RangeEncoder pair, on synthetic traces and on real traces extracted from an
x264 clip."""

import os
import random
import subprocess

import numpy as np
import pytest

from avrecode_tpu.models.h264_model import RecodeModel
from avrecode_tpu.models.trace import TraceModel
from avrecode_tpu.ops.estimator_jax import encode_slices, stream_bytes

DATA = os.path.join(os.path.dirname(__file__), "..", "data")
GEN = os.path.join(os.path.dirname(__file__), "..", "tools", "genvideo")


def host_encode(trace):
    """Encode a TraceModel's recorded trace with the host model."""
    m = RecodeModel("encode")
    inv = {v: k for k, v in trace.slot_of.items()}
    for slot, bit, pcab in zip(trace.slots, trace.bits, trace.pcabs):
        m.put_bit(inv[slot], bit, pcab if pcab else None)
    return m.finish()


def device_encode(traces, pad_t=None, pad_s=None):
    """Batch-encode a list of TraceModels on the device path."""
    T = pad_t or max(max((len(t) for t in traces), default=1), 1)
    S = pad_s or max(max((len(t.limits) for t in traces), default=1), 1)
    n = len(traces)
    slots = np.zeros((n, T), np.int32)
    bits = np.zeros((n, T), np.int32)
    pcabs = np.zeros((n, T), np.int32)
    valid = np.zeros((n, T), np.int32)
    limits = np.full((n, S), 0x60, np.int32)
    cls = np.zeros((n, S), np.int32)
    for i, t in enumerate(traces):
        k = len(t)
        slots[i, :k] = t.slots
        bits[i, :k] = t.bits
        pcabs[i, :k] = t.pcabs
        valid[i, :k] = 1
        limits[i, : len(t.limits)] = t.limits
        cls[i, : len(t.cls)] = t.cls
    out, lens = encode_slices(slots, bits, pcabs, limits, valid, cls)
    return [stream_bytes(out[i], lens[i]) for i in range(n)]


def _random_trace(seed, n):
    rng = random.Random(seed)
    t = TraceModel()
    keys = [("ctx", i) for i in range(40)] + [("sig", 2, i, 0, 1) for i in range(14)]
    biases = {k: rng.random() for k in keys}
    for _ in range(n):
        k = rng.choice(keys)
        bit = 1 if rng.random() < biases[k] else 0
        pcab = rng.choice([None, None, rng.randint(1, 0xFFFF)])
        t.put_bit(k, bit, pcab)
    return t


def test_device_matches_host_random():
    traces = [_random_trace(s, 2000 + 137 * s) for s in range(4)]
    host = [host_encode(t) for t in traces]
    dev = device_encode(traces)
    for i, (h, d) in enumerate(zip(host, dev)):
        assert h == d, f"trace {i}: host {len(h)}B device {len(d)}B"


def test_device_matches_host_carry_stress():
    # near-certain symbols coded against the grain force carry chains
    t = TraceModel()
    for i in range(3000):
        t.put_bit(("ctx", 0), 1 if i % 101 else 0, None)
    h = host_encode(t)
    d = device_encode([t])[0]
    assert h == d


def test_device_matches_host_real_traces():
    """Extract real per-slice traces from an x264 clip, compare streams."""
    from avrecode_tpu.codec import _scan_blocks
    from avrecode_tpu.utils.container import KIND_SLICE, SCOPE_SLICE

    path = os.path.join(DATA, "rt_tiny.mp4")
    if not os.path.exists(path):
        subprocess.run(
            [GEN, path, "160", "128", "8", "30", "4", "0", "26", "11", "1"],
            check=True,
            capture_output=True,
        )
    data = open(path, "rb").read()
    stats = {"slices": 0, "recoded": 0, "bins": 0}
    _, _, blocks, _ = _scan_blocks(data, SCOPE_SLICE, TraceModel, stats, {})
    traces = [b[6] for b in blocks if b[0] == KIND_SLICE]
    assert len(traces) >= 4
    host = [host_encode(t) for t in traces]
    dev = device_encode(traces)
    for i, (h, d) in enumerate(zip(host, dev)):
        assert h == d, f"slice {i}: host {len(h)}B device {len(d)}B"


def test_device_pipeline_gop_scope_matches_host():
    """device_compress(scope='gop') must equal the host gop-scope codec
    byte-for-byte (native extraction + device entropy stage)."""
    import pytest

    from avrecode_tpu.codec import compress, decompress
    from avrecode_tpu.host import native
    from avrecode_tpu.parallel import pipeline

    if not native.available():
        pytest.skip("native library unavailable")
    path = os.path.join(DATA, "rt_gop.mp4")
    if not os.path.exists(path):
        subprocess.run(
            [GEN, path, "192", "160", "12", "30", "4", "1", "26", "9", "1"],
            check=True,
            capture_output=True,
        )
    data = open(path, "rb").read()
    for scope in ("slice", "gop"):
        # default device path: lane-parallel sub-stream coder
        dev = pipeline.device_compress(data, scope=scope)
        assert dev == compress(data, scope=scope, substream_bins=4096), scope
        assert decompress(dev) == data
        # single-stream-per-trace device path (estimator scans)
        dev0 = pipeline.device_compress(data, scope=scope, substream_bins=0)
        assert dev0 == compress(data, scope=scope), scope
        assert decompress(dev0) == data


def test_python_extraction_gop_scope_matches_host():
    """Pure-Python trace extraction covers gop scope (round 3): without the
    native library the Python fallback can still drive the default gop-scope
    device pipeline, producing the host container byte-for-byte."""
    from avrecode_tpu.codec import compress, serialize_container
    from avrecode_tpu.ops.lane_coder import encode_traces_lanes, lane_encode_scan
    from avrecode_tpu.parallel import pipeline

    path = os.path.join(DATA, "rt_gop.mp4")
    if not os.path.exists(path):
        subprocess.run(
            [GEN, path, "192", "160", "12", "30", "4", "1", "26", "9", "1"],
            check=True, capture_output=True,
        )
    data = open(path, "rb").read()
    sps, pps, blocks, traces, _ = pipeline.extract_traces(
        data, use_native=False, scope="gop")
    assert len(traces) >= 2  # several GOPs, one trace each
    envs = encode_traces_lanes(traces, 4096, encode_fn=lane_encode_scan)
    finmap = {id(t): envs[i] for i, t in enumerate(traces)}
    out = serialize_container(
        2, sps, pps, blocks, None,
        finisher=lambda t: t if isinstance(t, bytes) else finmap[id(t)],
        substream_bins=4096,
    )
    assert out == compress(data, scope="gop", substream_bins=4096)


def test_trace_model_snapshot_rollback():
    """A failed slice mid-GOP must restore the recorder exactly: pre+post
    sequence after rollback equals a fresh recorder fed the same bits."""
    a = _random_trace(7, 800)
    snap = a.snapshot()
    rng = random.Random(99)
    for _ in range(300):  # doomed slice: new keys + estimator churn
        a.put_bit(("mvd", rng.randint(0, 30)), rng.randint(0, 1), None)
    a.rollback(snap)
    for i in range(200):
        a.put_bit(("ctx", i % 17), (i * 7) % 3 == 0, None)
    b = _random_trace(7, 800)
    for i in range(200):
        b.put_bit(("ctx", i % 17), (i * 7) % 3 == 0, None)
    assert host_encode(a) == host_encode(b)
    assert (a.slots, a.bits, a.pcabs, a.p1s, a.limits, a.cls) == (
        b.slots, b.bits, b.pcabs, b.p1s, b.limits, b.cls)


def test_device_compress_corpus_matches_per_file():
    # batch-directory pipeline (BASELINE config 4): containers byte-identical
    # to per-file device_compress, roundtrip bit-exact
    from avrecode_tpu.codec import decompress
    from avrecode_tpu.parallel.pipeline import (device_compress,
                                                device_compress_corpus)

    path = os.path.join(DATA, "rt_gop.mp4")
    if not os.path.exists(path):
        subprocess.run(
            [GEN, path, "192", "160", "12", "30", "4", "1", "26", "9", "1"],
            check=True, capture_output=True,
        )
    datas = [open(path, "rb").read(), b"not a video"]
    stats = {}
    outs = device_compress_corpus(datas, scope="gop", substream_bins=4096,
                                  stats=stats)
    for data, comp in zip(datas, outs):
        assert comp == device_compress(data, scope="gop", substream_bins=4096)
        assert decompress(comp) == data


def test_device_decompress_end_to_end():
    """device_decompress: containers decode end-to-end with the entropy
    stage executed by the lane decoder; output byte-identical to the host
    decoder, across scopes/envelopes and both entropy modes (CABAC and
    CAVLC slices)."""
    from avrecode_tpu.codec import compress, decompress
    from avrecode_tpu.parallel.pipeline import device_decompress

    path = os.path.join(DATA, "rt_gop.mp4")
    if not os.path.exists(path):
        subprocess.run(
            [GEN, path, "192", "160", "12", "30", "4", "1", "26", "9", "1"],
            check=True, capture_output=True,
        )
    cpath = os.path.join(DATA, "cavlc_rt.mp4")
    if not os.path.exists(cpath):
        subprocess.run(
            [GEN, cpath, "192", "160", "10", "30", "5", "0", "26", "3", "1",
             "cabac=0"],
            check=True, capture_output=True,
        )
    for f, kw in ((path, dict(scope="gop", substream_bins=4096)),
                  (path, dict(scope="gop")),
                  (cpath, dict(scope="slice", substream_bins=512)),
                  (cpath, dict(scope="stream"))):
        data = open(f, "rb").read()
        blob = compress(data, **kw)
        assert device_decompress(blob) == data == decompress(blob)


@pytest.mark.parametrize("env_dir", [None, "custom"])
def test_compile_cache_placement(tmp_path, env_dir):
    """Importing the pipeline leaves JAX_COMPILATION_CACHE_DIR to JAX when it
    is set, and otherwise keeps the cache at the checkout's build/jaxcache."""
    import json
    import sys

    root = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    if env_dir:
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / env_dir)
    code = (
        "import json, jax, avrecode_tpu.parallel.pipeline; c = jax.config; "
        "print(json.dumps([c.jax_compilation_cache_dir, "
        "c.jax_persistent_cache_min_compile_time_secs]))"
    )
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=root,
                       capture_output=True, text=True, check=True)
    cache_dir, min_secs = json.loads(r.stdout.strip().splitlines()[-1])
    if env_dir:
        assert cache_dir == str(tmp_path / env_dir)
        assert min_secs == 1.0  # JAX's default: nothing set in code
    else:
        assert cache_dir == os.path.join(root, "build", "jaxcache")
        assert min_secs == 2.0
