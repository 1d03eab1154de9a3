"""Lane-parallel estimator-free coder: every path (XLA scan, Pallas kernel
in interpret mode, numpy finalize, device finalize) must produce sub-stream
envelopes BYTE-IDENTICAL to the host RecodeModel(substream_bins=B).

The host model is the semantics oracle; traces carry the exact per-bin
probability (TraceModel mirrors the model's estimator arithmetic), so the
device coder is a bare range coder — SURVEY.md §2 bin-level parallelism."""

import os
import random
import subprocess

import numpy as np
import pytest

from avrecode_tpu.models.h264_model import RecodeModel
from avrecode_tpu.models.trace import TraceModel
from avrecode_tpu.ops.lane_coder import (
    choose_lane_kernel,
    encode_traces_lanes,
    finalize_lanes,
    lane_encode_pallas,
    lane_encode_scan,
    split_lanes,
)

DATA = os.path.join(os.path.dirname(__file__), "..", "data")
GEN = os.path.join(os.path.dirname(__file__), "..", "tools", "genvideo")


def _drive(seq, B):
    """Feed one (key, bit, pcab) sequence to both the host model and the
    trace recorder; return (host envelope, trace)."""
    m = RecodeModel("encode", substream_bins=B)
    t = TraceModel()
    for k, bit, pcab in seq:
        m.put_bit(k, bit, pcab)
        t.put_bit(k, bit, pcab)
    return m.finish(), t


def _mk(seed, n):
    rng = random.Random(seed)
    keys = [("ctx", i) for i in range(40)] + [("sig", 2, i, 0, 1) for i in range(14)]
    biases = {k: rng.random() for k in keys}
    return [
        (
            k,
            1 if rng.random() < biases[k] else 0,
            rng.choice([None, None, rng.randint(1, 0xFFFF)]),
        )
        for k in [rng.choice(keys) for _ in range(n)]
    ]


@pytest.mark.parametrize("B", [64, 257, 1024])
@pytest.mark.parametrize("n", [0, 1, 63, 64, 65, 1024, 5000])
def test_scan_matches_host(B, n):
    host, t = _drive(_mk(B * 1000 + n, n), B)
    assert encode_traces_lanes([t], B, encode_fn=lane_encode_scan)[0] == host


def test_pallas_interpret_matches_host():
    host, t = _drive(_mk(42, 3000), 512)
    dev = encode_traces_lanes([t], 512, interpret=True)[0]
    assert dev == host


def _ragged_problem(case):
    rng = np.random.RandomState(len(case))
    if case == "lanes_not_block_multiple":
        L, B = 130, 64
        lens = rng.randint(1, B + 1, L)
    elif case == "zero_length_lanes":
        L, B = 9, 40
        lens = rng.randint(0, B + 1, L)
        lens[::2] = 0
    elif case == "odd_bins":
        L, B = 5, 33
        lens = np.full(L, B)
        lens[-1] = 1
    else:  # carry_stress: near-certain symbols coded against the grain
        L, B = 3, 600
        lens = np.array([B, B - 7, 300])
    if case == "carry_stress":
        p1 = np.full((L, B), 0xFFF0)
        bit = np.ones((L, B), np.int64)
        bit[:, ::97] = 0
    else:
        p1 = rng.randint(1, 0xFFFF, (L, B))
        bit = rng.randint(0, 2, (L, B))
    return (p1 | (bit << 16)).astype(np.int32), lens.astype(np.int32)


@pytest.mark.parametrize(
    "case",
    ["lanes_not_block_multiple", "zero_length_lanes", "odd_bins",
     "carry_stress"],
)
def test_kernel_interpret_matches_scan_ragged(case):
    """The Pallas kernel (Triton route, interpret mode) pads lanes to its
    block and bins to its unroll; tokens must equal the XLA scan's."""
    bitp1, lens = _ragged_problem(case)
    s = lane_encode_scan(bitp1, lens)
    p = lane_encode_pallas(bitp1, lens, interpret=True)
    for a, b in zip(s, p):
        assert np.asarray(b).shape == np.asarray(a).shape
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize(
    "platform,kernel", [("cpu", "scan"), ("gpu", "pallas"), ("rocm", None)]
)
def test_choose_lane_kernel(monkeypatch, platform, kernel):
    import jax

    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    if kernel is None:
        with pytest.raises(RuntimeError, match="no lane kernel"):
            choose_lane_kernel()
    else:
        assert choose_lane_kernel() == kernel


def test_dispatch_group_sizes():
    """Full groups of GROUP_LANES (per device), then one power-of-two tail
    of at least LANE_BLOCK lanes per device."""
    from avrecode_tpu.ops.lane_coder import (GROUP_LANES, LANE_BLOCK,
                                             _group_sizes)

    assert list(_group_sizes(1)) == [(0, 1, LANE_BLOCK)]
    L = 2 * GROUP_LANES + LANE_BLOCK + 1
    assert list(_group_sizes(L)) == [
        (0, GROUP_LANES, GROUP_LANES),
        (GROUP_LANES, 2 * GROUP_LANES, GROUP_LANES),
        (2 * GROUP_LANES, L, 2 * LANE_BLOCK),
    ]
    # under a 4-device mesh every group splits evenly over the devices
    assert list(_group_sizes(4 * GROUP_LANES + 3, 4)) == [
        (0, 4 * GROUP_LANES, 4 * GROUP_LANES),
        (4 * GROUP_LANES, 4 * GROUP_LANES + 3, 4 * LANE_BLOCK),
    ]


def test_mesh_sharded_pipeline_matches_single_device():
    """Under a mesh the whole device pipeline (kernel + finalize) is
    shard_mapped over the lane axis; the streams must equal the
    single-device ones (kernel in interpret mode, 4 virtual devices)."""
    import jax

    from avrecode_tpu.ops.lane_coder import lane_streams_device
    from avrecode_tpu.parallel.pipeline import make_mesh

    if len(jax.devices()) < 4:
        pytest.skip("needs the virtual CPU mesh (conftest)")
    bitp1, lens = _ragged_problem("lanes_not_block_multiple")
    one = lane_streams_device(bitp1, lens, interpret=True)
    four = lane_streams_device(bitp1, lens, interpret=True, mesh=make_mesh(4))
    assert four == one == finalize_lanes(*lane_encode_scan(bitp1, lens), lens)


@pytest.mark.gpu
def test_kernel_compiled_matches_scan_on_gpu():
    """The kernel as compiled for the card (not interpreted) equals the XLA
    scan run on the CPU device; run with `pytest -m gpu tests/`."""
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: run `python -m pytest -m gpu tests/`")
    cpu = jax.devices("cpu")[0]
    for case in ["lanes_not_block_multiple", "zero_length_lanes", "odd_bins",
                 "carry_stress"]:
        bitp1, lens = _ragged_problem(case)
        p = lane_encode_pallas(bitp1, lens)
        s = lane_encode_scan(jax.device_put(bitp1, cpu),
                             jax.device_put(lens, cpu))
        for a, b in zip(s, p):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_carry_stress():
    """Near-certain symbols coded against the grain force carry chains and
    0xFF runs through sub-stream boundaries."""
    m = RecodeModel("encode", substream_bins=128)
    t = TraceModel()
    for i in range(3000):
        bit = 1 if i % 101 else 0
        m.put_bit(("ctx", 0), bit)
        t.put_bit(("ctx", 0), bit)
    assert encode_traces_lanes([t], 128, encode_fn=lane_encode_scan)[0] == m.finish()


def test_multi_trace_batch():
    traces, hosts = [], []
    for s in range(5):
        host, t = _drive(_mk(s, 700 + 631 * s), 256)
        hosts.append(host)
        traces.append(t)
    devs = encode_traces_lanes(traces, 256, encode_fn=lane_encode_scan)
    assert devs == hosts


def test_finalize_matches_scan_and_interpret():
    """The two kernels must agree token-for-token, and the numpy finalize
    must be the identity bridge between them."""
    _, t = _drive(_mk(9, 2000), 320)
    bitp1, lens, spans = split_lanes([t], 320)
    s = lane_encode_scan(np.asarray(bitp1), np.asarray(lens))
    p = lane_encode_pallas(np.asarray(bitp1), np.asarray(lens), interpret=True)
    for a, b in zip(s, p):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert finalize_lanes(*s, lens) == finalize_lanes(*p, lens)


def test_device_finalize_matches_numpy():
    """On-device finalize (packed scatter + ripple) == numpy finalize."""
    from avrecode_tpu.ops.lane_coder import lane_streams_device

    _, t = _drive(_mk(13, 4000), 512)
    bitp1, lens, _ = split_lanes([t], 512)
    s = lane_encode_scan(np.asarray(bitp1), np.asarray(lens))
    expect = finalize_lanes(*s, lens)
    got = lane_streams_device(bitp1, lens, interpret=True)
    assert got[: len(expect)] == expect


def test_device_finalize_overflow_fallback():
    """Streams denser than the transfer bound must fall back to the exact
    host finalize (bits_per_byte=1000 makes M tiny)."""
    from avrecode_tpu.ops.lane_coder import lane_streams_device

    host, t = _drive(_mk(17, 2000), 512)
    bitp1, lens, _ = split_lanes([t], 512)
    s = lane_encode_scan(np.asarray(bitp1), np.asarray(lens))
    expect = finalize_lanes(*s, lens)
    got = lane_streams_device(bitp1, lens, interpret=True, bits_per_byte=1000)
    assert got[: len(expect)] == expect


def test_real_clip_gop_scope_envelopes():
    """Per-GOP traces from a real x264 clip -> lane envelopes must equal
    the host compress(substream_bins=B) container's stream blobs."""
    from avrecode_tpu.host import native

    if not native.available():
        pytest.skip("native library not built")
    path = os.path.join(DATA, "rt_gop.mp4")
    if not os.path.exists(path):
        subprocess.run(
            [GEN, path, "192", "160", "12", "30", "4", "1", "26", "9", "1"],
            check=True,
            capture_output=True,
        )
    data = open(path, "rb").read()
    B = 2000
    _, _, _, traces = native.extract(data, "gop")
    assert traces
    envs = encode_traces_lanes(traces, B, encode_fn=lane_encode_scan)
    for t, env in zip(traces, envs):
        m = RecodeModel("encode", substream_bins=B)
        # replay the recorded (bit, p1) pairs through the host coder path
        # via direct sub-stream encoding to cross-check the envelope
        from avrecode_tpu.models.h264_model import _make_envelope
        from avrecode_tpu.ops.rangecoder import RangeEncoder

        streams = []
        rc = RangeEncoder()
        nb = 0
        for bit, p1 in zip(t.bits, t.p1s):
            if nb == B:
                streams.append(rc.finish())
                rc = RangeEncoder()
                nb = 0
            rc.put(int(bit), int(p1))
            nb += 1
        streams.append(rc.finish())
        assert env == _make_envelope(streams)


def test_p1_idx_pack_roundtrip():
    """12-bit squash-index transfer (pack_p1_idx): exact p1 reconstruction
    for every value in the squash image, zeros treated as padding, and a
    clean fallback signal for foreign p1 values."""
    from avrecode_tpu.ops.lane_coder import _squash_tables, pack_p1_idx

    sq, _, _ = _squash_tables()
    rng = np.random.default_rng(7)
    idx = rng.integers(0, 4096, size=(4, 512))
    p1 = sq[idx].astype(np.uint16)
    p1[0, :10] = 0  # lane/bin padding
    pk, ok = pack_p1_idx(p1)
    assert ok and pk.shape == (4, 512 // 2 * 3) and pk.dtype == np.uint8
    # numpy mirror of the device unpack in _lane_pipeline_idx_jit
    b = pk.astype(np.int64).reshape(4, -1, 3)
    ev = b[:, :, 0] | ((b[:, :, 1] & 0xF) << 8)
    od = (b[:, :, 1] >> 4) | (b[:, :, 2] << 4)
    rec = sq[np.stack([ev, od], axis=-1).reshape(4, -1)]
    mask = p1 != 0
    assert (rec[mask] == p1[mask]).all()
    bad = p1.copy()
    bad[1, 5] = 2  # below the squash image floor (22): foreign source
    _, ok2 = pack_p1_idx(bad)
    assert not ok2


def test_compact_idx_pipeline_matches_host():
    """The GPU dispatch path (split_lanes_recs -> pack_p1_idx ->
    _lane_pipeline, kernel in interpret mode) must produce envelopes
    byte-identical to the host coder on a real clip's native traces."""
    from avrecode_tpu.host import native
    from avrecode_tpu.models.h264_model import _make_envelope
    from avrecode_tpu.ops.lane_coder import (
        lane_streams_device_compact, split_lanes_recs)

    if not native.available():
        pytest.skip("native library not built")
    path = os.path.join(DATA, "rt_gop.mp4")
    if not os.path.exists(path):
        subprocess.run(
            [GEN, path, "192", "160", "12", "30", "4", "1", "26", "9", "1"],
            check=True,
            capture_output=True,
        )
    data = open(path, "rb").read()
    B = 512
    _, _, _, traces = native.extract(data, "gop", want_slots=False)
    assert traces and all(hasattr(t, "recs32") for t in traces)
    host_envs = encode_traces_lanes(traces, B, encode_fn=lane_encode_scan)
    p1u16, bitw, lens, spans = split_lanes_recs(traces, B)
    streams = lane_streams_device_compact(p1u16, bitw, lens, interpret=True)
    envs = [_make_envelope(streams[lo:hi]) for lo, hi in spans]
    assert envs == host_envs


def test_cross_file_lane_batcher_matches_per_file():
    """Corpus lane batching (_LaneBatcher): lanes of several 'files' share
    dispatch groups; the global stream list must equal the per-file
    dispatch results row for row."""
    from avrecode_tpu.host import native
    from avrecode_tpu.ops.lane_coder import (
        lane_dispatch_compact, lane_streams_device_compact, split_lanes_recs)
    from avrecode_tpu.parallel.pipeline import _LaneBatcher

    if not native.available():
        pytest.skip("native library not built")
    path = os.path.join(DATA, "rt_gop.mp4")
    if not os.path.exists(path):
        subprocess.run(
            [GEN, path, "192", "160", "12", "30", "4", "1", "26", "9", "1"],
            check=True, capture_output=True,
        )
    data = open(path, "rb").read()
    B = 512
    _, _, _, traces = native.extract(data, "gop", want_slots=False)
    p1u16, bitw, lens, _ = split_lanes_recs(traces, B)
    per_file = lane_streams_device_compact(p1u16, bitw, lens, interpret=True)

    def dispatch(p, b, l):
        return lane_dispatch_compact(p, b, l, interpret=True)

    # tiny group size (two rows) forces splits across segment boundaries
    bat = _LaneBatcher(dispatch, 2)
    ranges = []
    for lo in range(0, p1u16.shape[0], 3):  # three "files" of 3 rows each
        hi = min(lo + 3, p1u16.shape[0])
        ranges.append(bat.add(p1u16[lo:hi], bitw[lo:hi], lens[lo:hi]))
    streams = bat.finish()
    assert len(streams) == len(per_file)
    assert streams == per_file
    assert ranges[0][0] == 0 and ranges[-1][1] == p1u16.shape[0]
