"""Mesh-parallel compression pipeline.

The parallel decomposition designed in SURVEY.md §2 (the reference is
single-threaded by construction; parallelism is designed in, not ported):

  host   — container demux + slice parse + trace extraction (serial FSM,
           C++/Python; parse order defines the model-prior state),
  device — model scans + range encoding per independent trace (GOP or
           slice, per the container model_scope), batched and sharded over
           a jax.sharding.Mesh 'dp' axis.  Traces are entropy-independent
           by format, so the only cross-device communication is the billing
           psum — boundary/frame state stays host-side where the parse
           lives.

device_compress(data, scope=...) produces a container BYTE-IDENTICAL to
codec.compress(data, scope=...) — asserted in tests — so the device path is
not a sketch: it is the same format, the same streams, computed on the
device (the lane kernel that ops.lane_coder.choose_lane_kernel picks).
"""


import os

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

# Persistent compilation cache: where JAX_COMPILATION_CACHE_DIR is set, JAX
# reads it and nothing is set here; otherwise a fixed in-checkout path, so
# later processes of the same checkout load compiled executables instead of
# compiling again.
if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    jax.config.update(
        "jax_compilation_cache_dir",
        os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "..",
                                     "build", "jaxcache")),
    )
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 2.0)

from ..codec import _scan_blocks, serialize_container
from ..models.h264_model import RecodeModel
from ..models.trace import N_CLS, TraceModel
from ..ops.estimator_jax import encode_slices, stream_bytes
from ..utils.container import KIND_SLICE, SCOPE_GOP, SCOPE_SLICE


def extract_traces(data, use_native=None, scope="slice", threads=0,
                   want_slots=True):
    """Host stage: parse + verify all slices, returning (container pieces,
    traces).  Slice blocks reference their trace in the stream slot (GOP
    scope: one trace per GOP on its first slice block, b"" continuations).

    Uses the native (C++) extractor when built — ~50x the Python parser —
    falling back to the Python reference implementation (both scopes).
    threads: 0=auto (parallel GOP jobs, gop scope), 1=serial."""
    if use_native is None or use_native:
        try:
            from ..host import native

            if native.available():
                sps, pps, blocks, traces = native.extract(
                    bytes(data), scope, threads=threads,
                    want_slots=want_slots,
                )
                return sps, pps, blocks, traces, {"native": True}
        except Exception:
            if use_native:
                raise
    stats = {"slices": 0, "recoded": 0, "bins": 0}
    scope_id = SCOPE_SLICE if scope == "slice" else SCOPE_GOP
    sps, pps, blocks, _ = _scan_blocks(data, scope_id, TraceModel, stats, {})
    # GOP scope: one trace per GOP on its first slice block; b""
    # continuation markers are serialized as-is, not encoded
    traces = [b[6] for b in blocks
              if b[0] == KIND_SLICE and not isinstance(b[6], bytes)]
    return sps, pps, blocks, traces, stats


def pack_traces(traces, pad_multiple=8):
    """Pad/stack traces to [S, T] device arrays (S padded to the mesh).
    Returns encode_slices' positional argument order
    (slots, bits, pcabs, limits, valid, cls)."""
    n = len(traces)
    if n == 0:
        return None
    T = max(max(len(t) for t in traces), 1)
    NS = max(max(len(t.limits) for t in traces), 1)
    S = -(-n // pad_multiple) * pad_multiple
    slots = np.zeros((S, T), np.int32)
    bits = np.zeros((S, T), np.int32)
    pcabs = np.zeros((S, T), np.int32)
    valid = np.zeros((S, T), np.int32)
    limits = np.full((S, NS), 0x60, np.int32)
    cls = np.zeros((S, NS), np.int32)
    for i, t in enumerate(traces):
        k = len(t)
        slots[i, :k] = t.slots
        bits[i, :k] = t.bits
        pcabs[i, :k] = t.pcabs
        valid[i, :k] = 1
        limits[i, : len(t.limits)] = t.limits
        cls[i, : len(t.cls)] = t.cls
    assert cls.max(initial=0) < N_CLS, "key-class id out of mixer weight range"
    return slots, bits, pcabs, limits, valid, cls


def make_mesh(n_devices=None):
    devs = jax.devices()
    if n_devices:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), ("dp",))


def device_compress(data, mesh=None, scope=None, substream_bins=4096):
    """Full compression with the device entropy stage.

    scope: "gop" (default with native extraction; best ratio, GOP-parallel)
    or "slice" (finest parallel grain).

    substream_bins > 0 (default) selects the LANE-PARALLEL estimator-free
    coder: the recorded exact per-bin probabilities drive a bare range
    coder, one sub-stream per lane (ops.lane_coder.encode_traces_lanes;
    lane axis sharded over `mesh` when given).  Output is byte-identical to
    codec.compress(scope=..., substream_bins=...).

    substream_bins=0 keeps the single-stream-per-trace device path: the
    estimator scans of ops/estimator_jax.py, trace axis sharded over
    `mesh` when given."""
    data = bytes(data)
    if scope is None:
        from ..host import native

        scope = "gop" if native.available() else "slice"
    # the lane-parallel coder (substream_bins > 0) reads only (bit, p1):
    # skip the export-time slot remap pass in the native extractor
    sps, pps, blocks, traces, stats = extract_traces(
        data, scope=scope, want_slots=not substream_bins)
    if substream_bins == "auto":
        from ..ops.lane_coder import auto_substream_bins

        substream_bins = auto_substream_bins(sum(len(t) for t in traces))
    if not traces:
        from ..codec import compress

        return compress(data, scope=scope, substream_bins=substream_bins)
    scope_id = SCOPE_SLICE if scope == "slice" else 2  # SCOPE_GOP
    if substream_bins:
        from ..ops.lane_coder import encode_traces_lanes

        streams = encode_traces_lanes(traces, substream_bins, mesh=mesh)
    else:
        arrays = pack_traces(
            traces, pad_multiple=(mesh.devices.size if mesh else 1))
        if mesh is not None:
            sharding = NamedSharding(mesh, P("dp"))
            arrays = tuple(jax.device_put(a, sharding) for a in arrays)
        out, lens = encode_slices(*arrays)
        out = np.asarray(out)
        lens = np.asarray(lens)
        streams = [stream_bytes(out[i], lens[i]) for i in range(len(traces))]
    finmap = {id(t): streams[i] for i, t in enumerate(traces)}

    def finisher(t):
        return t if isinstance(t, bytes) else finmap[id(t)]

    return serialize_container(
        scope_id, sps, pps, blocks, None, finisher=finisher,
        substream_bins=substream_bins,
    )


class _LaneBatcher:
    """Cross-file lane accumulator: files append their lane rows to one
    global row stream; full GROUP_LANES-sized dispatch groups flush as they
    fill, so many small files share dispatches instead of each paying for
    a padded tail group.  Row order is append order, so each file's lanes
    occupy one contiguous global range."""

    def __init__(self, dispatch_fn, big):
        self.dispatch = dispatch_fn
        self.big = big
        self.segs = []  # undispatched (p1u16, bitw, lens) row segments
        self.acc = 0
        self.pending = []  # dispatched group handles, global row order
        self.rows = 0  # total rows appended

    def add(self, p1u16, bitw, lens):
        """Append one file's rows; returns (global_lo, global_hi)."""
        lo = self.rows
        self.rows += p1u16.shape[0]
        self.segs.append([p1u16, bitw, lens])
        self.acc += p1u16.shape[0]
        while self.acc >= self.big:
            self._flush(self.big)
        return lo, self.rows

    def _take(self, g):
        """Pop exactly g rows off the segment queue (splitting the last)."""
        parts = [[], [], []]
        need = g
        while need:
            seg = self.segs[0]
            n = seg[0].shape[0]
            if n <= need:
                for k in range(3):
                    parts[k].append(seg[k])
                self.segs.pop(0)
                need -= n
            else:
                for k in range(3):
                    parts[k].append(seg[k][:need])
                    seg[k] = seg[k][need:]
                need = 0
        self.acc -= g
        return (np.concatenate(parts[0]), np.concatenate(parts[1]),
                np.concatenate(parts[2]))

    def _flush(self, g):
        p1u16, bitw, lens = self._take(g)
        self.pending.extend(self.dispatch(p1u16, bitw, lens))

    def finish(self):
        """Dispatch the remainder, then collect -> global stream list."""
        from ..ops.lane_coder import lane_collect

        if self.acc:
            self._flush(self.acc)
        return lane_collect(self.pending)


def device_compress_corpus(inputs, scope="gop", substream_bins=4096,
                           stats=None):
    """Batch-directory device compression (BASELINE config 4): compress many
    files through ONE overlapped device pipeline instead of per-file
    device_compress calls.

    Per file the host extracts + packs, then APPENDS its lanes to the
    cross-file batcher — full dispatch groups launch asynchronously as
    they fill, so host parse (CPU threads) overlaps device compute and
    transfers, and small files share dispatches.  Output containers are
    byte-identical to device_compress(f, scope=..., substream_bins=...)
    per file.

    inputs: list of paths or bytes.  Returns list of container bytes.
    stats (optional dict) receives {'dispatches': N, 'bins': M}."""
    from ..models.h264_model import _make_envelope
    from ..ops.lane_coder import (GROUP_LANES, encode_traces_lanes,
                                  lane_dispatch_compact, split_lanes_recs)

    datas = [
        open(x, "rb").read() if isinstance(x, str) else bytes(x)
        for x in inputs
    ]
    scope_id = SCOPE_SLICE if scope == "slice" else 2  # SCOPE_GOP
    # biggest files first: their uploads and kernels start while the
    # remaining files extract on the host CPU
    order = sorted(range(len(datas)), key=lambda i: -len(datas[i]))
    # one-deep extraction prefetch: the native extractor releases the GIL,
    # so file i+1 parses while file i packs/dispatches
    import concurrent.futures as _fut

    metas_by_idx = [None] * len(datas)
    batcher = _LaneBatcher(lane_dispatch_compact, GROUP_LANES)
    n_bins = 0
    with _fut.ThreadPoolExecutor(max_workers=1) as pool:
        nxt = None
        for k, idx in enumerate(order):
            cur = nxt or pool.submit(
                extract_traces, datas[idx], scope=scope, want_slots=False)
            nxt = (
                pool.submit(extract_traces, datas[order[k + 1]], scope=scope,
                            want_slots=False)
                if k + 1 < len(order) else None
            )
            data = datas[idx]
            sps, pps, blocks, traces, _ = cur.result()
            if traces and all(hasattr(t, "recs32") for t in traces):
                p1u16, bitw, lens, spans = split_lanes_recs(
                    traces, substream_bins)
                rows = batcher.add(p1u16, bitw, lens)
                n_bins += sum(len(t) for t in traces)
                metas_by_idx[idx] = ("pend", data, sps, pps, blocks, traces,
                                     spans, rows)
            else:
                metas_by_idx[idx] = ("host", data, sps, pps, blocks, traces,
                                     None, None)
    # drain all device work (transfers/compute progressed in the background)
    all_streams = batcher.finish()
    outs = []
    for kind, data, sps, pps, blocks, traces, spans, rows in metas_by_idx:
        if kind == "host":
            if not traces:
                from ..codec import compress

                outs.append(compress(data, scope=scope,
                                     substream_bins=substream_bins))
                continue
            envs = encode_traces_lanes(traces, substream_bins)
        else:
            streams = all_streams[rows[0]:rows[1]]
            envs = [_make_envelope(streams[lo:hi]) for lo, hi in spans]
        finmap = {id(t): envs[i] for i, t in enumerate(traces)}

        def finisher(t, finmap=finmap):
            return t if isinstance(t, bytes) else finmap[id(t)]

        outs.append(serialize_container(
            scope_id, sps, pps, blocks, None, finisher=finisher,
            substream_bins=substream_bins,
        ))
    if stats is not None:
        stats["dispatches"] = len(batcher.pending)
        stats["bins"] = n_bins
    return outs


def multichip_step(mesh, slots, bits, pcabs, limits, valid, cls=None):
    """One sharded device step with a cross-chip billing collective —
    the SPMD program the driver dry-runs on an N-device mesh."""
    from jax import shard_map

    if cls is None:
        cls = jnp.zeros_like(limits)

    def local(slots, bits, pcabs, limits, valid, cls):
        out, lens = encode_slices(slots, bits, pcabs, limits, valid, cls)
        # cross-chip ledger reduction (the device-side "billing" collective)
        total = jax.lax.psum(jnp.sum(lens), "dp")
        return out, lens, total

    fn = shard_map(
        local,
        mesh=mesh,
        in_specs=(P("dp"),) * 6,
        out_specs=(P("dp"), P("dp"), P()),
    )
    return jax.jit(fn)(slots, bits, pcabs, limits, valid, cls)


# ------------------------------------------------------------------------
# Decode direction: device_decompress — the product mirror of
# device_compress (reference decompressor parity: recode.cpp:1319-1598 is
# a first-class driver there).
#
# The entropy decode of a recoded container is a serial recurrence through
# the MODEL (each bin's probability depends on every previously decoded
# bin via the parser state — DEVICE_DECODE.md), so the probability
# schedule must be derived host-side.  The pipeline therefore runs three
# phases:
#   A  host model pass: decompress the container with a RECORDING model
#      that captures each scope unit's per-bin probability schedule,
#   B  device entropy decode: every unit's sub-streams decode
#      lane-parallel on the chip (ops/lane_decoder.lane_decode_scan, the
#      exact int32 mirror of the host range decoder),
#   C  host assembly: the container is decoded AGAIN with the
#      device-produced bins feeding the parser + CABAC re-encoder (no
#      model arithmetic at all in this pass), producing the output bytes.
# The returned file is built from device-decoded bins end-to-end and is
# byte-identical to codec.decompress(blob).  This is a capability/
# verification surface, not the speed path: phase A already contains a
# full host entropy decode (fundamental, not an implementation artifact).


class _RecordingModel(RecodeModel):
    """RecodeModel('decode') that records the (p1, bit) schedule."""

    def __init__(self, data, substream_bins):
        super().__init__("decode", data, substream_bins=substream_bins)
        self.raw = data
        self.rec_p1s = []
        self.rec_bits = []

    def get_bit(self, key, pcab=None):
        self._boundary()
        e, p1, mixctx = self._prob_update(key, pcab)
        bit = self.rc.get(p1)
        self.rec_p1s.append(p1)
        self.rec_bits.append(bit)
        self._update_mix(mixctx, p1, bit)
        self._adapt(key, e, bit)
        return bit


class _FeedModel:
    """Serves pre-decoded bins to the parser; no model arithmetic."""

    def __init__(self, bits):
        self.bits = bits
        self.i = 0

    def get_bit(self, key, pcab=None):
        b = int(self.bits[self.i])
        self.i += 1
        return b

    def get_nnz(self, cat, max_coeff, prior):
        # bit-count mirror of RecodeModel.get_nnz
        v = 0
        for _ in range((max_coeff - 1).bit_length()):
            v = (v << 1) | self.get_bit(None)
        return v + 1


def device_decompress(blob):
    """Decompress a container with the entropy decode executed on the
    device (lane-parallel across sub-streams); output is byte-identical
    to codec.decompress(blob).  Raises if the device decode disagrees
    with the host model pass (it cannot, short of hardware fault: the
    kernel is the exact integer mirror)."""
    from ..codec import decompress as _host_decompress
    from ..ops.lane_decoder import decode_streams_lanes

    blob = bytes(blob)
    # phase A: host model pass, recording each unit's probability schedule
    units = []

    def rec_factory(data, B):
        m = _RecordingModel(data, B)
        units.append(m)
        return m

    host_out = _host_decompress(blob, _model_factory=rec_factory)

    # phase B: device lane decode, one dispatch per scope unit
    unit_bits = []
    for m in units:
        n = len(m.rec_p1s)
        if n == 0:
            unit_bits.append([])
            continue
        B = m.B or n
        streams = (m.streams if m.B else [m.raw]) or [b""]
        n_lanes = -(-n // B)
        lens = [min(B, n - i * B) for i in range(n_lanes)]
        p1s = np.zeros((n_lanes, B), np.int32)
        for i in range(n_lanes):
            p1s[i, : lens[i]] = m.rec_p1s[i * B : i * B + lens[i]]
        bits = np.asarray(
            decode_streams_lanes(list(streams[:n_lanes]), p1s,
                                 np.asarray(lens, np.int32)))
        flat = []
        for i in range(n_lanes):
            flat.extend(int(b) for b in bits[i, : lens[i]])
        unit_bits.append(flat)

    # phase C: assembly from the device-decoded bins (parser + CABAC
    # re-encode only; any divergence surfaces as a parse/size error)
    it = iter(unit_bits)

    def feed_factory(data, B):
        return _FeedModel(next(it))

    out = _host_decompress(blob, _model_factory=feed_factory)
    if out != host_out:
        raise RuntimeError("device decode diverged from host model pass")
    return out
