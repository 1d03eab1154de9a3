"""Lane-parallel, estimator-free device entropy coder.

Two format/trace decisions make the device coder a bare range coder:

  * trace records carry the EXACT per-bin model probability p1 (the host
    recorder adapts estimators exactly like the encoder), so device coding
    needs NO estimator state — each bin is (bit, p1) -> pure integer range
    coder arithmetic;
  * container v2 sub-streams: the coder (not the model) resets every B bins,
    so a model-scope trace splits into ceil(T/B) INDEPENDENT serial
    recurrences of <= B bins — the interleaved-entropy-coder design of
    SURVEY.md §2 ("bin level" parallelism).

Each sub-stream is one lane: the coder steps bin index i = 0..B-1 over all
lanes at once — pure elementwise int32 math, no gathers.  The same per-bin
step function runs in three forms, all byte-identical:

  * lane_encode_scan   — lax.scan over the bin axis (CPU, reference)
  * lane_encode_pallas — Pallas kernel on the Triton route (GPU): one
                         program per LANE_BLOCK lanes, a loop over all B bins
                         inside it, coder state in registers
  * the host encoders  — ops/rangecoder.py / host/src/rangecoder.h

choose_lane_kernel() picks between the first two by platform.

Token semantics: each bin emits <= 2 renorm bytes; a byte carries the count
of pending 32-bit carries since the previous byte; a finalize pass
(finalize_lanes on the host, _finalize_device on the device) resolves
carries (base-256 ripple) and applies the host flush-truncation +
shortest-terminator rules.

Replaces: the reference's serial arithmetic_code.h:106-126 encoder
recurrence, whose single-stream design is why the reference is
single-threaded (SURVEY.md §2 "Parallelism: NONE").
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton
from jax.sharding import NamedSharding, PartitionSpec as P

TOP = 1 << 24
SIGN = -0x80000000
LANE_BLOCK = 128   # lanes per kernel program (a power of two: Triton block)
KERNEL_WARPS = 4   # warps per program: one lane per thread
BIN_UNROLL = 8     # bins per kernel loop step; their loads issue together
BIN_ALIGN = 32     # bin-axis padding of the compact upload: one bit word
GROUP_LANES = 8192  # lanes per full dispatch group (per device under a mesh)


def _round_up(n, m):
    return -(-max(n, 1) // m) * m


# ---------------------------------------------------------------------------
# 12-bit probability transfer: every recorded p1 is kSquash[dot + 2048]
# (model.h::mix_prob / h264_model.mix_prob), i.e. lies in the 4096-entry
# squash table's image.  The host therefore ships the 12-bit table INDEX
# (1.5 B/bin packed) instead of the 16-bit p1 (2 B/bin) and the device
# reconstructs the EXACT p1 with one take() before the kernel — a ~21%
# cut of host->device bytes, with containers
# byte-identical.  The reverse map picks any index with SQUASH[i] == p1
# (the logistic flattens into runs of equal values near the rails; all
# such indices are equivalent to the coder).

def _squash_tables():
    global _SQ_NP, _SQ_REV, _SQ_OK
    if _SQ_NP is None:
        from ._mix_tables import SQUASH

        _SQ_NP = np.asarray(SQUASH, np.int32)
        _SQ_REV = np.zeros(1 << 16, np.uint16)
        _SQ_OK = np.zeros(1 << 16, bool)
        _SQ_REV[_SQ_NP] = np.arange(4096, dtype=np.uint16)
        _SQ_OK[_SQ_NP] = True
        # p1 == 0 appears only in lane/bin padding (real probabilities are
        # clamped to [1, 65535] and the squash image is [22, 65514]); map
        # it to index 0 — those bins are masked off by lens in the kernel
        _SQ_REV[0] = 0
        _SQ_OK[0] = True
    return _SQ_NP, _SQ_REV, _SQ_OK


_SQ_NP = _SQ_REV = _SQ_OK = None


def pack_p1_idx(p1u16):
    """uint16 p1 [L, B] -> (packed uint8 [L, 3*B//2], ok).  Two 12-bit
    squash indices per 3 bytes; ok=False when some p1 is outside the
    squash image (foreign trace source) — caller keeps the u16 path."""
    _, rev, okt = _squash_tables()
    if not okt[p1u16].all():
        return None, False
    idx = rev[p1u16].astype(np.uint16)
    ev, od = idx[:, 0::2], idx[:, 1::2]
    L, H = ev.shape
    out = np.empty((L, H, 3), np.uint8)
    out[:, :, 0] = ev & 0xFF
    out[:, :, 1] = (ev >> 8) | ((od & 0xF) << 4)
    out[:, :, 2] = od >> 4
    return out.reshape(L, 3 * H), True


def _ult(a, b):
    """Unsigned int32 a < b."""
    return (a ^ jnp.int32(SIGN)) < (b ^ jnp.int32(SIGN))


def encode_step(low, pend, rng, bit, p1, v):
    """One range-coder bin on a vector of lanes (exact int32 mirror of
    RangeEncoder.put, with (byte, pending-carry-count) token emission).

    All arrays share a shape; int32 holds uint32 bit patterns (wrapping
    multiply/add match uint32 mod-2^32 arithmetic).
    Returns (low, pend, rng, tok, car):
      tok = byte0 | byte1 << 8 | n_emitted << 16   (n in 0..2)
      car = pending-carry count attached to byte0 (byte1's is always 0:
            emission resets the counter and no carry occurs between the
            two renorm shifts of a single bin).
    """
    r1 = ((rng >> 16) & 0xFFFF) * p1
    low_a = low + r1
    carry = jnp.where(_ult(low_a, low), 1, 0)
    is1 = bit == 1
    low_n = jnp.where(is1, low, low_a)
    pend_n = pend + jnp.where(is1, 0, carry)
    rng_n = jnp.where(is1, r1, rng - r1)

    do0 = _ult(rng_n, jnp.int32(TOP))
    tok0 = (low_n >> 24) & 0xFF
    car0 = jnp.where(do0, pend_n, 0)
    low_n = jnp.where(do0, low_n << 8, low_n)
    pend_n = jnp.where(do0, 0, pend_n)
    rng_n = jnp.where(do0, rng_n << 8, rng_n)

    do1 = _ult(rng_n, jnp.int32(TOP))
    tok1 = (low_n >> 24) & 0xFF
    low_n = jnp.where(do1, low_n << 8, low_n)
    rng_n = jnp.where(do1, rng_n << 8, rng_n)

    n = do0.astype(jnp.int32) + do1.astype(jnp.int32)
    tok = tok0 | (tok1 << 8) | (n << 16)

    low = jnp.where(v, low_n, low)
    pend = jnp.where(v, pend_n, pend)
    rng = jnp.where(v, rng_n, rng)
    tok = jnp.where(v, tok, 0)
    car = jnp.where(v, car0, 0)
    return low, pend, rng, tok, car


def flush_state(low, pend):
    """Shortest-terminator flush from final lane state (vector mirror of
    RangeEncoder.finish): round low up to the next 2^24 multiple (in range
    because renorm keeps range >= 2^24), then two byte shifts.
    Returns (ftok = byte0 | byte1 << 8, fcar for byte0; byte1's count is 0
    and its value is provably 0 — low is a 2^24 multiple)."""
    low_r = (low + jnp.int32(TOP - 1)) & jnp.int32(-(1 << 24))
    fcar = pend + jnp.where(_ult(low_r, low), 1, 0)
    ftok = ((low_r >> 24) & 0xFF) | (((low_r >> 16) & 0xFF) << 8)
    return ftok, fcar


# ---------------------------------------------------------------------------
# XLA scan formulation (CPU path and plain reference)


@jax.jit
def lane_encode_scan(bitp1, lens):
    """[L, B] packed (p1 | bit << 16) int32, [L] lens -> per-lane tokens.

    Returns (tok [L, B], car [L, B], ftok [L], fcar [L])."""
    L, B = bitp1.shape
    xs = (bitp1.T, jnp.arange(B, dtype=jnp.int32))

    def step(st, x):
        low, pend, rng = st
        row, i = x
        bit = row >> 16
        p1 = row & 0xFFFF
        v = i < lens
        low, pend, rng, tok, car = encode_step(low, pend, rng, bit, p1, v)
        return (low, pend, rng), (tok, car)

    # derive the carry init from the input so its varying-manual-axes type
    # matches under shard_map (same trick as estimator_jax._vlike)
    z = jnp.zeros((L,), jnp.int32) + bitp1[:, 0] * 0
    (low, pend, _), (tok, car) = jax.lax.scan(
        step, (z, z, z - 1), xs
    )
    ftok, fcar = flush_state(low, pend)
    return tok.T, car.T, ftok, fcar


# ---------------------------------------------------------------------------
# Pallas kernel (Triton route): one program per LANE_BLOCK lanes, bin-major


def _lane_kernel(x_ref, lens_ref, tok_ref, car_ref, ftok_ref, fcar_ref):
    """x/tok/car: [Bp, LANE_BLOCK] bin-major blocks (each bin's row is one
    coalesced load/store across the block's lanes); lens/ftok/fcar:
    [LANE_BLOCK].  The coder state stays in registers for all Bp bins."""
    lens = lens_ref[...]

    def body(j, st):
        low, pend, rng = st
        base = j * BIN_UNROLL
        rows = [x_ref[base + k] for k in range(BIN_UNROLL)]
        for k, x in enumerate(rows):
            low, pend, rng, tok, car = encode_step(
                low, pend, rng, x >> 16, x & 0xFFFF, base + k < lens)
            tok_ref[base + k] = tok
            car_ref[base + k] = car
        return low, pend, rng

    z = jnp.zeros_like(lens)
    low, pend, _ = jax.lax.fori_loop(
        0, x_ref.shape[0] // BIN_UNROLL, body, (z, z, z - 1))
    ftok, fcar = flush_state(low, pend)
    ftok_ref[...] = ftok
    fcar_ref[...] = fcar


@functools.partial(jax.jit, static_argnames=("interpret",))
def lane_encode_pallas(bitp1, lens, interpret=False):
    """Same contract as lane_encode_scan: [L, B] packed (p1 | bit << 16)
    int32, [L] lens -> (tok [L, B], car [L, B], ftok [L], fcar [L]).

    Lanes pad to LANE_BLOCK and bins to BIN_UNROLL (padding is masked off
    by lens); the kernel runs on the transposed [Bp, Lp] layout.
    interpret=True runs the Pallas interpreter (tests on the CPU)."""
    L, B = bitp1.shape
    Lp, Bp = _round_up(L, LANE_BLOCK), _round_up(B, BIN_UNROLL)
    x = jnp.pad(bitp1, ((0, Lp - L), (0, Bp - B))).T
    lens_p = jnp.pad(lens, (0, Lp - L))
    bins = pl.BlockSpec((Bp, LANE_BLOCK), lambda j: (0, j))
    row = pl.BlockSpec((LANE_BLOCK,), lambda j: (j,))
    tok, car, ftok, fcar = pl.pallas_call(
        _lane_kernel,
        grid=(Lp // LANE_BLOCK,),
        in_specs=[bins, row],
        out_specs=[bins, bins, row, row],
        out_shape=[
            jax.ShapeDtypeStruct((Bp, Lp), jnp.int32),
            jax.ShapeDtypeStruct((Bp, Lp), jnp.int32),
            jax.ShapeDtypeStruct((Lp,), jnp.int32),
            jax.ShapeDtypeStruct((Lp,), jnp.int32),
        ],
        backend="triton",
        compiler_params=pltriton.CompilerParams(num_warps=KERNEL_WARPS,
                                                num_stages=1),
        interpret=interpret,
        name="lane_encode",
    )(x, lens_p)
    return tok.T[:L, :B], car.T[:L, :B], ftok[:L], fcar[:L]


_KERNELS = {
    "pallas": lane_encode_pallas,
    "interpret": functools.partial(lane_encode_pallas, interpret=True),
    "scan": lane_encode_scan,
}


def choose_lane_kernel():
    """The one place the lane kernel is chosen: the Pallas kernel on a GPU,
    the XLA scan on the CPU (the path the tests run).  The platform is the
    default device's (jax.default_device) when one is set, else the
    default backend's."""
    dev = jax.config.jax_default_device
    platform = getattr(dev, "platform", dev) or jax.default_backend()
    if platform == "gpu":
        return "pallas"
    if platform == "cpu":
        return "scan"
    raise RuntimeError(f"no lane kernel for platform {platform!r}")


# ---------------------------------------------------------------------------
# Host-side finalize: tokens -> stream bytes (vectorized across all lanes)


def finalize_lanes(tok, car, ftok, fcar, lens):
    """Resolve carries + host truncation rules for all lanes at once.

    tok/car: [L, B] int32; ftok/fcar: [L]; lens: [L].
    Returns a list of L bytes objects (byte-identical to RangeEncoder)."""
    tok = np.asarray(tok)
    car = np.asarray(car)
    ftok = np.asarray(ftok)
    fcar = np.asarray(fcar)
    lens = np.asarray(lens)
    L, B = tok.shape
    n = (tok >> 16) & 3

    # candidate timeline per lane: 2 slots per bin + 2 flush slots
    W = 2 * B + 2
    cand_tok = np.zeros((L, W), np.int64)
    cand_tok[:, 0 : 2 * B : 2] = tok & 0xFF
    cand_tok[:, 1 : 2 * B : 2] = (tok >> 8) & 0xFF
    cand_tok[:, 2 * B] = ftok & 0xFF
    cand_tok[:, 2 * B + 1] = (ftok >> 8) & 0xFF
    cand_car = np.zeros((L, W), np.int64)
    cand_car[:, 0 : 2 * B : 2] = car
    cand_car[:, 2 * B] = fcar
    msk = np.zeros((L, W), bool)
    msk[:, 0 : 2 * B : 2] = n >= 1
    msk[:, 1 : 2 * B : 2] = n >= 2
    msk[:, 2 * B :] = True

    counts = msk.sum(axis=1)
    M = int(counts.max()) if L else 0
    pos = np.cumsum(msk, axis=1) - 1
    rows, cols = np.nonzero(msk)
    p = pos[rows, cols]
    val = np.zeros((L, M), np.int64)
    raw = np.full((L, M), 0xFF, np.int64)  # padding: never flushable
    carr = np.zeros((L, M), np.int64)
    val[rows, p] = cand_tok[rows, cols]
    raw[rows, p] = cand_tok[rows, cols]
    carr[rows, p] = cand_car[rows, cols]

    # base-256 carry ripple toward lower indices; pass count = longest
    # 0xFF run anywhere (carries are rare events)
    val[:, :-1] += carr[:, 1:]
    while True:
        ov = val >> 8
        if not ov.any():
            break
        val &= 0xFF
        val[:, :-1] += ov[:, 1:]

    # host flush condition: a byte lands in the output iff a LATER token has
    # byte != 0xFF or a pending carry (the cache/run closes); the final
    # pending token is never emitted -> truncate AT the last flushable index
    flushable = (raw != 0xFF) | (carr > 0)
    j_last = np.where(
        flushable.any(axis=1),
        M - 1 - np.argmax(flushable[:, ::-1], axis=1),
        0,
    )
    # shortest-terminator: strip trailing zeros (decoder zero-fills) — on
    # RESOLVED bytes (carries can create zeros)
    idx = np.arange(M)
    nzmask = (val != 0) & (idx[None, :] < j_last[:, None])
    nbytes = np.where(
        nzmask.any(axis=1), M - np.argmax(nzmask[:, ::-1], axis=1), 0
    )
    u8 = val.astype(np.uint8)
    return [bytes(u8[l, : nbytes[l]]) for l in range(L)]


# ---------------------------------------------------------------------------
# On-device finalize: kernel tokens -> resolved stream bytes on the device,
# so only ~stream-sized uint8 data is read back instead of 8 bytes/bin of
# raw tokens.


@functools.partial(jax.jit, static_argnames=("max_bytes",))
def _finalize_device(tok, car, ftok, fcar, max_bytes):
    """Vector finalize on [L, B] kernel outputs.

    Compaction is ONE packed scatter: each emitted byte is a cell  byte(8) | carry_count(16) | present(1)<<24.  Carry counts fit
    16 bits because the counter resets at every emission and a lane codes
    at most B <= 2^15 bins.

    Returns (bytes uint8 [L, M], nbytes [L], overflow bool): `overflow`
    set when some lane emitted more than M bytes (adversarial streams;
    caller falls back to the exact host finalize on raw tokens)."""
    L, B = tok.shape
    M = max_bytes
    n = (tok >> 16) & 3
    cum = jnp.cumsum(n, axis=1)
    pos0 = cum - n
    total = cum[:, -1]
    overflow = jnp.any(total + 2 > M)

    rows = jnp.arange(L)[:, None]
    dump = M  # masked/overflow writes land in a dump slot
    pk0 = (tok & 0xFF) | (car << 8) | (1 << 24)
    pk1 = ((tok >> 8) & 0xFF) | (1 << 24)
    w0 = jnp.where(n >= 1, jnp.minimum(pos0, dump), dump)
    w1 = jnp.where(n >= 2, jnp.minimum(pos0 + 1, dump), dump)
    cells = (
        jnp.zeros((L, M + 1), jnp.int32)
        .at[rows, jnp.concatenate([w0, w1], axis=1)]
        .set(jnp.concatenate([pk0, pk1], axis=1))
    )
    lr = jnp.arange(L)
    fw0 = jnp.minimum(total, dump)
    fw1 = jnp.minimum(total + 1, dump)
    cells = cells.at[lr, fw0].set((ftok & 0xFF) | (fcar << 8) | (1 << 24))
    cells = cells.at[lr, fw1].set(((ftok >> 8) & 0xFF) | (1 << 24))
    cells = cells[:, :M]

    present = cells >> 24
    raw = jnp.where(present == 1, cells & 0xFF, 0xFF)
    carr = jnp.where(present == 1, (cells >> 8) & 0xFFFF, 0)

    # base-256 ripple toward lower indices; iterations = longest 0xFF
    # propagation chain (carries are rare events)
    val = raw * present + jnp.pad(carr[:, 1:], ((0, 0), (0, 1)))

    def ripple_cond(v):
        return jnp.any(v >> 8 != 0)

    def ripple_body(v):
        ov = v >> 8
        return (v & 0xFF) + jnp.pad(ov[:, 1:], ((0, 0), (0, 1)))

    val = jax.lax.while_loop(ripple_cond, ripple_body, val)

    # host truncation: output ends AT the last token with byte != 0xFF or a
    # pending carry (exclusive); then strip trailing zeros (decoder
    # zero-fills)
    idx = jnp.arange(M)[None, :]
    flushable = (raw != 0xFF) | (carr > 0)
    j_last = jnp.max(jnp.where(flushable, idx, -1), axis=1)
    j_last = jnp.maximum(j_last, 0)
    nz = (val != 0) & (idx < j_last[:, None])
    nbytes = jnp.max(jnp.where(nz, idx + 1, 0), axis=1)
    return val.astype(jnp.uint8), nbytes, overflow


def _lane_pipeline(p1, bitw, lens, *, idx, kernel, max_bytes):
    """Device pipeline on one dispatch group: unpack the compact upload ->
    lane kernel -> on-device finalize.

    p1: the 12-bit squash indices packed two per 3 bytes (uint8
    [L, 3*B//2], idx=True; see pack_p1_idx) or uint16 p1 [L, B]; bitw:
    int32 [L, B//32] little-endian bit words."""
    L = p1.shape[0]
    if idx:
        b = p1.astype(jnp.int32).reshape(L, -1, 3)
        ev = b[:, :, 0] | ((b[:, :, 1] & 0xF) << 8)
        od = (b[:, :, 1] >> 4) | (b[:, :, 2] << 4)
        sq, _, _ = _squash_tables()
        p1 = jnp.take(jnp.asarray(sq), jnp.stack([ev, od], -1).reshape(L, -1),
                      axis=0)
    B = p1.shape[1]
    bits = (bitw[:, :, None] >> jnp.arange(32, dtype=jnp.int32)) & 1
    bitp1 = p1.astype(jnp.int32) | (bits.reshape(L, B) << 16)
    tok, car, ftok, fcar = _KERNELS[kernel](bitp1, lens)
    out, nbytes, overflow = _finalize_device(tok, car, ftok, fcar, max_bytes)
    return out, nbytes, overflow.reshape(1), (tok, car, ftok, fcar)


@functools.lru_cache(maxsize=None)
def _pipeline_fn(idx, kernel, max_bytes, mesh):
    """Jitted _lane_pipeline; under a mesh, shard_mapped over the lane axis
    (lanes are independent: no collectives).  `overflow` comes back with
    one flag per shard.  check_vma=False: pallas_call outputs carry no
    varying-axes type."""
    body = functools.partial(_lane_pipeline, idx=idx, kernel=kernel,
                             max_bytes=max_bytes)
    if mesh is None:
        return jax.jit(body)
    lane = P("dp")
    return jax.jit(shard_map(body, mesh=mesh, in_specs=(lane,) * 3,
                             out_specs=(lane, lane, lane, (lane,) * 4),
                             check_vma=False))


def pack_compact(bitp1, lens):
    """Host-side compact packing: int32 (p1 | bit << 16) [L, B] ->
    (uint16 p1, int32 bit-words, int32 lens), bin axis padded to
    BIN_ALIGN."""
    bitp1 = np.asarray(bitp1)
    lens = np.asarray(lens, np.int32)
    B = bitp1.shape[1]
    bitp1 = np.pad(bitp1, ((0, 0), (0, _round_up(B, BIN_ALIGN) - B)))
    p1u16 = (bitp1 & 0xFFFF).astype(np.uint16)
    bitw = np.packbits(
        (bitp1 >> 16).astype(np.uint8), axis=1, bitorder="little"
    ).view(np.int32)
    return p1u16, bitw, lens


def _group_sizes(L, n_dev=1):
    """Split L lanes into dispatch groups: full GROUP_LANES-per-device
    groups, then one tail padded to a power of two (>= LANE_BLOCK) per
    device.  Yields (lo, hi, padded_size); the shapes that compile per B
    stay few (one full size, log2(GROUP_LANES / LANE_BLOCK) + 1 tails)."""
    big = GROUP_LANES * n_dev
    lo = 0
    while lo < L:
        n = min(big, L - lo)
        per_dev = -(-n // n_dev)
        g = max(LANE_BLOCK, 1 << (per_dev - 1).bit_length()) * n_dev
        yield lo, lo + n, g
        lo += n


def lane_dispatch_compact(p1u16, bitw, lens, interpret=False,
                          bits_per_byte=4, mesh=None):
    """Dispatch phase of lane_streams_device_compact: launch every lane
    group asynchronously and return the pending handles WITHOUT reading any
    result back — callers overlap host work (extraction/packing of the next
    file) with device compute, then drain with lane_collect.

    Uploads 12-bit squash indices (pack_p1_idx) when every p1 is in the
    squash image (always, for traces this framework recorded), falling
    back to the uint16 upload otherwise.  mesh: shard each group's lanes
    over the mesh 'dp' axis.  interpret=True (tests only) runs the Pallas
    kernel in the interpreter instead of the platform's choice."""
    L, Bp = p1u16.shape
    assert Bp <= 1 << 15, "substream_bins > 32768 overflows 16-bit carries"
    M = -(-Bp // bits_per_byte // 8) * 8 + 8
    kernel = "interpret" if interpret else choose_lane_kernel()
    n_dev = 1 if mesh is None else mesh.devices.size
    put = (jax.device_put if mesh is None else functools.partial(
        jax.device_put, device=NamedSharding(mesh, P("dp"))))
    p1pk, idx_ok = pack_p1_idx(p1u16)
    fn = _pipeline_fn(idx_ok, kernel, M, mesh)
    pending = []
    for lo, hi, g in _group_sizes(L, n_dev):
        rows = [p1pk[lo:hi] if idx_ok else p1u16[lo:hi], bitw[lo:hi],
                lens[lo:hi]]
        rows = [np.pad(a, ((0, g - (hi - lo)),) + ((0, 0),) * (a.ndim - 1))
                for a in rows]
        pending.append((hi - lo, lens[lo:hi], fn(*map(put, rows))))
    return pending


def lane_collect(pending):
    """Collect phase: read back dispatched lane groups -> stream bytes."""
    streams = []
    for n, glens, (out, nbytes, overflow, raw) in pending:
        if np.any(overflow):
            tok, car, ftok, fcar = raw
            streams.extend(
                finalize_lanes(tok[:n], car[:n], ftok[:n], fcar[:n], glens)
            )
            continue
        out = np.asarray(out[:n])
        nb = np.asarray(nbytes[:n])
        streams.extend(bytes(out[l, : nb[l]]) for l in range(n))
    return streams


def lane_streams_device_compact(p1u16, bitw, lens, interpret=False,
                                bits_per_byte=4, mesh=None):
    """Device pipeline on pre-packed compact arrays (see split_lanes_recs)
    -> list of per-lane stream bytes.

    All groups are dispatched asynchronously before any result is read
    back.  bits_per_byte bounds the readback buffer (M = B / bits_per_byte
    + 8 bytes per lane); lanes exceeding it (adversarial input) trigger an
    exact host-finalize fallback on that group's raw tokens."""
    return lane_collect(lane_dispatch_compact(
        p1u16, bitw, lens, interpret, bits_per_byte, mesh))


def lane_streams_device(bitp1, lens, interpret=False, bits_per_byte=4,
                        mesh=None):
    """lane_streams_device_compact on an int32 (p1 | bit << 16) [L, B]
    problem (see split_lanes)."""
    return lane_streams_device_compact(*pack_compact(bitp1, lens), interpret,
                                       bits_per_byte, mesh)


# ---------------------------------------------------------------------------
# Trace front end: sub-stream splitting / packing / envelope assembly


def split_lanes(traces, B):
    """Chop each trace into ceil(T/B)-bin sub-streams (>= 1), pack all
    sub-streams of all traces into one [L, B] problem.

    Returns (bitp1 int32 [L, B], lens int32 [L], spans) where spans[i] is
    the (lo, hi) lane range of traces[i]."""
    spans = []
    L = 0
    for t in traces:
        k = max(1, -(-len(t) // B))
        spans.append((L, L + k))
        L += k
    bitp1 = np.zeros((L, B), np.int32)
    lens = np.zeros(L, np.int32)
    for t, (lo, hi) in zip(traces, spans):
        T = len(t)
        if T:
            packed = (
                np.asarray(t.p1s, np.int32)
                | (np.asarray(t.bits, np.int32) << 16)
            )
            full = (hi - lo) * B
            if T < full:
                packed = np.pad(packed, (0, full - T))
            bitp1[lo:hi] = packed.reshape(hi - lo, B)
            lens[lo:hi] = B
            lens[hi - 1] = T - (hi - lo - 1) * B
    return bitp1, lens, spans


def auto_substream_bins(n_bins):
    """Two-tier sub-stream length: short lanes for small workloads (a
    populated device grid beats envelope overhead at small absolute cost),
    long lanes once there is enough work to fill thousands of them.  Two
    tiers keep the number of compiled pipeline shapes bounded."""
    return 2048 if n_bins < (1 << 22) else 16384


def split_lanes_recs(traces, B):
    """Fast path of split_lanes for native traces: build the compact device
    upload (uint16 p1, packed bit words) DIRECTLY from the zero-copy u64
    record views (recs32: lo = slot|bit<<24, hi = pcab|p1<<16), skipping
    the [L, B] int32 intermediate entirely (one pass over the records
    instead of four)."""
    spans = []
    L = 0
    for t in traces:
        k = max(1, -(-len(t) // B))
        spans.append((L, L + k))
        L += k
    Bp = _round_up(B, BIN_ALIGN)
    p1u16 = np.zeros((L, Bp), np.uint16)
    bitu8 = np.zeros((L, Bp), np.uint8)
    lens = np.zeros(L, np.int32)
    for t, (lo, hi) in zip(traces, spans):
        T = len(t)
        if not T:
            continue
        r32 = t.recs32()
        flat_p1 = p1u16[lo:hi].reshape(-1)
        flat_bit = bitu8[lo:hi].reshape(-1)
        if Bp == B:
            np.right_shift(r32[:, 1], 16, out=flat_p1[:T], casting="unsafe")
            np.bitwise_and(r32[:T, 0] >> 24, 1, out=flat_bit[:T],
                           casting="unsafe")
        else:  # B not BIN_ALIGN-aligned: scatter each lane row's B bins
            for j in range(hi - lo):
                a, b = j * B, min((j + 1) * B, T)
                row = p1u16[lo + j]
                np.right_shift(r32[a:b, 1], 16, out=row[: b - a],
                               casting="unsafe")
                np.bitwise_and(r32[a:b, 0] >> 24, 1,
                               out=bitu8[lo + j, : b - a], casting="unsafe")
        lens[lo:hi] = B
        lens[hi - 1] = T - (hi - lo - 1) * B
    bitw = np.packbits(bitu8, axis=1, bitorder="little").view(np.int32)
    return p1u16, bitw, lens, spans


def encode_traces_lanes(traces, B, interpret=False, encode_fn=None,
                        mesh=None):
    """Device entropy stage: traces -> per-trace sub-stream ENVELOPE bytes
    (the v2 container's stream blob for substream_bins=B), byte-identical
    to RecodeModel(..., substream_bins=B).finish().

    Runs the device pipeline (choose_lane_kernel's kernel + on-device
    finalize), lane-sharded over `mesh` when given.  encode_fn replaces
    the pipeline with a plain (bitp1, lens) -> tokens encoder whose tokens
    the host finalizes (e.g. encode_fn=lane_encode_scan: the reference)."""
    from ..models.h264_model import _make_envelope

    if not traces:
        return []
    if encode_fn is None and all(hasattr(t, "recs32") for t in traces):
        # native traces: one-pass packing straight from the u64 records
        p1u16, bitw, lens, spans = split_lanes_recs(traces, B)
        streams = lane_streams_device_compact(p1u16, bitw, lens,
                                              interpret=interpret, mesh=mesh)
        return [_make_envelope(streams[lo:hi]) for lo, hi in spans]
    bitp1, lens, spans = split_lanes(traces, B)
    if encode_fn is None:
        streams = lane_streams_device(bitp1, lens, interpret=interpret,
                                      mesh=mesh)
    else:
        tok, car, ftok, fcar = encode_fn(bitp1, lens)
        streams = finalize_lanes(tok, car, ftok, fcar, lens)
    return [_make_envelope(streams[lo:hi]) for lo, hi in spans]
