"""Device-side recode model + range encoder as exact-integer JAX scans.

This is the est-on-device compute path for compression (substream_bins=0): given per-slice bin traces
extracted by the host parser (models/trace.py), the device reproduces the
host model arithmetic bit-for-bit and range-encodes every slice's stream —
slices ride the batch dimension (vmap/shard_map over the mesh), the serial
recurrences ride lax.scan.  Output streams are byte-identical to the host
RecodeModel + RangeEncoder pair (tests/test_device_path.py).

Formulation notes:
  * all state is int32/uint32 — `low` is kept in 32 bits with an explicit
    pending-carry counter instead of a 33-bit register, so no 64-bit ints,
  * byte emission is one *token* per renorm shift: (byte, carry) pairs;
    carries are folded by a reverse scan (resolve_carries), the scan-friendly
    equivalent of the host encoder's cache/0xFF-run deferral,
  * the host drops never-flushed trailing tokens (pending cache/run); the
    device mirrors that by truncating at the last token with
    byte != 0xFF or carry == 1 (the host flush condition).
"""

import jax
import jax.numpy as jnp
import numpy as np


PROB_BITS = 16
TOP = 1 << 24
M32 = jnp.uint32(0xFFFFFFFF)


def _vlike(x, ref):
    """Give `x` the same varying-manual-axes type as `ref` (no-op outside
    shard_map): scan carries must match the inputs' mesh-varying type."""
    z = (ref.reshape(-1)[0] * 0).astype(x.dtype) if hasattr(ref, "reshape") else 0
    return x + z


def _mix_tables():
    from ._mix_tables import SQUASH, STRETCH12

    return (jnp.asarray(STRETCH12, jnp.int32), jnp.asarray(SQUASH, jnp.int32))


from ..models.trace import N_CLS  # model.h::K_NCLS (single source of truth)
HALVE_FAST = 0x18  # model v4 fast-counter halving (model.h::kHalveFast)
HIST_MAG = 256  # model v5 last-bit history magnitude (model.h::kHistMag)
HIST2_MAG = 128  # model v7 second-last-bit magnitude (model.h::kHist2Mag)
APM_CELLS = 33  # model v10 APM buckets per class (model.h::kApmCells)
APM_RATE = 6    # model v10 APM adaptation shift (model.h::kApmRate)
APM_HIST = 5    # stage-2 APM history contexts (model.h::kApmHist)


def _apm_init():
    """Identity-initialized APM row (h264_model._apm_row mirror)."""
    from ..models.h264_model import _apm_row

    return np.asarray(_apm_row(), np.int32)


def model_probs(slots, bits, pcabs, limits, cls, valid, n_slots):
    """Adaptive dual-rate estimator + logistic-mixer scan over one slice's
    trace (host-model mirror: model.h::mix_prob/update_mix/adapt, model v4).

    slots/bits/pcabs/valid: int32[T]; limits/cls: int32[n_slots].
    Returns p1 int32[T]."""
    stretch, squash = _mix_tables()

    def step(carry, x):
        est, w, apm = carry
        slot, bit, pcab, v = x
        e = est[slot]
        e0, e1, f0, f1, lb, lb2 = e[0], e[1], e[2], e[3], e[4], e[5]
        pe = jnp.clip((e0 << 16) // (e0 + e1), 1, 0xFFFF)
        pf = jnp.clip((f0 << 16) // (f0 + f1), 1, 0xFFFF)
        x0 = stretch[pe >> 4]
        x1 = jnp.where(pcab > 0, stretch[pcab >> 4], 0)
        x3 = stretch[pf >> 4]
        x4 = jnp.where(lb == 2, 0, jnp.where(lb == 1, HIST_MAG, -HIST_MAG))
        x5 = jnp.where(lb2 == 2, 0,
                       jnp.where(lb2 == 1, HIST2_MAG, -HIST2_MAG))
        c = cls[slot]
        wr = w[c]
        dot = ((wr[0] >> 6) * x0 + (wr[1] >> 6) * x1 + (wr[2] >> 6) * 77
               + (wr[3] >> 6) * x3 + (wr[4] >> 6) * x4
               + (wr[5] >> 6) * x5) >> 10
        dot = jnp.clip(dot, -2048, 2047)
        # model v10 APM stage (model.h::mix_prob mirror): blend with a map
        # keyed (class, 2-bit key history, stretch bucket), requantize onto
        # the squash grid
        pmix = squash[dot + 2048]
        u = stretch[pmix >> 4] + 2048
        j = u >> 7
        frac = u - (j << 7)
        h = jnp.where(jnp.logical_or(lb == 2, lb2 == 2), 4, lb * 2 + lb2)
        ci = c * APM_HIST + h
        a0 = apm[ci, j]
        a1 = apm[ci, j + 1]
        pa = (a0 * (128 - frac) + a1 * frac) >> 7
        pb = jnp.clip((pmix + pa) >> 1, 1, 65535)
        p1 = squash[stretch[pb >> 4] + 2048]
        tgt = bit << 16
        a0n = a0 + (((tgt - a0) * (128 - frac)) >> (7 + APM_RATE))
        a1n = a1 + (((tgt - a1) * frac) >> (7 + APM_RATE))
        apm = apm.at[ci, j].set(jnp.where(v == 1, a0n, a0))
        apm = apm.at[ci, j + 1].set(jnp.where(v == 1, a1n, a1))
        err = tgt - pmix  # the mixer learns on its pre-APM output
        wn = jnp.clip(
            wr + ((err * jnp.stack([x0, x1, jnp.int32(77), x3, x4, x5]))
                  >> 14),
            -(1 << 24), 1 << 24,
        )
        w = w.at[c].set(jnp.where(v == 1, wn, wr))
        inc1 = jnp.where(bit == 1, 1, 0)  # index 0 counts ones
        e0n, e1n = e0 + inc1, e1 + (1 - inc1)
        f0n, f1n = f0 + inc1, f1 + (1 - inc1)
        halve = (e0n + e1n) > limits[slot]
        e0n = jnp.where(halve, (e0n + 1) >> 1, e0n)
        e1n = jnp.where(halve, (e1n + 1) >> 1, e1n)
        fhalve = (f0n + f1n) > HALVE_FAST
        f0n = jnp.where(fhalve, (f0n + 1) >> 1, f0n)
        f1n = jnp.where(fhalve, (f1n + 1) >> 1, f1n)
        new = jnp.where(v == 1, jnp.stack([e0n, e1n, f0n, f1n, bit, lb]), e)
        est = est.at[slot].set(new)
        return (est, w, apm), jnp.where(v == 1, p1, 0x8000)

    est0 = _vlike(
        jnp.concatenate(
            [jnp.ones((n_slots, 4), jnp.int32),
             jnp.full((n_slots, 2), 2, jnp.int32)], axis=1),
        slots,
    )
    w0 = _vlike(
        jnp.tile(jnp.array([[24576, 24576, 0, 0, 0, 0]], jnp.int32),
                 (N_CLS, 1)),
        slots,
    )
    apm0 = _vlike(
        jnp.tile(jnp.asarray(_apm_init())[None, :], (N_CLS * APM_HIST, 1)),
        slots,
    )
    (_, _, _), p1s = jax.lax.scan(
        step, (est0, w0, apm0), (slots, bits, pcabs, valid),
    )
    return p1s


def range_encode(bits, p1s, valid):
    """Range-encoder scan for one slice -> (tokens, carries, n_tokens).

    Each put triggers at most 2 renorm byte-shifts (range >= 2^24 before a
    put and the split keeps range >= 2^8), plus 5 flush shifts at the end.

    Formulation: the scan carries ONLY scalars (low, pend, rng) and emits
    per-step token candidates as stacked outputs; one vectorized
    cumsum + scatter then compacts candidates into the token buffer.
    Carrying the buffer through the scan would force an O(buffer) copy per
    step under vmap — this keeps total work O(T)."""
    T = bits.shape[0]
    max_tok = 2 * T + 8

    def shift(low, pend, rng, do):
        """One candidate byte-shift; returns new scalars + token fields."""
        byte = ((low >> 24) & jnp.uint32(0xFF)).astype(jnp.uint8)
        tok_carry = pend
        low = jnp.where(do, (low << 8) & M32, low)
        pend = jnp.where(do, 0, pend)
        rng = jnp.where(do, (rng << 8) & M32, rng)
        return low, pend, rng, byte, tok_carry

    def step(state, x):
        bit, p1, v = x
        low, pend, rng = state
        r1 = ((rng >> 16) * p1.astype(jnp.uint32)) & M32
        low_a = (low + r1) & M32
        carry = (low_a < low).astype(jnp.int32)  # 32-bit wraparound
        low_n = jnp.where(bit == 1, low, low_a)
        pend_n = pend + jnp.where(bit == 1, 0, carry)
        rng_n = jnp.where(bit == 1, r1, (rng - r1) & M32)

        do0 = jnp.logical_and(rng_n < TOP, v == 1)
        low_n, pend_n, rng_n, b0, c0 = shift(low_n, pend_n, rng_n, do0)
        do1 = jnp.logical_and(rng_n < TOP, v == 1)
        low_n, pend_n, rng_n, b1, c1 = shift(low_n, pend_n, rng_n, do1)

        low = jnp.where(v == 1, low_n, low)
        pend = jnp.where(v == 1, pend_n, pend)
        rng = jnp.where(v == 1, rng_n, rng)
        ys = (
            do0.astype(jnp.int32),
            b0,
            c0,
            do1.astype(jnp.int32),
            b1,
            c1,
        )
        return (low, pend, rng), ys

    state = (
        _vlike(jnp.uint32(0), bits),
        _vlike(jnp.int32(0), bits),
        _vlike(jnp.uint32(0xFFFFFFFF), bits),
    )
    state, ys = jax.lax.scan(step, state, (bits, p1s, valid))
    e0, b0, c0, e1, b1, c1 = ys

    # interleave step-major candidate streams -> chronological [2T]
    flags = jnp.stack([e0, e1], axis=1).reshape(2 * T)
    cbytes = jnp.stack([b0, b1], axis=1).reshape(2 * T)
    ccarr = jnp.stack([c0, c1], axis=1).reshape(2 * T)

    # compact with one scatter (dump slot absorbs non-emitting candidates)
    positions = jnp.cumsum(flags) - 1
    write_pos = jnp.where(flags == 1, positions, max_tok)
    tokens = _vlike(jnp.zeros(max_tok + 1, jnp.uint8), bits).at[write_pos].set(cbytes)
    carries = _vlike(jnp.zeros(max_tok + 1, jnp.int32), bits).at[write_pos].set(ccarr)
    n_emitted = jnp.sum(flags)

    # shortest-terminator flush (mirror of rangecoder.py finish): round low
    # up to the next 2^24 multiple (in range: renorm keeps range >= 2^24);
    # the round-up carry folds into pend; two shifts emit the revealed byte
    # and the flush event that materializes the pending run
    low, pend, rng = state
    low_r = (low + jnp.uint32(TOP - 1)) & jnp.uint32(0xFF000000)
    pend = pend + (low_r < low).astype(jnp.int32)  # 32-bit wrap = carry
    low = low_r
    for k in range(2):
        low, pend, rng, byte, tok_carry = shift(low, pend, rng, jnp.bool_(True))
        tokens = tokens.at[n_emitted + k].set(byte)
        carries = carries.at[n_emitted + k].set(tok_carry)
    return tokens[:max_tok], carries[:max_tok], n_emitted + 2


def resolve_carries(tokens, carries, n_tokens):
    """Reverse scan folding pending carries into final bytes, then the
    host-equivalent tail truncation.  Returns (bytes uint8[Tmax], n_bytes)."""
    T = tokens.shape[0]
    idx = jnp.arange(T)
    in_range = (idx < n_tokens).astype(jnp.int32)

    def step(carry_in, x):
        byte, flag, ir = x
        s = byte.astype(jnp.int32) + jnp.where(ir == 1, carry_in, 0)
        out = (s & 0xFF).astype(jnp.uint8)
        carry_out = jnp.where(ir == 1, flag + (s >> 8), carry_in)
        return carry_out, out

    _, out = jax.lax.scan(
        step,
        _vlike(jnp.int32(0), tokens),
        (tokens, carries, in_range),
        reverse=True,
    )
    # host flush condition at shift j: byte != 0xFF or carry pending; the
    # host never emits tokens after the last such shift
    flushable = jnp.logical_and(
        in_range == 1, jnp.logical_or(tokens != 0xFF, carries > 0)
    )
    # clamp to 0 so the no-flushable-token degenerate tail yields an empty
    # stream, matching the host encoder (ADVICE r1)
    j_last = jnp.maximum(jnp.max(jnp.where(flushable, idx, -1)), 0)
    # shortest-terminator strip: trailing zeros are redundant (the decoder
    # zero-fills); must run on RESOLVED bytes (carries can create zeros)
    nz = jnp.logical_and(idx < j_last, out != 0)
    n_bytes = jnp.max(jnp.where(nz, idx + 1, 0))
    return out, n_bytes  # bytes out[0:n_bytes]


@jax.jit
def encode_slices(slots, bits, pcabs, limits, valid, cls=None):
    """Batched device path: [S, T] arrays -> (bytes [S, 2T+8], lengths [S]).

    cls: per-slot key-class ids [S, NS] for the mixer weight context
    (pipeline.pack_traces); None (synthetic tests) puts every slot in
    class 0 — still the exact model arithmetic, just one shared weight set.

    The batch dimension is the parallel unit (slices); shard it over the
    mesh for multi-chip compression (parallel/pipeline.py)."""
    n_slots = limits.shape[1]
    if cls is None:
        cls = jnp.zeros_like(limits)

    def one(slot, bit, pcab, lim, cl, v):
        p1s = model_probs(slot, bit, pcab, lim, cl, v, n_slots)
        tokens, carries, n_tok = range_encode(bit, p1s, v)
        return resolve_carries(tokens, carries, n_tok)

    return jax.vmap(one)(slots, bits, pcabs, limits, cls, valid)


def stream_bytes(out_row, n_bytes):
    """Host-side: one batched row -> the slice's stream bytes."""
    return bytes(np.asarray(out_row[: int(n_bytes)], dtype=np.uint8))
