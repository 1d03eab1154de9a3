"""Lane-parallel device entropy DECODER — the dual of ops/lane_coder.py.

This is the mechanism study for the north-star "speculative multi-bin
decode" item (SURVEY.md §2 bin-level parallelism; VERDICT round-1 item 2):
given per-bin probabilities, container-v2 sub-streams are INDEPENDENT
serial recurrences, so the decode direction vectorizes across lanes
exactly like the encode direction — one range-decoder per lane, stepped
over the bin axis.  `lane_decode_scan` is byte-exact against
ops/rangecoder.RangeDecoder and inverts lane/host encoding bit-for-bit
(tests/test_lane_decoder.py), and runs on CPU meshes and the GPU.

Why this stays a prototype rather than the decompress product path — the
measured argument lives in DEVICE_DECODE.md:

  * p1 is the model's probability for each bin, and in decompression the
    model is keyed by the H.264 parse state, which depends on every
    previously decoded bin.  The encoder can ship (bit, p1) traces to the
    device because the host parse already ran; the decoder cannot know p1
    ahead of the bits it is about to decode.  Lane decoding therefore
    applies only where p1 is known per bin (re-decode/verify of traces,
    model-free streams) — not to container decompression.
  * the byte feed is data-dependent: each lane consumes 0-2 stream bytes
    per bin depending on its own renorm history, i.e. a per-lane dynamic
    index into its stream.  XLA lowers that gather (take_along_axis), so
    the decode direction runs as an XLA scan, not a hand kernel.

Unsigned arithmetic rides int32 with wrapping semantics, same as
lane_coder (SIGN-flip trick for unsigned compares).
"""

import jax
import jax.numpy as jnp
import numpy as np

TOP = 1 << 24
SIGN = -0x80000000


def _ult(a, b):
    """Unsigned int32 a < b."""
    return (a ^ jnp.int32(SIGN)) < (b ^ jnp.int32(SIGN))


def decode_step(code, rng, pos, streams, p1, v):
    """One range-decoder bin on a vector of lanes (exact int32 mirror of
    RangeDecoder.get; reading past a stream's end yields zeros, provided
    by the caller's zero padding).

    streams: [L, M] int32 (byte values); code/rng/pos/p1/v: [L]."""

    def byte_at(p):
        return jnp.take_along_axis(streams, p[:, None], axis=1)[:, 0]

    r1 = ((rng >> 16) & 0xFFFF) * p1
    bit = _ult(code, r1)
    code_n = jnp.where(bit, code, code - r1)
    rng_n = jnp.where(bit, r1, rng - r1)

    do0 = _ult(rng_n, jnp.int32(TOP))
    b0 = byte_at(pos)
    code_n = jnp.where(do0, (code_n << 8) | b0, code_n)
    rng_n = jnp.where(do0, rng_n << 8, rng_n)
    pos_n = pos + do0.astype(jnp.int32)

    do1 = _ult(rng_n, jnp.int32(TOP))
    b1 = byte_at(pos_n)
    code_n = jnp.where(do1, (code_n << 8) | b1, code_n)
    rng_n = jnp.where(do1, rng_n << 8, rng_n)
    pos_n = pos_n + do1.astype(jnp.int32)

    code = jnp.where(v, code_n, code)
    rng = jnp.where(v, rng_n, rng)
    pos = jnp.where(v, pos_n, pos)
    return code, rng, pos, jnp.where(v, bit.astype(jnp.int32), 0)


@jax.jit
def lane_decode_scan(streams, p1s, lens):
    """[L, M] stream bytes (int32, zero-padded), [L, B] per-bin p1,
    [L] bin counts -> [L, B] decoded bits (0 beyond lens)."""
    L, _ = streams.shape
    B = p1s.shape[1]

    # init: code = first 4 bytes, big-endian (RangeDecoder.__init__)
    code = jnp.zeros((L,), jnp.int32)
    for k in range(4):
        code = (code << 8) | streams[:, k]
    st = (code, jnp.full((L,), -1, jnp.int32), jnp.full((L,), 4, jnp.int32))

    def step(st, x):
        code, rng, pos = st
        p1, i = x
        v = i < lens
        code, rng, pos, bit = decode_step(code, rng, pos, streams, p1, v)
        return (code, rng, pos), bit

    _, bits = jax.lax.scan(step, st, (p1s.T, jnp.arange(B, dtype=jnp.int32)))
    return bits.T


def decode_streams_lanes(stream_list, p1s, lens):
    """Host driver: pack per-lane stream bytes (list of bytes objects) into
    the padded [L, M] layout and decode.  Returns [L, B] int32 bits.

    M covers the worst case (4 init + 2 renorm bytes/bin); reads past each
    stream's real end see zeros, matching RangeDecoder._byte."""
    L = len(stream_list)
    B = int(p1s.shape[1]) if L else 0
    M = max(4 + 2 * B, max((len(s) for s in stream_list), default=0)) + 4
    buf = np.zeros((L, M), np.int32)
    for i, s in enumerate(stream_list):
        buf[i, : len(s)] = np.frombuffer(s, np.uint8)
    return lane_decode_scan(
        jnp.asarray(buf), jnp.asarray(p1s, jnp.int32),
        jnp.asarray(lens, jnp.int32)
    )
