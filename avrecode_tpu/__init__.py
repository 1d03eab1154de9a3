"""avrecode_tpu — lossless H.264 CABAC recompressor.

A from-scratch JAX/XLA/Pallas + C++ framework with the capabilities of the
reference recoder (pbluc/avrecode-ms): bit-exact lossless recompression of
CABAC-entropy-coded H.264 streams via a richer adaptive context model.

Layers (see SURVEY.md for the reference layer map this mirrors):
  ops/       — entropy coders: recoded-stream range coder, spec CABAC engine,
               the device lane coder (Pallas kernel + XLA scans) and spec
               constant tables
  h264/      — forward H.264 CABAC slice parser (replaces the reference's
               hooked-ffmpeg control inversion, recode.cpp:79-237)
  models/    — adaptive probability model as dense arrays (replaces
               std::map<model_key, estimator>, recode.cpp:1064-1065)
  parallel/  — jax.sharding mesh pipelines: slice/GOP sharding, collectives
  utils/     — bit IO, NAL/RBSP, MP4 demux, recoded container format
  host/      — C++ native hot-path library (parser + coders + model mirror)
"""

__version__ = "0.1.0"


def compress(data, scope="gop", threads=0):
    """Compress (native library when built, Python reference otherwise)."""
    from .host import native

    if native.available():
        return native.compress(data, scope, threads)
    from .codec import compress as py_compress

    return py_compress(data, scope=scope)


def decompress(blob, threads=0):
    """Decompress a recoded container back to the original bytes."""
    from .host import native

    if native.available():
        return native.decompress(blob, threads)
    from .codec import decompress as py_decompress

    return py_decompress(blob)
