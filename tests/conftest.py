import os
import subprocess

# Tests run on the CPU, with a virtual 8-device mesh so multi-device sharding
# paths are exercised without several cards.  `pytest -m gpu` selects the
# tests that need the card and leaves the platform to JAX's default.
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
).strip()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a GPU; skips without one (pytest -m gpu)")
    if config.option.markexpr != "gpu":
        os.environ["JAX_PLATFORMS"] = "cpu"
        import jax

        jax.config.update("jax_platforms", "cpu")


# Build the test-clip generator and the native library once per session
# (fresh clones have neither; several test modules shell out to them).
# Best-effort: without a toolchain, clip-generating tests fail loudly and
# native tests skip, but pure-Python tests still run.
_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
_GEN = os.path.join(_ROOT, "tools", "genvideo")
os.makedirs(os.path.join(_ROOT, "data"), exist_ok=True)
try:
    if not os.path.exists(_GEN):
        subprocess.run(
            ["gcc", "-O2", "-o", _GEN, _GEN + ".c", "-lavformat", "-lavcodec",
             "-lavutil", "-lm"],
            check=True,
        )
    if not os.path.exists(os.path.join(_ROOT, "avrecode_tpu", "host", "libavtpu.so")):
        subprocess.run(
            ["make", "-C", os.path.join(_ROOT, "avrecode_tpu", "host")],
            check=True,
            capture_output=True,
        )
except Exception as e:  # pragma: no cover
    import warnings

    warnings.warn(f"session build step failed: {e!r}")
