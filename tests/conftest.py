"""Test config: CPU-only, 1 device (the dry-run's 512-device flag must NOT
leak here — launch/dryrun.py sets it in its own process only)."""
import os

# fail fast if someone set the dry-run flag globally
assert "xla_force_host_platform_device_count=512" not in \
    os.environ.get("XLA_FLAGS", ""), \
    "dry-run XLA_FLAGS leaked into the test environment"


def pytest_configure(config):
    config.addinivalue_line("markers", "slow: long-running test")
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card and nvcc (the port's CUDA "
        "kernels); skips elsewhere")
