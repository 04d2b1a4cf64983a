"""Platform plumbing: the compile-cache location, the device peak table,
and the chip smoke's refusal to run without a GPU."""

import json
import os
import subprocess
import sys
from types import SimpleNamespace

import pytest

from visionx_slam_tpu.utils import cache, flops

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("env_dir", ["", "/some/shared/jax-cache"])
def test_compile_cache_dir(env_dir):
    environ = {cache.ENV_VAR: env_dir} if env_dir else {}
    got = cache.compile_cache_dir(environ)
    if env_dir:
        assert got == env_dir
    else:
        # a fixed path inside the checkout: never temp-, pid- or time-based
        assert got == os.path.join(REPO, ".jax_cache")
        assert got == cache.compile_cache_dir({})


def test_device_peaks_known_and_unknown():
    h100 = SimpleNamespace(device_kind="NVIDIA H100 80GB HBM3")
    p = flops.device_peaks(h100)
    assert p["flops_bf16"] == 989e12 and p["flops_int8"] == 1979e12
    assert p["hbm_Bps"] == 3.35e12
    assert p["device_kind"] == "NVIDIA H100 80GB HBM3"
    with pytest.raises(KeyError):
        flops.device_peaks(SimpleNamespace(device_kind="cpu"))
    with pytest.raises(KeyError):
        flops.summarize([], 1e-3, flops.device_peaks(
            SimpleNamespace(device_kind="NVIDIA A100-SXM4-80GB")))


def test_chip_smoke_refuses_cpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    for line in r.stdout.splitlines():
        with pytest.raises(json.JSONDecodeError):
            json.loads(line)
