"""chip_smoke.py's phases at a tiny size on the CPU, with the GPU check
injected: the same entry points, comparisons and tolerances the card runs at
full width (the Triton kernel phase runs interpreted here)."""

import sys
from pathlib import Path

import jax
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402

TINY = chip_smoke.Sizes(K=6, Ks=(6, 9), B=4, T=3, B_seq=2, B_grad=2,
                        n_check=2, K_mesh=8, B_mesh=4)


@pytest.mark.parametrize("phase", chip_smoke.ONE_CARD,
                         ids=lambda f: f.__name__)
def test_phase_tiny(phase):
    if phase is chip_smoke.phase_kernel:
        phase(TINY, interpret=True)
    else:
        phase(TINY)


def test_mesh_phase_on_four_cpu_devices():
    chip_smoke.phase_mesh(TINY, 4)


def test_run_reports_device_with_check_injected():
    seen = []
    device = chip_smoke.run(TINY, four=True, check_platform=seen.append)
    assert seen and seen[0].platform == "cpu"
    assert device == {"platform": "cpu", "kind": jax.devices()[0].device_kind,
                      "count": len(jax.devices())}


def test_require_gpu_refuses_cpu():
    with pytest.raises(SystemExit, match="needs a CUDA GPU"):
        chip_smoke.require_gpu(jax.devices()[0])


def test_failed_check_raises(capsys):
    with pytest.raises(chip_smoke.PhaseFailure):
        chip_smoke.check("demo", "err", 1.0, 1e-3)
    assert '"ok": false' in capsys.readouterr().out
    assert chip_smoke.rel_err([float("nan")], [1.0]) == float("inf")
