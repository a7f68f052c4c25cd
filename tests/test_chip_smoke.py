"""chip_smoke.py's phases at tiny sizes on the CPU: the same entry
points, oracles and checks the GPU run uses, so a broken phase shows
here before it costs card time. ``main`` itself refuses the CPU."""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402


@pytest.fixture(scope="module")
def pipeline_store(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("smoke"))
    return work, chip_smoke.phase_pipeline(work, n_symbols=16, n_check=3)


def test_phase_pipeline_tiny(pipeline_store):
    _, out = pipeline_store
    assert out["rows_written"]["minute_candles"] > 0
    assert out["max_rel_err"]["interp_rel"] < 1e-6


def test_phase_surface_tiny(pipeline_store):
    work, pipe = pipeline_store
    out = chip_smoke.phase_surface(pipe["root"], work,
                                   methods=("cubic_spline", "svi"),
                                   B=64, E=6, N=16, n_oracle=8)
    assert set(out["families"]) == {"cubic_spline", "svi"}
    assert out["parity"]["max_err_vs_scipy_x64"] <= chip_smoke.PARITY_TOL


def test_phase_stream_tiny():
    out = chip_smoke.phase_stream(B=8, L=256, n_minutes=64)
    assert out["tcp_ticks"] > 0 and len(out["refit_s"]) == 3


def test_phase_four_on_virtual_devices(tmp_path):
    """--four's comparison on 4 of the suite's virtual CPU devices."""
    out = chip_smoke.phase_four(str(tmp_path), n_devices=4, n_symbols=16)
    assert all(v is True for v in out["byte_identical"].values())


def test_main_refuses_cpu(capsys):
    assert chip_smoke.main([]) != 0
    out = capsys.readouterr()
    assert out.out == "" and "no GPU" in out.err
