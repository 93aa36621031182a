"""bench.py: the peak table, the analytic work model and the roofline
annotation (pure host math — no device work), and the refusal to measure
anything but a GPU."""

import json
import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import bench  # noqa: E402

H100 = "NVIDIA H100 80GB HBM3"


def test_peak_table_known_kind():
    peak = bench.peak_for(H100)
    assert peak["f32_flops"] == 67e12
    assert peak["hbm_Bps"] == 3.35e12
    assert "data sheet" in peak["source"]


@pytest.mark.parametrize("kind", ["cpu", "NVIDIA A100-SXM4-80GB", ""])
def test_peak_table_unknown_kind_raises(kind):
    with pytest.raises(ValueError, match="no peak rates"):
        bench.peak_for(kind)


def test_flops_bytes_scale_with_problem():
    fl1, by1, re1 = bench.solve_flops_bytes("pcg", 14, 7, 50, 27)
    fl2, by2, _ = bench.solve_flops_bytes("pcg", 14, 7, 100, 27)
    # Condense/PCG/recover all scale linearly in K.
    assert 1.8 < fl2 / fl1 < 2.2
    assert 1.8 < by2 / by1 < 2.2
    # More iterations -> more flops and more re-streamed bytes, same floor.
    fl3, by3, re3 = bench.solve_flops_bytes("pcg", 14, 7, 50, 54)
    assert fl3 > fl1 and by3 == by1 and re3 > re1
    assert re1 > by1


def test_direct_kinds():
    """Exact solves read their operator a fixed number of times (floor ==
    restream); cyclic reduction does more arithmetic than Thomas."""
    cr = bench.solve_flops_bytes("direct_cr", 14, 7, 1024, 0)
    th = bench.solve_flops_bytes("direct_thomas", 14, 7, 1024, 0)
    assert cr[1] == cr[2] and th[1] == th[2]
    assert cr[0] > th[0]
    with pytest.raises(ValueError):
        bench.solve_flops_bytes("fused", 14, 7, 50, 27)


def test_annotate_roofline_fields_and_bounds():
    e = bench.annotate_roofline({"ms_median": 0.5}, 14, 7, 50, "pcg", H100,
                                iters=27)
    r = e["roofline"]
    for f in ("flops", "bytes_floor", "bytes_restream", "achieved_gflops",
              "achieved_gbps", "roofline_ms", "pct_of_roofline", "bound",
              "peak_source"):
        assert f in r
    assert 0 < r["pct_of_roofline"] < 100
    # A time of twice the bandwidth floor reads 50 %, bandwidth-bound.
    fl, floor, _ = bench.solve_flops_bytes("pcg", 14, 7, 4096, 31)
    peak = bench.peak_for(H100)
    floor_ms = max(fl / peak["f32_flops"], floor / peak["hbm_Bps"]) * 1e3
    e2 = bench.annotate_roofline({"ms_median": 2.0 * floor_ms}, 14, 7, 4096,
                                 "pcg", H100, iters=31)
    assert e2["roofline"]["bound"] == "bandwidth"
    assert e2["roofline"]["pct_of_roofline"] == pytest.approx(50.0)
    # A batch multiplies the work, not the share.
    e3 = bench.annotate_roofline({"ms_median": 512 * floor_ms}, 14, 7, 4096,
                                 "pcg", H100, iters=31, batch=256)
    assert e3["roofline"]["pct_of_roofline"] == pytest.approx(50.0)


def test_annotate_roofline_skips_unmeasured():
    e = bench.annotate_roofline({"ms_median": 0.0}, 14, 7, 50, "pcg", H100)
    assert "roofline" not in e
    with pytest.raises(ValueError, match="no peak rates"):
        bench.annotate_roofline({"ms_median": 1.0}, 14, 7, 50, "pcg", "cpu")


def test_jsonable_casts_numpy():
    """Every dict bench prints must be json.dumps-able — NumPy scalars
    leaking onto a stdout line would break a JSON reader."""
    d = {"a": np.float64(7.0), "b": np.int32(3), "c": [np.float32(1.5)],
         "d": {"e": np.arange(2)}}
    out = bench._jsonable(d)
    json.dumps(out)
    assert out["a"] == 7.0 and out["d"]["e"] == [0, 1]


def test_rows_run_in_abba_order():
    rows = [("a", 50, 1, "pcg", "triton"), ("b", 50, 1, "pcg", "jax"),
            ("c", 50, 1, "direct", None)]
    assert [r[0] for r in bench._ordered(rows)] == ["a", "b", "b", "a", "c"]


def test_main_refuses_cpu(capsys):
    """No GPU: nonzero exit, no row printed."""
    assert bench.main(["--rows", "iiwa_b1_pcg", "--reps", "1"]) == 1
    assert capsys.readouterr().out == ""
