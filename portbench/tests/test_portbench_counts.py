"""The least time of each step from the benchmark's own field lists."""
import pytest

from portbench import counts


def test_fused_nl_bound_is_the_kernel_table_figure():
    """26 values a column-level (15 read, 11 written, the interface rows
    one longer) at f32, 65,536 x 137: 0.2791 ms by bytes."""
    spec = counts.load("nl_fused")
    assert round(counts.least_time_s([spec], 137, 65536, "float32", False) * 1e3, 4) == 0.2791
    assert counts.launch_bytes(spec, 137, 65536, "float32", False) == 4 * (26 * 137 * 65536 + 5 * 65536 + 137)


def test_tl_and_ad_bounds_at_f64():
    """TL ``tangent_only`` 32 in + 10 out; AD ``cotangent_only`` 16 state
    + 9 seeds (``covptot_i`` is read only with evaporation) + 16 out: about
    0.90 and 0.88 ms at f64, 65,536 x 137."""
    tl, ad = counts.load("tl_tangent_only"), counts.load("ad_cotangent_only")
    ms = [counts.least_time_s([s], 137, 65536, "float64", False) * 1e3 for s in (tl, ad)]
    assert ms == pytest.approx([0.9015, 0.8800], abs=5e-4)
    with_evap = counts.launch_bytes(ad, 137, 65536, "float64", True)
    assert with_evap - counts.launch_bytes(ad, 137, 65536, "float64", False) == 8 * 137 * 65536


def test_bound_is_the_larger_of_bytes_and_operations():
    spec = counts.load("nl_fused")
    fast_memory = {"hbm_bytes_per_s": 1e30, "flops_per_s": {"float32": 67e12}}
    assert counts.least_time_s([spec], 137, 65536, "float32", False, fast_memory) == pytest.approx(
        360 * 137 * 65536 / 67e12)


def test_evaporation_switches():
    assert not counts.evaporation({"LEVAPLS2": False, "LDRAIN1D": False})
    assert counts.evaporation({"LEVAPLS2": True}) and counts.evaporation({"LDRAIN1D": True})
