"""The cost counts behind the roofline metric."""

import math

from perfbench.lib import costs


def test_sol_time_takes_the_binding_resource():
    t, bound = costs.sol_time(3.35e12, fp32=0.0)
    assert (t, bound) == (1.0, "hbm")
    t, bound = costs.sol_time(1.0, fp32=67e12)
    assert math.isclose(t, 2.0) and bound == "fp32"
    t, bound = costs.sol_time(1.0, tensor=989e12 * 3)
    assert math.isclose(t, 3.0) and bound == "tensor"


def test_lane_mutual_counts_valid_rows_times_valid_rows():
    # Two lanes: 900 x 800 and 700 x 1000 valid rows at d = 33.
    entries = 900 * 800 + 700 * 1000
    expect = 35.0 * entries / 33.5e12
    assert math.isclose(costs.lane_mutual_seconds([900, 700], [800, 1000]), expect)
    # Bytes never bind at these sizes.
    bytes_s = (132.0 * 3400 + 3400 + 5.0 * 1600) / 3.35e12
    assert bytes_s < expect

