"""The traced stretch's arithmetic on hand-made records."""

from splatbench.trace import Stretch


def test_busy_is_the_union_and_gaps_name_the_host():
    device = [("k1", 0, 10), ("k2", 15, 20), ("k3", 40, 50), ("k4", 45, 60), ("k5", 100, 110)]
    host = [("outer", 0, 200), ("inner", 60, 100), ("cudaCall", 20, 40)]
    s = Stretch(device, host, wall_s=200e-6)
    assert abs(s.busy_s() - 45e-6) < 1e-12
    assert [(name, round(sec * 1e6)) for name, sec in s.idle_gaps()] == [
        ("inner", 40), ("cudaCall", 20), ("outer", 5)]
    assert s.device_ms()["k4"] == 0.015
    assert s.records(r"^k[12]$") == [0.01, 0.005]
    assert s.breakdown()["device_ops"][0][0] == "k4"

