"""The arrivals and the latency arithmetic."""

import math

import numpy as np
import pytest

from perfbench import traffic


def test_due_times_are_determined_by_the_seed():
    a = traffic.due_times(40.0, 20.0, 2**31 + 5, "poisson")
    b = traffic.due_times(40.0, 20.0, 2**31 + 5, "poisson")
    c = traffic.due_times(40.0, 20.0, 2**31 + 6, "poisson")
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)


@pytest.mark.parametrize("seed", [0, 2**31 + 5])
def test_periodic_arrivals_come_every_period(seed):
    due = traffic.due_times(30.0, 50.0, seed, "periodic")
    assert len(due) == 1500 and due[0] == 0.0
    np.testing.assert_allclose(np.diff(due), 1 / 30.0)


def test_unknown_arrivals_are_refused():
    with pytest.raises(ValueError, match="arrivals"):
        traffic.due_times(30.0, 1.0, 0, "bursty")


@pytest.mark.parametrize("rate,seconds", [(40.0, 20.0), (75.0, 10.0)])
def test_every_seed_gets_the_same_work_at_the_mean_rate(rate, seconds):
    spans, counts = [], []
    for seed in range(5):
        due = traffic.due_times(rate, seconds, seed, "poisson")
        gaps = np.sort(np.diff(np.concatenate([due, [np.nan]]))[:-1])
        counts.append(len(due))
        spans.append(due[-1])
        assert due[0] == 0.0 and np.all(np.diff(due) > 0)
    assert len(set(counts)) == 1 and counts[0] == round(rate * seconds)
    # the same gaps in another order: the span moves by one gap at most
    assert max(spans) - min(spans) < 10.0 / rate
    assert abs(counts[0] / max(spans) - rate) / rate < 0.05
    assert gaps[0] > 0


def test_a_stall_counts_against_every_request_behind_it():
    due = [0.0, 0.010, 0.020, 0.030]
    # the first request stalls for 50 ms; the rest are served back to back
    # in 5 ms each as soon as the one before returns
    done = [0.050, 0.055, 0.060, 0.065]
    lat = traffic.latency_ms(due, done)
    np.testing.assert_allclose(lat, [50.0, 45.0, 40.0, 35.0])
    start = [0.0, 0.050, 0.055, 0.060]
    assert traffic.lateness_growth_ms(due, start) == pytest.approx(30.0)


def test_a_failed_request_misses_every_limit():
    lat = traffic.latency_ms([0.0, 0.1, 0.2, 0.3], [0.01, None, 0.21, 0.31])
    assert math.isinf(lat[1])
    assert traffic.percentile(lat, 50) == pytest.approx(10.0)
    assert math.isinf(traffic.percentile(lat, 95))


def test_percentile_interpolates_between_order_statistics():
    lat = np.arange(1.0, 101.0)
    assert traffic.percentile(lat, 95) == pytest.approx(np.percentile(lat, 95))
    assert traffic.percentile(lat, 50) == pytest.approx(50.5)


def test_the_knee_sweep_stops_at_the_first_fraction_that_fails():
    """A fraction holds only when it holds on every seed, and nothing
    above the first failure is tried, even where it would pass."""
    from perfbench import knee
    p95 = {(0.5, 1): 20.0, (0.5, 2): 21.0, (0.6, 1): 25.0, (0.6, 2): 34.0,
           (0.7, 1): 20.0, (0.7, 2): 20.0}
    tried = []

    def window(f, seed):
        tried.append((f, seed))
        return {"p95_ms": p95[f, seed], "failed": 0,
                "lateness_growth_ms": 0.0}
    lines = []
    got = knee.sweep([0.7, 0.5, 0.6], [1, 2], window, 33.3, lines.append)
    assert got == 0.5
    assert tried == [(0.5, 1), (0.5, 2), (0.6, 1), (0.6, 2)]
    assert [x["sustained"] for x in lines] == [True, True, True, False]


@pytest.mark.parametrize("line", [
    {"p95_ms": 30.0, "failed": 1, "lateness_growth_ms": 0.0},
    {"p95_ms": 30.0, "failed": 0, "lateness_growth_ms": 6.0},
    {"p95_ms": 33.4, "failed": 0, "lateness_growth_ms": 0.0}])
def test_a_window_holds_only_within_every_condition(line):
    from perfbench import knee
    assert not knee.sustained(line, 33.3)
    assert knee.sustained({**line, "p95_ms": 30.0, "failed": 0,
                           "lateness_growth_ms": 0.0}, 33.3)
