"""The quantile sequence: lengths by law, the same requests for the same
seed, the same lengths for every seed, and windows that cover the law."""
import math
import statistics

import numpy as np
import pytest

from portbench.traffic import Traffic, biased_table, load_mix, quantile

MIXES = [("chat", "dsmoe16b"), ("chat", "mamba2"), ("longdoc", "dsmoe16b"),
         ("longdoc", "mamba2")]


def test_quantile_laws():
    law = {"law": "lognormal", "median": 512, "sigma": 1.0, "min": 64, "max": 2048}
    assert quantile(law, 0.5) == 512
    assert quantile(law, 1e-6) == 64 and quantile(law, 1 - 1e-6) == 2048
    lu = {"law": "loguniform", "min": 2048, "max": 3968}
    assert quantile(lu, 0.0) == 2048 and quantile(lu, 1.0) == 3968
    assert quantile(lu, 0.5) == round(math.sqrt(2048 * 3968))
    un = {"law": "uniform", "min": 8, "max": 32}
    assert {quantile(un, (i + 0.5) / 250) for i in range(250)} == set(range(8, 33))
    with pytest.raises(ValueError):
        quantile({"law": "zipf", "min": 1, "max": 2}, 0.5)


@pytest.mark.parametrize("mix,config", MIXES)
def test_same_seed_same_requests(mix, config):
    spec = load_mix(mix, config)
    a, b = Traffic(spec, 2**31 + 12345, 50280), Traffic(spec, 2**31 + 12345, 50280)
    for i in (0, 1, 17, 500):
        (ta, na), (tb, nb) = a.request(i), b.request(i)
        assert na == nb and np.array_equal(ta, tb)
        assert ta.dtype == np.int32 and 0 <= ta.min() and ta.max() < 50280


@pytest.mark.parametrize("mix,config", MIXES)
def test_seeds_share_lengths_not_tokens(mix, config):
    spec = load_mix(mix, config)
    a, b = Traffic(spec, 7, 1000), Traffic(spec, 8, 1000)
    assert [a.lengths(i) for i in range(300)] == [b.lengths(i) for i in range(300)]
    assert not np.array_equal(a.request(3)[0], b.request(3)[0])


@pytest.mark.parametrize("mix,config", MIXES)
def test_windows_cover_the_law(mix, config):
    """Any n consecutive requests: mean prompt length within the
    Koksma-Hlawka bound (range of the law times a discrepancy of order
    log(n)/n) of the law's mean, wherever the window starts; independent
    draws of the same law miss by a law's deviation over sqrt(n)."""
    spec = load_mix(mix, config)
    t = Traffic(spec, 1, 1000)
    law = spec["prompt"]
    grid = [quantile(law, (i + 0.5) / 20000) for i in range(20000)]
    mean = statistics.fmean(grid)
    n = 200
    bound = (law["max"] - law["min"]) * 2 * math.log(n) / n
    for start in (0, 57, 1000, 12345):
        window = [t.lengths(i)[0] for i in range(start, start + n)]
        assert abs(statistics.fmean(window) - mean) <= bound
    assert bound < statistics.pstdev(grid) / math.sqrt(n) * 3


def test_in_flight_is_a_share_of_a_biased_length():
    spec = load_mix("chat", "mamba2")
    t = Traffic(spec, 3, 1000)
    lengths, cdf = biased_table(spec["output"])
    assert cdf[-1] == pytest.approx(1.0) and np.all(np.diff(lengths) >= 0)
    left = [t.in_flight(j, 32)[1] for j in range(32)]
    assert all(1 <= x <= spec["output"]["max"] for x in left)
    # a busy slot holds longer requests than the law's mean
    assert statistics.fmean(lengths[np.searchsorted(cdf, np.linspace(0.01, 0.99, 99))]) > \
        statistics.fmean(t.lengths(i)[1] for i in range(1000))
