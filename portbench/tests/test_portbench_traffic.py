import pytest

pytest.importorskip("numpy")

from portbench import spec, traffic  # noqa: E402

MIXES = ("paper-1k1k-c256", "paper-1k1k-c64")

#: a mix of spread lengths, to see the order move while the sizes stay
SPREAD = dict(loop="closed", clients=16, block=32,
              prompt=dict(dist="lognormal", median=100, sigma=0.5, min=20,
                          max=400),
              output=dict(dist="lognormal", median=50, sigma=0.8, min=4,
                          max=300))


def _take(stream, n):
    return [stream.next() for _ in range(n)]


def _mixes():
    return [spec.mix(name) for name in MIXES] + [SPREAD]


@pytest.mark.parametrize("mix", _mixes(), ids=MIXES + ("spread",))
def test_same_seed_same_requests(mix):
    a, b = (traffic.Traffic(mix, 2**31 + 11, 1000) for _ in range(2))
    assert a.initial() == b.initial()
    assert _take(a, 3 * mix["block"]) == _take(b, 3 * mix["block"])


@pytest.mark.parametrize("mix", _mixes(), ids=MIXES + ("spread",))
def test_every_seed_sends_the_same_sizes_in_its_own_order(mix):
    n = mix["block"]

    def sizes(seed):
        s = traffic.Traffic(mix, seed, 1000)
        first = [(len(p), k) for p, k in s.initial()]
        return first, [(len(p), k) for p, k in _take(s, 3 * n)]

    one, two = sizes(1), sizes(2**32 + 5)
    assert sorted(one[0]) == sorted(two[0])
    blocks = [sorted(one[1][i * n:(i + 1) * n]) for i in range(3)]
    assert blocks[0] == blocks[1] == blocks[2] == sorted(two[1][:n])
    if len(set(one[1][:n])) > 1:
        assert one[1][:n] != one[1][n:2 * n]        # each block reordered
        assert one[1] != two[1]                     # by the seed
    s1, s2 = traffic.Traffic(mix, 1, 1000), traffic.Traffic(mix, 7, 1000)
    assert s1.next()[0] != s2.next()[0]             # the tokens move


@pytest.mark.parametrize("name", MIXES)
def test_lengths_follow_the_mix(name):
    mix = spec.mix(name)
    s = traffic.Traffic(mix, 3, 50)
    reqs = _take(s, mix["block"])
    lo, hi = mix["prompt"]["min"], mix["prompt"]["max"]
    assert all(lo <= len(p) <= hi for p, _ in reqs)
    assert all(mix["output"]["min"] <= k <= mix["output"]["max"]
               for _, k in reqs)
    assert all(1 <= t < 50 for p, _ in reqs for t in p)
    # every request, those in flight at the start too, fits the cache
    cap = mix["prompt"]["max"] + mix["output"]["max"]
    assert cap <= mix["max_len"]
    first = s.initial()
    assert len(first) == mix["clients"] <= mix["max_batch"]
    assert all(len(p) + k <= cap for p, k in first)


@pytest.mark.parametrize("mix", _mixes(), ids=MIXES + ("spread",))
def test_the_window_opens_in_the_steady_state(mix):
    """The requests in flight at the start hold the steady state's
    remaining tokens (mean E[L^2] / (2 E[L]) over the block) and, in the
    cache, the prompt and the answer so far."""
    s = traffic.Traffic(mix, 5, 1000)
    first = s.first
    outs = [k for _, k in s.block]
    want = sum(k * k for k in outs) / (2 * sum(outs))
    assert sum(k for _, k in first) / len(first) == pytest.approx(
        want, rel=0.03)
    assert all(2 <= k for _, k in first)
    totals = {p + k for p, k in s.block}
    assert all(p + k in totals for p, k in first)


def test_in_flight_of_equal_requests_are_uniform():
    got = traffic.in_flight([(7, 10)] * 3, 5)
    assert [k for _, k in got] == [2, 3, 5, 7, 9]
    assert [p for p, _ in got] == [15, 14, 12, 10, 8]


def test_quantile_lengths_are_mid_quantiles():
    got = traffic.quantile_lengths(
        dict(dist="uniform", min=0, max=100), 4)
    assert got == [12, 38, 62, 88]
    got = traffic.quantile_lengths(
        dict(dist="uniform", min=1024, max=1024), 3)
    assert got == [1024] * 3
    got = traffic.quantile_lengths(
        dict(dist="lognormal", median=100, sigma=0.5, min=1, max=10**6), 3)
    assert got[1] == 100 and got[0] < 100 < got[2]
