"""The traffic generator: a pure function of its mix and its seed."""
import json

import numpy as np
import pytest

from conftest import ROOT


def mixes():
    return sorted(p.stem for p in (ROOT / "portbench" / "traffic")
                  .glob("*.json"))


@pytest.mark.parametrize("mix", mixes())
def test_same_seed_same_rows(mix):
    from portbench import feed
    traffic = json.loads((ROOT / "portbench" / "traffic" / f"{mix}.json")
                         .read_text())
    traffic = dict(traffic, seq=32)
    a_clients, a_test = feed.make(traffic, 1000, 2 ** 31 + 77, 2)
    b_clients, b_test = feed.make(traffic, 1000, 2 ** 31 + 77, 2)
    c_clients, _ = feed.make(traffic, 1000, 2 ** 31 + 78, 2)
    for a, b, c in zip(a_clients, b_clients, c_clients):
        for key in ("tokens", "labels"):
            np.testing.assert_array_equal(a[key], b[key])
            assert a[key].shape == c[key].shape
        assert not np.array_equal(a["tokens"], c["tokens"])
    np.testing.assert_array_equal(a_test["tokens"], b_test["tokens"])
    rows = 2 * traffic["local_steps"] * traffic["rows_per_step"]
    assert len(a_clients) == traffic["clients"]
    assert a_clients[0]["tokens"].shape == (rows, 32)
    assert a_test["tokens"].shape == (traffic["test_rows"], 32)


def test_rows_and_labels():
    """Labels are the next tokens; every row of a client is distinct;
    tokens stay inside the vocabulary."""
    from portbench import feed
    rows = feed.token_rows(6, 50, 97, 5)
    np.testing.assert_array_equal(rows["tokens"][:, 1:],
                                  rows["labels"][:, :-1])
    assert len({r.tobytes() for r in rows["tokens"]}) == 6
    assert rows["tokens"].dtype == np.int32
    assert 0 <= rows["tokens"].min() and rows["tokens"].max() < 97


def test_seeds_take_any_whole_number():
    from portbench import feed
    for seed in (0, 2 ** 31 - 1, 2 ** 31 + 1, 2 ** 40):
        s = feed.seeds(seed, 4)
        assert len(set(s)) == 4 and all(0 <= x < 2 ** 30 for x in s)
    assert feed.seeds(2 ** 31 + 1, 4) != feed.seeds(2 ** 31 + 2, 4)


def test_tokens_per_round():
    from portbench import feed
    long = json.loads((ROOT / "portbench/traffic/long-1x4096.json")
                      .read_text())
    short = json.loads((ROOT / "portbench/traffic/short-8x512.json")
                       .read_text())
    assert feed.tokens_per_round(long) == 3 * 2 * 1 * 4096 == 24576
    assert feed.tokens_per_round(short) == 3 * 2 * 8 * 512 == 24576
