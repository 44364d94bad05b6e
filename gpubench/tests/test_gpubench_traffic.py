"""Traffic is deterministic per seed, and every seed gets the same sizes
and gaps in another order."""

from __future__ import annotations

import json

import numpy as np

from gpubench import traffic

from conftest import REPO

FILES = json.loads((REPO / "gpubench/traffic/files-default.json").read_text())
SERVE = json.loads((REPO / "gpubench/traffic/serve-open.json").read_text())
BIG = 2 ** 31 + 987654321


def test_same_seed_same_inputs():
    assert traffic.pool(FILES, BIG) == traffic.pool(FILES, BIG)
    assert traffic.schedule(SERVE, BIG, 20.0) == \
        traffic.schedule(SERVE, BIG, 20.0)
    a = traffic.signal(BIG, 2.0, 22050)
    assert a.dtype == np.dtype("<i2")
    assert np.array_equal(a, traffic.signal(BIG, 2.0, 22050))
    assert not np.array_equal(a, traffic.signal(BIG + 1, 2.0, 22050))


def test_seeds_change_order_not_work():
    p1, p2 = traffic.pool(FILES, 1), traffic.pool(FILES, BIG)
    assert [c.samples for c in p1] != [c.samples for c in p2]
    assert sorted(c.samples for c in p1) == sorted(c.samples for c in p2)
    s1, s2 = traffic.schedule(SERVE, 1, 20.0), traffic.schedule(SERVE, BIG, 20.0)
    assert sorted(c.samples for c in s1) == sorted(c.samples for c in s2)
    gaps = [sorted(np.diff([c.due_s for c in s] + [20.0])) for s in (s1, s2)]
    assert np.allclose(gaps[0], gaps[1])


def test_pool_and_schedule_shapes():
    pool = traffic.pool(FILES, BIG)
    sizes = np.array([c.samples for c in pool]) / 22050
    assert len(pool) == 32 and sizes.min() >= 10 and sizes.max() <= 300
    assert 75 < sizes.mean() < 95           # log-uniform 10-300: about 86 s
    span = int(FILES["signal_s"] * 22050)
    assert all(0 <= c.offset <= span - c.samples for c in pool)
    sched = traffic.schedule(SERVE, BIG, 20.0, rate=12.0)
    assert len(sched) == 240
    due = [c.due_s for c in sched]
    assert due[0] == 0.0 and all(b >= a for a, b in zip(due, due[1:]))
    assert due[-1] < 20.0


def test_sample_keeps_the_longest():
    for seed in (0, 5, BIG):
        picked = traffic.sample_indices(40, 6, longest=17, seed=seed)
        assert 17 in picked and len(picked) == 6 == len(set(picked))
    assert traffic.sample_indices(3, 6, longest=2, seed=1) == [0, 1, 2]


def test_wav_bytes_read_back_by_the_program():
    from nat_tpu_torch.io.audio import decode_bytes_ex

    pcm = traffic.signal(3, 0.5, 22050)
    audio, sr, i16 = decode_bytes_ex(traffic.wav_bytes(pcm, 22050))
    assert sr == 22050 and np.array_equal(i16, pcm)
    assert np.array_equal(audio, pcm.astype(np.float32) / 32768.0)
