"""The traffic: each mix's generator is found by the name its data file
gives; the same seed gives the same points, another seed other points, and
only the walked keys move."""

import itertools

import numpy as np
import pytest

from harness import manifest, traffic

BENCH = manifest.load()
CELLS = [w["name"] for w in BENCH["workloads"]]
SEEDS = (0, 7, 2**31 + 5, 2**40 + 3, -12)


def _setup(cell):
    entry = manifest.cell(BENCH, cell)
    return manifest.config(BENCH, entry), manifest.traffic(entry["traffic"])


def _points(cell, seed, n=40):
    cfg, mix = _setup(cell)
    return list(itertools.islice(traffic.points(cfg, mix, seed), n))


def test_generator_found_by_name():
    """A mix names its generator, benchmark/traffic/<generator>.py; a name
    with no file is refused."""
    mix = manifest.traffic("chain")
    gen = manifest.generator(mix["generator"])
    cfg, _ = _setup(CELLS[0])
    assert next(gen(cfg, mix, 4)) == next(traffic.points(cfg, mix, 4))
    with pytest.raises(FileNotFoundError):
        manifest.generator("no_such_generator")


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", SEEDS)
def test_same_seed_same_points(cell, seed):
    assert _points(cell, seed) == _points(cell, seed)


@pytest.mark.parametrize("cell", CELLS)
def test_seeds_differ(cell):
    walks = [_points(cell, s, 5) for s in SEEDS]
    for a, b in itertools.combinations(walks, 2):
        assert a != b


@pytest.mark.parametrize("cell", CELLS)
def test_only_walked_keys_move(cell):
    cfg, _ = _setup(cell)
    walked = {k.split("[")[0] for k in cfg["walk"]}
    for p in _points(cell, 3, 10):
        assert set(p) == set(cfg["params"])
        assert {k for k in p if p[k] != cfg["params"][k]} <= walked


def test_list_keys_walk_each_entry():
    cfg, mix = _setup("des_y1.chain")
    p = next(traffic.points(cfg, mix, 11))
    base = traffic._split(cfg["params"]["selection_bias"])
    moved = traffic._split(p["selection_bias"])
    assert len(moved) == len(base) and all(a != b for a, b in zip(moved, base))
    assert traffic.value_of(p, "selection_bias[2]") == moved[2]


def test_walk_stays_near_the_centre():
    """The stand-in posterior holds the walk: over 4000 proposals of one seed
    each parameter's mean offset is within one width of the centre and its
    spread within three."""
    cfg, mix = _setup("planck18.chain")
    keys = list(cfg["walk"])
    sig = np.array([cfg["walk"][k] for k in keys])
    centre = np.array([traffic.value_of(cfg["params"], k) for k in keys])
    x = np.array([[traffic.value_of(p, k) for k in keys]
                  for p in itertools.islice(traffic.points(cfg, mix, 5), 4000)])
    z = (x - centre) / sig
    assert np.all(np.abs(z.mean(axis=0)) < 1.0) and np.all(z.std(axis=0) < 3.0)
