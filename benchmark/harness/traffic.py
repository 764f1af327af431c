"""Traffic: the points a cell's window computes, from its mix's data file.

A mix is `benchmark/traffic/<traffic>.json`, whose `generator` names the
generator that reads it, `benchmark/traffic/<generator>.py`, found by name:
its `points(config, mix, seed)` yields classy parameter dicts, endless, from
the seed alone. The helpers here place a walked value in the parameter
dict: a key `name[i]` is the i-th entry of a comma-separated list such as
`selection_bias`.
"""

from __future__ import annotations

import re
from typing import Iterator

_LIST_KEY = re.compile(r"^(.+)\[(\d+)\]$")


def _split(value) -> list:
    return [float(v) for v in str(value).replace(",", " ").split()]


def value_of(params: dict, key: str) -> float:
    m = _LIST_KEY.match(key)
    if m:
        return _split(params[m.group(1)])[int(m.group(2))]
    return float(params[key])


def point(params: dict, keys: list, values) -> dict:
    """The classy parameter dict with the walked keys set to `values`."""
    out = dict(params)
    lists = {}
    for key, v in zip(keys, values):
        m = _LIST_KEY.match(key)
        if m:
            name = m.group(1)
            lists.setdefault(name, _split(params[name]))[int(m.group(2))] = float(v)
        else:
            out[key] = float(v)
    for name, vals in lists.items():
        out[name] = ", ".join(repr(v) for v in vals)
    return out


def points(config: dict, mix: dict, seed: int) -> Iterator[dict]:
    """The mix's points: its generator's, found by the name it gives."""
    from . import manifest

    return manifest.generator(mix["generator"])(config, mix, seed)
