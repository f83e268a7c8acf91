"""Finding a cell's pieces by name.

``BENCHMARK.json`` (at the root of the checkout) lists the cells and the
metrics; everything else is a file of its own under this folder, found by
the name the entry gives:

    configs/<config>.json     one configuration
    traffic/<traffic>.json    one traffic mix
    models/<model>.py         one model family's reference pieces, named
                              by a configuration's ``model.module``
    metrics/<metric>.py       one per-layer metric's reader

A metric named ``<metric>.<suffix>`` is read by ``metrics/<metric>.py``:
the same quantity in cells that report another end-to-end metric.
Adding a configuration, a mix, a model family or a metric is adding its
file and its entry; nothing here names one.
"""
from __future__ import annotations

import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _load_json(here: str, kind: str, name: str) -> dict:
    path = os.path.join(here, kind, f"{name}.json")
    if not os.path.exists(path):
        raise KeyError(f"no {kind[:-1] if kind.endswith('s') else kind} "
                       f"named {name!r} ({path})")
    with open(path) as f:
        return json.load(f)


def config(name: str, here: str = HERE) -> dict:
    return _load_json(here, "configs", name)


def traffic(name: str, here: str = HERE) -> dict:
    return _load_json(here, "traffic", name)


def _load_module(here: str, kind: str, name: str):
    path = os.path.join(here, kind, f"{name}.py")
    if not os.path.exists(path):
        raise KeyError(f"no {kind[:-1]} named {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(
        f"phylobench_{kind}_{name.replace('.', '_').replace('-', '_')}",
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def model(name: str, here: str = HERE):
    """The model family ``name``'s module: its state count, the program
    state's fields it reads, each division's parameters, Q, the
    parameters' prior and their ``.p`` columns."""
    return _load_module(here, "models", name)


def metric(name: str, here: str = HERE):
    """The reader module of per-layer metric ``name`` (of
    ``<name>.<suffix>``, the same reader): ``NAME``, ``UNIT`` and
    ``read(record)``, which returns the value or None where the record
    holds nothing to read."""
    base = name.split(".")[0]
    mod = _load_module(here, "metrics", base)
    if mod.NAME != base:
        raise ValueError(f"metrics/{base}.py defines NAME {mod.NAME!r}")
    return mod


def workload(name: str, bench: dict) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload named {name!r} in BENCHMARK.json")


def end_to_end(name: str, bench: dict) -> list[dict]:
    """The end-to-end metrics cell ``name`` reports."""
    return [m for m in bench["end_to_end"]
            if name in m.get("workloads", [name])]


def per_layer(name: str, bench: dict) -> list[dict]:
    """The per-layer metrics cell ``name`` reports: those that list it,
    and those without a list whose end-to-end metric it reports."""
    e2e = {m["name"] for m in end_to_end(name, bench)}
    return [m for m in bench["per_layer"]
            if (name in m["workloads"] if "workloads" in m
                else m["moves"] in e2e)]
