"""Objects of the program from a traffic file's JSON.

A value ``{"type": T, "args": [...], "kwargs": {...}}`` is the program's
public ``advancedmh_tpu_torch.T`` called with its arguments, each built the
same way; ``{"zeros": n}`` is a float32 zero vector of length n on the
device; ``{"config": key}`` is the object ``key`` that the configuration's
module makes from its data (``configs/<c>.py::program_objects(cfg, data,
device) -> dict``), such as a prior built from a kernel matrix; numbers,
strings and lists of numbers stay as they are.
"""
from __future__ import annotations

from typing import Any, Callable, Optional

import torch


def config_objects(cell, cfgmod, data, device) -> Callable[[str], Any]:
    """The resolver of ``{"config": key}`` values of ``cell``'s traffic:
    ``program_objects`` runs once, at the first such value."""
    made: Optional[dict] = None

    def resolve(key: str):
        nonlocal made
        where = f"configs/{cell.config['name']}.py"
        if made is None:
            make = getattr(cfgmod, "program_objects", None)
            if make is None:
                raise LookupError(f"cell {cell.name}: the traffic asks for {{'config': {key!r}}}"
                                  f" but {where} has no program_objects(cfg, data, device)")
            made = dict(make(cell.config, data, device))
        if key not in made:
            raise LookupError(f"cell {cell.name}: the traffic asks for {{'config': {key!r}}}"
                              f" but {where}::program_objects makes only {sorted(made)}")
        return made[key]

    return resolve


def build(spec, amh, device, objects: Callable[[str], Any]):
    """The program's object for the JSON value ``spec``; ``objects``
    resolves ``{"config": key}`` values (:func:`config_objects`)."""
    if isinstance(spec, dict) and "config" in spec:
        return objects(spec["config"])
    if isinstance(spec, dict) and "zeros" in spec:
        return torch.zeros(int(spec["zeros"]), dtype=torch.float32, device=device)
    if isinstance(spec, dict) and "type" in spec:
        fn = getattr(amh, spec["type"])
        args = [build(a, amh, device, objects) for a in spec.get("args", [])]
        kwargs = {k: build(v, amh, device, objects) for k, v in spec.get("kwargs", {}).items()}
        return fn(*args, **kwargs)
    if isinstance(spec, list) and not all(isinstance(v, (int, float)) for v in spec):
        return [build(v, amh, device, objects) for v in spec]
    return spec
