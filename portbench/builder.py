"""Objects of the program from a traffic file's JSON.

A value ``{"type": T, "args": [...], "kwargs": {...}}`` is the program's
public ``advancedmh_tpu_torch.T`` called with its arguments, each built the
same way; ``{"zeros": n}`` is a float32 zero vector of length n on the
device; numbers, strings and lists of numbers stay as they are.
"""
from __future__ import annotations

import torch


def build(spec, amh, device):
    if isinstance(spec, dict) and "zeros" in spec:
        return torch.zeros(int(spec["zeros"]), dtype=torch.float32, device=device)
    if isinstance(spec, dict) and "type" in spec:
        fn = getattr(amh, spec["type"])
        args = [build(a, amh, device) for a in spec.get("args", [])]
        kwargs = {k: build(v, amh, device) for k, v in spec.get("kwargs", {}).items()}
        return fn(*args, **kwargs)
    if isinstance(spec, list) and not all(isinstance(v, (int, float)) for v in spec):
        return [build(v, amh, device) for v in spec]
    return spec
