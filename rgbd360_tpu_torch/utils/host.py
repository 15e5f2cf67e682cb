"""Bringing device results to the host."""

from __future__ import annotations

import dataclasses

import torch


def fetch(tree):
    """The tensors of a result (a dataclass, tuple or list of tensors, or a
    tensor) on the host in ONE device-to-host copy: every leaf goes into
    one float64 buffer (exact for the f32, int and bool fields results
    carry) and is cut back out with its dtype and shape."""
    leaves = []

    def collect(x):
        if isinstance(x, torch.Tensor):
            leaves.append(x)
        elif dataclasses.is_dataclass(x) and not isinstance(x, type):
            for f in dataclasses.fields(x):
                collect(getattr(x, f.name))
        elif isinstance(x, (tuple, list)):
            for v in x:
                collect(v)

    collect(tree)
    if not leaves:
        return tree
    flat = torch.cat([t.detach().reshape(-1).to(torch.float64) for t in leaves]).cpu()
    host = iter(
        part.reshape(t.shape).to(t.dtype)
        for part, t in zip(torch.split(flat, [t.numel() for t in leaves]), leaves)
    )

    def rebuild(x):
        if isinstance(x, torch.Tensor):
            return next(host)
        if dataclasses.is_dataclass(x) and not isinstance(x, type):
            return dataclasses.replace(
                x, **{f.name: rebuild(getattr(x, f.name)) for f in dataclasses.fields(x)}
            )
        if isinstance(x, (tuple, list)):
            return type(x)(rebuild(v) for v in x)
        return x

    return rebuild(tree)
