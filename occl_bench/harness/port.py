"""The program's side of a configuration: its config object and its
parameter trees, and a way to swap one of its module attributes for the
length of a call."""
from __future__ import annotations

import contextlib
import dataclasses


def port_config(cfg: dict):
    """The port's config: its ``arch`` preset with the configuration's
    ``overrides``."""
    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(cfg["port"]["arch"]),
                               **cfg["port"]["overrides"])


def nest(flat: dict) -> dict:
    """Flat ``a/b/c`` keys -> nested dicts (the program's parameter trees)."""
    out: dict = {}
    for path, v in flat.items():
        *outer, last = path.split("/")
        d = out
        for k in outer:
            d = d.setdefault(k, {})
        d[last] = v
    return out


def flatten(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


@contextlib.contextmanager
def swapped(module, name: str, value):
    old = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, old)
