"""The reference put in the program's place: the control (one precision
below the configuration's) and the faults a cell can have, read by the
same comparison as the program (``calibrate.py`` reads them on the card
at the cells' sizes; the tests at a small size).  Each family says which
it has (``KINDS``) and reads them (``standin``)."""
from __future__ import annotations

from . import manifest


def read(cfg: dict, wl: dict, seed: int, device, kind: str) -> dict:
    return manifest.family(cfg["family"]).standin(
        cfg, wl, seed, device, kind, manifest.reference(cfg["reference"]))


def kinds(cfg: dict) -> tuple:
    return manifest.family(cfg["family"]).KINDS
