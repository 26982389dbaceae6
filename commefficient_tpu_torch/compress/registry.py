"""Compressor registry — the single place a mode string becomes code."""

from __future__ import annotations

from typing import Dict, Type

REGISTRY: Dict[str, Type] = {}


def register(name: str):
    """Class decorator: put the class on the registry under ``name``."""

    def deco(cls):
        if name in REGISTRY:
            raise ValueError(f"duplicate compressor registration: {name!r}")
        cls.name = name
        REGISTRY[name] = cls
        return cls

    return deco


def available_modes() -> tuple:
    return tuple(sorted(REGISTRY))


def compressor_class(mode: str) -> Type:
    try:
        return REGISTRY[mode]
    except KeyError:
        raise ValueError(f"unknown compression mode {mode!r}; registered: "
                         f"{available_modes()}") from None


def get_compressor(cfg, d: int, spec=None):
    """Construct and validate the compressor for ``cfg.mode``; ``spec`` is
    the CountSketch layout for modes that declare ``needs_sketch_spec``."""
    comp = compressor_class(cfg.mode)(cfg, d, spec=spec)
    comp.validate()
    return comp
