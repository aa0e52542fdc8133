"""Carry properties and engine state between ``dips_tpu`` and the port.

Both engines checkpoint the same numpy dict (``frame_index``, ``baseline``,
``tail``, ``heatmap``) with the same keys, shapes and dtypes, so a stream
can move between them.  These helpers check and normalise that dict.  They
take JAX-side objects but import nothing of JAX: a JAX ``DiPsProperties``
is read by field name and its enums by value.
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np

from . import properties as port_props

_ENUMS = {cls.__name__: cls for cls in (
    port_props.DiPsMethod, port_props.OutputMode, port_props.DiPsFilter,
    port_props.ChromaFilter, port_props.Encoding)}


def props_from_jax(p) -> port_props.DiPsProperties:
    """A ``dips_tpu.DiPsProperties`` as the port's, enums mapped by
    value."""
    kwargs = {}
    for f in dataclasses.fields(port_props.DiPsProperties):
        v = getattr(p, f.name)
        if isinstance(v, enum.Enum):
            v = _ENUMS[type(v).__name__](v.value)
        kwargs[f.name] = v
    return port_props.DiPsProperties(**kwargs)


def _state(d: dict) -> dict:
    tail = d.get("tail")
    heat = d.get("heatmap")
    return {
        "frame_index": int(d["frame_index"]),
        "baseline": np.array(d["baseline"]),
        "tail": None if tail is None else np.array(tail, dtype=np.uint8),
        "heatmap": None if heat is None else np.array(heat, np.float32),
    }


def state_from_jax(d: dict) -> dict:
    """``dips_tpu.DiPsEngine.state_dict()`` -> a dict the port's
    ``load_state_dict`` takes (numpy copies, same keys and shapes)."""
    return _state(d)


def state_to_jax(d: dict) -> dict:
    """The port's ``state_dict()`` -> a dict ``dips_tpu``'s
    ``load_state_dict`` takes (numpy copies, same keys and shapes)."""
    return _state(d)
