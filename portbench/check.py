"""The comparison that decides ``correct``: what the timed path produced
against the plain reference, number by number, each with its limit.

The numbers (the cell's file gives each its limit):

* ``maps_lsb``: the largest difference of a map byte, over every checked
  frame of every stream;
* ``stats_gap``: the largest gap of a per-frame statistic, over the
  largest magnitude of that statistic among the checked frames;
* ``heat_gap``: the largest gap of a heatmap pixel at the window's end,
  over the larger of that pixel's reference value and the mean one;
* ``base_gap``: the largest difference of the carried baseline;
* ``missing``: answers due in the window that never came.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Iterable, List, Tuple

import numpy as np


class Checks:
    """Numbers compared, each the worst over everything checked."""

    def __init__(self, limits: Dict[str, float]):
        self.limits = dict(limits)
        self.values: Dict[str, float] = {}

    def add(self, name: str, value: float) -> None:
        if name not in self.limits:
            raise KeyError(f"no limit for the number {name!r}")
        value = float(value)
        if np.isnan(value):
            value = float("inf")
        self.values[name] = max(self.values.get(name, value), value)

    def items(self) -> List[Tuple[str, float, float]]:
        return [(n, self.values[n], float(self.limits[n]))
                for n in self.limits if n in self.values]

    @property
    def correct(self) -> bool:
        return verdict(self.items(), self.limits)


def verdict(items: List[Tuple[str, float, float]],
            limits: Dict[str, float]) -> bool:
    """``correct``: every number within its limit, and none left unread."""
    return ({n for n, _, _ in items} == set(limits)
            and all(v <= lim for _, v, lim in items))


def maps_lsb(got: np.ndarray, exp: np.ndarray) -> float:
    got, exp = np.asarray(got), np.asarray(exp)
    if got.shape != exp.shape:
        return float("inf")
    return float(np.abs(got.astype(np.int16) - exp.astype(np.int16)).max())


def stats_gap(got: np.ndarray, exp: np.ndarray) -> float:
    """(n, 4) stats against (n, 4): per statistic, the largest gap over the
    largest reference magnitude (a floor keeps an all-zero column exact)."""
    got = np.asarray(got, np.float64).reshape(-1, exp.shape[-1])
    exp = np.asarray(exp, np.float64).reshape(-1, exp.shape[-1])
    if got.shape != exp.shape:
        return float("inf")
    scale = np.maximum(np.abs(exp).max(axis=0), 1e-30)
    return float((np.abs(got - exp) / scale).max())


def heat_gap(got: np.ndarray, exp: np.ndarray) -> float:
    got = np.asarray(got, np.float64)
    exp = np.asarray(exp, np.float64)
    if got.shape != exp.shape:
        return float("inf")
    floor = max(float(np.abs(exp).mean()), 1e-30)
    return float((np.abs(got - exp) / np.maximum(np.abs(exp), floor)).max())


def base_gap(got: np.ndarray, exp: np.ndarray) -> float:
    got = np.asarray(got, np.float64)
    exp = np.asarray(exp, np.float64)
    if got.shape != exp.shape:
        return float("inf")
    return float(np.abs(got - exp).max())


def per_stream(fn: Callable, items: Iterable) -> List:
    """``fn`` over the streams' items on a few threads (the reference's
    NumPy work releases the interpreter lock), results in order."""
    items = list(items)
    workers = max(1, min(len(items), os.cpu_count() or 1, 8))
    with ThreadPoolExecutor(workers) as pool:
        return list(pool.map(fn, items))
