"""TM modes (paper SS3.3): a monotonically increasing counter whose value
mod 4 is the mode, so transitions are single atomic increments and the
cyclic order Q -> QtoU -> U -> UtoQ -> Q is structural."""
from __future__ import annotations

MODE_Q = 0
MODE_QTOU = 1
MODE_U = 2
MODE_UTOQ = 3

MODE_NAMES = {MODE_Q: "Q", MODE_QTOU: "QtoU", MODE_U: "U",
              MODE_UTOQ: "UtoQ"}


def get_mode(counter: int) -> int:
    return counter & 3


def mode_name(counter: int) -> str:
    return MODE_NAMES[get_mode(counter)]


def writers_must_version(mode: int) -> bool:
    """Paper Table 1: writers version in every mode except Q."""
    return mode != MODE_Q


def readers_assume_versioned(mode: int) -> bool:
    """Paper Table 1: only local-Mode-U readers may assume all relevant
    addresses are versioned."""
    return mode == MODE_U


def unversioning_enabled(mode: int) -> bool:
    return mode == MODE_Q
