"""Bytes an n-tuple network's value must move, counted from its shapes.

The value of one board (``csrc/ntuple_value.cu``) reads the board's 16
bytes, writes its 4-byte float32 value, and reads one 4-byte table entry a
lookup: 32 lookups at Yeh et al.'s four 6-tuples under the 8 symmetries, so
16 + 4 + 128 = 148 B. Only the board and the value are bytes that must
cross HBM on every call: sibling leaves of the expectimax tree differ in a
few cells, so most of their tuples read the same entries, which L1 and L2
serve. A share of the card's HBM bandwidth that counted every lookup could
pass 100%, so the kernel's roofline counts 20 B a board fed; the share of
the whole move counts 148 B a leaf the tree needed, the work a move must do
whatever the tree feeds the leaf. Nothing here counts operations: the value
is integer index arithmetic and adds, and its bound is memory.
"""

from __future__ import annotations

BOARD_BYTES = 16
VALUE_BYTES = 4
ENTRY_BYTES = 4


def lookups(config: dict) -> int:
    """Table lookups of one board's value."""
    return len(config["tuples"]) * (8 if config["symmetric"] else 1)


def fed_bytes(boards: int) -> int:
    """Bytes the value kernel must move for ``boards`` boards fed: each
    board read, each value written."""
    return boards * (BOARD_BYTES + VALUE_BYTES)


def leaf_bytes(config: dict, leaves: float) -> float:
    """Bytes of ``leaves`` leaf values with every lookup read from memory."""
    return leaves * (BOARD_BYTES + VALUE_BYTES + ENTRY_BYTES * lookups(config))
