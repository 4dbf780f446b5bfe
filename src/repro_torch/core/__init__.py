"""The word-level Multiverse STM (``stm.py``) and what it is built from:
the clock, lock table, bloom filters, version lists and their device
mirror (``vlt.py``), epoch-based reclamation, the mode machine and the
K/S/L/P heuristics, over the transaction engine in ``engine/``."""
