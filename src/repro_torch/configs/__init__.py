"""Configurations of the port: the paper's STM tunables
(``paper_stm.MultiverseParams``)."""
