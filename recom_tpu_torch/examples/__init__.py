"""The port's counterparts of the root ``examples/``: ``dlrm``,
``microbenchmark`` and ``serving``, each on the card by default
(``--device cpu`` runs every kernel's plain version) and each with a
``main(argv=None)``."""
