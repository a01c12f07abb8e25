"""Both decompositions of the port: ``sharding`` (the particle ledger split by
slot, fields replicated) and ``spatial`` (blocks split, particles migrating),
over the collectives of ``exchange``."""
