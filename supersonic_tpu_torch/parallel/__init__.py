"""Distribution helpers of the port.  So far the row hash mixers
(``hashing``); the rest of ``supersonic_tpu/parallel`` (its partitioning
and collectives, which extend ``hashing``) is ROADMAP.md queue 1 item 17."""
