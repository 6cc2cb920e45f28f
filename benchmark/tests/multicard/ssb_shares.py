"""SSB data (generators/ssb.py) handed out in shares: with ``part=(rank,
ranks)`` only that rank's lineorder rows, every ``ranks``-th row from the
``rank``-th, as a generator that makes each rank's share would give them."""
from benchlib import registry


def generate(config, seed, device, part=None):
    data = registry.load_module("generators", "ssb").generate(config, seed,
                                                              device)
    if part is not None:
        rank, ranks = part
        data["tables"]["lineorder"] = {
            c: a[rank::ranks].copy()
            for c, a in data["tables"]["lineorder"].items()}
    return data
