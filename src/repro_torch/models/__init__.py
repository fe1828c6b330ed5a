"""The dense model family on packed ternary weights (reference: ``repro/models``)."""
