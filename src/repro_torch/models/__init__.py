"""The model families on packed ternary weights (reference: ``repro/models``)."""
