"""Continuous-batching serving (reference: ``repro/serving``)."""
