"""Fault vocabulary shared by the serving plane (reference: ``repro/distributed``)."""
