"""Quantized representations and the DR-tiered KV cache (reference: ``repro/core``)."""
