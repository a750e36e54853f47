"""Unified index and dataset search (counterpart of ``repro.core``)."""
