"""Data pipeline of the port (counterpart of ``repro.data``)."""
