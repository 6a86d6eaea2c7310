"""Core of the port: model math, error-bound algebra, the static RMI and the
two-tier dynamic index (counterparts of ``repro.core``)."""
