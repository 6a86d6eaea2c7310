"""Rule registry: each rule module exposes a ``RULE`` record
(``id``, one-line ``doc``, ``check(project)``); the engine iterates
``RULES`` and owns suppression/rendering.  ``NOT_PORTED`` names the
reference's rule ids the port has no counterpart of, and why."""
from . import dtype, hostsync, kernel, retrace

RULES = [
    hostsync.RULE,
    retrace.RULE,
    kernel.RULE,
    dtype.RULE,
]

NOT_PORTED = {
    "donation": "no torch API consumes an argument's buffer: where the "
                "reference donates, the port writes in place (the KV "
                "caches, serve/step.py; the restack slice cache, "
                "core.distributed.scatter_rows_)",
}

KNOWN_RULE_IDS = {r.id for r in RULES}

__all__ = ["RULES", "KNOWN_RULE_IDS", "NOT_PORTED"]
