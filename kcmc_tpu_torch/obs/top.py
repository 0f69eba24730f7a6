"""The address parsing of `kcmc_tpu top` (the port's copy of
`parse_addr` from kcmc_tpu/obs/top.py).

The live dashboard over serve replicas comes with the fleet (ROADMAP
queue 1 item 19d); the `metrics` and `trace` subcommands read their
`host:port` sources through `parse_addr` from here, where the
reference keeps it.
"""

from __future__ import annotations


def parse_addr(addr: str, default_port: int = 7733) -> tuple[str, int]:
    """'host:port' | 'host' | ':port' -> (host, port)."""
    addr = (addr or "").strip()
    if ":" in addr:
        host, _, port = addr.rpartition(":")
        return host or "127.0.0.1", int(port)
    return addr or "127.0.0.1", default_port
