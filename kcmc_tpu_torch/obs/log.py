"""The advisory-warning seam (the port's copy of `advise` from
kcmc_tpu/obs/log.py): rescue-fraction warnings, checkpoint quarantine,
zlib downgrade and degradation-ladder recoveries go through
`warnings.warn`, so `pytest.warns` and an embedder's warning filters
see them."""

from __future__ import annotations

import warnings


def advise(message: str, category: type[Warning] = RuntimeWarning,
           stacklevel: int = 2) -> None:
    """Emit an advisory diagnostic through `warnings.warn`."""
    warnings.warn(message, category, stacklevel=stacklevel + 1)
