"""repro_torch — the PyTorch/CUDA port of the AVEC reproduction.

The supported host-side entry point is the :mod:`repro_torch.avec` facade:

    from repro_torch import avec
    client = avec.connect(["tcp://edge:9000"])
    sess = client.session(cfg, params, "lm")

Destinations compute on an NVIDIA H100 through hand-written CUDA kernels
(``repro_torch.kernels``).  The package imports ``torch``, numpy and the
standard library only.  Submodule re-exports are lazy (PEP 562) so
``import repro_torch.models`` and friends don't drag the whole client stack
in."""
from __future__ import annotations

import importlib

__all__ = ["avec", "connect", "AvecClient", "ConnectPolicy", "ArgSpec"]

_LAZY = {
    "avec": ("repro_torch.avec", None),
    "connect": ("repro_torch.avec", "connect"),
    "AvecClient": ("repro_torch.avec", "AvecClient"),
    "ConnectPolicy": ("repro_torch.avec", "ConnectPolicy"),
    "ArgSpec": ("repro_torch.avec", "ArgSpec"),
}


def __getattr__(name: str):
    try:
        mod_name, attr = _LAZY[name]
    except KeyError:
        raise AttributeError(f"module 'repro_torch' has no attribute {name!r}")
    mod = importlib.import_module(mod_name)
    value = mod if attr is None else getattr(mod, attr)
    globals()[name] = value         # cache: __getattr__ runs once per name
    return value


def __dir__():
    return sorted(set(globals()) | set(_LAZY))
