"""Runner ``method`` dispatch.

The JAX package picks between three formulations of the shell pass:
``cellmajor`` (its accelerator fast path), ``gather`` (a cross-check)
and ``scatter`` (halo-major windows ending in the sorted scatter-add; the
reference semantics). Only ``scatter`` is ported so far, so here
``'auto'`` resolves to ``'scatter'`` on every device. The other two are
methods not yet ported (ROADMAP queue B, item B2, for ``cellmajor``), not
fallbacks: asking for them raises.
"""

__all__ = ["resolve_method"]

_NOT_PORTED = {
    "cellmajor": "ROADMAP item B2 (cellmajor_offsets_pass)",
    "gather": "ROADMAP queue A (runners/shell_gather.py)",
}


def resolve_method(method):
    """Resolve a runner ``method`` kwarg: 'auto' | 'scatter' | 'cellmajor'
    | 'gather'. Returns 'scatter' or raises."""
    if method in ("auto", "scatter"):
        return "scatter"
    if method in _NOT_PORTED:
        raise NotImplementedError(
            f"method={method!r} is not ported to PyTorch yet (see "
            f"{_NOT_PORTED[method]}); use method='scatter'")
    raise ValueError(f"unknown method {method!r}")
