"""Runner ``method`` dispatch.

The shell runners have two ported formulations: ``cellmajor`` (NESTED
pixels, candidate lists per coarse cell, one dense pass per bucket; the
fast path on the card) and ``scatter`` (halo-major windows ending in a
scatter-add; the reference semantics). The snapshot runner's two are
``cellmajor`` and ``gather`` (per-halo blocks of cell-list cells ending
in a scatter-add; its reference semantics). ``'auto'`` resolves as in
the JAX package: the slow method on the CPU, ``cellmajor`` on an
accelerator when the configuration allows it, and otherwise the slow
method with a warning that names the reason; an explicit ``'cellmajor'``
that the configuration does not allow raises with the same reason. The
shell runners' ``gather`` (the JAX package's pixel-major cross-check,
``runners/shell_gather.py``) is not ported: asking a runner whose slow
method is ``scatter`` for it raises.
"""

import warnings

__all__ = ["resolve_method"]


def resolve_method(method, why_not, slow_name, device_type):
    """Resolve a runner ``method`` kwarg.

    method : 'auto' | 'cellmajor' | 'scatter' | 'gather'
    why_not : None if the cell-major path supports this configuration,
              else a short reason (the warning / error text)
    slow_name : the family's reference-semantics method ('scatter' for
                the shell and grid runners, 'gather' for the snapshot)
    device_type : the runner's device type ('cpu' or 'cuda'), in place of
                  the JAX package's default backend
    """
    if method == "auto":
        if device_type == "cpu":
            return slow_name
        if why_not is None:
            return "cellmajor"
        warnings.warn(f"falling back to the '{slow_name}' method "
                      f"({why_not})")
        return slow_name
    if method == "cellmajor":
        if why_not is not None:
            raise ValueError(f"method='cellmajor' unsupported here: "
                             f"{why_not}; use '{slow_name}'")
        return method
    if method == slow_name:
        return method
    if method == "gather":
        raise NotImplementedError(
            "method='gather' (the JAX package's pixel-major cross-check, "
            "runners/shell_gather.py) is not ported to PyTorch; see ROADMAP "
            "queue A. Use method='cellmajor' or 'scatter'")
    raise ValueError(f"unknown method {method!r}")
