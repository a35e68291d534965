"""Solution-field output artifacts for the CLI and example scripts.

Counterpart of the JAX package's ``utils/fields.py``.  Every reference script
ends by *looking at* the solve, ``imshow(real(reshape(u, n, m)))``
(``examples/example.jl:96-98``, ``tests/plasma_example.jl``'s plots).
:func:`save_field` restores that visual-validation role headlessly: it writes
the field and residual history to ``<base>.npz`` (machine-readable) and
renders ``<base>.png`` (real part, magnitude, and the GMRES residual curve)
when matplotlib is importable.
"""

from __future__ import annotations

import numpy as np
import torch


def _host(a) -> np.ndarray:
    """A tensor (on any device) or array-like as a numpy array."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def save_field(base: str, u, shape, residuals=None, title: str = ""):
    """Write ``<base>.npz`` (+ ``<base>.png`` if matplotlib is available).

    ``u`` is the flat solution vector (a tensor on any device, or an array),
    ``shape`` the grid shape (slowest axis first); 3D fields are rendered at
    the middle slice of the slowest axis.  The ``.npz`` keys are the JAX
    package's: ``u``, ``shape`` and, with ``residuals``, the nonzero entries
    of the residual history.  Returns the list of files written.
    """
    if base.endswith((".npz", ".png")):
        base = base.rsplit(".", 1)[0]
    u = _host(u).reshape(tuple(shape))
    res = None
    if residuals is not None:
        res = _host(residuals).ravel()
        res = res[res > 0]
    written = []

    npz_path = base + ".npz"
    payload = {"u": u, "shape": np.asarray(shape)}
    if res is not None:
        payload["residuals"] = res
    np.savez_compressed(npz_path, **payload)
    written.append(npz_path)

    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:         # plotting is best-effort
        return written

    img = u if u.ndim == 2 else u[u.shape[0] // 2]
    n_panels = 2 + (res is not None)
    fig, axes = plt.subplots(1, n_panels, figsize=(4.2 * n_panels, 3.6))
    for ax, data, name, cmap in (
        (axes[0], np.real(img), "Re u", "RdBu_r"),
        (axes[1], np.abs(img), "|u|", "viridis"),
    ):
        im = ax.imshow(data, origin="lower", cmap=cmap)
        ax.set_title(name)
        fig.colorbar(im, ax=ax, fraction=0.046)
    if res is not None:
        ax = axes[2]
        ax.semilogy(np.arange(len(res)), res, "o-", ms=3)
        ax.set_title("GMRES residual")
        ax.set_xlabel("iteration")
        ax.grid(True, which="both", alpha=0.3)
    if title:
        fig.suptitle(title)
    fig.tight_layout()
    png_path = base + ".png"
    fig.savefig(png_path, dpi=110)
    plt.close(fig)
    written.append(png_path)
    return written
