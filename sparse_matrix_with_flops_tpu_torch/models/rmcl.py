"""R-MCL initialisation (the port of ``models/rmcl.py:52-55`` of the JAX
package).  The dynamic ``rmcl_one_step`` and its drivers are not ported
yet (ROADMAP A7)."""

from __future__ import annotations

from ..formats.coo import COO
from ..formats.csr import CSR


def rmcl_init(coo: COO) -> CSR:
    """Self loops + ordering + CSR + row-uniform normalisation
    (rmclInit, qrmcl.cc:126-134).  Requires coo capacity >= nnz + rows."""
    return coo.add_self_loops().make_ordered().to_csr().aver_and_norm_rows()
