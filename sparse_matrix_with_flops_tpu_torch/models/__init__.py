"""Algorithm drivers of the port: R-MCL initialisation and the static
fused R-MCL loop."""

from .rmcl import rmcl_init
from .rmcl_ell import plan_rmcl_ell, rmcl_ell, rmcl_ell_scan, rmcl_ell_step

__all__ = ["plan_rmcl_ell", "rmcl_ell", "rmcl_ell_scan", "rmcl_ell_step", "rmcl_init"]
