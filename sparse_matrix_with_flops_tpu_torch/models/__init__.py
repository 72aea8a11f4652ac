"""Algorithms of the port: R-MCL (reference semantics and the
static fused loop), cluster extraction and checkpointing."""

from .checkpoint import load_checkpoint, rmcl_resumable, save_checkpoint
from .clusters import cluster_sizes, extract_clusters
from .rmcl import rmcl, rmcl_init, rmcl_one_step
from .rmcl_ell import plan_rmcl_ell, rmcl_ell, rmcl_ell_scan, rmcl_ell_step

__all__ = [
    "cluster_sizes",
    "extract_clusters",
    "load_checkpoint",
    "rmcl_resumable",
    "save_checkpoint",
    "rmcl",
    "rmcl_init",
    "rmcl_one_step",
    "plan_rmcl_ell",
    "rmcl_ell",
    "rmcl_ell_scan",
    "rmcl_ell_step",
]
