"""Kernel layer: SpGEMM pipelines, SpMM/SpMV, flops machinery, prune math
(the port of the JAX package's ``ops/__init__.py``).

Public surface:

* ``spgemm`` / ``spgemm_symbolic`` / ``matmul`` — stream-ESC pipeline
* ``spgemm_ell`` / ``spgemm_ell_tiled`` / ``spgemm_ell_symbolic`` /
  ``plan_ell`` — the flops-classified ELL-ESC pipeline (``plan_ell``
  lives in ``ell_plan``, not beside the device side as in the
  reference)
* ``spgemm_binned`` / ``plan_bins`` — per-bin padded-width variant
* ``spgemm_ell_partitioned`` / ``flops_prefix_partition`` — row-split
  driver for flat export past one card's memory scale
* ``bcsr_spmm`` / ``bcsr_spmm_plain`` / ``csr_spmv`` /
  ``csr_spmm_dense`` — blocked matmuls; ``bcsr_spmm_plain`` (K5's plain
  twin) is the counterpart of the reference's ``bcsr_spmm_xla``
* ``row_flops`` / ``classify_flops`` / ``flops_stats`` — the namesake
* ``prune_normalize`` / ``compute_threshold`` — R-MCL row math

Exports resolve lazily (PEP 562): the format layer imports ops.segments
during its own init, so eager re-exports here would be circular.
"""

_EXPORTS = {
    "plan_bins": "binned",
    "spgemm_binned": "binned",
    "plan_ell": "ell_plan",
    "spgemm_ell": "ell_esc",
    "spgemm_ell_symbolic": "ell_esc",
    "spgemm_ell_tiled": "ell_esc",
    "classify_flops": "flops",
    "flops_stats": "flops",
    "nnz_stats": "flops",
    "row_flops": "flops",
    "spgemm_flops": "flops",
    "compute_threshold": "prune",
    "prune_normalize": "prune",
    "csr_row_slice": "partitioned",
    "csr_vstack": "partitioned",
    "flops_prefix_partition": "partitioned",
    "spgemm_ell_partitioned": "partitioned",
    "matmul": "spgemm",
    "spgemm": "spgemm",
    "spgemm_dense_oracle": "spgemm",
    "spgemm_symbolic": "spgemm",
    "bcsr_spmm": "spmm",
    "bcsr_spmm_plain": "spmm",
    "csr_spmm_dense": "spmm",
    "csr_spmv": "spmm",
}

__all__ = list(_EXPORTS)


def __getattr__(name):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(name)
    import importlib

    return getattr(importlib.import_module(f".{mod}", __name__), name)
