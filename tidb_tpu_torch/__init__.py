"""tidb_tpu_torch: the PyTorch/CUDA port of ``tidb_tpu``.

A second package beside the JAX one, module for module: each module
here carries a first line naming its counterpart in ``tidb_tpu/`` and
the commit it was taken from.  The port imports ``torch``, ``numpy``
and the standard library only; it never imports ``jax`` or anything of
``tidb_tpu``.

Entry points run on the GPU (``device="cuda"``) unless the caller asks
for the CPU (``device="cpu"``), where every hand-written kernel is
replaced by its plain PyTorch version.  Asking for CUDA on a machine
without a GPU raises.

What is ported so far is the coprocessor client's aggregation:
``store.client.CopClient.execute_agg`` over a
``store.columnar.ColumnarSnapshot``, for the SCALAR and DENSE strategies
(TPC-H Q1, Q6, Q19), whose reductions run on the ``group_reduce`` CUDA
kernel (``copr/cuda/group_reduce.cu``), and for the high-NDV SCATTER
strategy, whose radix counting sort runs as CUDA kernels
(``copr/cuda/radix_kernel.cu``).
"""
