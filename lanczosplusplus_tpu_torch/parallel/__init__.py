"""Distribution over ranks of a ``torch.distributed`` group: NCCL on the
card, gloo on the CPU.  Counterpart of ``lanczosplusplus_tpu/parallel/``:
``mesh`` (the mesh, the flat row-sharded form, the distributed solver and
estimators), ``kron`` (the Kronecker form), ``halo`` (the halo-exchange
forms), ``blockkron_dist`` (the column-sharded factored forms),
``scatter_plan`` (sector-changing operators) and ``dryrun`` (one step of
every path, held against the single-device port)."""
