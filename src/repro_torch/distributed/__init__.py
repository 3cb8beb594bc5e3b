"""Multi-process planes of the port: the partition-routing key exchange
of ``PartitionedDB`` over a ``torch.distributed`` process group and
training's int8 error feedback (``collectives``), the logical-axis
sharding rules, the ambient mesh and ``constrain`` (``sharding``), and
the GPipe pipeline over the "pod" mesh axis (``pipeline``)."""
