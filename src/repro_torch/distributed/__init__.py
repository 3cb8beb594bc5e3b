"""Multi-process planes of the port: the partition-routing key exchange
of ``PartitionedDB`` over a ``torch.distributed`` process group and
training's int8 error feedback (``collectives``), and the logical-axis
sharding rules (``sharding``)."""
