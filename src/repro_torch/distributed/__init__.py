"""Multi-process planes of the port: the partition-routing key exchange
of ``PartitionedDB`` over a ``torch.distributed`` process group."""
