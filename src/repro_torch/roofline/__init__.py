"""Roofline of the port's cells: analytic model FLOPs and the H100's
datasheet peaks (``analysis``), operation-level FLOPs and bytes of a
PyTorch function (``op_cost``), and one rank's collectives
(``comm_cost``) and buffers (``buffer_cost``) on DTensors."""
