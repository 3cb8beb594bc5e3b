"""Roofline of the port's cells: analytic model FLOPs and the H100's
datasheet peaks (``analysis``), and operation-level FLOPs and bytes of a
PyTorch function (``op_cost``)."""
