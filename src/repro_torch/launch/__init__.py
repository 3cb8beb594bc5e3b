"""Command-line entry points of the port: ``python -m
repro_torch.launch.train``, ``launch.serve`` and ``launch.dryrun``; the
meshes (``launch.mesh``) and the cells' inputs (``launch.specs``)."""
