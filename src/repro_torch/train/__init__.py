"""Training (the port's copy of the JAX package's ``train/``): the
synthetic token stream (``data``), AdamW (``optimizer``), the step
(``trainer``) and checkpointing (``checkpoint``).  The step computes its
gradients with ``torch.autograd`` through the plain paths: no kernel has
a backward, as no Pallas kernel of the JAX package has a VJP."""
