"""Static backend dispatch and device resolution for the port.

The kernelized primitives -- the CLOCK tracker update (§4.3),
approx-MSC candidate scoring (§5), the tier_compact row movers of the
quantized drain and the payload mirrors, the model's flash and paged
decode attention, and RWKV-6's WKV scan -- each exist twice: a plain
PyTorch version and a hand-written CUDA kernel under
``repro_torch.kernels``.  This module decides which one runs.

* ``"reference"`` runs the plain PyTorch version on any device.
* ``"cuda"`` launches the kernel for CUDA tensors.  The plain version is
  taken only for tensors that lie on the CPU; any other device raises.

Dispatch is static: ``backend`` comes from ``EngineConfig`` and is never
read off tensor values.  There is no fallback from a CUDA tensor to the
plain version.  No kernel has a backward (as no Pallas kernel of the JAX
package has a VJP): a launcher given an input that autograd records
raises (``refuse_grad``), so no gradient is lost without a word.
"""
from __future__ import annotations

import torch

REFERENCE = "reference"
CUDA = "cuda"
BACKENDS = (REFERENCE, CUDA)


def check(backend: str) -> str:
    """Validate a backend name (raise early, not mid-step)."""
    if backend not in BACKENDS:
        raise ValueError(
            f"unknown backend {backend!r}; expected one of {BACKENDS}")
    return backend


def resolve_device(device=None) -> torch.device:
    """``None`` means the card: the port's entry points run on CUDA unless
    the caller asks for another device (the CPU tests pass ``"cpu"``)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    return dev


def use_kernel(backend: str, t: torch.Tensor) -> bool:
    """True when ``backend`` asks for the kernel and ``t`` lies on a card;
    False for the plain version (backend "reference", or a CPU tensor).
    Raises for any other device: nothing falls back silently."""
    if backend == REFERENCE:
        return False
    check(backend)
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise RuntimeError(
        f"backend {backend!r} has no kernel for device {t.device}")


def refuse_grad(name: str, *tensors: torch.Tensor) -> None:
    """Raise when grad mode is on and one of a kernel's inputs requires
    grad: the kernel's output would carry no graph, and every gradient
    through it would be silently dropped.  Train on backend
    "reference"."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: the kernel has no backward, and an input requires "
            "grad; train on backend 'reference' (or call it under "
            "torch.no_grad())")
