"""PyTorch/CUDA port of predictionio_tpu for one NVIDIA H100.

The JAX package ``predictionio_tpu`` stays the reference; this package
mirrors its layout file for file where a counterpart exists and never
imports it (nor JAX).  Plain tensor code is PyTorch; every Pallas kernel
of the ported path is a CUDA C++ kernel written for ``sm_90a``
(``ops/csrc``), built with ``nvcc`` at first use.

Entry points run on the card (``device="cuda"``) unless the caller asks
for ``device="cpu"``; on a CPU tensor a kernel wrapper runs its plain
PyTorch version, on a CUDA tensor it launches the kernel or raises.

``python -m predictionio_tpu_torch <command>`` is the console (``cli``).
"""

# the reference's version: the port serves the same CLI, file formats and
# template min-version gate
__version__ = "0.3.0"

__all__ = ["__version__", "fence", "resolve_device"]


def __getattr__(name: str):
    # torch is imported on first use: the package's torch-free tools
    # (``analysis``, ``tools.runlog``, ``tools.tracecat``) start without it
    if name in ("fence", "resolve_device"):
        from . import device

        return getattr(device, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
