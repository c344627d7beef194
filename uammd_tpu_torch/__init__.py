"""uammd_tpu_torch — the PyTorch/CUDA port of ``uammd_tpu`` for NVIDIA Hopper.

The JAX package ``uammd_tpu`` is the reference; this package mirrors its
module paths and names (``engine/layout.py``, ``engine/md.py``, ...) so each
function has an obvious counterpart. Plain tensor code is PyTorch; every
kernel the JAX package wrote in Pallas is a hand-written CUDA kernel here
(``engine/csrc/*.cu``, compiled with nvcc on first use and bound with
ctypes), with a plain PyTorch version beside it that serves CPU tensors.

Entry points run on the GPU unless the caller passes ``device="cpu"``.
"""

from .core.box import Box, box
from .core.state import SimState, make_state
from .device import resolve_device

__version__ = "0.1.0"

__all__ = ["Box", "SimState", "box", "make_state", "resolve_device"]
