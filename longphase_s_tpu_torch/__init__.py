"""longphase_s_tpu_torch — the PyTorch + CUDA port of longphase_s_tpu.

The port runs on one NVIDIA Hopper GPU (sm_90a). It imports the JAX
package's framework-free host layers (``io/``, ``core/``, ``native/``,
``utils/``, ``testing/`` and the numpy read correction) and replaces its
device layer:

* ``ops/``: the banded pair pack and the haplotype vote scan as kernels
  written by hand in CUDA C++ (``csrc/``), each with a plain PyTorch
  version beside it; block assembly as plain torch on the device,
* ``core/fastpath.py``, ``models/phase.py``, ``cli.py``: the ``phase``
  pipeline with the device dispatch swapped,
* ``parallel/distributed.py``: a single-process stand-in for the
  multi-host shim.

Every function that touches a tensor takes an explicit ``device``. A CUDA
device that is not there raises; nothing falls back to the CPU. The port
never imports ``jax``.
"""

from longphase_s_tpu import REFERENCE_VERSION

__version__ = "0.1.0"

__all__ = ["REFERENCE_VERSION", "__version__"]
