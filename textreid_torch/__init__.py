"""textreid_torch — the PyTorch/CUDA port of ``textreid_tpu`` for NVIDIA Hopper.

The JAX package ``textreid_tpu`` stays the reference; this package mirrors
its layout (``models/``, ``ops/``, ``utils/``, ``serving.py``, ``tools/``)
so each module's counterpart is easy to find.  It imports ``torch`` and
never ``jax``, and nothing of ``textreid_tpu``: the config tree
(``config/``), the host-side data pipeline (``data/``) and the HTTP front
(``server.py``) are the port's own copies, so the package stands alone.

Hand-written CUDA kernels live in ``csrc/`` and are built with ``nvcc`` at
first use (``ops/_build.py``); on CPU tensors every kernel wrapper runs its
plain PyTorch version instead.
"""

__version__ = "0.1.0"
