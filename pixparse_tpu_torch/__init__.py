"""pixparse_tpu_torch: the PyTorch/CUDA port of pixparse_tpu.

Same module layout as :mod:`pixparse_tpu`; imports ``torch`` and never
JAX, flax, optax, orbax or anything of ``pixparse_tpu``. Entry points run on
the CUDA device unless the caller asks for the CPU (see :mod:`.device`).
"""

__version__ = "0.1.0"
