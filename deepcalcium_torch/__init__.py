"""deepcalcium-torch: the PyTorch and CUDA port of deepcalcium-tpu.

The JAX package ``deepcalcium_tpu`` beside this one is the reference: each
module here keeps the name of its JAX counterpart, and the tests hold the two
against each other on the same inputs. Importing this package imports no
submodule and never imports JAX; the kernels are built at their first launch.
"""

__version__ = "0.1.0"
